"""Augmentation transforms on RawHierarchy feature columns (numpy, host-side).

A copy of `stinet_tpu/data/transforms.py`, so the port's samples equal the
JAX package's bit for bit. The 10-channel 3D feature layout is
[masked color 0:3 | normals 3:6 | positions 6:9 | mask_bool 9], as the
reference's ScanNet loader writes it; CoordsNormalization and the random
transforms act on those fixed column ranges as the reference's do.
Randomness comes from an explicit np.random.Generator passed per sample,
not from torch's global generator.
"""
import math

import numpy as np

from stinet_tpu_torch.core.registry import TRANSFORMS


@TRANSFORMS.register("ColorNormalization")
class ColorNormalization:
    """Map color channels (assumed in [0,1]) to [begin, end]
    (reference transform/color_normalization.py)."""

    def __init__(self, begin: float = 0.0, end: float = 1.0):
        self._begin = begin
        self._end = end

    def __call__(self, sample, rng=None):
        sample.x[:, :3] = ((self._end - self._begin) * sample.x[:, :3]
                           + self._begin)
        return sample


@TRANSFORMS.register("CoordsNormalization")
class CoordsNormalization:
    """Divide positions (cols 6:9) by per-axis max sizes
    (reference transform/coords_normalization.py)."""

    def __init__(self, max_sizes):
        self.max_sizes = np.asarray(max_sizes, dtype=np.float32)

    def __call__(self, sample, rng=None):
        sample.x[:, 6:9] = sample.x[:, 6:9] / self.max_sizes
        return sample


@TRANSFORMS.register("RandomRotation")
class RandomRotation:
    """Random rotation about the height (z) axis applied to normals (3:6)
    and positions (6:9) (reference transform/random_rotation.py)."""

    def __call__(self, sample, rng):
        theta = float(rng.uniform(0.0, 2.0 * math.pi))
        rot = np.array([[math.cos(theta), math.sin(theta), 0.0],
                        [-math.sin(theta), math.cos(theta), 0.0],
                        [0.0, 0.0, 1.0]], dtype=np.float32)
        sample.x[:, 3:6] = sample.x[:, 3:6] @ rot
        sample.x[:, 6:9] = sample.x[:, 6:9] @ rot
        return sample


@TRANSFORMS.register("RandomLinearTransformation")
class RandomLinearTransformation:
    """Positions are multiplied by I + noise*perturbation (optionally with an
    x-axis flip) (reference transform/random_linear_transformation.py)."""

    def __init__(self, flip: bool = True, pertubation_factor: float = 0.1):
        self._flip = flip
        self._factor = pertubation_factor

    def __call__(self, sample, rng):
        m = (np.eye(3) + rng.normal(size=(3, 3)) * self._factor).astype(
            np.float32)
        if self._flip:
            m[0, 0] *= -1.0
        sample.x[:, 6:9] = sample.x[:, 6:9] @ m
        return sample


@TRANSFORMS.register("MoveToOrigin")
class MoveToOrigin:
    """Center level-0 positions at the origin
    (reference transform/move_to_origin.py)."""

    def __call__(self, sample, rng=None):
        pos = sample.x[:, 6:9]
        middle = (pos.max(0) + pos.min(0)) / 2.0
        sample.x[:, 6:9] = pos - middle
        return sample


@TRANSFORMS.register("AddSelfLoops")
class AddSelfLoops:
    """Remove then re-add self loops on every edge set
    (reference transform/add_self_loops.py)."""

    def __init__(self, identifier: str = "edge_index"):
        self.identifier = identifier

    def __call__(self, sample, rng=None):
        new_edges = []
        for l, e in enumerate(sample.level_edges):
            keep = e[:, e[0] != e[1]]
            n = sample.num_vertices[l]
            loops = np.tile(np.arange(n, dtype=e.dtype), (2, 1))
            new_edges.append(np.concatenate([keep, loops], axis=1))
        sample.level_edges = new_edges
        return sample


def compose(transform_configs):
    """Instantiate a transform pipeline from config dicts
    ({'type': ..., 'args': {...}}), reference
    scannetcolorgraph_dataloader.py:167-185."""
    ts = [TRANSFORMS.get(tc["type"])(**tc.get("args", {}))
          for tc in (transform_configs or [])]

    def apply(sample, rng):
        for t in ts:
            sample = t(sample, rng)
        return sample
    return apply
