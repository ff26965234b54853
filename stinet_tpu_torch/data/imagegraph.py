"""2D texture-image inpainting data pipeline: images as 4-connected grid
graphs with a synthetic pooling hierarchy.

A copy of `stinet_tpu/data/imagegraph.py` (which imports no JAX), building
through the port's `graph/build.py`, so its batches equal the JAX
package's leaf for leaf. As the reference's ImageGraphTextureDataLoader:
[-1, 1] normalization, center crop, 90-degree rotations and flips,
`num_circles` circular masks (fixed quadrant offsets for eval, random
offsets for train), input features [img * ~mask | mask] flattened to
[N, 4].

Every sample shares one grid topology (`graph.build.grid_hierarchy`), so a
loader builds its padded batched graph once, on its first batch, and after
that refreshes only the x, color and mask leaves. When `root_dir` has no
PNGs, 32 training and 8 validation textures are synthesized from a fixed
seed, so the workload needs no data.

A dataset draws its rotations, flips and mask offsets from one generator
in `__getitem__` order, and its loaders share it: the order in which a
trainer walks `train_loader` and `sample_train_loader` decides every later
batch, as in the JAX package. The loaders here are plain generators; walk
one at a time.

With `stacked_batching` (forced in a torch.distributed group of more than
one rank) every batch is a stacked graph, one image a slice of a leading
sample axis: the skeleton is built once, from the first batch, and each
rank builds its contiguous slice of every global batch (`_Loader`).
"""
import dataclasses
import glob
import os
import time
from typing import List, Optional

import numpy as np
import torch

from stinet_tpu_torch.core.registry import DATALOADERS
from stinet_tpu_torch.graph.build import (
    RawHierarchy, build_hierarchical_graph, build_stacked_graph,
    grid_hierarchy)
from stinet_tpu_torch.parallel import multihost


def _circle_stamp(radius: int) -> np.ndarray:
    yy, xx = np.mgrid[:2 * radius, :2 * radius]
    return ((yy - radius) ** 2 + (xx - radius) ** 2 <= radius ** 2)


def synth_texture(rng: np.random.Generator, size: int = 256) -> np.ndarray:
    """Procedural RGB texture in [0,255] uint8: random low-frequency fourier
    mixture (stands in for the reference's texture PNG directory)."""
    yy, xx = np.mgrid[:size, :size] / size
    img = np.zeros((size, size, 3))
    for _ in range(6):
        fx, fy = rng.uniform(1, 8, 2)
        ph = rng.uniform(0, 2 * np.pi, 2)
        col = rng.uniform(0, 1, 3)
        img += np.sin(2 * np.pi * (fx * xx + ph[0]))[..., None] * \
            np.cos(2 * np.pi * (fy * yy + ph[1]))[..., None] * col
    img = (img - img.min()) / (np.ptp(img) + 1e-8)
    return (img * 255).astype(np.uint8)


class ImageGraphTextureDataSet:
    def __init__(self, images: List[np.ndarray], end_level: int,
                 is_train: bool, img_size: int, crop_half_width: int,
                 circle_radius: int, num_circles: int = 4,
                 random_mask: bool = False, random_augmentation: bool = False,
                 seed: int = 0):
        self._images = images
        self._end_level = end_level
        self._is_train = is_train
        self.img_size = img_size
        self.crop_half_width = crop_half_width
        self.circle_radius = circle_radius
        self.num_circles = num_circles
        self.random_mask = random_mask
        self.random_augmentation = random_augmentation
        self._rng = np.random.default_rng(seed)
        self._circle = _circle_stamp(circle_radius)
        self.num_vertices, self.level_edges, self.traces = grid_hierarchy(
            img_size, end_level)

    def __len__(self):
        return len(self._images)

    def _transform(self, img: np.ndarray) -> np.ndarray:
        """Normalize to [-1,1]; (train) random 90-rotation + horizontal flip.
        Images are synthesized/center-cropped at img_size already."""
        img = img.astype(np.float32) / 255.0 * 2.0 - 1.0
        s = self.img_size
        if img.shape[0] != s or img.shape[1] != s:
            h0 = (img.shape[0] - s) // 2
            w0 = (img.shape[1] - s) // 2
            img = img[h0:h0 + s, w0:w0 + s]
        if self._is_train and self.random_augmentation:
            img = np.rot90(img, k=int(self._rng.integers(0, 4)), axes=(0, 1))
            if self._rng.integers(0, 2):
                img = img[:, ::-1]
        return np.ascontiguousarray(img)

    def _make_mask(self) -> np.ndarray:
        s, r = self.img_size, self.circle_radius
        mask = np.zeros((s, s), dtype=bool)
        for i in range(self.num_circles):
            if self._is_train and self.random_mask:
                lim = (s / 2 - self.crop_half_width) * 0.95
                xo = int(self._rng.uniform(-lim, lim))
                yo = int(self._rng.uniform(-lim, lim))
            else:
                xo = ((i % 2) * 2 - 1) * s // 4
                yo = ((i // 2) * 2 - 1) * s // 4
            r0, c0 = s // 2 - r + xo, s // 2 - r + yo
            rs, cs = max(r0, 0), max(c0, 0)
            re, ce = min(r0 + 2 * r, s), min(c0 + 2 * r, s)
            mask[rs:re, cs:ce] |= self._circle[rs - r0:re - r0, cs - c0:ce - c0]
        return mask

    def __getitem__(self, index: int) -> RawHierarchy:
        img = self._transform(self._images[index])
        mask = self._make_mask()
        color = img.reshape(-1, 3)
        m = mask.reshape(-1, 1).astype(np.float32)
        x = np.concatenate([color * (1.0 - m), m], axis=-1).astype(np.float32)
        return RawHierarchy(
            x=x, color=color, mask=m,
            num_vertices=list(self.num_vertices),
            level_edges=list(self.level_edges),
            traces=list(self.traces), name=f"img_{index}")


class _Loader:
    """Batched loader yielding (HierarchicalGraph, names), concatenated or,
    with `stacked`, stacked (graph/build.py `build_stacked_graph`: one
    image a slice of a leading sample axis). The padded topology is built
    on the first batch and kept; each batch refreshes only x, color and
    mask. `build_ms` holds the host time of each batch (sample draws, the
    first build, the refill), in order. Stacked, `batch_size` is the global
    batch: every rank walks the same shuffled schedule and builds only its
    contiguous slice of B / ranks images (all images share one topology,
    so no signature is merged across ranks)."""

    def __init__(self, dataset: ImageGraphTextureDataSet, batch_size: int,
                 shuffle: bool, seed: int = 0,
                 max_batches: Optional[int] = None, stacked: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._skeleton = None
        self.max_batches = max_batches
        self.stacked = stacked
        self.build_ms: List[float] = []

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        return min(n, self.max_batches) if self.max_batches else n

    @staticmethod
    def _fill(g, samples, stacked):
        """The cached skeleton with its x/color/mask leaves refilled: the
        samples' rows one after another, or one a slice when `stacked`."""
        lead = (len(samples),) if stacked else ()
        v_pad = g.x.shape[len(lead)]
        x = np.zeros(lead + (v_pad,) + samples[0].x.shape[1:], np.float32)
        color = np.zeros(lead + (v_pad, 3), np.float32)
        mask = np.zeros(lead + (v_pad, 1), np.float32)
        off = 0
        for i, s in enumerate(samples):
            n = s.x.shape[0]
            rows = (i, slice(0, n)) if stacked else slice(off, off + n)
            x[rows] = s.x
            color[rows] = s.color
            mask[rows] = s.mask
            off += n
        return dataclasses.replace(
            g, x=torch.from_numpy(x), color=torch.from_numpy(color),
            mask=torch.from_numpy(mask))

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        rank, ranks = multihost.process_index(), multihost.process_count()
        if self.stacked and self.batch_size % ranks:
            raise ValueError(f"global batch {self.batch_size} does not "
                             f"divide over {ranks} processes")
        local = self.batch_size // ranks
        for b in range(len(self)):
            t0 = time.perf_counter()
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if self.stacked:
                sel = sel[rank * local:(rank + 1) * local]
            samples = [self.dataset[i] for i in sel]
            if self._skeleton is None:
                self._skeleton = (build_stacked_graph(samples)[0]
                                  if self.stacked
                                  else build_hierarchical_graph(samples))
            graph = self._fill(self._skeleton, samples, self.stacked)
            self.build_ms.append((time.perf_counter() - t0) * 1e3)
            yield graph, [s.name for s in samples]


@DATALOADERS.register("ImageGraphTextureDataLoader")
class ImageGraphTextureDataLoader:
    """The reference loader's config surface
    (experiments/2d_inpainting/config/config_stinet_imageinpainting.json)."""

    def __init__(self, config, multi_gpu=False, seed=0):
        c = dict(config)
        self.config = c
        img_size = c["img_size"]
        end_level = c["end_level"]

        train_imgs, val_imgs = self._load_images(
            c.get("root_dir", ""), c.get("max_items", -1), img_size)

        common = dict(end_level=end_level, img_size=img_size,
                      crop_half_width=c["crop_half_width"],
                      circle_radius=c["circle_radius"],
                      num_circles=c.get("num_circles", 4))
        self.train_dataset = ImageGraphTextureDataSet(
            train_imgs, is_train=True, random_mask=c.get("random_mask", False),
            random_augmentation=c.get("random_augmentation", False),
            seed=seed, **common)
        self.val_dataset = ImageGraphTextureDataSet(
            val_imgs, is_train=False, seed=seed + 1, **common)

        # stacked batching: a config's choice in one process, the layout
        # across processes
        stacked = (bool(c.get("stacked_batching", False))
                   or multihost.process_count() > 1)
        self.stacked = stacked
        self.train_loader = _Loader(self.train_dataset,
                                    c["train_batch_size"], shuffle=True,
                                    seed=seed, stacked=stacked)
        self.val_loader = _Loader(self.val_dataset, c["test_batch_size"],
                                  shuffle=False, stacked=stacked)
        nstat = c.get("num_static_samples", 8)
        self.sample_train_loader = _Loader(
            self.train_dataset, c["train_batch_size"], shuffle=False,
            max_batches=max(1, nstat // c["train_batch_size"]),
            stacked=stacked)
        self.sample_val_loader = _Loader(
            self.val_dataset, c["test_batch_size"], shuffle=False,
            max_batches=max(1, nstat // c["test_batch_size"]),
            stacked=stacked)

    @staticmethod
    def _load_images(root_dir, max_items, img_size):
        def read_dir(d):
            files = sorted(glob.glob(os.path.join(d, "*.png")))
            rng = np.random.default_rng(42)
            rng.shuffle(files)
            out = []
            for f in files:
                from PIL import Image   # only where there are PNGs to read
                out.append(np.asarray(Image.open(f).convert("RGB")))
            return out

        train = read_dir(os.path.join(root_dir, "train")) if root_dir else []
        val = read_dir(os.path.join(root_dir, "val")) if root_dir else []
        if not train:
            rng = np.random.default_rng(7)
            n_train, n_val = 32, 8
            train = [synth_texture(rng, img_size) for _ in range(n_train)]
            val = [synth_texture(rng, img_size) for _ in range(n_val)]
        if max_items and max_items > 0:
            frac = len(train) / max(len(train) + len(val), 1)
            train = train[:int(max_items * frac)]
            val = val[:max(1, int(max_items * (1 - frac)))]
        return train, val
