"""Hostile benchmark scenes built through the repo's OWN preprocessing
pipeline: the friendly jittered-grid scenes in
utils/synthetic.py are naturally RCM-bandable (avg degree ~6, near-banded
already), which flattered the windowed-kernel dispatch tuning. These
generators instead produce irregular 2-manifolds and push them through the
native QEM decimation ladder (preprocessing/graph_levels.py +
preprocessing/native/decimator.cpp) — the same regime as the reference's
real data (graph_level_generation.py:248-249 QEM meshes): skewed valence
(deg 3-12), shuffled ids, non-trivial RCM bandwidth.

Kinds:
  sphere  — convex hull of uniform points on S^2 (irregular Delaunay-like
            valences), radially perturbed AFTER hull construction;
  terrain — 2D jittered-grid Delaunay triangulation with fractal heights
            (long thin triangles, valence skew).
Both are then QEM-decimated to the requested level-0 size, so level 0
itself is an irregular decimated surface, not a construction-regular one.

A copy of the JAX package's `utils/hostile.py` over the port's
preprocessing: the two give the same scene, leaf for leaf.
"""
from typing import Sequence

import numpy as np

from stinet_tpu_torch.graph.build import RawHierarchy


def sphere_mesh(num_vertices: int, seed: int = 0, noise: float = 0.08):
    """Convex hull of exactly-unit points (every point lands on the hull),
    vertices radially perturbed afterwards so geometry is bumpy but
    connectivity stays a closed 2-manifold."""
    from scipy.spatial import ConvexHull
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(num_vertices, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    hull = ConvexHull(p)
    v = p * (1.0 + noise * rng.normal(size=(num_vertices, 1)))
    return v, hull.simplices.astype(np.int64)


def terrain_mesh(num_vertices: int, seed: int = 0, jitter: float = 0.45):
    """Delaunay triangulation of a jittered grid with multi-octave heights:
    irregular valences and anisotropic triangles."""
    from scipy.spatial import Delaunay
    rng = np.random.default_rng(seed)
    n = int(np.sqrt(num_vertices))
    gx, gy = np.meshgrid(np.arange(n, dtype=np.float64),
                         np.arange(n, dtype=np.float64))
    xy = np.stack([gx.ravel(), gy.ravel()], axis=1)
    xy += rng.uniform(-jitter, jitter, size=xy.shape)
    tri = Delaunay(xy)
    z = np.zeros(len(xy))
    for octave in (4.0, 11.0, 29.0):
        phase = rng.uniform(0, 2 * np.pi, size=2)
        direction = rng.normal(size=2)
        direction /= np.linalg.norm(direction)
        z += (n / octave) * 0.3 * np.sin(
            xy @ direction * (2 * np.pi * octave / n) + phase[0])
    v = np.concatenate([xy, z[:, None]], axis=1)
    return v, tri.simplices.astype(np.int64)


def hostile_scene(num_vertices: int = 65536, kind: str = "sphere",
                  seed: int = 0,
                  level_params: Sequence = ("50", "30", "30"),
                  dilation_dists: Sequence[int] = (2, 4, 8, 16),
                  masked_frac: float = 0.25,
                  name: str = None) -> RawHierarchy:
    """RawHierarchy with ~num_vertices level-0 vertices, produced by the
    native QEM ladder from a hostile source mesh. level_params follows the
    reference "p0 p1 p2 ..." convention; the default decimates even level 0
    (50%), so its connectivity is decimator output, not generator output.
    The dict -> RawHierarchy conversion mirrors the ScanNet loader's
    full-mesh path (data/scannet.py::__getitem__: traces[1:], color to
    [-1, 1], x = [masked color, normals, pos, mask_bool])."""
    from stinet_tpu_torch.preprocessing.graph_levels import (
        build_scene_levels)

    p0 = float(level_params[0])
    src_n = int(num_vertices * 100.0 / p0) if p0 < 100 else num_vertices
    if kind == "sphere":
        v, f = sphere_mesh(src_n, seed)
    elif kind == "terrain":
        v, f = terrain_mesh(src_n, seed)
    else:
        raise ValueError(f"unknown hostile kind {kind!r}")

    rng = np.random.default_rng(seed + 1)
    colors01 = rng.uniform(0, 1, size=(len(v), 3))
    d = build_scene_levels(v, f, colors01, None, list(level_params),
                           dilation_dists=dilation_dists,
                           dilation_levels=(len(level_params) - 1,))

    L = len(level_params)
    v0 = d["vertices_0"].astype(np.float32)
    pos, color01, normals = v0[:, 0:3], v0[:, 3:6], v0[:, 6:9]
    color = color01 * 2.0 - 1.0

    nv0 = v0.shape[0]
    mask = np.zeros((nv0, 1), np.float32)
    hit = rng.integers(0, nv0, size=int(nv0 * masked_frac))
    mask[hit, 0] = rng.integers(1, 5, size=len(hit)).astype(np.float32)
    mask_bool = (mask == 0).astype(np.float32)

    x = np.concatenate([color * mask_bool, normals, pos, mask_bool],
                       axis=-1)

    traces = [d[f"traces_{l}"].astype(np.int64) for l in range(1, L)]
    num_v = [nv0] + [int(t.max()) + 1 for t in traces]
    edges = [d[f"edges_{l}"].astype(np.int64) for l in range(L)]
    dilated = {}
    for l in range(L):
        per = {int(dd): d[f"dil_{dd}_edges_{l}"].astype(np.int64)
               for dd in dilation_dists if f"dil_{dd}_edges_{l}" in d}
        if per:
            dilated[l] = per

    return RawHierarchy(
        x=x.astype(np.float32), color=color.astype(np.float32), mask=mask,
        num_vertices=num_v, level_edges=edges, traces=traces,
        dilated=dilated, name=name or f"hostile_{kind}_{num_vertices}")
