"""Synthetic ScanNet-like mesh hierarchies for benchmarks, smoke runs and
tests: the statistics of the preprocessing pipeline's output (avg degree ~6
triangle-mesh connectivity, ~30% decimation per level, dilated edge sets at
the coarsest level) without ScanNet data. A copy of
`stinet_tpu/utils/synthetic.py`: the same seed gives the same scene.

The mesh is a GRID TRIANGULATION (a 2-manifold surface), matching real scan
topology: planar-like connectivity, bounded degree, local decimation
traces, dilation edges at graph distance ~d. Vertex ids are SHUFFLED before
return so nothing downstream relies on the construction order.
"""
from typing import Sequence

import numpy as np

from stinet_tpu_torch.graph.build import RawHierarchy

# The flagship serving scene: ScanNet crop scale, 3 levels, the dilation
# distances of the flagship bottleneck
FLAGSHIP_SCENE = dict(num_vertices=65536, levels=3, seed=0,
                      dilation_dists=(2, 4, 8, 16))


def _grid_dims(n: int):
    w = max(int(round(np.sqrt(n))), 2)
    h = max(-(-n // w), 2)
    return h, w


def surface_mesh_edges(n: int, rng=None) -> np.ndarray:
    """Triangulated-grid surface connectivity over n vertices (ids beyond
    the grid rectangle are clamped away): right/down/down-right diagonal
    links -> average degree ~6, exactly a triangle mesh's. Directed [2, E]
    with both directions."""
    h, w = _grid_dims(n)
    ids = np.arange(h * w).reshape(h, w)
    pairs = [
        (ids[:, :-1], ids[:, 1:]),       # right
        (ids[:-1, :], ids[1:, :]),       # down
        (ids[:-1, :-1], ids[1:, 1:]),    # down-right (triangulation)
    ]
    src = np.concatenate([a.ravel() for a, _ in pairs])
    dst = np.concatenate([b.ravel() for _, b in pairs])
    keep = (src < n) & (dst < n)
    src, dst = src[keep], dst[keep]
    return np.stack([np.concatenate([src, dst]),
                     np.concatenate([dst, src])])


def grid_ring_edges(n: int, dist: int, rng, samples: int = 4) -> np.ndarray:
    """Dilated edge set: links between vertices at grid Chebyshev distance
    ~dist (the tangent-plane dilation walk lands on such rings,
    preprocessing/dilation.py), `samples` per vertex."""
    h, w = _grid_dims(n)
    r = np.repeat(np.arange(h * w) // w, samples)
    c = np.repeat(np.arange(h * w) % w, samples)
    ang = rng.uniform(0, 2 * np.pi, size=r.shape)
    rr = np.clip(r + np.round(dist * np.sin(ang)).astype(np.int64), 0, h - 1)
    cc = np.clip(c + np.round(dist * np.cos(ang)).astype(np.int64), 0, w - 1)
    src = r * w + c
    dst = rr * w + cc
    keep = (src < n) & (dst < n) & (src != dst)
    src, dst = src[keep], dst[keep]
    return np.stack([np.concatenate([src, dst]),
                     np.concatenate([dst, src])])


def grid_block_trace(n_fine: int, n_coarse: int) -> np.ndarray:
    """Local (block) fine -> coarse map over the two grids — surjective as
    long as the coarse grid is no larger than the fine one, like the QEM
    collapse traces."""
    hf, wf = _grid_dims(n_fine)
    hc, wc = _grid_dims(n_coarse)
    r = np.arange(n_fine) // wf
    c = np.arange(n_fine) % wf
    rc = np.minimum(r * hc // hf, hc - 1)
    cc = np.minimum(c * wc // wf, wc - 1)
    t = np.minimum(rc * wc + cc, n_coarse - 1).astype(np.int64)
    # Coarse cells with an empty preimage (their block falls entirely in
    # the missing tail of the partial last fine row) get patched with the
    # geometrically nearest fine vertex WHOSE CURRENT TARGET KEEPS >= 2
    # preimages — reassigning a sole preimage would just move the hole
    # (n_fine >= n_coarse guarantees such a donor exists while any cell
    # is missing). Keeps the map surjective AND local.
    counts = np.bincount(t, minlength=n_coarse)
    for m in np.nonzero(counts == 0)[0]:
        mr, mc = m // wc, m % wc
        # fine-grid coordinates of the missing cell's center
        fr = (mr * hf + hf // 2) / hc
        fc = (mc * wf + wf // 2) / wc
        d2 = (r - fr) ** 2 + (c - fc) ** 2
        for f in np.argsort(d2):
            if counts[t[f]] >= 2:
                counts[t[f]] -= 1
                t[f] = m
                counts[m] = 1
                break
    return t


def synthetic_scene(num_vertices: int = 65536, levels: int = 3,
                    decimation: float = 0.3, input_nc: int = 10,
                    dilation_dists: Sequence[int] = (2, 4, 8, 16),
                    masked_frac: float = 0.25, seed: int = 0,
                    name: str = "synthetic") -> RawHierarchy:
    rng = np.random.default_rng(seed)
    nv = [num_vertices]
    for _ in range(levels - 1):
        nv.append(max(int(nv[-1] * decimation), 8))

    edges = [surface_mesh_edges(v, rng) for v in nv]
    traces = [grid_block_trace(nv[l], nv[l + 1]) for l in range(levels - 1)]
    dilated = {levels - 1: {
        int(d): grid_ring_edges(nv[-1], int(d), rng, samples=3)
        for d in dilation_dists}}

    # shuffle ids at every level: downstream must not rely on construction
    # order (bandwidth ordering is reorder_bandwidth's job, as for real data)
    perms = [rng.permutation(v) for v in nv]       # perm[new] = old? no:
    invs = [np.argsort(p) for p in perms]          # invs[old] = new
    edges = [invs[l][e] for l, e in enumerate(edges)]
    traces = [invs[l + 1][traces[l][perms[l]]] for l in range(levels - 1)]
    dilated = {l: {d: invs[l][e] for d, e in dists.items()}
               for l, dists in dilated.items()}

    pos = rng.normal(size=(nv[0], 3)).astype(np.float32)
    color = rng.uniform(-1, 1, size=(nv[0], 3)).astype(np.float32)
    normals = rng.normal(size=(nv[0], 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    mask = np.zeros((nv[0], 1), np.float32)
    n_masked = int(nv[0] * masked_frac)
    mask[rng.choice(nv[0], n_masked, replace=False), 0] = rng.integers(
        1, 16, size=n_masked)
    mask_bool = (mask == 0).astype(np.float32)

    if input_nc == 10:
        x = np.concatenate([color * mask_bool, normals, pos, mask_bool], -1)
    else:
        x = rng.normal(size=(nv[0], input_nc)).astype(np.float32)

    return RawHierarchy(
        x=x.astype(np.float32), color=color, mask=mask,
        num_vertices=nv, level_edges=edges, traces=traces,
        dilated=dilated, name=name)
