"""Rooms as the port's preprocessing CLI writes them, made from a seed.

Frozen copy of `stinet_tpu_torch/utils/synthetic.py` (`synthetic_scene`,
`write_loader_scene`, and the grid helpers they call), kept here so that a
later change to the program cannot change the benchmark's traffic. It is
extended to the CLI's defaults (`preprocessing/cli.py graphs
--level-params 100 30 30 --dilations 2 4 6 8 16`): three levels at a
decimation of 0.3 a level, dilated edge sets at every level (or only at
the levels a mix names, as `--dilation-levels` does), vertex ids in no
order, a quarter of the vertices masked, and files written the way the
CLI writes them (`np.savez_compressed`, int64 edges and traces).

Nothing here imports the program or torch: the reference reads a `Room`
as it is, and the traffic drivers turn it into the program's input.

A room's geometry (edges, traces, dilated sets, positions, normals) comes
from (seed, room index); the colours and the mask of each submission of a
room come from (seed, submission index), so every submission is fresh.
"""
import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

CLI_DILATIONS = (2, 4, 6, 8, 16)


@dataclasses.dataclass
class Room:
    """One room's hierarchy in the scene's own (shuffled) vertex order.

    edges[l]: [2, E] int64 (row 0 sender, row 1 receiver); traces[l]:
    [V_l] ids of level l+1; dilated[l]: {dist: [2, E]}; pos, normals:
    [V_0, 3] float32."""
    num_vertices: List[int]
    edges: List[np.ndarray]
    traces: List[np.ndarray]
    dilated: Dict[int, Dict[int, np.ndarray]]
    pos: np.ndarray
    normals: np.ndarray


@dataclasses.dataclass
class Submission:
    """What one request carries besides the room: colours in [-1, 1], the
    mask (0 = kept; 1..15 = masked, its distance class) and the
    10-channel input [colour * kept | normals | positions | kept]."""
    color: np.ndarray
    mask: np.ndarray
    x: np.ndarray


def room_sizes(count: int, low: int, high: int) -> List[int]:
    """`count` fixed quantiles, (k + 0.5) / count, of a log-uniform law
    between `low` and `high` vertices, smallest first."""
    a, b = math.log(low), math.log(high)
    return [int(round(math.exp(a + (k + 0.5) / count * (b - a))))
            for k in range(count)]


def _grid_dims(n: int):
    w = max(int(round(np.sqrt(n))), 2)
    h = max(-(-n // w), 2)
    return h, w


def surface_mesh_edges(n: int) -> np.ndarray:
    """Triangulated-grid surface over n vertices: right, down and
    down-right links, both directions (average degree about 6)."""
    h, w = _grid_dims(n)
    ids = np.arange(h * w).reshape(h, w)
    pairs = [(ids[:, :-1], ids[:, 1:]), (ids[:-1, :], ids[1:, :]),
             (ids[:-1, :-1], ids[1:, 1:])]
    src = np.concatenate([a.ravel() for a, _ in pairs])
    dst = np.concatenate([b.ravel() for _, b in pairs])
    keep = (src < n) & (dst < n)
    src, dst = src[keep], dst[keep]
    return np.stack([np.concatenate([src, dst]),
                     np.concatenate([dst, src])])


def grid_ring_edges(n: int, dist: int, rng, samples: int = 3) -> np.ndarray:
    """A dilated edge set: links between vertices at grid Chebyshev
    distance about `dist`, `samples` a vertex, both directions."""
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
    """Local fine -> coarse map over the two grids, made surjective: a
    coarse cell with no preimage takes the nearest fine vertex whose target
    keeps two or more."""
    hf, wf = _grid_dims(n_fine)
    hc, wc = _grid_dims(n_coarse)
    r = np.arange(n_fine) // wf
    c = np.arange(n_fine) % wf
    rc = np.minimum(r * hc // hf, hc - 1)
    cc = np.minimum(c * wc // wf, wc - 1)
    t = np.minimum(rc * wc + cc, n_coarse - 1).astype(np.int64)
    counts = np.bincount(t, minlength=n_coarse)
    for m in np.nonzero(counts == 0)[0]:
        mr, mc = m // wc, m % wc
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


def make_room(num_vertices: int, seed: int, index: int, levels: int = 3,
              decimation: float = 0.3,
              dilation_dists: Sequence[int] = CLI_DILATIONS,
              dilation_levels: Optional[Sequence[int]] = None) -> Room:
    """Room `index` of the traffic drawn from `seed`. `dilation_levels`
    None puts the dilated sets at every level, as the CLI's default."""
    rng = np.random.default_rng((seed, 0, index))
    nv = [int(num_vertices)]
    for _ in range(levels - 1):
        nv.append(max(int(nv[-1] * decimation), 8))
    edges = [surface_mesh_edges(v) for v in nv]
    traces = [grid_block_trace(nv[l], nv[l + 1]) for l in range(levels - 1)]
    at = range(levels) if dilation_levels is None else dilation_levels
    dilated = {l: {int(d): grid_ring_edges(nv[l], int(d), rng)
                   for d in dilation_dists} for l in at}
    # ids in no order at every level, as a mesh's own are
    perms = [rng.permutation(v) for v in nv]
    invs = [np.argsort(p) for p in perms]
    edges = [invs[l][e] for l, e in enumerate(edges)]
    traces = [invs[l + 1][traces[l][perms[l]]] for l in range(levels - 1)]
    dilated = {l: {d: invs[l][e] for d, e in per.items()}
               for l, per in dilated.items()}
    pos = rng.normal(size=(nv[0], 3)).astype(np.float32)
    normals = rng.normal(size=(nv[0], 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return Room(num_vertices=nv, edges=edges, traces=traces, dilated=dilated,
                pos=pos, normals=normals)


def make_submission(room: Room, seed: int, index: int,
                    masked_frac: float = 0.25) -> Submission:
    """Fresh colours and a fresh mask for submission `index`: about
    `masked_frac` of the vertices masked, each with a class in 1..15."""
    rng = np.random.default_rng((seed, 1, index))
    n = room.num_vertices[0]
    color = rng.random((n, 3), dtype=np.float32) * 2.0 - 1.0
    # 15 classes in a draw of round(15 / masked_frac): the rest are kept
    r = rng.integers(0, int(round(15 / masked_frac)), size=n, dtype=np.int16)
    mask = np.where(r < 15, r + 1, 0).astype(np.float32)[:, None]
    kept = (mask == 0).astype(np.float32)
    x = np.concatenate([color * kept, room.normals, room.pos, kept], -1)
    return Submission(color=color, mask=mask, x=x)


def write_room(root: str, name: str, room: Room, sub: Submission,
               mask_name: str = "rad_16") -> None:
    """Write a room as the CLI does: `graphs/<name>.npz` (compressed) with
    vertices_l [V_l, 10] (positions, colours in [0, 1] and normals on
    level 0, the vertex's index in column 9), edges_l, traces_l (traces_0
    the identity), dil_<d>_edges_l, num_levels and dilation_dists; and
    one mask set `masks/<mask_name>/<name>/0.npz`."""
    levels = len(room.num_vertices)
    dists = sorted({int(d) for per in room.dilated.values() for d in per})
    arrays = {"num_levels": levels,
              "dilation_dists": np.asarray(dists, np.int64)}
    for l, v in enumerate(room.num_vertices):
        verts = np.zeros((v, 10), np.float32)
        if l == 0:
            verts[:, 0:3] = room.pos
            verts[:, 3:6] = (sub.color + 1.0) / 2.0
            verts[:, 6:9] = room.normals
        verts[:, 9] = np.arange(v)
        arrays[f"vertices_{l}"] = verts
        arrays[f"edges_{l}"] = room.edges[l].astype(np.int64)
        for d, e in room.dilated.get(l, {}).items():
            arrays[f"dil_{int(d)}_edges_{l}"] = e.astype(np.int64)
    arrays["traces_0"] = np.arange(room.num_vertices[0], dtype=np.int64)
    for l, t in enumerate(room.traces):
        arrays[f"traces_{l + 1}"] = t.astype(np.int64)
    os.makedirs(os.path.join(root, "graphs"), exist_ok=True)
    np.savez_compressed(os.path.join(root, "graphs", name + ".npz"),
                        **arrays)
    mask_dir = os.path.join(root, "masks", mask_name, name)
    os.makedirs(mask_dir, exist_ok=True)
    np.savez(os.path.join(mask_dir, "0.npz"),
             vertex_mask=sub.mask[:, 0].astype(np.float32))
