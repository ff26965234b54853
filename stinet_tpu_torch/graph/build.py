"""Host-side construction of padded `HierarchicalGraph`s.

A copy of `stinet_tpu/graph/build.py`, which the tests hold leaf for leaf
against the JAX package's builder. Graphs are batched by concatenation
with vertex-offset shifts, then padded up to bucket shapes; every edge set
gets hybrid ELL(+COO spill) tables.

The edge-set tables, the children tables and the RCM order of a windowed
build run in C++ (`graph/native`, the JAX package's `graph_builder.cpp`
through ctypes, with the interpreter lock released), dispatched as the JAX
package dispatches them. `STINET_NATIVE_BUILD=0` takes the numpy bodies
here instead (and scipy's RCM), which stay as the tests' oracle.
The result holds CPU tensors that share memory with the numpy arrays;
`HierarchicalGraph.to(device)` moves them.
"""
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from stinet_tpu_torch.graph import native as _native
from stinet_tpu_torch.graph.hierarchy import (
    EdgeSet, GraphLevel, HierarchicalGraph, map_tensors, tensor_leaves,
    tree_structure)
from stinet_tpu_torch.utils.profiling import span


def bucket_size(n: int, multiple: int = 128, geometric: bool = False,
                ratio: float = 1.25) -> int:
    """Round `n` up to a bucket shape: to the next `multiple`, or with
    `geometric` up a ladder of `ratio` steps."""
    n = max(int(n), 1)
    if geometric:
        b = multiple
        while b < n:
            b = int(np.ceil(b * ratio / multiple) * multiple)
        return b
    return int(-(-n // multiple) * multiple)


@dataclasses.dataclass
class RawHierarchy:
    """Ragged, host-side (numpy) view of one multi-level graph sample.

    level_edges[l]: [2, E_l] int (row 0 = src/sender, row 1 = dst/receiver),
    traces[l]: [V_l] -> level l+1 vertex ids (l = 0..L-2),
    dilated[l]: {dist: [2, E]} extra edge sets (usually only coarsest level).
    """
    x: np.ndarray
    color: np.ndarray
    mask: np.ndarray
    num_vertices: List[int]
    level_edges: List[np.ndarray]
    traces: List[np.ndarray]
    dilated: Dict[int, Dict[int, np.ndarray]] = dataclasses.field(
        default_factory=dict)
    labels: Optional[np.ndarray] = None
    name: str = ""
    banded: bool = False


ELL_MAX_DEGREE = 64


def _stable_argsort_int(keys: np.ndarray) -> np.ndarray:
    """Stable argsort for non-negative int keys: (key, position) encoded in
    one int64 so the default sort is stable by construction."""
    n = keys.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    comp = keys.astype(np.int64) * n + np.arange(n, dtype=np.int64)
    return np.argsort(comp)


def _build_ell(src, dst, e, v_pad, trash, max_deg=ELL_MAX_DEGREE,
               cap_quantile=0.97, max_spill_frac=0.25, window_halo=None):
    """Hybrid ELL(+spill) tables from the (dst-sorted) valid edges.

    The slot axis is capped near the `cap_quantile` in-degree: receivers
    with more edges keep their first D_cap edges in ELL and spill the rest
    to a COO list. With `window_halo`, edges with |src - dst| > window_halo
    spill too, so the tables are banded and the windowed kernels apply
    (ops/windowed.py). Returns a dict with nbr / rev_dst / out_degree /
    ell_degree / spill, or None when a mostly-empty table would lose to
    pure COO."""
    vs, vd = src[:e].astype(np.int64), dst[:e].astype(np.int64)
    if e == 0:
        return None
    win_ok = (np.abs(vs - vd) <= window_halo if window_halo is not None
              else np.ones(e, bool))
    deg = np.bincount(vd[win_ok], minlength=v_pad)
    d_in = int(deg.max()) if win_ok.any() else 0
    if d_in == 0:
        return None
    nz = deg[deg > 0]
    d_cap = max(int(np.quantile(nz, cap_quantile)), 4)
    d_cap = min(d_cap, d_in, max_deg)
    spill_count = (int(np.maximum(deg - d_cap, 0).sum())
                   + int((~win_ok).sum()))
    if (d_cap >= d_in or spill_count > max_spill_frac * e) \
            and window_halo is None:
        # spilling at the quantile cap is unnecessary or unprofitable:
        # widen to the full degree where it fits under max_deg, and give up
        # on ELL when even a max-width table leaves too much in COO
        d_cap = min(d_in, max_deg)
        if d_cap < d_in:
            spill_at_cap = int(np.maximum(deg - d_cap, 0).sum())
            if spill_at_cap > max_spill_frac * e:
                return None

    # slot = position within the receiver's (dst-sorted) run of in-window
    # edges: csum_ok[i] counts in-window edges before i
    csum_ok = np.cumsum(win_ok) - win_ok
    run_start_ok = np.zeros(v_pad, np.int64)
    first = np.flatnonzero(np.diff(vd, prepend=vd[0] - 1))
    uniq = vd[first]
    run_start_ok[uniq] = csum_ok[first]
    slot = np.where(win_ok, csum_ok - run_start_ok[vd], d_cap)
    keep = win_ok & (slot < d_cap)

    # sender-side cap: edges past a sender's first max_deg kept slots spill
    # too, and receiver slots re-pack so valid slots stay contiguous
    kidx = np.flatnonzero(keep)
    if len(kidx):
        kvs_k = vs[kidx]
        order_k = _stable_argsort_int(kvs_k)
        od_full = np.bincount(kvs_k, minlength=v_pad)
        indptr_k = np.zeros(v_pad + 1, np.int64)
        np.cumsum(od_full, out=indptr_k[1:])
        rank = np.arange(len(kvs_k)) - indptr_k[kvs_k[order_k]]
        overflow = order_k[rank >= max_deg]
        if len(overflow):
            keep[kidx[overflow]] = False
            csum_k = np.cumsum(keep) - keep
            run_start_k = np.zeros(v_pad, np.int64)
            run_start_k[uniq] = csum_k[first]
            slot = np.where(keep, csum_k - run_start_k[vd], d_cap)

    nbr = np.full((v_pad, d_cap), trash, np.int32)
    nbr[vd[keep], slot[keep]] = vs[keep]
    ell_deg = np.bincount(vd[keep], minlength=v_pad)

    kvs, kvd = vs[keep], vd[keep]
    out_deg = np.bincount(kvs, minlength=v_pad)
    d_out = int(out_deg.max()) if len(kvs) else 1
    order = _stable_argsort_int(kvs)
    indptr_o = np.zeros(v_pad + 1, np.int64)
    np.cumsum(out_deg, out=indptr_o[1:])
    slot_o = np.arange(len(kvs)) - indptr_o[kvs[order]]
    rev_dst = np.full((v_pad, max(d_out, 1)), trash, np.int32)
    rev_dst[kvs[order], slot_o] = kvd[order]

    spill = None
    n_sp = int((~keep).sum())
    if n_sp:
        s_pad = bucket_size(n_sp, 128)
        sp_src = np.full(s_pad, trash, np.int32)
        sp_dst = np.full(s_pad, trash, np.int32)
        sp_src[:n_sp] = vs[~keep]
        sp_dst[:n_sp] = vd[~keep]   # still sorted by dst
        spill = (sp_src, sp_dst)
    return {"nbr": nbr, "rev_dst": rev_dst,
            "out_degree": out_deg.astype(np.float32),
            "ell_degree": ell_deg.astype(np.float32), "spill": spill}


def _build_children(trace, num_valid_fine, coarse_pad, fine_trash,
                    max_children=128):
    """Children table (coarse vertex -> its valid fine vertices) for
    gather-only pooling. Returns (children [Vc, C] int32, counts [Vc] f32),
    or (None, None) when a cluster exceeds max_children. Native unless
    STINET_NATIVE_BUILD=0."""
    if num_valid_fine > 0 and _native.available():
        return _native.build_children_table(
            trace, num_valid_fine, coarse_pad, fine_trash, max_children)
    tv = trace[:num_valid_fine].astype(np.int64)
    counts = np.bincount(tv, minlength=coarse_pad)
    cmax = int(counts.max()) if num_valid_fine else 0
    if cmax == 0 or cmax > max_children:
        return None, None
    order = _stable_argsort_int(tv)
    indptr = np.zeros(coarse_pad + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    slot = np.arange(num_valid_fine) - indptr[tv[order]]
    children = np.full((coarse_pad, cmax), fine_trash, np.int32)
    children[tv[order], slot] = order.astype(np.int32)
    return children, counts.astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _pad_edge_set(edges: np.ndarray, e_pad: int, trash: int, v_pad: int,
                  ell_max_degree: int = ELL_MAX_DEGREE,
                  cap_quantile: float = 0.97,
                  window_halo: Optional[int] = None) -> EdgeSet:
    """Sort a [2, E] COO edge array by destination, pad it to e_pad with
    trash self-edges, and add the valid in-degree and the ELL tables
    (banded to `window_halo` when given). Native unless
    STINET_NATIVE_BUILD=0."""
    src, dst = np.asarray(edges[0]), np.asarray(edges[1])
    if src.shape[0] > e_pad:
        raise ValueError(f"edge bucket too small: {src.shape[0]} > {e_pad}")
    if src.shape[0] > 0 and _native.available():
        fields = _native.build_edge_set_tables(
            src, dst, e_pad, trash, v_pad, ell_max_degree, cap_quantile,
            max_spill_frac=0.25, window_halo=window_halo,
            bucket=bucket_size)
        e = int(fields.pop("num_edges"))
        return EdgeSet(num_edges=torch.tensor(e, dtype=torch.int32),
                       **{k: v if k == "halo" else _t(v)
                          for k, v in fields.items()})
    order = _stable_argsort_int(dst)
    src, dst = src[order], dst[order]
    e = src.shape[0]
    ell = _build_ell(src, dst, e, v_pad, trash, ell_max_degree,
                     cap_quantile=cap_quantile, window_halo=window_halo)
    pad = e_pad - e
    src = np.concatenate([src, np.full(pad, trash, dtype=np.int64)])
    dst = np.concatenate([dst, np.full(pad, trash, dtype=np.int64)])
    degree = np.bincount(edges[1], minlength=v_pad).astype(np.float32)
    kw = {}
    if ell is not None:
        spill = ell["spill"] or (None, None)
        kw = dict(nbr=_t(ell["nbr"]), rev_dst=_t(ell["rev_dst"]),
                  out_degree=_t(ell["out_degree"]),
                  ell_degree=_t(ell["ell_degree"]),
                  spill_src=_t(spill[0]), spill_dst=_t(spill[1]),
                  halo=window_halo)
    return EdgeSet(src=_t(src.astype(np.int32)), dst=_t(dst.astype(np.int32)),
                   num_edges=torch.tensor(e, dtype=torch.int32),
                   degree=_t(degree), **kw)


def rcm_perm(edges: np.ndarray, nv: int):
    """Reverse-Cuthill-McKee ordering of one level: returns ``(order,
    inv)`` with ``order[new_id] = old_id`` and ``inv[old_id] = new_id``.
    The native RCM, or scipy's `reverse_cuthill_mckee` under
    STINET_NATIVE_BUILD=0: the two may break ties another way, and either
    is a pure relabelling."""
    if _native.available():
        order = _native.rcm_order(edges, nv).astype(np.int64)
    else:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        ones = np.ones(edges.shape[1], np.int8)
        adj = csr_matrix((ones, (edges[0], edges[1])), shape=(nv, nv))
        order = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=False),
                           np.int64)
    inv = np.empty(nv, np.int64)
    inv[order] = np.arange(nv)
    return order, inv


def reorder_bandwidth(sample: RawHierarchy) -> RawHierarchy:
    """Relabel every level's vertices by reverse-Cuthill-McKee so edges
    become banded (|src - dst| small), which the windowed kernels need.
    The graph, features, traces and dilated edge sets are only relabelled;
    `_auto_halo` reads the band from whatever ordering was achieved."""
    return _reorder_bandwidth(sample)[0]


def _reorder_bandwidth(sample: RawHierarchy):
    """(`reorder_bandwidth(sample)`, its level-0 order: order[new] = old)."""
    perms, newids = [], []   # perms[l][new] = old; newids[l][old] = new
    for l, nv in enumerate(sample.num_vertices):
        order, inv = rcm_perm(sample.level_edges[l], nv)
        perms.append(order)
        newids.append(inv)

    def remap_edges(e, l):
        return newids[l][np.asarray(e, np.int64)]

    new_traces = [newids[l + 1][sample.traces[l].astype(np.int64)][perms[l]]
                  for l in range(len(sample.traces))]
    new_dilated = {l: {d: remap_edges(e, l) for d, e in dists.items()}
                   for l, dists in sample.dilated.items()}
    p0 = perms[0]
    return dataclasses.replace(
        sample, x=sample.x[p0], color=sample.color[p0], mask=sample.mask[p0],
        labels=sample.labels[p0] if sample.labels is not None else None,
        level_edges=[remap_edges(e, l)
                     for l, e in enumerate(sample.level_edges)],
        traces=new_traces, dilated=new_dilated), p0


def windowed_layout(sample: RawHierarchy, quantile: float = 0.999):
    """(sample, order): `sample` in the vertex order a windowed build gives
    it, marked `banded` so a build keeps that order, and its level-0 order
    (order[new_id] = old_id), None where the ids are kept (`_is_banded`)."""
    if sample.banded or _is_banded(sample, quantile):
        return dataclasses.replace(sample, banded=True), None
    out, order = _reorder_bandwidth(sample)
    return dataclasses.replace(out, banded=True), order


# a scene whose every level already ladders to a halo at or below this (the
# windowed dispatch caps, ops/message_passing.py) skips the reorder
_BANDED_SKIP_HALO = 384


def _is_banded(sample: RawHierarchy, quantile: float) -> bool:
    """True when every level's edge band already ladders to a halo small
    enough that reordering would not change the kernel dispatch. The band
    quantile runs on a strided subsample of at most ~32k edges."""
    for l in range(len(sample.num_vertices)):
        e = sample.level_edges[l]
        ne = e.shape[1]
        if ne == 0:
            continue
        step = max(ne // 32768, 1)
        band = np.abs(e[0, ::step].astype(np.int64)
                      - e[1, ::step].astype(np.int64))
        if max(int(np.quantile(band, quantile)), 1) > _BANDED_SKIP_HALO:
            return False
    return True


# Halos are rounded up onto this ladder, so the set of window shapes stays
# bounded over arbitrary scenes; the dispatch caps (384) are rungs of it
_HALO_LADDER = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048)


def _auto_halo(edges: np.ndarray, v_pad: int, quantile: float,
               tile: int = 256, max_window_frac: float = 0.75):
    """The window halo from the achieved band distribution (a strided
    subsample of at most ~64k edges), rounded up onto _HALO_LADDER; None
    when the band exceeds the ladder or the window would cover most of the
    graph."""
    ne = edges.shape[1]
    if ne == 0:
        return None
    step = max(ne // 65536, 1)
    band = np.abs(edges[0, ::step].astype(np.int64)
                  - edges[1, ::step].astype(np.int64))
    need = max(int(np.quantile(band, quantile)), 1)
    halo = next((h for h in _HALO_LADDER if h >= need), None)
    if halo is None or tile + 2 * halo > max_window_frac * v_pad:
        return None
    return halo


def _concat_features(arrs, pad_rows, pad_value=0):
    a = np.concatenate(arrs, axis=0)
    if pad_rows > 0:
        pad_shape = (pad_rows,) + a.shape[1:]
        a = np.concatenate(
            [a, np.full(pad_shape, pad_value, dtype=a.dtype)], axis=0)
    return a


def build_hierarchical_graph(
        samples: Sequence[RawHierarchy],
        v_buckets: Optional[Sequence[int]] = None,
        e_buckets: Optional[Sequence[int]] = None,
        pad_multiple: int = 128,
        geometric: bool = False,
        ell_cap_quantile: float = 0.97,
        windowed: bool = False,
        window_quantile: float = 0.999) -> HierarchicalGraph:
    """Batch and pad raw hierarchies into one static-shape graph.

    Vertex ids of sample g at level l are shifted by the vertex count of
    samples 0..g-1 at that level. Buckets default to the batched totals plus
    one trash row, rounded up to `pad_multiple` (geometrically with
    `geometric`).

    With `windowed`, samples are RCM-reordered (`windowed_layout`) unless
    their ids are already banded (`_is_banded`), and each edge set's ELL
    tables are banded to a halo read from the band's `window_quantile`
    (out-of-band edges spill to COO), which the windowed kernels need.

    The edge sets' tables build on a thread pool of `STINET_BUILD_WORKERS`
    threads (the JAX package's switch; default one an edge set, at most
    the CPU count), since the native builder releases the interpreter
    lock; 1 builds them in turn.
    """
    names = [s.name for s in samples]
    if windowed:
        with span("build.order", names):
            samples = [windowed_layout(s, window_quantile)[0]
                       for s in samples]
    num_levels = len(samples[0].num_vertices)
    num_graphs = len(samples)

    counts = np.array([[s.num_vertices[l] for s in samples]
                       for l in range(num_levels)])  # [L, G]
    offsets = np.concatenate(
        [np.zeros((num_levels, 1), dtype=np.int64),
         np.cumsum(counts, axis=1)], axis=1)  # [L, G+1]
    totals = offsets[:, -1]

    if v_buckets is None:
        v_buckets = [bucket_size(int(t) + 1, pad_multiple, geometric)
                     for t in totals]

    # stage 1: every edge set's task, keyed (level, dist), dist None for
    # the level's base set
    tasks = {}
    for l in range(num_levels):
        v_pad = int(v_buckets[l])
        if v_pad <= totals[l]:
            raise ValueError(f"vertex bucket {v_pad} must exceed the valid "
                             f"count {int(totals[l])} at level {l}")
        trash = v_pad - 1
        edges = np.concatenate(
            [s.level_edges[l] + offsets[l, g]
             for g, s in enumerate(samples)], axis=1)
        e_pad = (int(e_buckets[l]) if e_buckets is not None
                 else bucket_size(edges.shape[1], pad_multiple, geometric))
        halo = (_auto_halo(edges, v_pad, window_quantile) if windowed
                else None)
        tasks[(l, None)] = (edges, e_pad, trash, v_pad, halo)
        for dist in sorted({d for s in samples for d in s.dilated.get(l, {})}):
            # a scene missing this distance contributes zero edges
            de = np.concatenate(
                [s.dilated.get(l, {}).get(
                    dist, np.zeros((2, 0), np.int64)) + offsets[l, g]
                 for g, s in enumerate(samples)], axis=1)
            de_pad = bucket_size(de.shape[1], pad_multiple, geometric)
            dhalo = (_auto_halo(de, v_pad, window_quantile) if windowed
                     else None)
            tasks[(l, int(dist))] = (de, de_pad, trash, v_pad, dhalo)

    # stage 2: the tables, on a thread pool (the native builder releases
    # the interpreter lock); a task reads only its own arrays, so thread
    # timing changes no result
    def run(task):
        edges, e_pad, trash, v_pad, halo = task
        with span("build.edge_set", names, parent="build.tables"):
            return _pad_edge_set(edges, e_pad, trash, v_pad,
                                 cap_quantile=ell_cap_quantile,
                                 window_halo=halo)

    workers = os.environ.get("STINET_BUILD_WORKERS")
    workers = (int(workers) if workers
               else min(len(tasks), os.cpu_count() or 4))
    with span("build.tables", names):
        if workers <= 1 or len(tasks) <= 1:
            built = {k: run(t) for k, t in tasks.items()}
        else:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                futures = {k: pool.submit(run, t) for k, t in tasks.items()}
                built = {k: f.result() for k, f in futures.items()}

    # stage 3: the levels, traces and children tables, and the features
    with span("build.levels", names):
        levels, traces, children = [], [], []
        for l in range(num_levels):
            v_pad = int(v_buckets[l])
            base = built[(l, None)]
            dil = {d: es for (ll, d), es in built.items()
                   if ll == l and d is not None}

            graph_id = np.full(v_pad, num_graphs, dtype=np.int32)
            for g in range(num_graphs):
                graph_id[offsets[l, g]:offsets[l, g + 1]] = g
            levels.append(GraphLevel(
                edges=base, num_vertices=torch.tensor(int(totals[l]),
                                                      dtype=torch.int32),
                graph_id=_t(graph_id), dilated=dil))

            if l < num_levels - 1:
                coarse_pad = int(v_buckets[l + 1])
                tr = np.full(v_pad, coarse_pad - 1, dtype=np.int32)
                for g, s in enumerate(samples):
                    tr[offsets[l, g]:offsets[l, g + 1]] = (
                        s.traces[l].astype(np.int64) + offsets[l + 1, g])
                traces.append(_t(tr))
                children.append(_build_children(
                    tr, int(totals[l]), coarse_pad, v_pad - 1))

        pad0 = int(v_buckets[0]) - int(totals[0])
        x = _concat_features([s.x for s in samples], pad0)
        color = _concat_features([s.color for s in samples], pad0)
        mask = _concat_features([s.mask for s in samples], pad0)
        labels = None
        if samples[0].labels is not None:
            labels = _concat_features(
                [s.labels for s in samples], pad0).astype(np.int32)

        return HierarchicalGraph(
            x=_t(x.astype(np.float32)), color=_t(color.astype(np.float32)),
            mask=_t(mask.astype(np.float32)), levels=tuple(levels),
            traces=tuple(traces), num_graphs=num_graphs, labels=_t(labels),
            children=tuple(_t(c[0]) for c in children),
            child_counts=tuple(_t(c[1]) for c in children))


# ---------------------------------------------------------------------------
# The grid-graph hierarchy of the 2D image-inpainting workload: 4-connected
# grid edges per level and 2x2 nearest-upsample traces with decimation 2
# (the reference's fake hierarchy, imagegraph_dataloader.py:44-108), built
# vectorized. numpy only.
# ---------------------------------------------------------------------------

def grid_edges(n: int) -> np.ndarray:
    """Directed 4-neighborhood edges of an n x n grid, [2, E] (both
    directions present, no self loops)."""
    idx = np.arange(n * n).reshape(n, n)
    h = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()])   # left->right
    v = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()])   # up->down
    und = np.concatenate([h, v], axis=1)
    return np.concatenate([und, und[::-1]], axis=1)


def grid_trace(coarse_n: int, decimation: int = 2) -> np.ndarray:
    """Fine vertex -> coarse vertex map by 2x2 block replication."""
    tr = np.arange(coarse_n * coarse_n).reshape(coarse_n, coarse_n)
    tr = np.repeat(np.repeat(tr, decimation, axis=1), decimation, axis=0)
    return tr.reshape(-1).astype(np.int64)


_GRID_CACHE: Dict[tuple, tuple] = {}


def grid_hierarchy(img_size: int, end_level: int, decimation: int = 2):
    """(num_vertices, level_edges, traces) for an image-as-graph hierarchy,
    cached per (img_size, end_level)."""
    key = (img_size, end_level)
    if key not in _GRID_CACHE:
        sizes = [img_size // (decimation ** l) for l in range(end_level)]
        nv = [s * s for s in sizes]
        edges = [grid_edges(s) for s in sizes]
        trs = [grid_trace(sizes[l + 1], decimation)
               for l in range(end_level - 1)]
        _GRID_CACHE[key] = (nv, edges, trs)
    return _GRID_CACHE[key]


# ---------------------------------------------------------------------------
# Stacked batching: each scene as its own single-scene padded graph, every
# tensor stacked to [B, ...], so a forward runs scene by scene over tables
# that never mix scenes. The vertex and edge buckets are forced to common
# values; the data-dependent table dims (ELL slot width, reverse width,
# spill length, children width, windowed halos) are padded up to explicit
# `widths` so every scene of a batch has one layout. Padding is trash-filled
# and masked everywhere, so it changes no valid row.
# ---------------------------------------------------------------------------

def table_widths(graph: HierarchicalGraph) -> Dict[tuple, int]:
    """Data-dependent table dims of a built graph, keyed by
    (level, dist, field) with dist None for the base edge set; windowed
    halos ride along as (level, dist, "halo"). Merge dicts across graphs
    with `merge_widths` and apply them with `pad_tables_to_widths`."""
    out = {}

    def es_widths(es, li, dk):
        out[(li, dk, "edges")] = int(es.src.shape[0])
        if es.nbr is not None:
            out[(li, dk, "nbr")] = int(es.nbr.shape[1])
            out[(li, dk, "rev_dst")] = int(es.rev_dst.shape[1])
            out[(li, dk, "spill")] = (0 if es.spill_src is None
                                      else int(es.spill_src.shape[0]))
            if es.halo is not None:
                out[(li, dk, "halo")] = int(es.halo)

    for li, lev in enumerate(graph.levels):
        es_widths(lev.edges, li, None)
        for d, es in lev.dilated.items():
            es_widths(es, li, int(d))
    for l, ch in enumerate(graph.children):
        if ch is not None:
            out[(l, None, "children")] = int(ch.shape[1])
    return out


def merge_widths(dicts) -> Dict[tuple, int]:
    """Key-union maximum. A graph missing a key another has (an ELL table
    that fell back to COO, a missing dilation distance) still cannot share
    a stacked layout: `stack_graphs` raises on it."""
    merged = {}
    for d in dicts:
        for k, v in d.items():
            merged[k] = max(merged.get(k, 0), int(v))
    return merged


def _pad_cols(a: torch.Tensor, width: int, fill: int) -> torch.Tensor:
    """a ([N] or [N, K]) padded with `fill` to `width` along its last axis."""
    shape = a.shape[:-1] + (width - a.shape[-1],)
    return torch.cat([a, torch.full(shape, fill, dtype=a.dtype)], dim=-1)


def pad_tables_to_widths(graph: HierarchicalGraph,
                         widths: Dict[tuple, int]) -> HierarchicalGraph:
    """Pad every data-dependent table dim up to `widths` with trash entries.
    Widths below the built dims are ignored (padding only grows)."""
    def pad_es(es, li, dk, trash):
        upd = {}
        w = widths.get((li, dk, "edges"), 0)
        if w > es.src.shape[0]:
            # trash self-edges at the tail keep the list sorted by dst
            # (trash is the largest vertex id)
            upd["src"] = _pad_cols(es.src, w, trash)
            upd["dst"] = _pad_cols(es.dst, w, trash)
        if es.nbr is not None:
            for f in ("nbr", "rev_dst"):
                w = widths.get((li, dk, f), 0)
                if w > getattr(es, f).shape[1]:
                    upd[f] = _pad_cols(getattr(es, f), w, trash)
            cur = 0 if es.spill_src is None else int(es.spill_src.shape[0])
            w = widths.get((li, dk, "spill"), 0)
            if w > cur:
                for f in ("spill_src", "spill_dst"):
                    base = getattr(es, f)
                    if base is None:
                        base = torch.zeros(0, dtype=torch.int32)
                    upd[f] = _pad_cols(base, w, trash)
            h = widths.get((li, dk, "halo"))
            if h is not None and es.halo is not None and h > es.halo:
                # a larger halo is still a bound of the band
                upd["halo"] = h
        return dataclasses.replace(es, **upd) if upd else es

    levels = []
    for li, lev in enumerate(graph.levels):
        trash = lev.num_padded_vertices - 1
        levels.append(dataclasses.replace(
            lev, edges=pad_es(lev.edges, li, None, trash),
            dilated={d: pad_es(es, li, int(d), trash)
                     for d, es in lev.dilated.items()}))
    children = []
    for l, ch in enumerate(graph.children):
        w = widths.get((l, None, "children"), 0)
        if ch is not None and w > ch.shape[1]:
            ch = _pad_cols(ch, w, graph.levels[l].num_padded_vertices - 1)
        children.append(ch)
    return dataclasses.replace(graph, levels=tuple(levels),
                               children=tuple(children))


def stack_graphs(graphs: Sequence[HierarchicalGraph]) -> HierarchicalGraph:
    """Stack single-scene graphs of one layout to [B, ...] tensors. Raises
    ValueError when their structures (`tree_structure`: halos, ELL or COO,
    dilation sets) or any tensor's shape differ; pad them with
    `pad_tables_to_widths` at merged widths first."""
    ref = tree_structure(graphs[0])
    for g in graphs[1:]:
        if tree_structure(g) != ref:
            raise ValueError(
                "scenes produce different graph structures (static halo or "
                "ELL/COO layout mismatch); cannot stack")
    columns = list(zip(*(tensor_leaves(g) for g in graphs)))
    for col in columns:
        if len({tuple(t.shape) for t in col}) > 1:
            raise ValueError(
                f"scenes land on different table shapes "
                f"({[tuple(t.shape) for t in col]}); force common v_buckets "
                "and pad_tables_to_widths first")
    stacked = iter([torch.stack(col) for col in columns])
    return map_tensors(graphs[0], lambda _: next(stacked))


def build_stacked_graph(samples: Sequence[RawHierarchy],
                        v_buckets: Optional[Sequence[int]] = None,
                        widths: Optional[Dict[tuple, int]] = None,
                        pad_multiple: int = 128,
                        geometric: bool = False,
                        ell_cap_quantile: float = 0.97,
                        windowed: bool = False,
                        window_quantile: float = 0.999):
    """Build each sample as a single-scene graph at common vertex buckets,
    pad the data-dependent table dims to one layout and stack. Returns
    (stacked graph, widths used). Pass `widths` to pin the layout (a
    scene that needs more raises ValueError); otherwise the batch maxima
    are used. The scenes build on a thread pool of `STINET_BUILD_WORKERS`
    threads (default: one a scene, at most the CPU count; the native
    builder releases the interpreter lock), in sequence when that is 1 or
    there is one scene."""
    num_levels = len(samples[0].num_vertices)
    if v_buckets is None:
        v_buckets = [
            max(bucket_size(int(s.num_vertices[l]) + 1, pad_multiple,
                            geometric) for s in samples)
            for l in range(num_levels)]

    # the union of dilation distances per level: a sample whose dilated set
    # for some distance is empty must still build that (empty) edge set, or
    # the scenes' structures differ
    union_dists = {l: {int(d) for s in samples for d in s.dilated.get(l, {})}
                   for l in range(num_levels)}
    if widths is not None:
        for (li, dk, _f) in widths:
            if dk is not None:
                union_dists.setdefault(li, set()).add(int(dk))
    if any(union_dists.values()):
        fixed = []
        for s in samples:
            dil = {l: dict(s.dilated.get(l, {})) for l in s.dilated}
            changed = False
            for l, dists in union_dists.items():
                for d in dists:
                    if d not in dil.setdefault(l, {}):
                        dil[l][d] = np.zeros((2, 0), np.int64)
                        changed = True
            fixed.append(dataclasses.replace(s, dilated=dil)
                         if changed else s)
        samples = fixed

    def one(s):
        return build_hierarchical_graph(
            [s], v_buckets=v_buckets, pad_multiple=pad_multiple,
            geometric=geometric, ell_cap_quantile=ell_cap_quantile,
            windowed=windowed, window_quantile=window_quantile)

    workers = os.environ.get("STINET_BUILD_WORKERS")
    workers = (int(workers) if workers
               else min(len(samples), os.cpu_count() or 4))
    if workers <= 1 or len(samples) <= 1:
        graphs = [one(s) for s in samples]
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            graphs = list(pool.map(one, samples))
    return pad_and_stack(graphs, widths)


def pad_and_stack(graphs: Sequence[HierarchicalGraph],
                  widths: Optional[Dict[tuple, int]] = None):
    """Pad built single-scene graphs to one layout and stack them: every
    table width to the batch maximum (`merge_widths`, windowed halos
    included), or to `widths`, which pins the layout (a graph that needs
    more raises ValueError). Returns (stacked graph, widths used)."""
    batch_w = merge_widths([table_widths(g) for g in graphs])
    if widths is not None:
        over = {k: (batch_w[k], widths.get(k, 0)) for k in batch_w
                if batch_w[k] > widths.get(k, 0)}
        if over:
            raise ValueError(
                f"scene exceeds the pinned stacked layout "
                f"{{key: (built, pinned)}} = {over}; pin wider widths")
        batch_w = dict(widths)
    graphs = [pad_tables_to_widths(g, batch_w) for g in graphs]
    return stack_graphs(graphs), batch_w


def freeze_stacked_signature(samples: Sequence[RawHierarchy],
                             pad_multiple: int = 128,
                             geometric: bool = False,
                             windowed: bool = False,
                             margin: float = 1.25):
    """One stacked layout for a whole run, (v_buckets, widths), from
    representative samples (stinet_tpu/graph/build.py:770-800): each
    level's vertex bucket from the largest sample's count times `margin`,
    the samples built at those buckets, and their table widths times
    `margin` (ELL, reverse and children widths rounded up; edge and spill
    lengths to multiples of 128; halos as built). A later scene that needs
    more raises ValueError in `build_stacked_graph`."""
    num_levels = len(samples[0].num_vertices)
    v_buckets = [
        bucket_size(
            int(max(s.num_vertices[l] for s in samples) * margin) + 1,
            pad_multiple, geometric)
        for l in range(num_levels)]
    _, widths = build_stacked_graph(
        samples, v_buckets=v_buckets, pad_multiple=pad_multiple,
        geometric=geometric, windowed=windowed)
    out = {}
    for k, w in widths.items():
        if k[2] == "halo":
            out[k] = w
        elif k[2] in ("nbr", "rev_dst", "children"):
            out[k] = int(np.ceil(w * margin))
        else:
            out[k] = bucket_size(int(w * margin), 128)
    return v_buckets, out
