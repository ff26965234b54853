"""Host-side (numpy) construction of padded `HierarchicalGraph`s.

A numpy-only copy of `stinet_tpu/graph/build.py` (the RCM reorder takes
scipy's `reverse_cuthill_mckee`, not the JAX package's native one), which
the tests hold leaf for leaf against the JAX package's builder.
Graphs are batched by concatenation with vertex-offset shifts, then padded
up to bucket shapes; every edge set gets hybrid ELL(+COO spill) tables.
The result holds CPU tensors that share memory with the numpy arrays;
`HierarchicalGraph.to(device)` moves them.
"""
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from stinet_tpu_torch.graph.hierarchy import (
    EdgeSet, GraphLevel, HierarchicalGraph)


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
    or (None, None) when a cluster exceeds max_children."""
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
    (banded to `window_halo` when given)."""
    src, dst = np.asarray(edges[0]), np.asarray(edges[1])
    if src.shape[0] > e_pad:
        raise ValueError(f"edge bucket too small: {src.shape[0]} > {e_pad}")
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
    """Reverse-Cuthill-McKee ordering of one level (scipy's
    `reverse_cuthill_mckee`): returns ``(order, inv)`` with
    ``order[new_id] = old_id`` and ``inv[old_id] = new_id``."""
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
        traces=new_traces, dilated=new_dilated)


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

    With `windowed`, samples are RCM-reordered (`reorder_bandwidth`) unless
    their ids are already banded (`_is_banded`), and each edge set's ELL
    tables are banded to a halo read from the band's `window_quantile`
    (out-of-band edges spill to COO), which the windowed kernels need.
    """
    if windowed:
        samples = [s if (s.banded or _is_banded(s, window_quantile))
                   else reorder_bandwidth(s) for s in samples]
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

    levels, traces, children = [], [], []
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
        base = _pad_edge_set(edges, e_pad, trash, v_pad,
                             cap_quantile=ell_cap_quantile, window_halo=halo)

        dil = {}
        for dist in sorted({d for s in samples for d in s.dilated.get(l, {})}):
            # a scene missing this distance contributes zero edges
            de = np.concatenate(
                [s.dilated.get(l, {}).get(
                    dist, np.zeros((2, 0), np.int64)) + offsets[l, g]
                 for g, s in enumerate(samples)], axis=1)
            de_pad = bucket_size(de.shape[1], pad_multiple, geometric)
            dhalo = (_auto_halo(de, v_pad, window_quantile) if windowed
                     else None)
            dil[int(dist)] = _pad_edge_set(de, de_pad, trash, v_pad,
                                           cap_quantile=ell_cap_quantile,
                                           window_halo=dhalo)

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
