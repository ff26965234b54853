"""Partitioned hierarchy build: the data layout of graph-partition serving.

PyTorch counterpart of `stinet_tpu/graph/partition.py`, host code (numpy)
copied with the port's own builder helpers. It scales STINet to full
uncropped scenes split across a mesh of partitions (the reference's only
answer is offline 3 m cropping). What makes pooling and unpooling local by
construction:

  1. the COARSEST level is split into `n_parts` contiguous, balanced
     ranges (builders emit locality-ordered vertices, so ranges approximate
     spatial partitions);
  2. ownership is propagated down the hierarchy through the trace maps:
     part(v at level l) = part(trace_l(v)). A vertex's whole ancestry lives
     on one partition, so children-table pooling and gather-unpooling never
     cross a partition boundary;
  3. only message passing crosses boundaries, through a per-edge-set ring
     halo plan (parallel/halo.py) that ships exactly the boundary sender
     rows.

Per level l every partition owns an equal padded range of `vp[l]` rows
(row p*vp+vp-1 is partition p's own trash row). Every array's first
dimension is n_parts equal pieces, one a partition (`shard`), and every
index table (traces, children, ELL slots in the local-plus-halo space) is
SHARD-LOCAL. The build keeps JAX's guarantees: no COO spill (every edge
is ELL-resident, so the mean divides by the full in-degree), ValueError
above `max_degree` or above `max_children`, and ownership propagated down
the traces (checked).

The dataclasses hold numpy arrays as built; `parallel/sharded_stinet.py:
place_partitioned` places them as torch tensors.
"""
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from stinet_tpu_torch.graph.build import (
    RawHierarchy, _build_children, bucket_size)
from stinet_tpu_torch.graph.hierarchy import map_tensors
from stinet_tpu_torch.parallel.halo import build_halo_plan


@dataclasses.dataclass
class PartEdges:
    """One edge set in partitioned form, ELL-resident with no spill.
    `rev_idx` / `rev_deg` invert nbr_halo per shard over the extended
    (local + halo) sender space, for a gather-only backward."""
    nbr_halo: np.ndarray   # [V_tot, D] int32, local+halo index space
    degree: np.ndarray     # [V_tot] f32, total valid in-degree
    send_idx: np.ndarray   # [n_parts, S, W] int32 rows shipped at hop s
    rev_idx: np.ndarray    # [n_parts*(vp+S*W), D_rev] int32 receivers
    rev_deg: np.ndarray    # [n_parts*(vp+S*W)] f32 receivers a sender


@dataclasses.dataclass
class PartLevel:
    edges: PartEdges
    vmask: np.ndarray      # [V_tot] f32: valid rows are per-shard prefixes,
                           # not a global prefix, so an explicit mask
    dilated: Dict[int, PartEdges] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PartitionedGraph:
    x: np.ndarray
    color: Optional[np.ndarray]
    mask: Optional[np.ndarray]
    levels: Tuple[PartLevel, ...]
    traces: Tuple[np.ndarray, ...]        # [V_tot_l] int32 shard-local ids
    children: Tuple[np.ndarray, ...]      # [V_tot_{l+1}, C] int32 local
    child_counts: Tuple[np.ndarray, ...]  # [V_tot_{l+1}] f32
    n_parts: int = 1
    vp: Tuple[int, ...] = ()

    @property
    def num_levels(self):
        return len(self.levels)


@dataclasses.dataclass
class PartitionInfo:
    """Host-side bookkeeping."""
    new_id: List[np.ndarray]   # per level: old vertex id -> new padded id
    counts: List[np.ndarray]   # per level: valid vertices per partition


def shard(obj, p: int, n_parts: int):
    """Partition p's piece of every leaf: its first dimension cut into
    n_parts equal pieces (what `shard_map` hands a device in JAX). Views
    of the leaves, so a contiguous leaf gives contiguous pieces."""
    def piece(a):
        n = a.shape[0] // n_parts
        return a[p * n:(p + 1) * n]
    return map_tensors(obj, piece)


def _partition_ell(src, dst, v_tot, vp, n_parts, max_degree):
    """Dst-major ELL table in the partitioned global index space; pad slots
    point at the RECEIVER's own shard-trash row so they never generate halo
    traffic."""
    order = np.argsort(dst, kind="stable")
    src, dst = src[order].astype(np.int64), dst[order].astype(np.int64)
    deg = np.bincount(dst, minlength=v_tot)
    d_max = max(int(deg.max()) if len(dst) else 0, 1)
    if d_max > max_degree:
        raise ValueError(
            f"partitioned build requires full-ELL edge sets; max in-degree "
            f"{d_max} > {max_degree} (hub-dominated graphs need the COO "
            "spill path, which the halo plan does not cover)")
    row_trash = (np.arange(v_tot, dtype=np.int64) // vp) * vp + vp - 1
    nbr = np.repeat(row_trash[:, None], d_max, axis=1)
    indptr = np.zeros(v_tot + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    slot = np.arange(len(dst)) - indptr[dst]
    nbr[dst, slot] = src
    return nbr.astype(np.int64), deg.astype(np.float32)


def _reverse_tables(nbr_halo, deg, vp, n_parts, halo_width):
    """Invert nbr_halo per shard: for each extended sender index e (local
    rows [0, vp), then halo slots [vp, vp + S*W)), the local receiver rows
    whose valid ELL slots reference e. Pad entries use receiver 0 with
    rev_deg excluding them (ops/ell.py's convention)."""
    s_steps = max(n_parts - 1, 1)
    ext = vp + s_steps * halo_width
    d_in = nbr_halo.shape[1]
    deg_i = deg.astype(np.int64)
    rev_lists = []
    d_rev = 1
    for p in range(n_parts):
        rows = nbr_halo[p * vp:(p + 1) * vp]          # [vp, D] ext-space ids
        slot_valid = (np.arange(d_in)[None, :]
                      < deg_i[p * vp:(p + 1) * vp, None])
        r, d = np.nonzero(slot_valid)
        e = rows[r, d]
        order = np.argsort(e, kind="stable")
        e, r = e[order], r[order]
        counts = np.bincount(e, minlength=ext)
        d_rev = max(d_rev, int(counts.max()) if len(e) else 0)
        rev_lists.append((e, r, counts))
    rev_idx = np.zeros((n_parts * ext, d_rev), np.int32)
    rev_deg = np.zeros(n_parts * ext, np.float32)
    for p, (e, r, counts) in enumerate(rev_lists):
        indptr = np.zeros(ext + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        slot = np.arange(len(e)) - indptr[e]
        rev_idx[p * ext + e, slot] = r
        rev_deg[p * ext:(p + 1) * ext] = counts
    return rev_idx, rev_deg


def _part_edges(edges_new: np.ndarray, v_tot: int, vp: int, n_parts: int,
                max_degree: int) -> PartEdges:
    nbr, deg = _partition_ell(edges_new[0], edges_new[1], v_tot, vp,
                              n_parts, max_degree)
    plan = build_halo_plan(nbr, v_tot, n_parts)
    rev_idx, rev_deg = _reverse_tables(plan.nbr_halo, deg, vp, n_parts,
                                       plan.halo_width)
    return PartEdges(nbr_halo=plan.nbr_halo.astype(np.int32),
                     degree=deg,
                     send_idx=plan.send_idx.astype(np.int32),
                     rev_idx=rev_idx, rev_deg=rev_deg)


def partition_hierarchy(sample: RawHierarchy, n_parts: int,
                        pad_multiple: int = 8,
                        max_degree: int = 96,
                        max_children: int = 128
                        ) -> Tuple[PartitionedGraph, PartitionInfo]:
    """Single-scene partitioned build. `pad_multiple` rounds each
    partition's row count a level."""
    L = len(sample.num_vertices)
    nv = [int(n) for n in sample.num_vertices]

    # 1-2. ownership: contiguous balanced split of the coarsest level,
    # propagated down through the traces
    part = [None] * L
    part[L - 1] = (np.arange(nv[L - 1], dtype=np.int64) * n_parts) // nv[L - 1]
    for l in range(L - 2, -1, -1):
        tr = np.asarray(sample.traces[l], dtype=np.int64)
        if tr.shape[0] != nv[l]:
            raise ValueError(f"level {l}: trace of {tr.shape[0]} rows for "
                             f"{nv[l]} vertices")
        part[l] = part[l + 1][tr]

    # 3. per-level renumbering: partition-major stable order, padded ranges
    new_id, counts, vp = [], [], []
    for l in range(L):
        c = np.bincount(part[l], minlength=n_parts)
        vpl = bucket_size(int(c.max()) + 1, pad_multiple)
        order = np.argsort(part[l], kind="stable")  # old ids grouped by part
        rank = np.empty(nv[l], np.int64)
        starts = np.zeros(n_parts, np.int64)
        np.cumsum(c[:-1], out=starts[1:])
        rank[order] = np.arange(nv[l]) - starts[part[l][order]]
        nid = part[l] * vpl + rank
        new_id.append(nid)
        counts.append(c)
        vp.append(vpl)

    levels, traces, children, child_counts = [], [], [], []
    for l in range(L):
        v_tot = n_parts * vp[l]
        edges = np.asarray(sample.level_edges[l], dtype=np.int64)
        edges_new = np.stack([new_id[l][edges[0]], new_id[l][edges[1]]])
        pe = _part_edges(edges_new, v_tot, vp[l], n_parts, max_degree)

        vmask = np.zeros(v_tot, np.float32)
        vmask[new_id[l]] = 1.0

        dil = {}
        for dist, de in sample.dilated.get(l, {}).items():
            de = np.asarray(de, dtype=np.int64)
            de_new = np.stack([new_id[l][de[0]], new_id[l][de[1]]])
            dil[int(dist)] = _part_edges(de_new, v_tot, vp[l], n_parts,
                                         max_degree)
        levels.append(PartLevel(edges=pe, vmask=vmask, dilated=dil))

        if l < L - 1:
            # shard-local trace: same partition by construction
            tr_old = np.asarray(sample.traces[l], dtype=np.int64)
            coarse_new = new_id[l + 1][tr_old]
            if not (coarse_new // vp[l + 1] == part[l]).all():
                raise AssertionError("ownership propagation violated")
            tr_local = np.full(n_parts * vp[l], vp[l + 1] - 1, np.int32)
            tr_local[new_id[l]] = (coarse_new % vp[l + 1]).astype(np.int32)
            traces.append(tr_local)

            # per-shard children tables in local fine index space; each
            # shard's valid fine rows are a prefix of its range
            ch_parts, cc_parts, widths = [], [], []
            for p in range(n_parts):
                seg = tr_local[p * vp[l]:(p + 1) * vp[l]]
                ch, cc = _build_children(seg, int(counts[l][p]),
                                         vp[l + 1], vp[l] - 1,
                                         max_children=max_children)
                if ch is None:
                    raise ValueError(
                        "partitioned build requires children tables "
                        f"(a level-{l} cluster exceeds {max_children} "
                        "children)")
                ch_parts.append(ch)
                cc_parts.append(cc)
                widths.append(ch.shape[1])
            w = max(widths)
            ch_full = np.full((n_parts * vp[l + 1], w), vp[l] - 1, np.int32)
            for p in range(n_parts):
                ch_full[p * vp[l + 1]:(p + 1) * vp[l + 1],
                        :widths[p]] = ch_parts[p]
            children.append(ch_full)
            child_counts.append(np.concatenate(cc_parts))

    v0 = n_parts * vp[0]

    def scatter_feat(a, pad_value=0.0):
        a = np.asarray(a)
        out = np.full((v0,) + a.shape[1:], pad_value, dtype=np.float32)
        out[new_id[0]] = a
        return out

    pg = PartitionedGraph(
        x=scatter_feat(sample.x),
        color=scatter_feat(sample.color),
        mask=scatter_feat(sample.mask),
        levels=tuple(levels), traces=tuple(traces),
        children=tuple(children), child_counts=tuple(child_counts),
        n_parts=n_parts, vp=tuple(vp))
    return pg, PartitionInfo(new_id=new_id, counts=counts)
