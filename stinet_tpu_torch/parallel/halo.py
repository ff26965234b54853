"""Ring halo exchange for graph-partition parallelism.

PyTorch counterpart of `stinet_tpu/parallel/halo.py`. Vertices are split
into contiguous, equal-sized ranges, one a partition. Each message-passing
layer then needs the projections of remote senders: a ring of P-1 hops
ships only the boundary rows each peer references (host-precomputed send
lists, padded to the widest hop), and the ordinary ELL aggregation runs
over the local rows followed by the received ones.

`HaloPlan` / `build_halo_plan` are the host part, copied. `halo_exchange`
is the device part, over a mesh of parallel/mesh.py.

Not ported: `allgather_edge_conv` and `halo_edge_conv`, which only the JAX
package's own tests call; they come with their first caller.
"""
from typing import List, NamedTuple

import numpy as np
import torch


class HaloPlan(NamedTuple):
    """Host-precomputed PIPELINED ring exchange plan for one edge set over
    `n_parts` contiguous equal ranges of `v_pad / n_parts` vertices.

    The ring runs S = n_parts-1 hops; at every hop each partition sends
    exactly ONE buffer of W rows to its right neighbour (i -> i+1). The
    buffer a partition sends at hop t originates t hops to its left: at hop
    0 it gathers its own boundary union (rows ANY downstream receiver
    needs); at hop t>0 it filters the buffer it just received down to the
    rows still needed >= t+1 hops from their origin, so a hop's volume is W
    whatever n_parts is.

    send_idx [n_parts, S, W]: hop-t gather list of each partition. Row ids
        index q_loc at t=0 and the hop-(t-1) RECEIVED buffer at t>0
        (chained gather); pads use 0 (never referenced by receivers).
    nbr_halo [v_pad, D]: the ELL table rewritten into the local+halo index
        space: senders owned locally -> [0, Vp); a sender received at hop
        s, slot h -> Vp + s*W + h.
    """
    send_idx: np.ndarray
    nbr_halo: np.ndarray
    halo_width: int


def build_halo_plan(nbr: np.ndarray, v_pad: int, n_parts: int) -> HaloPlan:
    """The plan of one spill-free ELL table `nbr` ([v_pad, D], global ids)
    over n_parts equal ranges."""
    if v_pad % n_parts:
        raise ValueError(f"{v_pad} rows do not divide into {n_parts} parts")
    vp = v_pad // n_parts
    nbr = np.asarray(nbr)
    owner = nbr // vp                                  # [V, D]
    me = (np.arange(v_pad) // vp)[:, None]
    # ring hop at which each remote sender's row arrives: a row owned by
    # (me - (s+1)) mod P arrives at hop s (data flows rightward)
    step = (me - owner - 1) % n_parts                  # n_parts-1 == local
    remote = owner != me
    steps = n_parts - 1

    # need[o][s]: LOCAL row ids of origin o needed by the receiver s+1 hops
    # to its right
    need = [[np.zeros(0, np.int64)] * max(steps, 1) for _ in range(n_parts)]
    for r in range(n_parts):
        rows = slice(r * vp, (r + 1) * vp)
        for s in range(steps):
            o = (r - s - 1) % n_parts
            mask = remote[rows] & (step[rows] == s)
            need[o][s] = np.unique(nbr[rows][mask]) - o * vp

    # union[o][t]: rows of origin o still in transit at hop t (needed by a
    # receiver >= t+1 hops away). Monotone: union[o][t] is a subset of
    # union[o][t-1], so hop-t buffers only ever shrink along the ring.
    union = [[None] * max(steps, 1) for _ in range(n_parts)]
    for o in range(n_parts):
        acc = np.zeros(0, np.int64)
        for t in range(steps - 1, -1, -1):
            acc = np.union1d(acc, need[o][t])
            union[o][t] = acc

    w = max((len(union[o][t]) for o in range(n_parts)
             for t in range(steps)), default=0)
    w = max(w, 1)
    send_idx = np.zeros((n_parts, max(steps, 1), w), np.int32)
    for t in range(steps):
        for o in range(n_parts):
            carrier = (o + t) % n_parts
            if t == 0:
                idx = union[o][0]                       # rows of q_loc
            else:  # positions within the hop-(t-1) buffer (same origin)
                idx = np.searchsorted(union[o][t - 1], union[o][t])
            send_idx[carrier, t, :len(idx)] = idx

    # receiver side: hop-s buffer from origin o = r-s-1 lands at
    # ext offset vp + s*w; slot = position of the row in union[o][s]
    local_idx = nbr % vp
    halo_idx = np.zeros_like(nbr)
    for r in range(n_parts):
        rows = slice(r * vp, (r + 1) * vp)
        for s in range(steps):
            o = (r - s - 1) % n_parts
            mask = remote[rows] & (step[rows] == s)
            sub = halo_idx[rows]
            sub[mask] = vp + s * w + np.searchsorted(
                union[o][s], nbr[rows][mask] - o * vp)
            halo_idx[rows] = sub
    nbr_halo = np.where(remote, halo_idx, local_idx).astype(np.int32)
    return HaloPlan(send_idx=send_idx, nbr_halo=nbr_halo, halo_width=w)


def halo_exchange(q_loc: List[torch.Tensor], send_loc: List[torch.Tensor],
                  mesh) -> List[torch.Tensor]:
    """The pipelined ring exchange of `build_halo_plan`'s schedule, for
    each partition this process holds (lists in `mesh.parts` order): at
    hop t, gather the rows send_idx[t] of the previous buffer (q_loc at
    t=0), shift the buffers one step along the ring (`mesh.ring_shift`),
    and keep what arrived. Returns each q_loc extended with its S received
    buffers, [Vp + S*W, H] (the index space of `nbr_halo`); with one
    partition, q_loc as it is. `send_loc`: each partition's [S, W] plan."""
    if mesh.n_parts <= 1:
        return list(q_loc)
    halos = [[] for _ in q_loc]
    base = list(q_loc)
    for t in range(send_loc[0].shape[0]):
        buf = mesh.ring_shift([b.index_select(0, s[t])
                               for b, s in zip(base, send_loc)])
        for h, b in zip(halos, buf):
            h.append(b)
        base = buf
    return [torch.cat([q] + h) for q, h in zip(q_loc, halos)]
