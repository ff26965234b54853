"""The yardstick's arithmetic: the bytes and operations an op's inputs and
outputs need, the least time they take on the card, and the useful FLOPs
of the model on a room.

The byte counts are copied from `chip_smoke.py` (`k1_call_bound`,
`_slot_bytes`, `_dq_bytes`, `_tp_grad_need`, its K3 rows and K2's
`4 * c * (n + v)`):
each input byte is counted once, each output byte written once, whatever
a kernel reads again, so a share of the roofline reads the same work
whatever implements the op.
"""
from typing import Dict, Sequence

import torch

from benchlib import peaks


def _live(idx, count):
    return (torch.arange(idx.shape[1], device=count.device)
            < count.to(torch.int64)[:, None])


def k1_need(h: int, es: int, nbr, deg):
    """(bytes, operations) of one K1 forward call on p, q of width `h`
    and `es` bytes an element: deg and out for every row, the live slots
    of nbr, p of each row with an edge, q of each sender once; add, relu
    and sum a live slot and channel."""
    v = nbr.shape[0]
    live = _live(nbr, deg)
    slots = int(live.sum())
    senders = int(torch.unique(nbr[live]).numel())
    receivers = int(torch.count_nonzero(deg))
    return (4 * (v + slots) + es * (v * h + h * (receivers + senders)),
            3 * h * slots)


def slot_bytes(idx, count, es: int, h: int, reads_local: int):
    """(bytes, live slots) an ELL slot loop's data needs: count and out of
    every row, the live slots of idx, `reads_local` local rows of each row
    with a slot, and each gathered row once."""
    live = _live(idx, count)
    slots = int(live.sum())
    gathered = int(torch.unique(idx[live]).numel())
    rows = int(torch.count_nonzero(count))
    v = idx.shape[0]
    return (4 * v + es * v * h + 4 * slots
            + es * h * (reads_local * rows + gathered)), slots


def k1_dp_need(h, es, nbr, deg):
    """(bytes, operations) of K1's dp: p and g of each row, q gathered."""
    nbytes, slots = slot_bytes(nbr, deg, es, h, 2)
    return nbytes, 4 * h * slots


def k1_dq_need(h, es, rev_dst, out_degree):
    """(bytes, operations) of K1's dq: as dp from the sender's side, with
    g and p of each referenced receiver read once."""
    nbytes, slots = slot_bytes(rev_dst, out_degree, es, h, 1)
    receivers = int(torch.unique(rev_dst[_live(rev_dst, out_degree)]).numel())
    return nbytes + es * h * receivers, 4 * h * slots


def k3_need(h, nbr, deg):
    """(bytes, operations) of one windowed slot sum (K3a, relu or step) on
    bf16 rows of width `h`, counted as `chip_smoke.py` counts it: as K1's
    forward, with 4 operations a live slot and channel."""
    nbytes, slots = slot_bytes(nbr, deg, 2, h, 1)
    return nbytes, 4 * h * slots


def k2_need(v: int, c: int, n: int):
    """(bytes, operations) of one f32 instance-norm call on [v, c] with n
    valid rows: the valid rows read once, every row written once."""
    return 4 * c * (n + v), 7 * n * c


def least_seconds(nbytes: float, ops: float, flops_per_s: float) -> float:
    """The least time the work can take: bytes over the memory bandwidth or
    operations over the peak, whichever is longer."""
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / flops_per_s)


def forward_flops(args: dict, num_vertices: Sequence[int],
                  edge_counts: Sequence[int], dilated_counts: Dict[int, int]
                  ) -> float:
    """Useful FLOPs of one forward on a room: the per-vertex projections
    of each EdgeConv (Lin1 split into a receiver and a sender block, Lin2,
    the shortcut), the per-edge add, ReLU and sum and the mean's scaling,
    each norm (7 a value), ELU and the residual add, the max pooling's
    compares, and the head. Counted on the valid vertices and edges."""
    from reference.stinet_ref import block_widths
    L = int(args["n_levels"])
    trans_inv = args["filter_type"] == "edgeconvtransinv"
    dilations = list(args.get("dilations") or [1] * int(args["n_blocks"]))
    total = 0.0
    for group, i, cin, cout, first in block_widths(args):
        if group in ("input_blocks", "output_blocks"):
            lvl, e = 0, edge_counts[0]
        elif group == "encoder_blocks":
            lvl = i + 1
            e = edge_counts[lvl]
            total += num_vertices[i] * cin            # pooling compares
        elif group == "bottleneck_blocks":
            lvl, d = L, int(dilations[i])
            e = dilated_counts[d] if d > 1 else edge_counts[L]
        else:
            lvl = L - i - 1
            e = edge_counts[lvl]
        v, h = num_vertices[lvl], 2 * cout
        proj = 1 if (trans_inv and first) else 2
        total += 2.0 * v * cin * h * proj          # P and Q
        total += 3.0 * h * e + v * h               # edge pass and the mean
        total += 2.0 * v * h * cout                # Lin2
        total += 9.0 * v * cout                    # norm, ELU, residual add
        if cin != cout:
            total += 2.0 * v * cin * cout          # shortcut
    ngf, out_nc, v0 = int(args["ngf"]), int(args["output_nc"]), \
        num_vertices[0]
    total += 2.0 * v0 * ngf * ngf + 8.0 * v0 * ngf + 2.0 * v0 * ngf * out_nc \
        + v0 * out_nc
    return total
