"""EdgeConv message aggregation, the hot op of the model.

PyTorch counterpart of `stinet_tpu/ops/message_passing.py`. Writing the
EdgeConv MLP's first layer as a receiver block and a difference block,

    Lin1([x_i, x_j - x_i]) = x_i (W_i - W_d) + x_j W_d + b =: P[i] + Q[j]

and Lin2 commutes with the mean, so

    EdgeConv(x)_i = Lin2( mean_{j in N(i)} relu(P[i] + Q[j]) ).

P and Q are dense per-vertex matmuls in the model; this module does the
per-edge part: gather, add, relu and the mean over each receiver's edges.
It also holds the plain neighbourhood mean of the SageConv filters
(`neighbor_mean`).
"""
import torch

from stinet_tpu_torch.graph.hierarchy import EdgeSet
from stinet_tpu_torch.ops.ell import ell_edge_conv_sum
from stinet_tpu_torch.ops.segment import segment_mean, segment_sum
from stinet_tpu_torch.ops.windowed import (
    WindowedEdgeConvSum, WindowedEdgeConvSumF32, default_tile)

# Largest halo at which an edge set of (dtype, width H) takes the windowed
# kernels: stinet_tpu/ops/message_passing.py:96-97, win regions measured on
# a TPU v5e and kept so the port dispatches as the reference does.
HALO_CAPS = {("bf16", 128): 384, ("bf16", 256): 384, ("f32", 256): 384}
_DTYPE_KEYS = {torch.bfloat16: "bf16", torch.float32: "f32"}


def windowed_kernel_applies(p, halo) -> bool:
    """Dispatch rule of the windowed kernels (message_passing.py:51-91):
    banded tables (a halo), V a multiple of 128, bf16 or f32 rows, and a
    halo within the cap of the (dtype, row width). The same rule holds on
    the CPU, where the windowed ops run their plain versions, so both
    devices compute the same numbers."""
    v, h = p.shape
    key = _DTYPE_KEYS.get(p.dtype)
    if halo is None or v % 128 != 0 or key is None:
        return False
    return halo <= HALO_CAPS.get((key, h), 0)


def edge_conv_aggregate(p, q, edges: EdgeSet, impl=None):
    """out[i] = mean_{e: dst[e] == i} relu(p[dst[e]] + q[src[e]]).

    With ELL tables the slot sum runs through the windowed op of the row
    dtype where `windowed_kernel_applies`, else through `ell_edge_conv_sum`
    (each a kernel on a CUDA tensor); the spilled edges are added by an f32
    segment sum, and the total is multiplied by 1/max(degree, 1) as the JAX
    code does (a division would round differently), with the degree
    rounded to the working dtype first as the JAX model passes it. Edge
    sets with no ELL table take the COO segment mean. Pad edges point at
    the trash row, so their messages never reach a valid row."""
    num_segments = edges.degree.shape[0]
    acc_dt = torch.promote_types(p.dtype, torch.float32)
    degree = edges.degree.to(p.dtype)
    if edges.nbr is None:
        m = torch.relu(p.index_select(0, edges.dst)
                       + q.index_select(0, edges.src))
        return segment_mean(m, edges.dst, num_segments, counts=degree)
    ell_deg = edges.degree if edges.ell_degree is None else edges.ell_degree
    if windowed_kernel_applies(p, edges.halo):
        fn = (WindowedEdgeConvSum if p.dtype == torch.bfloat16
              else WindowedEdgeConvSumF32)
        out = fn.apply(
            p, q, edges.nbr, edges.rev_dst, ell_deg, edges.out_degree,
            edges.halo, default_tile(p.shape[0]), impl)
    else:
        out = ell_edge_conv_sum(p, q, edges.nbr, ell_deg, edges.rev_dst,
                                edges.out_degree, impl=impl)
    if edges.spill_src is not None:
        m = torch.relu(p.index_select(0, edges.spill_dst)
                       + q.index_select(0, edges.spill_src))
        out = out + segment_sum(m.to(acc_dt), edges.spill_dst,
                                num_segments).to(out.dtype)
    inv = 1.0 / torch.clamp(degree.to(acc_dt), min=1.0)
    return (out.to(acc_dt) * inv[:, None]).to(p.dtype)


def neighbor_mean(x, edges: EdgeSet, degree):
    """out[i] = mean_{e: dst[e] == i} x[src[e]] over the COO lists, in the
    dtype of `x`, divided by max(degree, 1) (`neighbor_aggregate` with
    aggr "mean", stinet_tpu/ops/message_passing.py:173-188)."""
    return segment_mean(x.index_select(0, edges.src), edges.dst,
                        degree.shape[0], counts=degree)
