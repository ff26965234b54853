"""EdgeConv message aggregation, the hot op of the model.

PyTorch counterpart of `stinet_tpu/ops/message_passing.py`. Writing the
EdgeConv MLP's first layer as a receiver block and a difference block,

    Lin1([x_i, x_j - x_i]) = x_i (W_i - W_d) + x_j W_d + b =: P[i] + Q[j]

and Lin2 commutes with the mean, so

    EdgeConv(x)_i = Lin2( mean_{j in N(i)} relu(P[i] + Q[j]) ).

P and Q are dense per-vertex matmuls in the model; this module does the
per-edge part: gather, add, relu and the mean over each receiver's edges.
"""
import torch

from stinet_tpu_torch.graph.hierarchy import EdgeSet
from stinet_tpu_torch.ops.ell import ell_edge_conv_sum
from stinet_tpu_torch.ops.segment import segment_mean, segment_sum


def edge_conv_aggregate(p, q, edges: EdgeSet, impl=None):
    """out[i] = mean_{e: dst[e] == i} relu(p[dst[e]] + q[src[e]]).

    With ELL tables the slot sum runs through `ell_edge_conv_sum` (the
    kernel on a CUDA tensor), the spilled edges are added by an f32 segment
    sum, and the total is multiplied by 1/max(degree, 1) as the JAX code
    does (a division would round differently). Edge sets with no ELL table
    take the COO segment mean. Pad edges point at the trash row, so their
    messages never reach a valid row."""
    num_segments = edges.degree.shape[0]
    acc_dt = torch.promote_types(p.dtype, torch.float32)
    if edges.nbr is None:
        m = torch.relu(p.index_select(0, edges.dst)
                       + q.index_select(0, edges.src))
        return segment_mean(m, edges.dst, num_segments, counts=edges.degree)
    ell_deg = edges.degree if edges.ell_degree is None else edges.ell_degree
    out = ell_edge_conv_sum(p, q, edges.nbr, ell_deg, impl=impl)
    if edges.spill_src is not None:
        m = torch.relu(p.index_select(0, edges.spill_dst)
                       + q.index_select(0, edges.spill_src))
        out = out + segment_sum(m.to(acc_dt), edges.spill_dst,
                                num_segments).to(out.dtype)
    inv = 1.0 / torch.clamp(edges.degree.to(acc_dt), min=1.0)
    return (out.to(acc_dt) * inv[:, None]).to(p.dtype)
