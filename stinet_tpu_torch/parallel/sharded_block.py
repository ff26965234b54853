"""Graph-partitioned STINet building blocks.

PyTorch counterpart of `stinet_tpu/parallel/sharded_block.py` and of the
block and norm of `stinet_tpu/parallel/sharded_stinet.py`. Each function
takes lists with one entry per partition the process holds (parallel/
mesh.py), and only the two collective steps cross partitions:

  conv:     ring halo exchange of the sender projection Q (parallel/
            halo.py), then the ordinary ELL aggregation over the extended
            (local + halo) sender space (ops/message_passing.py);
  norm:     single-graph instance norm whose masked sums are summed over
            the mesh;
  the dense projections, ELU and the residual stay local.

The block reuses the model's own modules (models/stinet.py:
`GraphResnetBlock` and its `EdgeConvFilter`), so one state dict serves the
partitioned and the single-device forward.
"""
from typing import List

import torch
import torch.nn.functional as F

from stinet_tpu_torch.graph.hierarchy import EdgeSet
from stinet_tpu_torch.models.stinet import _dense
from stinet_tpu_torch.ops.message_passing import edge_conv_aggregate
from stinet_tpu_torch.parallel.halo import halo_exchange


def sharded_instance_norm(xs: List[torch.Tensor], vmasks, mesh,
                          eps: float = 1e-5) -> List[torch.Tensor]:
    """Single-graph masked instance norm with the rows split over the
    mesh: JAX's `_instance_norm_psum` (sharded_stinet.py:68-77), in two
    passes, each a sum over the mesh: the valid count and the mean, then
    the centered variance; out = centered * (var + eps) ** -0.5, 0 on pad
    rows. Each x in f32 or wider. Not K2, which normalizes one graph on one
    device: here the statistics are summed across partitions."""
    ws = [m.to(x.dtype)[:, None] for x, m in zip(xs, vmasks)]
    n = mesh.sum([w.sum() for w in ws])
    s = mesh.sum([(x * w).sum(0) for x, w in zip(xs, ws)])
    means = [si / torch.clamp(ni, min=1.0) for si, ni in zip(s, n)]
    centered = [(x - m) * w for x, m, w in zip(xs, means, ws)]
    sq = mesh.sum([(c * c).sum(0) for c in centered])
    return [c * (v / torch.clamp(ni, min=1.0) + eps) ** -0.5
            for c, v, ni in zip(centered, sq, n)]


def _halo_edge_set(edges, rows: int) -> EdgeSet:
    """A partition's PartEdges (placed) as the EdgeSet that
    `edge_conv_aggregate` reads: the ELL table in the local-plus-halo
    space, its reverse tables over the `rows` of the extended sender space,
    no COO lists, no spill, and `halo` None, so the windowed dispatch is
    bypassed (its band premise |nbr[v, d] - v| <= halo does not hold once
    halo rows follow the local range). With one partition there is no halo,
    but the layout keeps one hop of W pad rows (graph/partition.py), which
    no receiver reads; `rows` cuts them, so dq is shaped as q."""
    return EdgeSet(src=None, dst=None, num_edges=None, degree=edges.degree,
                   nbr=edges.nbr_halo, rev_dst=edges.rev_idx[:rows],
                   out_degree=edges.rev_deg[:rows])


def sharded_edge_conv(filt, xs, edges, mesh, impl=None):
    """`filt` (an EdgeConvFilter) on partitioned rows: P and Q per
    partition, Q's halo exchanged, the mean relu message over the extended
    sender space (K1 on a CUDA tensor, with q of Vp + S*W rows), then
    Lin2."""
    pq = [filt.projections(x) for x in xs]
    q_ext = halo_exchange([q for _, q in pq],
                          [e.send_idx[0] for e in edges], mesh)
    return [_dense(filt.nn[2], edge_conv_aggregate(
                p, q, _halo_edge_set(e, q.shape[0]), impl=impl), filt.dtype)
            for (p, _), q, e in zip(pq, q_ext, edges)]


def sharded_resnet_block(block, xs, edges, vmasks, mesh, impl=None):
    """A GraphResnetBlock (models/stinet.py) on partitioned rows:
    x + elu(norm(conv(x))), with x projected by the shortcut where the
    block has one. The norm's statistics are f32 (or wider) and its result
    takes the conv's dtype, as in the single-device block."""
    outs = sharded_edge_conv(block.first_filter, xs, edges, mesh, impl)
    normed = sharded_instance_norm(
        [o.to(torch.promote_types(o.dtype, torch.float32)) for o in outs],
        vmasks, mesh, eps=block.first_norm.eps)
    outs = [F.elu(n.to(o.dtype)) for n, o in zip(normed, outs)]
    if block.shortcut is not None:
        xs = [_dense(block.shortcut, x, block.dtype) for x in xs]
    return [x + o for x, o in zip(xs, outs)]
