"""SingleConvMeshNet, the geodesic U-Net for mesh semantic segmentation,
the counterpart of `stinet_tpu/models/singleconvmeshnet.py` (the
reference's models/singleconvmeshnet.py).

Per level a residual block of `num_propagation_steps` EdgeConvs whose
inner MLP carries batch norms (bias-free linears), additive residuals with
post-activation, trace pooling on the encoder, gather-unpooling with skip
concatenation on the decoder, and a Linear -> BN -> ReLU -> Linear head.

The first linear of every EdgeConv is split per vertex into P and Q, as in
STINet, but the batch norm needs per-edge statistics, so the message
tensor [E_pad, 2H] is built per edge set from the COO `src`/`dst` that
every `EdgeSet` has, with ELL tables or without. The statistics are taken
over the valid edges only (`_MaskedEdgeBatchNorm`), so this is not
`nn.BatchNorm1d` on the padded tensor. Every op is a torch op: the JAX
model runs as XLA and reaches no Pallas kernel.

Module names are the JAX model's (`left_{l}`, `right_{l}`, `filter_{i}`,
`bn1`, `bn2`, `head_lin1`, `head_bn`, `head_lin2`), and
`utils/convert.py:seg_state_dict_from_jax_params` maps its variables one
to one. Every block but `left_0` runs under `torch.utils.checkpoint`, where
the JAX model puts `nn.remat`; the recomputed forward in the backward
leaves the running statistics alone (`stinet.is_recomputing`).

`dtype` (None, or "bfloat16" / torch.bfloat16) is the JAX model's, which
only its head reads: the edge convolutions compute in the input's dtype
(f32) whatever it is, and the head's two linears cast their input and
weights to it (`stinet._dense`), so with bf16 the head's batch norm takes
bf16 statistics, returns f32 (its parameters' dtype), and the logits are
bf16. Parameters stay f32.
"""
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from stinet_tpu_torch.graph.hierarchy import EdgeSet, HierarchicalGraph
from stinet_tpu_torch.metrics.graph_metrics import length_mask
from stinet_tpu_torch.models.factory import resolve_dtype, weak_scalar
from stinet_tpu_torch.models.stinet import (
    _dense, init_weights, is_recomputing, run_checkpointed)
from stinet_tpu_torch.ops.segment import segment_max, segment_mean


def edge_mask(edges: EdgeSet, dtype=torch.float32):
    """[E_pad]: 1 on the valid edges, 0 on the pad edges
    (`arange(E_pad) < num_edges`)."""
    return length_mask(edges.num_edges, edges.src.shape[0],
                       edges.src.device).to(dtype)


class _MaskedEdgeBatchNorm(nn.Module):
    """BatchNorm1d over the rows of m [N, C] where `mask` [N] is 1.

    In training: the batch mean and biased variance over those rows, with
    n = max(sum(mask), 1), and the running statistics move by `momentum`,
    the variance unbiased as var * n / max(n - 1, 1). In eval: the running
    statistics. Every row is normalized, pad rows too. On bf16 rows the
    statistics are bf16 and the constants take bf16, as JAX's module
    computes them; the output takes the parameters' dtype."""

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, m, mask):
        if self.training:
            w = mask[:, None]
            n = torch.clamp(mask.sum(), min=1.0)
            mean = (m * w).sum(0) / n
            var = (((m - mean) * w) ** 2).sum(0) / n
            if not is_recomputing():
                with torch.no_grad():
                    unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                    k = weak_scalar(self.momentum, m.dtype)
                    self.running_mean.mul_(1 - self.momentum).add_(k * mean)
                    self.running_var.mul_(1 - self.momentum).add_(
                        k * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        eps = weak_scalar(self.eps, var.dtype)
        return (m - mean) / torch.sqrt(var + eps) * self.weight + self.bias


def _bias_free(in_features: int, out_features: int) -> nn.Linear:
    # weights are drawn by init_weights from an explicit generator
    return nn.utils.skip_init(nn.Linear, in_features, out_features,
                              bias=False)


class EdgeConvWithNorm(nn.Module):
    """EdgeConv whose inner MLP is Lin(2H, no bias) -> BN -> ReLU ->
    Lin(H, no bias) -> BN, aggregated by mean or max at the receiver:

        trans_inv:  P = -x W,        Q = x W
        otherwise:  P = x (W_i - W_d), Q = x W_d
        m_e = P[dst_e] + Q[src_e]
        out[v] = aggr_{e: dst_e = v} bn2(lin2(relu(bn1(m_e))))

    with the pad edges' messages zeroed before the aggregation."""

    def __init__(self, in_features: int, out_features: int,
                 trans_inv: bool = False, aggr: str = "mean"):
        super().__init__()
        if aggr not in ("mean", "max"):
            raise ValueError(f"aggregation {aggr!r}")
        hidden = 2 * out_features
        self.in_features, self.trans_inv, self.aggr = (
            in_features, trans_inv, aggr)
        self.lin1 = _bias_free(in_features if trans_inv else 2 * in_features,
                               hidden)
        self.bn1 = _MaskedEdgeBatchNorm(hidden)
        self.lin2 = _bias_free(hidden, out_features)
        self.bn2 = _MaskedEdgeBatchNorm(out_features)

    def forward(self, x, edges: EdgeSet):
        w1 = self.lin1.weight
        if self.trans_inv:
            xw = x @ w1.T
            p, q = -xw, xw
        else:
            c = self.in_features
            wi, wd = w1[:, :c], w1[:, c:]
            p, q = x @ (wi - wd).T, x @ wd.T
        emask = edge_mask(edges, x.dtype)
        m = p.index_select(0, edges.dst) + q.index_select(0, edges.src)
        m = F.relu(self.bn1(m, emask))
        y = self.bn2(self.lin2(m), emask) * emask[:, None]
        v_pad = edges.degree.shape[0]
        if self.aggr == "mean":
            return segment_mean(y, edges.dst, v_pad,
                                counts=edges.degree.to(x.dtype))
        return segment_max(y, edges.dst, v_pad)


class MeshResBlock(nn.Module):
    """`num_steps` EdgeConvs with additive residuals and post-activation
    (reference singleconvmeshnet.py:94-108)."""

    def __init__(self, in_features: int, out_features: int, num_steps: int,
                 first_trans_inv: bool = False, aggr: str = "mean"):
        super().__init__()
        self.num_steps = num_steps
        self.add_module("filter_0", EdgeConvWithNorm(
            in_features, out_features, trans_inv=first_trans_inv,
            aggr=aggr))
        for step in range(1, num_steps):
            self.add_module(f"filter_{step}", EdgeConvWithNorm(
                out_features, out_features, aggr=aggr))
        self.checkpointed = False

    def forward(self, x, edges: EdgeSet):
        if self.checkpointed and torch.is_grad_enabled():
            return run_checkpointed(self._forward, x, edges)
        return self._forward(x, edges)

    def _forward(self, x, edges):
        h = F.relu(self.filter_0(x, edges))
        for step in range(1, self.num_steps):
            h = F.relu(h + getattr(self, f"filter_{step}")(h, edges))
        return h


class SingleConvMeshNet(nn.Module):
    """U-Net over the mesh hierarchy; `filter_sizes` gives the levels.
    Arguments are the config's archs args (and the JAX model's)."""

    def __init__(self, feature_number: int, num_propagation_steps: int,
                 filter_sizes: Sequence[int], num_classes: int = 21,
                 pooling_method: str = "mean", aggr: str = "mean",
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        if pooling_method not in ("mean", "max"):
            raise ValueError(f"pooling method {pooling_method!r}")
        fs = [int(f) for f in filter_sizes]
        self.num_levels, self.pooling_method = len(fs), pooling_method
        steps = num_propagation_steps
        self.add_module("left_0", MeshResBlock(
            feature_number, fs[0], steps, first_trans_inv=True, aggr=aggr))
        for level in range(1, len(fs)):
            self.add_module(f"left_{level}", MeshResBlock(
                fs[level - 1], fs[level], steps, aggr=aggr))
        for fine in reversed(range(len(fs) - 1)):
            self.add_module(f"right_{fine}", MeshResBlock(
                fs[fine] + fs[fine + 1], fs[fine], steps, aggr=aggr))
        for name, block in self.named_children():
            block.checkpointed = name != "left_0"
        self.head_lin1 = nn.utils.skip_init(nn.Linear, fs[0], fs[0] // 2)
        self.head_bn = _MaskedEdgeBatchNorm(fs[0] // 2)
        self.head_lin2 = nn.utils.skip_init(nn.Linear, fs[0] // 2,
                                            num_classes)
        init_weights(self, generator if generator is not None
                     else torch.Generator())

    def _pool(self, x, trace, coarse_size):
        if self.pooling_method == "mean":
            return segment_mean(x, trace, coarse_size)
        return segment_max(x, trace, coarse_size)

    def forward(self, g: HierarchicalGraph):
        L = self.num_levels
        levels = [self.left_0(g.x, g.levels[0].edges)]
        for level in range(1, L):
            lvl = g.levels[level]
            cur = self._pool(levels[-1], g.traces[level - 1],
                             lvl.num_padded_vertices)
            levels.append(getattr(self, f"left_{level}")(cur, lvl.edges))

        current = levels[-1]
        for i in range(1, L):
            fine = L - i - 1
            back = current.index_select(0, g.traces[fine])
            fused = torch.cat([levels[fine], back], dim=-1)
            current = getattr(self, f"right_{fine}")(
                fused, g.levels[fine].edges)

        lvl0 = g.levels[0]
        h = _dense(self.head_lin1, current, self.dtype)
        vmask = length_mask(lvl0.num_vertices, lvl0.num_padded_vertices,
                            current.device).to(h.dtype)
        h = F.relu(self.head_bn(h, vmask))
        return _dense(self.head_lin2, h, self.dtype)
