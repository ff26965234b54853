"""SurfaceTextureInpaintingNet, the flagship model, in PyTorch.

Counterpart of `stinet_tpu/models/stinet.py`: input blocks, trace-map
pooling encoder, dilated-edge bottleneck, gather-unpooling decoder, and the
Linear -> norm -> ELU -> Linear -> Tanh head. Every EdgeConv is two dense
per-vertex matmuls (P, Q) plus the per-edge pass of
`ops/message_passing.py`.

Parameter names follow the reference's state dict
(`input_blocks.0.first_filter.nn.0.weight`, `bottleneck_blocks.3.shortcut
.bias`, `final_linear2.weight`, ...), so a reference checkpoint loads with
`load_state_dict` as it is. Inference only in this slice: there is no
activation checkpointing.

`impl` (None | "plain") is passed down to the ops: None runs the CUDA
kernels on a CUDA graph and the plain versions on a CPU graph; "plain"
forces the plain versions.
"""
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from stinet_tpu_torch.graph.hierarchy import (
    EdgeSet, GraphLevel, HierarchicalGraph)
from stinet_tpu_torch.ops.ell import ell_pool_max, ell_pool_mean, ell_unpool
from stinet_tpu_torch.ops.message_passing import edge_conv_aggregate
from stinet_tpu_torch.ops.norms import masked_instance_norm
from stinet_tpu_torch.ops.segment import segment_max, segment_mean


def _linear(in_features: int, out_features: int) -> nn.Linear:
    # parameters are set by init_weights from an explicit generator
    return nn.utils.skip_init(nn.Linear, in_features, out_features)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """torch.nn.Linear's default weight law, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), drawn from `generator`; zero biases (the reference's
    init pass zeroes them, as the JAX model's initializers do)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()


class GraphNormLayer(nn.Module):
    """Norm dispatcher: 'instance' (affine-free, per graph, masked) or
    'none'. The graph and batch norms are not ported yet."""

    def __init__(self, features: int, norm_type: str = "instance",
                 eps: float = 1e-5):
        super().__init__()
        if norm_type not in ("instance", "none"):
            raise NotImplementedError(f"norm type {norm_type!r} is not "
                                      "ported yet")
        self.features, self.norm_type, self.eps = features, norm_type, eps

    def forward(self, x, level: GraphLevel, num_graphs: int, impl=None):
        if self.norm_type == "none":
            return x
        return masked_instance_norm(x, level.graph_id, num_graphs,
                                    level.num_vertices, eps=self.eps,
                                    impl=impl)


class EdgeConvFilter(nn.Module):
    """EdgeConv / EdgeConvTransInv with the inner MLP
    Lin(2H) -> ReLU -> Lin(H_out), in the algebraic P/Q form:

        EdgeConv:         P = x (W_i - W_d) + b1, Q = x W_d
        EdgeConvTransInv: P = -x W + b1,          Q = x W
        out = Lin2( mean_e relu(P[dst_e] + Q[src_e]) )

    `nn` keeps the reference's Sequential layout (so its keys are nn.0 and
    nn.2); the ReLU in it is applied inside the aggregation."""

    def __init__(self, in_features: int, out_features: int,
                 trans_inv: bool = False):
        super().__init__()
        hidden = 2 * out_features
        self.in_features, self.out_features = in_features, out_features
        self.trans_inv = trans_inv
        fan_in = in_features if trans_inv else 2 * in_features
        self.nn = nn.Sequential(_linear(fan_in, hidden), nn.ReLU(),
                                _linear(hidden, out_features))

    def projections(self, x):
        """The per-vertex projections (P, Q), each [V, 2*out_features]."""
        w1, b1 = self.nn[0].weight, self.nn[0].bias
        if self.trans_inv:
            xw = x @ w1.T
            return b1 - xw, xw
        c = self.in_features
        wi, wd = w1[:, :c], w1[:, c:]
        return x @ (wi - wd).T + b1, x @ wd.T

    def forward(self, x, edges: EdgeSet, impl=None):
        p, q = self.projections(x)
        agg = edge_conv_aggregate(p, q, edges, impl=impl)
        return self.nn[2](agg)


def make_filter(filter_type: str, dim_in: int, dim_out: int, first: bool):
    """The trans-inv variant is used only for the very first conv."""
    if filter_type in ("edgeconv", "edgeconvtransinv"):
        return EdgeConvFilter(
            dim_in, dim_out,
            trans_inv=(filter_type == "edgeconvtransinv" and first))
    raise NotImplementedError(f"filter type {filter_type!r} is not ported "
                              "yet")


class GraphResnetBlock(nn.Module):
    """filter -> norm -> ELU, plus the (linearly projected) input."""

    def __init__(self, dim_in: int, dim_out: int, filter_type: str,
                 norm_type: str = "instance", first: bool = False):
        super().__init__()
        self.first_filter = make_filter(filter_type, dim_in, dim_out, first)
        self.first_norm = GraphNormLayer(dim_out, norm_type)
        self.shortcut = (_linear(dim_in, dim_out) if dim_in != dim_out
                         else None)

    def forward(self, x, edges: EdgeSet, level: GraphLevel,
                num_graphs: int = 1, impl=None):
        out = self.first_filter(x, edges, impl=impl)
        out = F.elu(self.first_norm(out, level, num_graphs, impl=impl))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + out


def _pool(x, trace, coarse_size, pooling_type, children=None, counts=None):
    """Encoder pooling: mean/max of the fine rows over the trace map, by
    the children table where the level has one, else by segment ops (pad
    fine rows trace to the coarse trash vertex, so no masking is needed)."""
    if pooling_type not in ("mean", "max"):
        raise ValueError(f"Unknown pooling type {pooling_type!r}")
    if children is not None:
        fn = ell_pool_mean if pooling_type == "mean" else ell_pool_max
        return fn(x, trace, children, counts)
    if pooling_type == "mean":
        return segment_mean(x, trace, coarse_size)
    return segment_max(x, trace, coarse_size)


class SurfaceTextureInpaintingNet(nn.Module):
    """See the module docstring. Arguments match the reference define_G's
    (the archs section of experiments/3d_inpainting/config/*.json)."""

    def __init__(self, input_nc: int, output_nc: int = 3, ngf: int = 64,
                 filter_type: str = "edgeconvtransinv",
                 norm: str = "instance", n_blocks: int = 6,
                 n_levels: int = 2, n_repeated_io_convs: int = 1,
                 pooling_type: str = "max",
                 dilations: Optional[Sequence[int]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dilations = (list(dilations) if dilations is not None
                     else [1] * n_blocks)
        if len(dilations) != n_blocks:
            raise ValueError(f"{len(dilations)} dilations for {n_blocks} "
                             "bottleneck blocks")
        self.dilations = [int(d) for d in dilations]
        self.n_levels, self.pooling_type = n_levels, pooling_type
        L = n_levels

        self.input_blocks = nn.ModuleList(
            GraphResnetBlock(input_nc,
                             ngf if i == n_repeated_io_convs - 1 else input_nc,
                             filter_type, norm, first=(i == 0))
            for i in range(n_repeated_io_convs))
        self.encoder_blocks = nn.ModuleList(
            GraphResnetBlock(ngf * 2 ** i, ngf * 2 ** (i + 1), filter_type,
                             norm)
            for i in range(L))
        self.bottleneck_blocks = nn.ModuleList(
            GraphResnetBlock(ngf * 2 ** L, ngf * 2 ** L, filter_type, norm)
            for _ in range(n_blocks))
        self.decoder_blocks = nn.ModuleList(
            GraphResnetBlock(ngf * 2 ** (L - i), ngf * 2 ** (L - i) // 2,
                             filter_type, norm)
            for i in range(L))
        self.output_blocks = nn.ModuleList(
            GraphResnetBlock(ngf, ngf, filter_type, norm)
            for _ in range(n_repeated_io_convs))
        self.final_linear1 = _linear(ngf, ngf)
        self.final_norm1 = GraphNormLayer(ngf, norm)
        self.final_linear2 = _linear(ngf, output_nc)
        init_weights(self, generator if generator is not None
                     else torch.Generator())

    def forward(self, g: HierarchicalGraph, impl=None):
        L, ng = self.n_levels, g.num_graphs
        out = g.x
        for block in self.input_blocks:
            out = block(out, g.levels[0].edges, g.levels[0], ng, impl=impl)

        for i, block in enumerate(self.encoder_blocks):
            lvl = g.levels[i + 1]
            out = _pool(out, g.traces[i], lvl.num_padded_vertices,
                        self.pooling_type,
                        g.children[i] if g.children else None,
                        g.child_counts[i] if g.children else None)
            out = block(out, lvl.edges, lvl, ng, impl=impl)

        coarse = g.levels[L]
        for d, block in zip(self.dilations, self.bottleneck_blocks):
            edges = coarse.dilated[d] if d > 1 else coarse.edges
            out = block(out, edges, coarse, ng, impl=impl)

        for i, block in enumerate(self.decoder_blocks):
            fine = g.levels[L - i - 1]
            # unpool: every fine vertex copies its coarse representative
            out = ell_unpool(out, g.traces[L - i - 1], None, None)
            out = block(out, fine.edges, fine, ng, impl=impl)

        for block in self.output_blocks:
            out = block(out, g.levels[0].edges, g.levels[0], ng, impl=impl)

        out = self.final_linear1(out)
        out = F.elu(self.final_norm1(out, g.levels[0], ng, impl=impl))
        return torch.tanh(self.final_linear2(out))
