"""SurfaceTextureInpaintingNet, the flagship model, in PyTorch.

Counterpart of `stinet_tpu/models/stinet.py`: input blocks, trace-map
pooling encoder, dilated-edge bottleneck, gather-unpooling decoder, and the
Linear -> norm -> ELU -> Linear -> Tanh head. Every EdgeConv is two dense
per-vertex matmuls (P, Q) plus the per-edge pass of
`ops/message_passing.py`.

Parameter names follow the reference's state dict
(`input_blocks.0.first_filter.nn.0.weight`, `bottleneck_blocks.3.shortcut
.bias`, `final_linear2.weight`, ...), so a reference checkpoint loads with
`load_state_dict` as it is.

`dtype` (None = f32, or torch.bfloat16) is the compute dtype, as the JAX
model's: parameters stay f32 and are cast at each matmul, each filter casts
its input, and every norm runs in f32 between casts.

Activation checkpointing (`torch.utils.checkpoint`, non-reentrant) sits where
the JAX model puts `nn.remat`: on the io, encoder and decoder blocks when
`remat_io_blocks`, and on the bottleneck blocks per `checkpoint_bottleneck`
and `num_blocks_per_uncheckpointed_block`. It acts only when gradients are
recorded; a checkpointed block runs its forward again in the backward, and
the batch norm moves its running statistics in the first run only.

`impl` (None | "plain") is passed down to the ops: None runs the CUDA
kernels on a CUDA graph and the plain versions on a CPU graph; "plain"
forces the plain versions.
"""
import contextlib
import math
import threading
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from stinet_tpu_torch.graph.hierarchy import (
    EdgeSet, GraphLevel, HierarchicalGraph)
from stinet_tpu_torch.ops.ell import ell_pool_max, ell_pool_mean, ell_unpool
from stinet_tpu_torch.ops.message_passing import edge_conv_aggregate
from stinet_tpu_torch.ops.norms import (
    _valid_weight, masked_batch_norm_stats, masked_graph_norm,
    masked_instance_norm)
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


_recompute = threading.local()


@contextlib.contextmanager
def _recomputing():
    """Marks a checkpointed block's second forward (in the backward), so
    the batch norm updates its running statistics once a step, as the JAX
    model's nn.remat does."""
    prev = getattr(_recompute, "on", False)
    _recompute.on = True
    try:
        yield
    finally:
        _recompute.on = prev


class GraphNormLayer(nn.Module):
    """Norm dispatcher (stinet_tpu/models/stinet.py:40-102), masked:

    - 'instance': affine-free, per graph (the CUDA kernel on a card);
    - 'graph': GraphNorm per graph with `weight`, `bias` and `mean_scale`
      (the reference's SingleBatchGraphNorm keys);
    - 'batch': PyG's BatchNorm over every valid row, its parameters and
      buffers in `module` (an nn.BatchNorm1d used as their holder only, so
      the keys are the reference's `module.{weight, bias, running_mean,
      running_var, num_batches_tracked}`). In training mode it normalizes
      by the batch's mean and biased variance and moves the running ones by
      `momentum`, the variance unbiased with n = max(valid rows, 2); in eval
      mode it normalizes by the running ones;
    - 'none'.

    Statistics are f32 and the output takes the input's dtype."""
    momentum = 0.1      # torch's BatchNorm default, as the JAX layer's

    def __init__(self, features: int, norm_type: str = "instance",
                 eps: float = 1e-5):
        super().__init__()
        if norm_type not in ("instance", "graph", "batch", "none"):
            raise NotImplementedError(f"norm type {norm_type!r}")
        self.features, self.norm_type, self.eps = features, norm_type, eps
        if norm_type == "graph":
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
            self.mean_scale = nn.Parameter(torch.ones(features))
        elif norm_type == "batch":
            self.module = nn.BatchNorm1d(features, eps=eps)

    def forward(self, x, level: GraphLevel, num_graphs: int, impl=None):
        # statistics in >= f32 (bf16 means over 10^5 rows drift)
        if self.norm_type == "none":
            return x
        xa = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.norm_type == "instance":
            out = masked_instance_norm(xa, level.graph_id, num_graphs,
                                       level.num_vertices, eps=self.eps,
                                       impl=impl)
        elif self.norm_type == "graph":
            out = masked_graph_norm(xa, level.graph_id, num_graphs,
                                    level.num_vertices, self.weight,
                                    self.bias, self.mean_scale, eps=self.eps)
        else:
            out = self._batch_norm(xa, level.num_vertices)
        return out.to(x.dtype)

    def _batch_norm(self, x, num_valid):
        bn = self.module
        if self.training:
            mean, var = masked_batch_norm_stats(x, num_valid)
            if not getattr(_recompute, "on", False):
                with torch.no_grad():
                    n = torch.clamp(torch.as_tensor(
                        num_valid, device=x.device).to(x.dtype), min=2.0)
                    m = self.momentum
                    bn.running_mean.mul_(1 - m).add_(m * mean)
                    unbiased = var * n / (n - 1.0)
                    bn.running_var.mul_(1 - m).add_(m * unbiased)
                    bn.num_batches_tracked.add_(1)
        else:
            mean, var = bn.running_mean, bn.running_var
        inv = torch.rsqrt(var + self.eps)
        return ((x - mean) * inv * bn.weight + bn.bias) * _valid_weight(
            x, num_valid)


class EdgeConvFilter(nn.Module):
    """EdgeConv / EdgeConvTransInv with the inner MLP
    Lin(2H) -> ReLU -> Lin(H_out), in the algebraic P/Q form:

        EdgeConv:         P = x (W_i - W_d) + b1, Q = x W_d
        EdgeConvTransInv: P = -x W + b1,          Q = x W
        out = Lin2( mean_e relu(P[dst_e] + Q[src_e]) )

    `nn` keeps the reference's Sequential layout (so its keys are nn.0 and
    nn.2); the ReLU in it is applied inside the aggregation."""

    def __init__(self, in_features: int, out_features: int,
                 trans_inv: bool = False, dtype=None):
        super().__init__()
        hidden = 2 * out_features
        self.in_features, self.out_features = in_features, out_features
        self.trans_inv, self.dtype = trans_inv, dtype
        fan_in = in_features if trans_inv else 2 * in_features
        self.nn = nn.Sequential(_linear(fan_in, hidden), nn.ReLU(),
                                _linear(hidden, out_features))

    def projections(self, x):
        """The per-vertex projections (P, Q), each [V, 2*out_features], in
        the compute dtype (x and the weights cast to it first)."""
        dt = self.dtype or x.dtype
        x = x.to(dt)
        w1, b1 = self.nn[0].weight, self.nn[0].bias.to(dt)
        if self.trans_inv:
            xw = x @ w1.to(dt).T
            return b1 - xw, xw
        c = self.in_features
        wi, wd = w1[:, :c].to(dt), w1[:, c:].to(dt)
        return x @ (wi - wd).T + b1, x @ wd.T

    def forward(self, x, edges: EdgeSet, impl=None):
        p, q = self.projections(x)
        agg = edge_conv_aggregate(p, q, edges, impl=impl)
        return _dense(self.nn[2], agg, self.dtype)


def _dense(linear: nn.Linear, x, dtype):
    """`linear(x)` in the compute dtype, as flax's Dense(dtype=...) casts
    the input, kernel and bias (f32 when dtype is None)."""
    dt = dtype or x.dtype
    return F.linear(x.to(dt), linear.weight.to(dt), linear.bias.to(dt))


def make_filter(filter_type: str, dim_in: int, dim_out: int, first: bool,
                dtype=None):
    """The trans-inv variant is used only for the very first conv."""
    if filter_type in ("edgeconv", "edgeconvtransinv"):
        return EdgeConvFilter(
            dim_in, dim_out,
            trans_inv=(filter_type == "edgeconvtransinv" and first),
            dtype=dtype)
    raise NotImplementedError(f"filter type {filter_type!r} is not ported "
                              "yet")


class GraphResnetBlock(nn.Module):
    """filter -> norm -> ELU, plus the (linearly projected) input."""

    def __init__(self, dim_in: int, dim_out: int, filter_type: str,
                 norm_type: str = "instance", first: bool = False,
                 dtype=None):
        super().__init__()
        self.first_filter = make_filter(filter_type, dim_in, dim_out, first,
                                        dtype)
        self.first_norm = GraphNormLayer(dim_out, norm_type)
        self.shortcut = (_linear(dim_in, dim_out) if dim_in != dim_out
                         else None)
        self.dtype = dtype
        self.checkpointed = False

    def forward(self, x, edges: EdgeSet, level: GraphLevel,
                num_graphs: int = 1, impl=None):
        if self.checkpointed and torch.is_grad_enabled():
            # no random draws inside a block: nothing to replay
            return checkpoint(self._forward, x, edges, level, num_graphs,
                              impl, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=lambda: (contextlib.nullcontext(),
                                                  _recomputing()))
        return self._forward(x, edges, level, num_graphs, impl)

    def _forward(self, x, edges, level, num_graphs, impl):
        out = self.first_filter(x, edges, impl=impl)
        out = F.elu(self.first_norm(out, level, num_graphs, impl=impl))
        if self.shortcut is not None:
            x = _dense(self.shortcut, x, self.dtype)
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
                 checkpoint_bottleneck: bool = False,
                 num_blocks_per_uncheckpointed_block: int = 1,
                 remat_io_blocks: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dilations = (list(dilations) if dilations is not None
                     else [1] * n_blocks)
        if len(dilations) != n_blocks:
            raise ValueError(f"{len(dilations)} dilations for {n_blocks} "
                             "bottleneck blocks")
        self.dilations = [int(d) for d in dilations]
        self.n_levels, self.pooling_type = n_levels, pooling_type
        self.dtype = dtype
        L = n_levels

        def block(dim_in, dim_out, first=False):
            return GraphResnetBlock(dim_in, dim_out, filter_type, norm,
                                    first=first, dtype=dtype)

        self.input_blocks = nn.ModuleList(
            block(input_nc, ngf if i == n_repeated_io_convs - 1 else input_nc,
                  first=(i == 0))
            for i in range(n_repeated_io_convs))
        self.encoder_blocks = nn.ModuleList(
            block(ngf * 2 ** i, ngf * 2 ** (i + 1)) for i in range(L))
        self.bottleneck_blocks = nn.ModuleList(
            block(ngf * 2 ** L, ngf * 2 ** L) for _ in range(n_blocks))
        self.decoder_blocks = nn.ModuleList(
            block(ngf * 2 ** (L - i), ngf * 2 ** (L - i) // 2)
            for i in range(L))
        self.output_blocks = nn.ModuleList(
            block(ngf, ngf) for _ in range(n_repeated_io_convs))
        # checkpoint placement of the JAX model's nn.remat (stinet.py:279-335)
        for blocks in (self.input_blocks, self.encoder_blocks,
                       self.decoder_blocks, self.output_blocks):
            for b in blocks:
                b.checkpointed = remat_io_blocks
        for i, b in enumerate(self.bottleneck_blocks):
            b.checkpointed = (checkpoint_bottleneck and (i + 1)
                              % num_blocks_per_uncheckpointed_block == 0)
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
            f = L - i - 1
            fine = g.levels[f]
            # unpool: every fine vertex copies its coarse representative
            has_children = bool(g.children) and g.children[f] is not None
            out = ell_unpool(out, g.traces[f],
                             g.children[f] if has_children else None,
                             g.child_counts[f] if has_children else None)
            out = block(out, fine.edges, fine, ng, impl=impl)

        for block in self.output_blocks:
            out = block(out, g.levels[0].edges, g.levels[0], ng, impl=impl)

        out = _dense(self.final_linear1, out, self.dtype)
        out = F.elu(self.final_norm1(out, g.levels[0], ng, impl=impl))
        return torch.tanh(_dense(self.final_linear2, out, self.dtype))
