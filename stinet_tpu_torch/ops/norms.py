"""Masked per-graph instance norm.

PyTorch counterpart of `masked_instance_norm` in `stinet_tpu/ops/norms.py`:
per-graph, per-channel standardization over the valid rows, with the
biased CENTERED variance (mean of (x - mean)^2) and pad rows zeroed.
Statistics accumulate in >= f32.

The valid rows are [0, num_valid), as every graph builder lays them out, so
the kernel takes the valid count (a 0-d device tensor: no host round trip)
instead of a [V] mask. On a CUDA tensor a single-graph call launches the
hand-written kernel `ops/cuda/instance_norm.cu`; a CPU tensor, or
impl="plain", takes `masked_instance_norm_plain`. Batched graphs
(num_graphs > 1) run only the plain version until batched serving is
ported, and raise on the kernel path.

A single-graph call is an autograd Function whose backward is the exact
gradient of the centered-variance forward, in f32 torch ops (JAX's is XLA):
with c = (x - mean) * w, r = (var + eps)^-1/2 and y = c * r,

    g_c = r * (g - y * sum_v(w * g * y) / n),
    dx  = w * (g_c - sum_v(w * g_c) / n).

Batched calls differentiate through the plain torch ops.
"""
import torch

from stinet_tpu_torch.ops import _cuda


def masked_instance_norm(x, graph_id, num_graphs, num_valid, eps=1e-5,
                         impl=None):
    """x: [V, C]; graph_id: [V] int (pad rows = num_graphs); num_valid: 0-d
    int tensor or int, the number of valid rows."""
    if num_graphs == 1:
        return _InstanceNorm.apply(x, num_valid, eps, impl)
    if _cuda.use_kernel(x, impl):
        raise NotImplementedError(
            "the instance-norm kernel takes one graph; batched "
            "(num_graphs > 1) graphs are not ported to the card yet")
    return masked_instance_norm_plain(x, graph_id, num_graphs, num_valid, eps)


def _valid_weight(x, num_valid):
    """[V, 1] f32 weight: 1 on the valid rows [0, num_valid), 0 after."""
    rows = torch.arange(x.shape[0], device=x.device)
    nv = torch.as_tensor(num_valid, device=x.device)
    return (rows < nv).to(torch.promote_types(x.dtype, torch.float32))[:, None]


class _InstanceNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, num_valid, eps, impl):
        ctx.eps = eps
        ctx.save_for_backward(x, torch.as_tensor(num_valid, device=x.device))
        if _cuda.use_kernel(x, impl):
            return masked_instance_norm_kernel(x, num_valid, eps)
        return masked_instance_norm_plain(x, None, 1, num_valid, eps)

    @staticmethod
    def backward(ctx, g):
        x, num_valid = ctx.saved_tensors
        w = _valid_weight(x, num_valid)
        xa, ga = x.to(w.dtype), g.to(w.dtype)
        n = torch.clamp(w.sum(), min=1.0)
        mean = (xa * w).sum(0, keepdim=True) / n
        c = (xa - mean) * w
        r = ((c * c).sum(0, keepdim=True) / n + ctx.eps) ** -0.5
        y = c * r
        g_c = r * (ga - y * (w * ga * y).sum(0, keepdim=True) / n)
        dx = w * (g_c - (w * g_c).sum(0, keepdim=True) / n)
        return dx.to(x.dtype), None, None, None


def masked_instance_norm_plain(x, graph_id, num_graphs, num_valid, eps=1e-5):
    """Plain torch version, the arithmetic of stinet_tpu/ops/norms.py:79-104:
    masked mean, then the centered variance, then (x-mean)*(var+eps)^-0.5."""
    acc = torch.promote_types(x.dtype, torch.float32)
    w = _valid_weight(x, num_valid)
    xa = x.to(acc)
    if num_graphs == 1:
        n = torch.clamp(w.sum(), min=1.0)
        mean = (xa * w).sum(0, keepdim=True) / n
        centered = (xa - mean) * w
        var = (centered * centered).sum(0, keepdim=True) / n
        return (centered * (var + eps) ** -0.5).to(x.dtype)
    # per-graph statistics through a [G, V] one-hot product; pad rows carry
    # graph_id == num_graphs and match no column
    oh = (graph_id[None, :] == torch.arange(
        num_graphs, device=x.device, dtype=graph_id.dtype)[:, None]).to(acc)
    n = torch.clamp(oh @ w, min=1.0)                       # [G, 1]
    mean = (oh @ (xa * w)) / n                            # [G, C]
    centered = (xa - oh.T @ mean) * w
    var = (oh @ (centered * centered)) / n
    return (centered * (oh.T @ (var + eps) ** -0.5)).to(x.dtype)


def masked_instance_norm_kernel(x, num_valid, eps=1e-5):
    """Launch `masked_instance_norm_f32` (ops/cuda/instance_norm.cu) on the
    current stream. Raises on a tensor it does not take or a failed launch;
    it never falls back to the plain version."""
    dev = x.device
    _cuda.check_tensor("x", x, torch.float32, 2, dev)
    nv = torch.as_tensor(num_valid, dtype=torch.int32, device=dev)
    if nv.dim() != 0:
        raise ValueError(f"num_valid must be a scalar, got shape "
                         f"{tuple(nv.shape)}")
    v, c = x.shape
    lib = _cuda.library("instance_norm")
    scratch = torch.empty(lib.masked_instance_norm_f32_scratch_floats(v, c),
                          dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    rc = lib.masked_instance_norm_f32(
        x.data_ptr(), nv.data_ptr(), out.data_ptr(), scratch.data_ptr(), v, c,
        float(eps), dev.index, _cuda.stream_of(dev))
    _cuda.check_status(lib, "masked_instance_norm_f32", rc)
    masked_instance_norm_kernel.launches += 1
    return out


masked_instance_norm_kernel.launches = 0
