"""Masked per-graph instance norm.

PyTorch counterpart of `masked_instance_norm` in `stinet_tpu/ops/norms.py`:
per-graph, per-channel standardization over the valid rows, with the
biased CENTERED variance (mean of (x - mean)^2) and pad rows zeroed.
Statistics accumulate in >= f32.

The valid rows are [0, num_valid), as every graph builder lays them out, so
the kernel takes the valid count (a 0-d device tensor: no host round trip)
instead of a [V] mask. A batch of G graphs (the concatenated layout) adds
`graph_id`: graph g's valid rows are one contiguous run, in g order, and
pad rows carry G. On a CUDA tensor a call launches the hand-written kernel
`ops/cuda/instance_norm.cu` (`masked_instance_norm_kernel`, whose
multi-graph entry takes G > 1); a CPU tensor, or impl="plain", takes
`masked_instance_norm_plain`.

Every call is an autograd Function whose backward is the exact gradient of
the centered-variance forward, per graph, in f32 torch ops (JAX's is XLA):
with c = (x - mean_g) * w, r = (var_g + eps)^-1/2, y = c * r and n_g the
valid rows of graph g,

    g_c = r * (g - y * sum_{v in g}(w * g * y) / n_g),
    dx  = w * (g_c - sum_{v in g}(w * g_c) / n_g).
"""
import torch

from stinet_tpu_torch.ops import _cuda


def masked_instance_norm(x, graph_id, num_graphs, num_valid, eps=1e-5,
                         impl=None):
    """x: [V, C]; graph_id: [V] int (pad rows = num_graphs); num_valid: 0-d
    int tensor or int, the number of valid rows."""
    return _InstanceNorm.apply(x, graph_id, num_graphs, num_valid, eps, impl)


def _valid_weight(x, num_valid):
    """[V, 1] f32 weight: 1 on the valid rows [0, num_valid), 0 after."""
    rows = torch.arange(x.shape[0], device=x.device)
    nv = torch.as_tensor(num_valid, device=x.device)
    return (rows < nv).to(torch.promote_types(x.dtype, torch.float32))[:, None]


def _per_graph(graph_id, num_graphs, dtype):
    """(total, rows): `total` sums [V, k] rows per graph into [G, k], `rows`
    gives every row its graph's [G, k] entry (pad rows, graph_id ==
    num_graphs, match no graph and get 0). One graph: column sums and
    broadcasting. Batches: products with the [G, V] one-hot of graph_id,
    as the JAX code forms them (norms.py:29-56)."""
    if num_graphs == 1:
        return (lambda t: t.sum(0, keepdim=True)), (lambda t: t)
    oh = (graph_id[None, :] == torch.arange(
        num_graphs, device=graph_id.device,
        dtype=graph_id.dtype)[:, None]).to(dtype)
    return (lambda t: oh @ t), (lambda t: oh.T @ t)


class _InstanceNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, graph_id, num_graphs, num_valid, eps, impl):
        ctx.eps, ctx.num_graphs = eps, num_graphs
        ctx.save_for_backward(x, torch.as_tensor(num_valid, device=x.device),
                              graph_id)
        if not _cuda.use_kernel(x, impl):
            return masked_instance_norm_plain(x, graph_id, num_graphs,
                                              num_valid, eps)
        return masked_instance_norm_kernel(
            x, num_valid, eps, graph_id if num_graphs > 1 else None,
            num_graphs)

    @staticmethod
    def backward(ctx, g):
        x, num_valid, graph_id = ctx.saved_tensors
        w = _valid_weight(x, num_valid)
        total, rows = _per_graph(graph_id, ctx.num_graphs, w.dtype)
        xa, ga = x.to(w.dtype), g.to(w.dtype)
        n = torch.clamp(total(w), min=1.0)
        mean = total(xa * w) / n
        c = (xa - rows(mean)) * w
        r = rows((total(c * c) / n + ctx.eps) ** -0.5)
        n_rows = torch.clamp(rows(n), min=1.0)   # pad rows: no graph, 0
        y = c * r
        g_c = r * (ga - y * rows(total(w * ga * y)) / n_rows)
        dx = w * (g_c - rows(total(w * g_c)) / n_rows)
        return dx.to(x.dtype), None, None, None, None, None


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
    total, rows = _per_graph(graph_id, num_graphs, acc)
    n = torch.clamp(total(w), min=1.0)                    # [G, 1]
    mean = total(xa * w) / n                              # [G, C]
    centered = (xa - rows(mean)) * w
    var = total(centered * centered) / n
    return (centered * rows((var + eps) ** -0.5)).to(x.dtype)


def masked_instance_norm_kernel(x, num_valid, eps=1e-5, graph_id=None,
                                num_graphs=1):
    """Launch ops/cuda/instance_norm.cu on the current stream:
    `masked_instance_norm_f32` for one graph (graph_id None, rows [0,
    num_valid)), `masked_instance_norm_multigraph_f32` for `num_graphs`
    graphs, graph g's valid rows the run of graph_id == g below num_valid.
    graph_id must be non-decreasing with pad rows = num_graphs (the kernel
    traps otherwise). Counts `.launches` (one graph) and
    `.multigraph_launches`. Raises on a tensor it does not take or a failed
    launch; it never falls back to the plain version."""
    dev = x.device
    _cuda.check_tensor("x", x, torch.float32, 2, dev)
    v, c = x.shape
    if graph_id is not None:
        _cuda.check_tensor("graph_id", graph_id, torch.int32, 1, dev)
        if graph_id.shape[0] != v:
            raise ValueError(f"graph_id of {graph_id.shape[0]} rows for {v} "
                             "rows")
    if int(num_graphs) < 1 or (graph_id is None and num_graphs != 1):
        raise ValueError(f"num_graphs {num_graphs} with graph_id "
                         f"{'given' if graph_id is not None else 'None'}")
    nv = torch.as_tensor(num_valid, dtype=torch.int32, device=dev)
    if nv.dim() != 0:
        raise ValueError(f"num_valid must be a scalar, got shape "
                         f"{tuple(nv.shape)}")
    lib = _cuda.library("instance_norm")
    scratch = torch.empty(
        lib.masked_instance_norm_f32_scratch_floats(v, c, int(num_graphs)),
        dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    if graph_id is None:
        name = "masked_instance_norm_f32"
        rc = lib.masked_instance_norm_f32(
            x.data_ptr(), nv.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            v, c, float(eps), dev.index, _cuda.stream_of(dev))
    else:
        name = "masked_instance_norm_multigraph_f32"
        rc = lib.masked_instance_norm_multigraph_f32(
            x.data_ptr(), nv.data_ptr(), graph_id.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), v, c, int(num_graphs), float(eps), dev.index,
            _cuda.stream_of(dev))
    _cuda.check_status(lib, name, rc)
    if graph_id is None:
        masked_instance_norm_kernel.launches += 1
    else:
        masked_instance_norm_kernel.multigraph_launches += 1
    return out


masked_instance_norm_kernel.launches = 0
masked_instance_norm_kernel.multigraph_launches = 0
