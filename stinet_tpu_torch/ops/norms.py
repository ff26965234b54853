"""Masked per-graph instance norm, and the graph and batch norms' statistics.

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
from stinet_tpu_torch.utils.profiling import span


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
        if impl is None and torch.compiler.is_exporting():
            from stinet_tpu_torch.ops import library
            return library.masked_instance_norm(
                x, graph_id, num_graphs,
                torch.as_tensor(num_valid, device=x.device), eps)
        if not _cuda.use_kernel(x, impl):
            return masked_instance_norm_plain(x, graph_id, num_graphs,
                                              num_valid, eps)
        return masked_instance_norm_kernel(
            x, num_valid, eps, graph_id if num_graphs > 1 else None,
            num_graphs)

    @staticmethod
    def backward(ctx, g):
        # the first read of a checkpointed block's saved tensors reruns
        # its forward: the span opens after it, so that the rerun's ops
        # are not counted as this backward's
        x, num_valid, graph_id = ctx.saved_tensors
        with span("op.k2.backward"):
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


def masked_graph_norm(x, graph_id, num_graphs, num_valid, weight, bias,
                      mean_scale, eps=1e-5):
    """GraphNorm with a learned mean scale a (stinet_tpu/ops/norms.py:
    107-133): out = weight * (x - a*mean) / sqrt(E[(x - a*mean)^2] + eps)
    + bias per graph and channel over the valid rows. The variance is the
    UNcentered second moment of x - a*mean, as in the reference. Pad rows
    are 0. Plain torch ops (XLA in JAX); autograd gives the gradient."""
    acc = torch.promote_types(x.dtype, torch.float32)
    w = _valid_weight(x, num_valid)
    xa = x.to(acc)
    total, rows = _per_graph(graph_id, num_graphs, acc)
    n = torch.clamp(total(w), min=1.0)
    mean = total(xa * w) / n
    out = (xa - rows(mean) * mean_scale) * w
    var = total(out * out) / n
    out = out * rows((var + eps) ** -0.5)
    return ((weight * out + bias) * w).to(x.dtype)


def masked_batch_norm_stats(x, num_valid):
    """(mean [C], biased variance [C]) over every valid row, whatever graph
    it is in (PyG's BatchNorm normalizes over the whole node dimension;
    stinet_tpu/ops/norms.py:136-144). Plain torch ops."""
    w = _valid_weight(x, num_valid).to(x.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (x * w).sum(0) / n
    centered = (x - mean) * w
    return mean, (centered * centered).sum(0) / n


# The kernel's layout (ops/cuda/instance_norm.cu keeps the same numbers):
# the rows are cut into chunks of CHUNK_ROWS_SMALL, or CHUNK_ROWS_LARGE when
# x has more than LARGE_FROM_ROWS rows; a block sums TILE_COLS columns of a
# chunk; the merge has 32 lanes with 16-byte loads (C % 4 == 0) and 8
# without, shared among min(G, 8) graphs at a time.
CHUNK_ROWS_SMALL, CHUNK_ROWS_LARGE, LARGE_FROM_ROWS = 256, 512, 32768
TILE_COLS = 32
MAX_COL_TILES = 4096    # ticket counters kept per device and stream


def _chunk_rows(num_rows: int) -> int:
    """Rows per chunk of the kernel's statistics pass for x of `num_rows`
    (padded) rows."""
    return CHUNK_ROWS_SMALL if num_rows <= LARGE_FROM_ROWS else CHUNK_ROWS_LARGE


def scratch_floats(num_rows: int, channels: int, num_graphs: int) -> int:
    """Floats of scratch the kernel needs for `num_graphs` graphs of
    [num_rows, channels]: a (sum, M2) pair per slot and column (the part of
    chunk k in graph g has slot k + g, so chunks + G slots), mean and
    inv_std per graph and column, and G + 1 run starts (int32) per tile of
    32 columns."""
    slots = -(-num_rows // _chunk_rows(num_rows)) + num_graphs
    tiles = -(-channels // TILE_COLS)
    return (2 * slots * channels + 2 * num_graphs * channels
            + tiles * (num_graphs + 1))


def _merge_lanes(channels: int, num_graphs: int) -> int:
    """Lanes that merge one graph's partials in the kernel: 32 with 16-byte
    loads (8 without, which the kernel also takes when x is not 16-byte
    aligned; the emulation assumes it is), shared among the largest power
    of two of graphs that is at most min(num_graphs, 8)."""
    side_by_side = 8 if num_graphs >= 8 else 4 if num_graphs >= 4 else \
        2 if num_graphs >= 2 else 1
    return (32 if channels % 4 == 0 else 8) // side_by_side


def _lane_sum(terms, lanes):
    """Sum `terms` as the kernel's merge does: `lanes` partial sums, lane j
    over terms j, j + lanes, ... in order, then the lanes in order."""
    total = torch.zeros_like(terms[0])
    for j in range(lanes):
        lane = torch.zeros_like(terms[0])
        for term in terms[j::lanes]:
            lane = lane + term
        total = total + lane
    return total


def masked_instance_norm_chunked(x, graph_id, num_graphs, num_valid,
                                 eps=1e-5):
    """Plain emulation of the kernel's statistics, for tests only: no path
    calls it. The rows [0, num_valid) are cut into the kernel's chunks; the
    part of a chunk that lies in graph g gives (n_k, sum_k, M2_k) with
    M2_k = sum (x - sum_k / n_k)^2, and a graph's parts merge over the
    kernel's merge lanes by Chan's formula,

        mean = sum_k sum_k / n,
        var  = (sum_k M2_k + sum_k n_k (sum_k / n_k - mean)^2) / n,

    which is the centered variance in exact arithmetic. graph_id must be
    non-decreasing with pad rows = num_graphs (ignored for one graph, whose
    rows are [0, num_valid))."""
    v = x.shape[0]
    chunk = _chunk_rows(v)
    lanes = _merge_lanes(x.shape[1], num_graphs)
    nv = min(max(int(num_valid), 0), v)
    xa = x.to(torch.float32)
    out = torch.zeros_like(xa)
    if num_graphs == 1:
        starts = [0, nv]
    else:
        starts = torch.searchsorted(
            graph_id[:nv].contiguous(),
            torch.arange(num_graphs + 1, dtype=graph_id.dtype,
                         device=graph_id.device)).tolist()
    for g in range(num_graphs):
        b, e = starts[g], starts[g + 1]
        if b == e:
            continue
        parts = []
        for k in range(b // chunk, (e - 1) // chunk + 1):
            rows = xa[max(k * chunk, b):min((k + 1) * chunk, e)]
            n_k = float(rows.shape[0])
            sum_k = rows.sum(0)
            d = rows - sum_k / n_k
            parts.append((n_k, sum_k, (d * d).sum(0)))
        n = float(e - b)
        mean = _lane_sum([s for _, s, _ in parts], lanes) / n
        var = _lane_sum([m2 + n_k * (s / n_k - mean) ** 2
                         for n_k, s, m2 in parts], lanes) / n
        out[b:e] = (xa[b:e] - mean) * (1.0 / torch.sqrt(var + eps))
    return out.to(x.dtype)


def _tickets(dev, stream):
    """The zeroed ticket counters of (device, stream), MAX_COL_TILES uint32:
    the statistics launch counts its finished blocks there and leaves them
    0. Kept across calls (the per-call scratch is not zeroed); calls on one
    stream run in order, so one buffer a stream is enough."""
    key = (dev.index, stream)
    buf = _TICKETS.get(key)
    if buf is None:
        buf = _TICKETS[key] = torch.zeros(MAX_COL_TILES, dtype=torch.int32,
                                          device=dev)
    return buf


_TICKETS = {}


def masked_instance_norm_kernel(x, num_valid, eps=1e-5, graph_id=None,
                                num_graphs=1):
    """Launch ops/cuda/instance_norm.cu on the current stream:
    `masked_instance_norm_f32` for one graph (graph_id None, rows [0,
    num_valid)), `masked_instance_norm_multigraph_f32` for `num_graphs`
    graphs, graph g's valid rows the run of graph_id == g below num_valid.
    Either is two device launches: the statistics, then the normalization.
    graph_id must be non-decreasing with pad rows = num_graphs (the kernel
    traps otherwise). Counts `.launches` (one graph) and
    `.multigraph_launches`. Raises on a tensor it does not take or a failed
    launch; it never falls back to the plain version."""
    dev = x.device
    _cuda.check_tensor("x", x, torch.float32, 2, dev)
    v, c = x.shape
    num_graphs = int(num_graphs)
    if graph_id is not None:
        _cuda.check_tensor("graph_id", graph_id, torch.int32, 1, dev)
        if graph_id.shape[0] != v:
            raise ValueError(f"graph_id of {graph_id.shape[0]} rows for {v} "
                             "rows")
    if num_graphs < 1 or (graph_id is None and num_graphs != 1):
        raise ValueError(f"num_graphs {num_graphs} with graph_id "
                         f"{'given' if graph_id is not None else 'None'}")
    if c > MAX_COL_TILES * TILE_COLS:
        raise ValueError(f"{c} channels: the kernel takes at most "
                         f"{MAX_COL_TILES * TILE_COLS}")
    # the graph carries its count as a 0-d int32 tensor on the device
    if (isinstance(num_valid, torch.Tensor) and num_valid.device == dev
            and num_valid.dtype == torch.int32):
        nv = num_valid
    else:
        nv = torch.as_tensor(num_valid, dtype=torch.int32, device=dev)
    if nv.dim() != 0:
        raise ValueError(f"num_valid must be a scalar, got shape "
                         f"{tuple(nv.shape)}")
    lib = _cuda.library("instance_norm")
    stream = _cuda.stream_of(dev)
    size = scratch_floats(v, c, num_graphs)
    scratch = torch.empty(size, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    tickets = _tickets(dev, stream)
    if graph_id is None:
        name = "masked_instance_norm_f32"
        rc = lib.masked_instance_norm_f32(
            x.data_ptr(), nv.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            size, tickets.data_ptr(), v, c, float(eps), dev.index, stream)
    else:
        name = "masked_instance_norm_multigraph_f32"
        rc = lib.masked_instance_norm_multigraph_f32(
            x.data_ptr(), nv.data_ptr(), graph_id.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), size, tickets.data_ptr(), v, c, num_graphs,
            float(eps), dev.index, stream)
    _cuda.check_status(lib, name, rc)
    if graph_id is None:
        masked_instance_norm_kernel.launches += 1
    else:
        masked_instance_norm_kernel.multigraph_launches += 1
    return out


masked_instance_norm_kernel.launches = 0
masked_instance_norm_kernel.multigraph_launches = 0
