"""ELL (padded neighbour table) message passing and children-table pooling.

PyTorch counterpart of `stinet_tpu/ops/ell.py`. Graph builders emit, beside
the COO edge list, a neighbour table and its reverse

  nbr     [V_pad, D]     — for receiver v, slot d: sender id (pad -> trash)
  rev_dst [V_pad, D_out] — for sender s, slot j: receiver of its j-th edge

and the EdgeConv message sum runs over the slot axis as row gathers with no
scatter. Its gradient is gathers too:

  dp[v] = sum_{d < deg[v]} g[v] * step(p[v] + q[nbr[v, d]])
  dq[s] = sum_{j < deg_out[s]} g[r] * step(p[r] + q[s]),  r = rev_dst[s, j]

On a CUDA tensor each of the three launches a hand-written kernel
(`ops/cuda/ell_edge_conv.cu`), in f32 or bf16; on a CPU tensor, or with
impl="plain", it runs the plain torch slot loop beside it. Both do the
arithmetic of the JAX code: p + q in the working dtype, compare and relu in
f32, f32 accumulation in slot order, one rounding to the working dtype.

Children-table pooling: the trace map (fine -> coarse) induces a children
table (coarse -> its fine vertices). Pooling is a gather + reduce over child
slots, unpooling a trace gather, and their gradients are gathers as well
(max routes to the lowest achieving child slot, as torch_scatter's
scatter_max routes to one argmax).
"""
import ctypes
import functools
from typing import NamedTuple

import torch

from stinet_tpu_torch.ops import _cuda


def ell_edge_conv_sum(p, q, nbr, deg, rev_dst=None, out_degree=None,
                      impl=None):
    """out[v] = sum_{d < deg[v]} relu(p[v] + q[nbr[v, d]]).

    p, q: [V, H] f32 or bf16; nbr: [V, D] int32 (every slot a valid row of
    q, pad slots at the trash row); deg: [V] f32 count of ELL-resident
    edges. Differentiable in p and q; the backward needs `rev_dst` and
    `out_degree` ([V] f32). Callers divide by the TOTAL degree (after adding
    any COO spill) for mean aggregation."""
    return _EllEdgeConvSum.apply(p, q, nbr, deg, rev_dst, out_degree, impl)


class _EllEdgeConvSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, q, nbr, deg, rev_dst, out_degree, impl):
        ctx.impl = impl
        ctx.save_for_backward(p, q, nbr, deg, rev_dst, out_degree)
        if impl is None and torch.compiler.is_exporting():
            from stinet_tpu_torch.ops import library
            return library.ell_edge_conv_sum(p, q, nbr, deg)
        if _cuda.use_kernel(p, impl):
            return ell_edge_conv_sum_kernel(p, q, nbr, deg)
        return ell_edge_conv_sum_plain(p, q, nbr, deg)

    @staticmethod
    def backward(ctx, g):
        dp, dq = ell_edge_conv_grads(*ctx.saved_tensors, g, ctx.impl,
                                     ctx.needs_input_grad[:2])
        return dp, dq, None, None, None, None, None


def ell_edge_conv_grads(p, q, nbr, deg, rev_dst, out_degree, g, impl=None,
                        needs=(True, True)):
    """(dp, dq) of the relu slot sum for the cotangent g, each a kernel on
    a CUDA tensor (None where `needs` says the gradient is not wanted).
    The backward of ell_edge_conv_sum and of the f32 windowed sum
    (ops/windowed.py), as JAX's f32 windowed VJP reuses ops/ell.py's."""
    g = g.contiguous()
    dp = dq = None
    if needs[0]:
        dp = (ell_edge_conv_dp_kernel(p, q, nbr, deg, g)
              if _cuda.use_kernel(p, impl)
              else ell_edge_conv_dp_plain(p, q, nbr, deg, g))
    if needs[1]:
        if rev_dst is None or out_degree is None:
            raise ValueError("the gradient in q needs the edge set's "
                             "rev_dst and out_degree tables")
        dq = (ell_edge_conv_dq_kernel(q, g, p, rev_dst, out_degree)
              if _cuda.use_kernel(q, impl)
              else ell_edge_conv_dq_plain(q, g, p, rev_dst, out_degree))
    return dp, dq


def _acc_dtype(t):
    return torch.promote_types(t.dtype, torch.float32)


def ell_edge_conv_sum_plain(p, q, nbr, deg):
    """Plain torch version: slots accumulated in f32 in order d=0..D-1, as
    stinet_tpu/ops/ell.py:_forward does, so the two agree bit for bit."""
    acc_dt = _acc_dtype(p)
    deg_i = deg.to(torch.int32)
    acc = torch.zeros(p.shape, dtype=acc_dt, device=p.device)
    zero = torch.zeros((), dtype=acc_dt, device=p.device)
    for d in range(nbr.shape[1]):
        m = torch.relu(p + q.index_select(0, nbr[:, d]))
        acc = acc + torch.where((d < deg_i)[:, None], m.to(acc_dt), zero)
    return acc.to(p.dtype)


def ell_edge_conv_dp_plain(p, q, nbr, deg, g):
    """dp[v] = sum_{d < deg[v]} g[v] * step(p[v] + q[nbr[v, d]]), the slot
    loop of stinet_tpu/ops/ell.py:_bwd_rule (f32 accumulation in slot
    order, so the two agree bit for bit)."""
    acc_dt = _acc_dtype(p)
    deg_i = deg.to(torch.int32)
    g32 = g.to(acc_dt)
    acc = torch.zeros(p.shape, dtype=acc_dt, device=p.device)
    zero = torch.zeros((), dtype=acc_dt, device=p.device)
    for d in range(nbr.shape[1]):
        mask = (p + q.index_select(0, nbr[:, d]) > 0).to(acc_dt)
        acc = acc + torch.where((d < deg_i)[:, None], g32 * mask, zero)
    return acc.to(p.dtype)


def ell_edge_conv_dq_plain(q, g, p, rev_dst, out_degree):
    """dq[s] = sum_{j < deg_out[s]} g[r] * step(p[r] + q[s]) with
    r = rev_dst[s, j], the sender-side slot loop of
    stinet_tpu/ops/ell.py:_bwd_rule."""
    acc_dt = _acc_dtype(q)
    deg_o = out_degree.to(torch.int32)
    acc = torch.zeros(q.shape, dtype=acc_dt, device=q.device)
    zero = torch.zeros((), dtype=acc_dt, device=q.device)
    for j in range(rev_dst.shape[1]):
        r = rev_dst[:, j]
        contrib = (g.index_select(0, r).to(acc_dt)
                   * (p.index_select(0, r) + q > 0).to(acc_dt))
        acc = acc + torch.where((j < deg_o)[:, None], contrib, zero)
    return acc.to(q.dtype)


_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_rows(names, tensors, dev):
    """Raise unless the [V, H] operands share one supported dtype and
    shape; returns the dtype's suffix of the C launchers."""
    dtype = tensors[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{names[0]}: the kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    for name, t in zip(names, tensors):
        _cuda.check_tensor(name, t, dtype, 2, dev)
        if t.shape != tensors[0].shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(tensors[0].shape)}")
    return _DTYPES[dtype]


def _check_table(idx, count, v, dev):
    _cuda.check_tensor("index table", idx, torch.int32, 2, dev)
    _cuda.check_tensor("degree", count, torch.float32, 1, dev)
    if idx.shape[0] != v or count.shape[0] != v:
        raise ValueError(f"tables of {idx.shape[0]} / {count.shape[0]} rows "
                         f"for {v} rows of features")


# The row kernels' layout (ops/cuda/ell_edge_conv.cu: ell_fwd_rows,
# ell_dp_rows, ell_dq_rows): threads of a block (stinet::kThreads) and
# 16-byte chunks a lane holds at most (kMaxChunks).
THREADS = 256
MAX_CHUNKS = 2
# The three sums of the row kernels, in the library's order (its `Kind`),
# and the chunks a lane holds in each one's default split, the fastest on
# the flagship's tables (sweep_k1.py): the forward 2 (4 chunks a lane ran
# slower than 2 chunks in each of two groups a row); dp and dq, which hold
# or gather one row more, 1 (bf16 H=512 in two groups a row, registers for
# 4 blocks an SM).
KINDS = ("sum", "dp", "dq")
KIND_CHUNKS = {"sum": 2, "dp": 1, "dq": 1}


class EllPlan(NamedTuple):
    """How a row kernel (the forward, dp or dq) covers [V, H] rows. A
    row's channels are cut into 16-byte chunks of 16 / elem_bytes channels
    (`row_chunks` of them; the last one stops at H). A group of `lanes`
    lanes owns a row, or one of `groups` parts of it, and each lane
    `chunks` chunks, which it keeps in registers through the whole slot
    loop; a warp holds 32 / lanes groups, a block of THREADS threads
    `groups_per_block`. `vector`: 16-byte loads and stores (H * elem_bytes
    a multiple of 16, aligned rows), else the same layout with element
    loads and stores."""
    v: int
    h: int
    elem_bytes: int
    vector: bool
    lanes: int
    chunks: int
    groups: int
    blocks: int

    @property
    def row_chunks(self) -> int:
        return -(-self.h * self.elem_bytes // 16)

    @property
    def chunk_channels(self) -> int:
        return 16 // self.elem_bytes

    @property
    def groups_per_block(self) -> int:
        return THREADS // self.lanes

    @property
    def rows_per_block(self) -> float:
        return self.groups_per_block / self.groups

    def chunk_of(self, block, thread, chunk):
        """(row, chunk of the row) that `thread` of `block` computes as its
        chunk number `chunk`: the kernel's arithmetic, on ints or integer
        arrays alike. A row >= v or a chunk >= row_chunks is computed by
        no one (the lane idles)."""
        group = block * self.groups_per_block + thread // self.lanes
        row, part = group // self.groups, group % self.groups
        return row, (part * self.chunks + chunk) * self.lanes \
            + thread % self.lanes


@functools.lru_cache(maxsize=256)
def ell_plan(v: int, h: int, dtype: torch.dtype, aligned: bool = True,
             groups: int = 0, kind: str = "sum") -> EllPlan:
    """The layout of one launch of the row kernel of `kind` ("sum" the
    forward, "dp", "dq") on [v, h] rows of `dtype`:

    - lanes: min(32, ceil(h * elem_bytes / 16)) rounded up to a power of
      two, so that a warp holds whole groups;
    - groups: as few parts a row as keep every lane at KIND_CHUNKS[kind]
      chunks or fewer (for the forward 1 up to 32 * 2 * 16 bytes of row: H
      = 256 f32, 512 bf16; for dp and dq half that), or `groups` when given
      (a split of the row's chunks across more or fewer groups, at most
      MAX_CHUNKS chunks a lane);
    - chunks: ceil(ceil(row_chunks / lanes) / groups);
    - blocks: ceil(v * groups / groups_per_block);
    - vector: h * elem_bytes a multiple of 16 and `aligned` rows.

    Raises ValueError for a `groups` that leaves a group without a chunk
    or a lane with more than MAX_CHUNKS, and for an unknown kind."""
    if kind not in KIND_CHUNKS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    es = dtype.itemsize
    row_chunks = max(1, -(-h * es // 16))
    lanes = 1 << (min(32, row_chunks) - 1).bit_length()
    per_lane = -(-row_chunks // lanes)
    groups = groups or -(-per_lane // KIND_CHUNKS[kind])
    chunks = -(-per_lane // groups)
    if chunks > MAX_CHUNKS or (groups - 1) * chunks >= per_lane:
        raise ValueError(f"{groups} groups for rows of {per_lane} chunks a "
                         "lane leave a group empty or a lane too many")
    return EllPlan(v, h, es, aligned and (h * es) % 16 == 0, lanes, chunks,
                   groups, -(-v * groups // (THREADS // lanes)))


def _plan_args(plan: EllPlan):
    return (plan.lanes, plan.chunks, plan.groups, plan.blocks,
            int(plan.vector))


def launcher_name(kind, dtype) -> str:
    """The C launcher of the row kernel of `kind` on rows of `dtype`."""
    stem = "sum_fwd" if kind == "sum" else kind
    return f"ell_edge_conv_{stem}_{_DTYPES[dtype]}"


@functools.cache
def _launcher(kind, dtype):
    """(C launcher, its name) of the row kernel of `kind` on rows of
    `dtype`, looked up once."""
    name = launcher_name(kind, dtype)
    return getattr(_cuda.library("ell_edge_conv"), name), name


# where each kind's launcher takes its row operands: p, q; p, q, g; q, g, p
_ROWS = {"sum": (0, 1), "dp": (0, 1, 4), "dq": (0, 1, 2)}


def _launch(kind, tensors, d, plan=None):
    """Launch the row kernel of `kind` on checked tensors, in the C
    launcher's order, on the current stream, with `plan`, by default
    `ell_plan`'s for their shape and alignment (out is a fresh allocation,
    so 16-byte aligned like every block the caching allocator hands out;
    the launcher checks it anyway); out is shaped as the first tensor.
    Raises on a failed launch; counts nothing."""
    first = tensors[0]
    ptrs = [t.data_ptr() for t in tensors]
    if plan is None:
        rows = 0
        for i in _ROWS[kind]:
            rows |= ptrs[i]
        plan = ell_plan(*first.shape, first.dtype, not rows & 15, 0, kind)
    fn, name = _launcher(kind, first.dtype)
    out = torch.empty_like(first)
    rc = fn(*ptrs, out.data_ptr(), plan.v, plan.h, d, *_plan_args(plan),
            first.device.index, _cuda.stream_of(first.device))
    if rc:
        _cuda.check_status(_cuda.library("ell_edge_conv"), name, rc)
    return out


def launch_sum(plan, p, q, nbr, deg):
    """Launch the forward of p's dtype with `plan` (from `ell_plan`) on the
    current stream, on checked tensors; returns out. Raises on a failed
    launch. Counts nothing: `ell_edge_conv_sum_kernel` does."""
    return _launch("sum", (p, q, nbr, deg), nbr.shape[1], plan)


def launch_dp(plan, p, q, nbr, deg, g):
    """dp with a plan from `ell_plan(..., kind="dp")`, as `launch_sum`."""
    return _launch("dp", (p, q, nbr, deg, g), nbr.shape[1], plan)


def launch_dq(plan, q, g, p, rev_dst, out_degree):
    """dq with a plan from `ell_plan(..., kind="dq")`, as `launch_sum`."""
    return _launch("dq", (q, g, p, rev_dst, out_degree), rev_dst.shape[1],
                   plan)


def ell_edge_conv_sum_kernel(p, q, nbr, deg):
    """Launch `ell_edge_conv_sum_fwd_{f32,bf16}` (ops/cuda/ell_edge_conv.cu)
    on the current stream with `ell_plan`'s layout. Raises on a tensor it
    does not take or a failed launch; it never falls back to the plain
    version."""
    dev = p.device
    _cuda.check_tensor("p", p, p.dtype, 2, dev)
    _cuda.check_tensor("q", q, p.dtype, 2, dev)
    if p.dtype not in _DTYPES:
        raise TypeError(f"p: the kernel takes float32 or bfloat16, got "
                        f"{p.dtype}")
    if q.shape[1] != p.shape[1]:
        raise ValueError(f"shape mismatch: p {tuple(p.shape)}, q "
                         f"{tuple(q.shape)}")
    _check_table(nbr, deg, p.shape[0], dev)
    out = _launch("sum", (p, q, nbr, deg), nbr.shape[1])
    ell_edge_conv_sum_kernel.launches += 1
    return out


ell_edge_conv_sum_kernel.launches = 0


def last_launch(kind: str = "sum") -> dict:
    """What the library's last launch of `kind` ran: lanes a group, chunks
    a lane, groups a row, blocks, threads a block, 16-byte loads or not."""
    lib = _cuda.library("ell_edge_conv")
    lib.ell_last_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.ell_last_launch.restype = None
    keys = ("lanes", "chunks", "groups", "blocks", "threads", "vector")
    out = (ctypes.c_int * len(keys))()
    lib.ell_last_launch(KINDS.index(kind), out)
    return dict(zip(keys, out))


def ell_edge_conv_dp_kernel(p, q, nbr, deg, g):
    """Launch `ell_edge_conv_dp_{f32,bf16}` (ops/cuda/ell_edge_conv.cu)
    with `ell_plan`'s "dp" layout: the receiver-side gradient, bit for bit
    `ell_edge_conv_dp_plain`. Raises as `ell_edge_conv_sum_kernel`."""
    _check_rows(("p", "q", "g"), (p, q, g), p.device)
    _check_table(nbr, deg, p.shape[0], p.device)
    out = _launch("dp", (p, q, nbr, deg, g), nbr.shape[1])
    ell_edge_conv_dp_kernel.launches += 1
    return out


ell_edge_conv_dp_kernel.launches = 0


def ell_edge_conv_dq_kernel(q, g, p, rev_dst, out_degree):
    """Launch `ell_edge_conv_dq_{f32,bf16}` (ops/cuda/ell_edge_conv.cu)
    with `ell_plan`'s "dq" layout: the sender-side gradient through
    `rev_dst`, bit for bit `ell_edge_conv_dq_plain`. Raises as
    `ell_edge_conv_sum_kernel`."""
    _check_rows(("q", "g", "p"), (q, g, p), q.device)
    _check_table(rev_dst, out_degree, q.shape[0], q.device)
    out = _launch("dq", (q, g, p, rev_dst, out_degree), rev_dst.shape[1])
    ell_edge_conv_dq_kernel.launches += 1
    return out


ell_edge_conv_dq_kernel.launches = 0


def _pool_sum(x, children, counts):
    """Child-slot sum in >= f32, slots in order."""
    cnt = counts.to(torch.int32)
    acc_dt = _acc_dtype(x)
    acc = torch.zeros((children.shape[0], x.shape[1]), dtype=acc_dt,
                      device=x.device)
    zero = torch.zeros((), dtype=acc_dt, device=x.device)
    for c in range(children.shape[1]):
        acc = acc + torch.where((c < cnt)[:, None],
                                x.index_select(0, children[:, c]).to(acc_dt),
                                zero)
    return acc


def ell_pool_mean(x, trace, children, counts):
    """Mean of each coarse vertex's children; empty rows give 0. The
    gradient is the gather g[trace] / count[trace]."""
    return _PoolMean.apply(x, trace, children, counts)


class _PoolMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, trace, children, counts):
        ctx.save_for_backward(trace, counts)
        s = _pool_sum(x, children, counts)
        return (s / torch.clamp(counts.to(s.dtype), min=1.0)[:, None]).to(
            x.dtype)

    @staticmethod
    def backward(ctx, g):
        trace, counts = ctx.saved_tensors
        inv = 1.0 / torch.clamp(counts, min=1.0)
        return ((g * inv[:, None]).index_select(0, trace).to(g.dtype),
                None, None, None)


def ell_pool_max(x, trace, children, counts):
    """Max of each coarse vertex's children; empty rows give 0. A later
    child replaces the running max only when strictly greater, so ties go
    to the lowest child slot, and the gradient of each (coarse row,
    feature) goes whole to that child (stinet_tpu/ops/ell.py:229-261)."""
    return _PoolMax.apply(x, trace, children, counts)


class _PoolMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, trace, children, counts):
        cnt = counts.to(torch.int32)
        neg = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
        acc = neg.expand(children.shape[0], x.shape[1])
        arg = torch.full(acc.shape, -1, dtype=torch.int32, device=x.device)
        for c in range(children.shape[1]):
            child = children[:, c]
            cand = torch.where((c < cnt)[:, None],
                               x.index_select(0, child), neg)
            better = cand > acc
            acc = torch.where(better, cand, acc)
            arg = torch.where(better, child[:, None], arg)
        ctx.save_for_backward(trace, arg)
        return torch.where((cnt > 0)[:, None], acc, acc.new_zeros(()))

    @staticmethod
    def backward(ctx, g):
        trace, arg = ctx.saved_tensors
        # fine row f takes the gradient iff it is THE recorded argmax of
        # its coarse row
        fine = torch.arange(trace.shape[0], dtype=torch.int32,
                            device=trace.device)
        routed = arg.index_select(0, trace) == fine[:, None]
        return (g.index_select(0, trace) * routed.to(g.dtype),
                None, None, None)


def ell_unpool(x, trace, children=None, counts=None):
    """out[f] = x[trace[f]]: every fine vertex copies its coarse row. With a
    children table the gradient is the child-slot sum (in f32, slot order);
    without one it is index_select's own scatter-add, as JAX's gather VJP
    is."""
    if children is None:
        return x.index_select(0, trace)
    return _Unpool.apply(x, trace, children, counts)


class _Unpool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, trace, children, counts):
        ctx.save_for_backward(children, counts)
        return x.index_select(0, trace)

    @staticmethod
    def backward(ctx, g):
        children, counts = ctx.saved_tensors
        return _pool_sum(g, children, counts).to(g.dtype), None, None, None
