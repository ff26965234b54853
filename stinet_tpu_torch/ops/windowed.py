"""Windowed EdgeConv message sums for bandwidth-ordered graphs.

PyTorch counterpart of `stinet_tpu/ops/pallas/onehot_gather.py` (K3a, K3b,
K3c and the custom VJPs K3d). On a graph whose ELL tables are banded,
|nbr[v, d] - v| <= halo on every live slot (graph/build.py with
windowed=True), the senders of a tile of T receivers all lie in one window
of rows [w0, w0 + W), W = min(T + 2*halo, V), and the reverse table is
banded the same way. The TPU kernels streamed that window into VMEM and
gathered from it with one-hot MXU matmuls; the CUDA kernels
(`ops/cuda/windowed_edge_conv.cu`) walk a strip of consecutive tiles per
block, one channel slice at a time, and keep the window in a ring in shared
memory that TMA copies fill ahead of the gathers. `window_plan` works out
that layout, here and nowhere else; the launchers only check it.

  relu: out[v] = sum_{d < deg[v]} relu(p[v] + q[nbr[v, d]])   (forward)
  step: out[v] = sum_{d < deg[v]} step(p[v] + q[nbr[v, d]])   (dp factor)
  dq:   out[s] = sum_{j < deg_out[s]} g[r] * step(p[r] + q[s]),
        r = rev_dst[s, j]

bf16 (K3a, K3c): inputs are cast to bf16; p + q is a bf16 add, compare and
relu run in f32, slots accumulate in f32 in slot order, and the output is
bf16. f32 (K3b, relu only): the same loop on f32 rows, bit for bit the f32
ELL sum of ops/ell.py; its backward is the ELL backward, as JAX's f32 VJP
reuses ops/ell.py's. The plain versions are the slot loops of ops/ell.py,
which is what the one-hot gather computes exactly; a CUDA tensor takes the
kernel, a CPU tensor (or impl="plain") the plain version.

Two epilogues take the torch ops that followed a sum into the kernel, with
their roundings: relu with `mean_degree`, the EdgeConv mean
(ops/ell.py:mean_scale_plain); step with `g`, K3d's dp = g * (step sum).
"""
import ctypes
import functools
import math
from typing import NamedTuple

import torch

from stinet_tpu_torch.ops import _cuda
from stinet_tpu_torch.ops.ell import (
    _check_mean, _check_rows, _check_table, ell_edge_conv_dq_plain,
    ell_edge_conv_grads, ell_edge_conv_sum_plain, mean_scale,
    mean_scale_plain)

_MODES = {"relu": 0, "step": 1}


def window_geometry(v: int, tile: int, halo: int):
    """(halo, W) of `_window_geometry` (onehot_gather.py:197-203): the halo
    rounded up to 32 and W = min(tile + 2*halo, V). Raises unless tile
    divides V."""
    if tile <= 0 or v % tile != 0:
        raise ValueError(f"tile {tile} must divide the row count {v}")
    halo = -(-int(halo) // 32) * 32
    return halo, min(tile + 2 * halo, v)


def default_tile(v: int) -> int:
    """256 rows when they divide V, else 128 (message_passing.py:141)."""
    return 256 if v % 256 == 0 else 128


# H100 limits the plan is sized for: the dynamic shared memory one block may
# take, the shared memory of an SM and what each resident block reserves of
# it, and the threads of a block (8 consumer warps and 1 producer warp).
MAX_BLOCK_SMEM = 232448
SM_SMEM = 233472
BLOCK_RESERVED_SMEM = 1024
CONSUMER_THREADS = 256
BLOCK_THREADS = CONSUMER_THREADS + 32
SLICES = (64, 32, 16, 8)     # channel slices a plan may take, widest first
# A slice is narrowed until this many blocks fit an SM: the kernels'
# __launch_bounds__ (kMinBlocks in windowed_edge_conv.cu) budget registers
# for as many, and no more are counted on.
TARGET_BLOCKS_PER_SM = 2
BARRIER_BYTES = 16           # a ring stage's "full" and "empty" mbarriers


class WindowPlan(NamedTuple):
    """How a windowed kernel walks its rows. A block takes `strip_tiles`
    consecutive tiles (the last strip fewer) of one channel slice of `cs`
    channels; the grid is (strips, ceil(H / cs)). The rows of the strip's
    windows stream through a ring of `ring` rows in stages of `sub` rows
    (one TMA box each): stage k holds rows [k*sub, (k+1)*sub) in ring slot
    (k - k_begin) % (ring / sub). While a tile computes, its whole clamped
    window is resident and the next rows are in flight. The operands of
    the block's own rows (p, or q for dq, the `slots` index columns and the
    counts) come in chunks of `buf_rows` rows through `bufs` buffers.
    `smem` is a block's dynamic shared memory: `arrays` rings, the
    buffers, the mbarriers."""
    v: int
    h: int
    tile: int
    halo: int      # rounded up to 32, as window_geometry does
    w: int         # window rows of a tile
    arrays: int    # staged arrays: 1 (q) or 2 (g and p)
    elem_bytes: int
    slots: int     # index columns D
    cs: int
    sub: int
    ring: int
    bufs: int
    buf_rows: int
    strip_tiles: int
    strips: int
    smem: int

    @property
    def slices(self) -> int:
        return -(-self.h // self.cs)

    def window_start(self, i: int) -> int:
        """w0 of tile i: clamp(i*tile - halo, 0, V - W)."""
        return min(max(i * self.tile - self.halo, 0), self.v - self.w)

    def strip_tiles_of(self, s: int) -> range:
        n = self.v // self.tile
        return range(s * self.strip_tiles, min((s + 1) * self.strip_tiles, n))

    def strip_stages(self, s: int) -> range:
        """The stages strip s loads, in order, each once."""
        tiles = self.strip_tiles_of(s)
        return range(self.window_start(tiles[0]) // self.sub,
                     (self.window_start(tiles[-1]) + self.w) // self.sub)

    def staged_bytes(self) -> int:
        """Bytes the rings take in by one call: every stage of every strip,
        channel slice and staged array once."""
        rows = sum(len(self.strip_stages(s)) for s in range(self.strips))
        return (rows * self.sub * self.slices * self.cs * self.elem_bytes
                * self.arrays)

    def own_row_bytes(self) -> int:
        """Bytes the buffers take in by one call: every row's own slice
        once, its indices and count once a slice."""
        return self.v * self.slices * (self.cs * self.elem_bytes
                                       + 4 * self.slots + 4)

    def per_tile_staged_bytes(self) -> int:
        """What a design that stages every tile's window anew copies:
        (V / tile) * W rows of each array."""
        return (self.v // self.tile) * self.w * self.h * self.elem_bytes \
            * self.arrays


def _round128(nbytes: int) -> int:
    return -(-nbytes // 128) * 128


def _smem(arrays, ring, cs, es, sub, bufs, buf_rows, slots):
    buffer = (_round128(buf_rows * cs * es) + _round128(buf_rows * slots * 4)
              + _round128(buf_rows * 4))
    return (arrays * ring * cs * es + bufs * buffer
            + BARRIER_BYTES * (ring // sub + bufs))


@functools.lru_cache(maxsize=256)
def window_plan(v: int, h: int, halo: int, tile: int, elem_bytes: int,
                arrays: int, sms: int, slots: int) -> WindowPlan:
    """The layout of one windowed launch (see `WindowPlan`); `slots` is the
    index table's column count D.

    - sub: gcd(tile, halo, 64) rows, so every clamped window starts and
      ends on a stage (w0 is a multiple of the rounded halo, of the tile or
      0, and W of both);
    - ring: the window and one tile of rows in flight, min(W + tile, V)
      rows, else W (no rows ahead);
    - buf_rows, bufs: own-row chunks of min(tile, 256) rows or fewer, two
      tiles of them in flight, fewer buffers, then shorter chunks, while
      they do not fit (a wide index table);
    - cs: the widest of SLICES (up to H rounded up to a power of two) at
      which TARGET_BLOCKS_PER_SM blocks fit an SM with the full ring, a
      tile of own rows buffered ahead and chunks no shorter than a pass of
      the consumer threads (16 bytes of channels a thread); else the widest
      that fits one block, with either ring and any buffering;
    - strips: as many as fill the card once, (sms * resident blocks) /
      slices, so a strip walks ceil(tiles / strips) tiles; a block counts
      as resident up to TARGET_BLOCKS_PER_SM, the registers' budget.

    Raises RuntimeError when no ring fits a block's shared memory even at
    8 channels; ValueError unless tile divides V."""
    halo, w = window_geometry(v, tile, halo)
    sub = math.gcd(math.gcd(tile, halo), 64)
    cap = max(SLICES[-1], 1 << max(h - 1, 0).bit_length())
    widths = [c for c in SLICES if c <= cap]
    rings = list(dict.fromkeys((min(w + tile, v), w)))
    target = SM_SMEM // TARGET_BLOCKS_PER_SM - BLOCK_RESERVED_SMEM

    def halvings(n, stop):
        out = []
        while n > stop and n % 2 == 0:
            out.append(n)
            n //= 2
        return out + [n]

    buffering = [(rows, bufs) for rows in halvings(min(tile, 256), 1)
                 if tile % rows == 0
                 for bufs in halvings(2 * (tile // rows), 2)]

    def smem(ring, cs, rows, bufs):
        return _smem(arrays, ring, cs, elem_bytes, sub, bufs, rows, slots)

    def keeps_busy(cs, rows, bufs):
        # a tile of own rows buffered ahead, a chunk no shorter than what
        # the consumer threads take in one pass (16 bytes a lane)
        per_pass = CONSUMER_THREADS * 16 // (cs * elem_bytes)
        return rows * bufs >= tile and rows >= min(per_pass, tile)

    # first: the full ring, TARGET_BLOCKS_PER_SM blocks an SM, busy
    # consumers; then whatever fits one block
    choice = next(
        ((ring, cs, rows, bufs) for limit, rs, busy in
         ((target, rings[:1], True), (MAX_BLOCK_SMEM, rings, False))
         for ring in rs for cs in widths for rows, bufs in buffering
         if (not busy or keeps_busy(cs, rows, bufs))
         and smem(ring, cs, rows, bufs) <= limit), None)
    if choice is None:
        raise RuntimeError(
            f"a window of {w} rows does not fit a block's shared memory "
            f"even at {SLICES[-1]} channels ({arrays} staged arrays)")
    ring, cs, buf_rows, bufs = choice
    nbytes = smem(ring, cs, buf_rows, bufs)
    resident = min(TARGET_BLOCKS_PER_SM,
                   SM_SMEM // (nbytes + BLOCK_RESERVED_SMEM))
    tiles = v // tile
    strips = min(tiles, max(1, sms * resident // -(-h // cs)))
    strip_tiles = -(-tiles // strips)
    return WindowPlan(v, h, tile, halo, w, arrays, elem_bytes, slots, cs,
                      sub, ring, bufs, buf_rows, strip_tiles,
                      -(-tiles // strip_tiles), nbytes)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_plan(rows: torch.Tensor, halo: int, tile: int, arrays: int,
                slots: int) -> WindowPlan:
    """`window_plan` for [V, H] `rows` on their card."""
    v, h = rows.shape
    return window_plan(v, h, halo, tile, rows.element_size(), arrays,
                       _sm_count(rows.device.index), slots)


def _plan_args(plan: WindowPlan):
    return (plan.tile, plan.halo, plan.w, plan.cs, plan.sub, plan.ring,
            plan.bufs, plan.buf_rows, plan.strip_tiles, plan.strips,
            plan.smem)


def last_launch() -> dict:
    """What the library's last windowed launch ran: grid, threads, shared
    memory, the plan's slice, stage, ring and buffer rows, and whether TMA
    or ordinary loads filled the ring."""
    lib = _cuda.library("windowed_edge_conv")
    lib.windowed_last_launch.argtypes = [ctypes.c_void_p]
    lib.windowed_last_launch.restype = None
    keys = ("strips", "slices", "threads", "smem", "cs", "sub", "ring",
            "bufs", "buf_rows", "strip_tiles", "tma")
    out = (ctypes.c_int * len(keys))()
    lib.windowed_last_launch(out)
    return dict(zip(keys, out))


def _check_mode(mode, mean_degree, g):
    if mode not in _MODES:
        raise ValueError(f"mode must be 'relu' or 'step', got {mode!r}")
    if (mean_degree is not None and mode != "relu") or (
            g is not None and mode != "step"):
        raise ValueError("mean_degree goes with mode 'relu', g with 'step'")


def windowed_edge_conv_sum(p, q, nbr, deg, halo, tile, mode="relu",
                           impl=None, mean_degree=None, g=None):
    """The relu (forward) or step (dp factor) slot sum over a banded
    window. p, q: [V, H] (cast to bf16); nbr: [V, D] int32; deg: [V] f32.
    Returns [V, H] bf16. With `mean_degree` ([V] f32, relu) the mean of
    ops/ell.py:mean_scale_plain; with `g` ([V, H], step, cast to bf16) K3d's
    dp, bf16(f32(g) * f32(step sum))."""
    p16, q16 = p.to(torch.bfloat16), q.to(torch.bfloat16)
    g16 = None if g is None else g.to(torch.bfloat16)
    if _cuda.use_kernel(p, impl):
        return windowed_edge_conv_sum_kernel(p16, q16, nbr, deg, halo, tile,
                                             mode, mean_degree, g16)
    return windowed_edge_conv_sum_plain(p16, q16, nbr, deg, mode,
                                        mean_degree, g16)


def windowed_edge_conv_sum_plain(p, q, nbr, deg, mode="relu",
                                 mean_degree=None, g=None):
    """The bf16 slot loop: relu mode is `ell_edge_conv_sum_plain` (with
    `mean_degree`, its mean), step mode counts the live slots with
    p + q > 0 (with `g`, times g in f32, rounded to bf16)."""
    _check_mode(mode, mean_degree, g)
    if mode == "relu":
        return ell_edge_conv_sum_plain(p, q, nbr, deg, mean_degree)
    deg_i = deg.to(torch.int32)
    acc = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    for d in range(nbr.shape[1]):
        m = (p + q.index_select(0, nbr[:, d]) > 0).to(torch.float32)
        acc = acc + torch.where((d < deg_i)[:, None], m, zero)
    out = acc.to(p.dtype)
    if g is None:
        return out
    return (g.to(torch.float32) * out.to(torch.float32)).to(p.dtype)


def windowed_dq(q, g, p, rev_dst, deg_out, halo, tile, impl=None):
    """dq of the windowed sum: the sender-side slot loop over the banded
    reverse table. q, g, p: [V, H] (cast to bf16). Returns [V, H] bf16."""
    q16, g16, p16 = (t.to(torch.bfloat16) for t in (q, g, p))
    if _cuda.use_kernel(q, impl):
        return windowed_dq_kernel(q16, g16, p16, rev_dst, deg_out, halo,
                                  tile)
    return ell_edge_conv_dq_plain(q16, g16, p16, rev_dst, deg_out)


def windowed_edge_conv_sum_f32(p, q, nbr, deg, halo, tile, impl=None,
                               mean_degree=None):
    """K3b: the relu slot sum over a banded window on f32 rows, bit for bit
    the f32 `ell_edge_conv_sum` (with `mean_degree`, its mean). p, q:
    [V, H] f32; nbr: [V, D] int32; deg: [V] f32. Returns [V, H] f32."""
    if _cuda.use_kernel(p, impl):
        return windowed_edge_conv_sum_f32_kernel(p, q, nbr, deg, halo, tile,
                                                 mean_degree)
    return ell_edge_conv_sum_plain(p, q, nbr, deg, mean_degree)


def _check(names, rows, idx, count, dev, dtype="bf16"):
    got = _check_rows(names, rows, dev)
    if got != dtype:
        raise TypeError(f"{names[0]}: this windowed kernel takes {dtype}, "
                        f"got {rows[0].dtype}")
    _check_table(idx, count, rows[0].shape[0], dev)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def launch_sum(plan, p, q, nbr, deg, mode="relu", mean_degree=None, g=None):
    """Launch the receiver kernel of p's dtype with `plan` on the current
    stream (checked tensors; `plan` from `window_plan`; `mean_degree` with
    relu, `g` with step on bf16 rows, or None); returns out. Raises on a
    failed launch. Counts nothing: the wrappers below do."""
    f32 = p.dtype == torch.float32
    name = ("windowed_edge_conv_sum_f32" if f32
            else "windowed_edge_conv_sum_bf16")
    out = torch.empty_like(p)
    lib = _cuda.library("windowed_edge_conv")
    args = [p.data_ptr(), q.data_ptr(), nbr.data_ptr(), deg.data_ptr(),
            _ptr(mean_degree), *([] if f32 else [_ptr(g)]), out.data_ptr(),
            plan.v, plan.h, nbr.shape[1], *_plan_args(plan)]
    rc = getattr(lib, name)(*args, *([] if f32 else [_MODES[mode]]),
                            p.device.index, _cuda.stream_of(p.device))
    _cuda.check_status(lib, name, rc)
    return out


def launch_dq(plan, q, g, p, rev_dst, deg_out):
    """Launch `windowed_dq_bf16` with `plan`, as `launch_sum`."""
    out = torch.empty_like(q)
    lib = _cuda.library("windowed_edge_conv")
    rc = lib.windowed_dq_bf16(
        q.data_ptr(), g.data_ptr(), p.data_ptr(), rev_dst.data_ptr(),
        deg_out.data_ptr(), out.data_ptr(), plan.v, plan.h,
        rev_dst.shape[1], *_plan_args(plan), q.device.index,
        _cuda.stream_of(q.device))
    _cuda.check_status(lib, "windowed_dq_bf16", rc)
    return out


def windowed_edge_conv_sum_kernel(p, q, nbr, deg, halo, tile, mode="relu",
                                  mean_degree=None, g=None):
    """Launch `windowed_edge_conv_sum_bf16`
    (ops/cuda/windowed_edge_conv.cu) on the current stream with
    `window_plan`'s layout, with the epilogue of `mean_degree` (relu) or
    `g` (step) where given; every live slot of `nbr` must lie in its tile's
    window. Raises on a tensor it does not take, a window that fits no
    block, or a failed launch; never falls back."""
    _check_mode(mode, mean_degree, g)
    _check(("p", "q") + (() if g is None else ("g",)),
           (p, q) + (() if g is None else (g,)), nbr, deg, p.device)
    _check_mean(mean_degree, p.shape[0], p.device)
    out = launch_sum(launch_plan(q, halo, tile, 1, nbr.shape[1]), p, q, nbr,
                     deg, mode, mean_degree, g)
    windowed_edge_conv_sum_kernel.launches += 1
    return out


windowed_edge_conv_sum_kernel.launches = 0


def windowed_edge_conv_sum_f32_kernel(p, q, nbr, deg, halo, tile,
                                      mean_degree=None):
    """Launch `windowed_edge_conv_sum_f32` (ops/cuda/windowed_edge_conv.cu)
    as `windowed_edge_conv_sum_kernel` does (relu, with `mean_degree` the
    mean)."""
    _check(("p", "q"), (p, q), nbr, deg, p.device, "f32")
    _check_mean(mean_degree, p.shape[0], p.device)
    out = launch_sum(launch_plan(q, halo, tile, 1, nbr.shape[1]), p, q, nbr,
                     deg, "relu", mean_degree)
    windowed_edge_conv_sum_f32_kernel.launches += 1
    return out


windowed_edge_conv_sum_f32_kernel.launches = 0


def windowed_dq_kernel(q, g, p, rev_dst, deg_out, halo, tile):
    """Launch `windowed_dq_bf16` (ops/cuda/windowed_edge_conv.cu) as
    `windowed_edge_conv_sum_kernel` does; every live slot of `rev_dst` must
    lie in its tile's window."""
    _check(("q", "g", "p"), (q, g, p), rev_dst, deg_out, q.device)
    out = launch_dq(launch_plan(g, halo, tile, 2, rev_dst.shape[1]), q, g,
                    p, rev_dst, deg_out)
    windowed_dq_kernel.launches += 1
    return out


windowed_dq_kernel.launches = 0


def band_violations(idx, count, halo, tile):
    """Number of live slots (slot < count) of a [V, D] table that fall
    outside their tile's window: 0 is what the kernels need."""
    v = idx.shape[0]
    halo, w = window_geometry(v, tile, halo)
    rows = torch.arange(v, device=idx.device)
    w0 = torch.clamp((rows // tile) * tile - halo, 0, v - w)
    live = (torch.arange(idx.shape[1], device=idx.device)[None, :]
            < count.to(torch.int64)[:, None])
    local = idx.to(torch.int64) - w0[:, None]
    return int((live & ((local < 0) | (local >= w))).sum())


class WindowedEdgeConvSum(torch.autograd.Function):
    """K3d: the windowed forward with its windowed backward
    (onehot_gather.py:319-349). dp = g * (step sum, in bf16 as the TPU
    kernel returns it), taken in the step sum's epilogue; dq from the
    banded reverse table. With `mean_degree` the forward is the mean
    (ops/ell.py:mean_scale_plain) and the backward scales g first."""

    @staticmethod
    def forward(ctx, p, q, nbr, rev_dst, deg_in, deg_out, halo, tile,
                impl=None, mean_degree=None):
        ctx.halo, ctx.tile, ctx.impl = halo, tile, impl
        ctx.save_for_backward(p, q, nbr, rev_dst, deg_in, deg_out,
                              mean_degree)
        if impl is None and torch.compiler.is_exporting():
            from stinet_tpu_torch.ops import library
            out = library.windowed_edge_conv_sum(
                p, q, nbr, deg_in, halo, tile).to(p.dtype)
            return (out if mean_degree is None
                    else mean_scale_plain(out, mean_degree))
        return windowed_edge_conv_sum(p, q, nbr, deg_in, halo, tile, "relu",
                                      impl, mean_degree=mean_degree
                                      ).to(p.dtype)

    @staticmethod
    def backward(ctx, g):
        p, q, nbr, rev_dst, deg_in, deg_out, mean_degree = ctx.saved_tensors
        g = g.contiguous()
        if mean_degree is not None:
            g = mean_scale(g, mean_degree, ctx.impl)
        dp = windowed_edge_conv_sum(p, q, nbr, deg_in, ctx.halo, ctx.tile,
                                    "step", ctx.impl, g=g).to(p.dtype)
        dq = windowed_dq(q, g, p, rev_dst, deg_out, ctx.halo, ctx.tile,
                         ctx.impl).to(q.dtype)
        return dp, dq, None, None, None, None, None, None, None, None


class WindowedEdgeConvSumF32(torch.autograd.Function):
    """The f32 K3d (onehot_gather.py:352-375): K3b forward, and the ELL
    backward (dp, and dq through rev_dst), each a kernel on a CUDA
    tensor; `mean_degree` as in `WindowedEdgeConvSum`."""

    @staticmethod
    def forward(ctx, p, q, nbr, rev_dst, deg_in, deg_out, halo, tile,
                impl=None, mean_degree=None):
        ctx.impl = impl
        ctx.save_for_backward(p, q, nbr, deg_in, rev_dst, deg_out,
                              mean_degree)
        if impl is None and torch.compiler.is_exporting():
            from stinet_tpu_torch.ops import library
            out = library.windowed_edge_conv_sum_f32(p, q, nbr, deg_in, halo,
                                                     tile)
            return (out if mean_degree is None
                    else mean_scale_plain(out, mean_degree))
        return windowed_edge_conv_sum_f32(p, q, nbr, deg_in, halo, tile, impl,
                                          mean_degree)

    @staticmethod
    def backward(ctx, g):
        *saved, mean_degree = ctx.saved_tensors
        if mean_degree is not None:
            g = mean_scale(g, mean_degree, ctx.impl)
        dp, dq = ell_edge_conv_grads(*saved, g, ctx.impl,
                                     ctx.needs_input_grad[:2])
        return dp, dq, None, None, None, None, None, None, None, None
