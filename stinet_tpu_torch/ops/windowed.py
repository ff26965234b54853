"""Windowed EdgeConv message sums for bandwidth-ordered graphs.

PyTorch counterpart of `stinet_tpu/ops/pallas/onehot_gather.py` (K3a, K3b,
K3c and the custom VJPs K3d). On a graph whose ELL tables are banded,
|nbr[v, d] - v| <= halo on every live slot (graph/build.py with
windowed=True), the senders of a tile of T receivers all lie in one window
of rows [w0, w0 + W), W = min(T + 2*halo, V), and the reverse table is
banded the same way. The TPU kernels streamed that window into VMEM and
gathered from it with one-hot MXU matmuls; the CUDA kernels
(`ops/cuda/windowed_edge_conv.cu`) stage it in shared memory, one channel
slice at a time, and gather from there.

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
"""
import torch

from stinet_tpu_torch.ops import _cuda
from stinet_tpu_torch.ops.ell import (
    _check_rows, _check_table, ell_edge_conv_dq_plain, ell_edge_conv_grads,
    ell_edge_conv_sum_plain)

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


def windowed_edge_conv_sum(p, q, nbr, deg, halo, tile, mode="relu",
                           impl=None):
    """The relu (forward) or step (dp factor) slot sum over a banded
    window. p, q: [V, H] (cast to bf16); nbr: [V, D] int32; deg: [V] f32.
    Returns [V, H] bf16."""
    if mode not in _MODES:
        raise ValueError(f"mode must be 'relu' or 'step', got {mode!r}")
    p16, q16 = p.to(torch.bfloat16), q.to(torch.bfloat16)
    if _cuda.use_kernel(p, impl):
        return windowed_edge_conv_sum_kernel(p16, q16, nbr, deg, halo, tile,
                                             mode)
    return windowed_edge_conv_sum_plain(p16, q16, nbr, deg, mode)


def windowed_edge_conv_sum_plain(p, q, nbr, deg, mode="relu"):
    """The bf16 slot loop: relu mode is `ell_edge_conv_sum_plain`, step
    mode counts the live slots with p + q > 0."""
    if mode == "relu":
        return ell_edge_conv_sum_plain(p, q, nbr, deg)
    deg_i = deg.to(torch.int32)
    acc = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    for d in range(nbr.shape[1]):
        m = (p + q.index_select(0, nbr[:, d]) > 0).to(torch.float32)
        acc = acc + torch.where((d < deg_i)[:, None], m, zero)
    return acc.to(p.dtype)


def windowed_dq(q, g, p, rev_dst, deg_out, halo, tile, impl=None):
    """dq of the windowed sum: the sender-side slot loop over the banded
    reverse table. q, g, p: [V, H] (cast to bf16). Returns [V, H] bf16."""
    q16, g16, p16 = (t.to(torch.bfloat16) for t in (q, g, p))
    if _cuda.use_kernel(q, impl):
        return windowed_dq_kernel(q16, g16, p16, rev_dst, deg_out, halo,
                                  tile)
    return ell_edge_conv_dq_plain(q16, g16, p16, rev_dst, deg_out)


def windowed_edge_conv_sum_f32(p, q, nbr, deg, halo, tile, impl=None):
    """K3b: the relu slot sum over a banded window on f32 rows, bit for bit
    the f32 `ell_edge_conv_sum`. p, q: [V, H] f32; nbr: [V, D] int32; deg:
    [V] f32. Returns [V, H] f32."""
    if _cuda.use_kernel(p, impl):
        return windowed_edge_conv_sum_f32_kernel(p, q, nbr, deg, halo, tile)
    return ell_edge_conv_sum_plain(p, q, nbr, deg)


def _check(names, rows, idx, count, dev, dtype="bf16"):
    got = _check_rows(names, rows, dev)
    if got != dtype:
        raise TypeError(f"{names[0]}: this windowed kernel takes {dtype}, "
                        f"got {rows[0].dtype}")
    _check_table(idx, count, rows[0].shape[0], dev)


def windowed_edge_conv_sum_kernel(p, q, nbr, deg, halo, tile, mode="relu"):
    """Launch `windowed_edge_conv_sum_bf16`
    (ops/cuda/windowed_edge_conv.cu) on the current stream; every live
    slot of `nbr` must lie in its tile's window. Raises on a tensor it does
    not take or a failed launch; never falls back."""
    dev = p.device
    _check(("p", "q"), (p, q), nbr, deg, dev)
    v, h = p.shape
    halo, w = window_geometry(v, tile, halo)
    out = torch.empty_like(p)
    lib = _cuda.library("windowed_edge_conv")
    rc = lib.windowed_edge_conv_sum_bf16(
        p.data_ptr(), q.data_ptr(), nbr.data_ptr(), deg.data_ptr(),
        out.data_ptr(), v, h, nbr.shape[1], tile, halo, w, _MODES[mode],
        dev.index, _cuda.stream_of(dev))
    _cuda.check_status(lib, "windowed_edge_conv_sum_bf16", rc)
    windowed_edge_conv_sum_kernel.launches += 1
    return out


windowed_edge_conv_sum_kernel.launches = 0


def windowed_edge_conv_sum_f32_kernel(p, q, nbr, deg, halo, tile):
    """Launch `windowed_edge_conv_sum_f32` (ops/cuda/windowed_edge_conv.cu)
    on the current stream; every live slot of `nbr` must lie in its tile's
    window. Raises on a tensor it does not take or a failed launch; never
    falls back."""
    dev = p.device
    _check(("p", "q"), (p, q), nbr, deg, dev, "f32")
    v, h = p.shape
    halo, w = window_geometry(v, tile, halo)
    out = torch.empty_like(p)
    lib = _cuda.library("windowed_edge_conv")
    rc = lib.windowed_edge_conv_sum_f32(
        p.data_ptr(), q.data_ptr(), nbr.data_ptr(), deg.data_ptr(),
        out.data_ptr(), v, h, nbr.shape[1], tile, halo, w, dev.index,
        _cuda.stream_of(dev))
    _cuda.check_status(lib, "windowed_edge_conv_sum_f32", rc)
    windowed_edge_conv_sum_f32_kernel.launches += 1
    return out


windowed_edge_conv_sum_f32_kernel.launches = 0


def windowed_dq_kernel(q, g, p, rev_dst, deg_out, halo, tile):
    """Launch `windowed_dq_bf16` (ops/cuda/windowed_edge_conv.cu) on the
    current stream; every live slot of `rev_dst` must lie in its tile's
    window."""
    dev = q.device
    _check(("q", "g", "p"), (q, g, p), rev_dst, deg_out, dev)
    v, h = q.shape
    halo, w = window_geometry(v, tile, halo)
    out = torch.empty_like(q)
    lib = _cuda.library("windowed_edge_conv")
    rc = lib.windowed_dq_bf16(
        q.data_ptr(), g.data_ptr(), p.data_ptr(), rev_dst.data_ptr(),
        deg_out.data_ptr(), out.data_ptr(), v, h, rev_dst.shape[1], tile,
        halo, w, dev.index, _cuda.stream_of(dev))
    _cuda.check_status(lib, "windowed_dq_bf16", rc)
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
    kernel returns it), dq from the banded reverse table."""

    @staticmethod
    def forward(ctx, p, q, nbr, rev_dst, deg_in, deg_out, halo, tile,
                impl=None):
        ctx.halo, ctx.tile, ctx.impl = halo, tile, impl
        ctx.save_for_backward(p, q, nbr, rev_dst, deg_in, deg_out)
        return windowed_edge_conv_sum(p, q, nbr, deg_in, halo, tile, "relu",
                                      impl).to(p.dtype)

    @staticmethod
    def backward(ctx, g):
        p, q, nbr, rev_dst, deg_in, deg_out = ctx.saved_tensors
        g = g.contiguous()
        step_sum = windowed_edge_conv_sum(p, q, nbr, deg_in, ctx.halo,
                                          ctx.tile, "step", ctx.impl)
        dp = (g.to(torch.float32) * step_sum.to(torch.float32)).to(p.dtype)
        dq = windowed_dq(q, g, p, rev_dst, deg_out, ctx.halo, ctx.tile,
                         ctx.impl).to(q.dtype)
        return dp, dq, None, None, None, None, None, None, None


class WindowedEdgeConvSumF32(torch.autograd.Function):
    """The f32 K3d (onehot_gather.py:352-375): K3b forward, and the ELL
    backward (dp, and dq through rev_dst), each a kernel on a CUDA
    tensor."""

    @staticmethod
    def forward(ctx, p, q, nbr, rev_dst, deg_in, deg_out, halo, tile,
                impl=None):
        ctx.impl = impl
        ctx.save_for_backward(p, q, nbr, deg_in, rev_dst, deg_out)
        return windowed_edge_conv_sum_f32(p, q, nbr, deg_in, halo, tile, impl)

    @staticmethod
    def backward(ctx, g):
        dp, dq = ell_edge_conv_grads(*ctx.saved_tensors, g, ctx.impl,
                                     ctx.needs_input_grad[:2])
        return dp, dq, None, None, None, None, None, None, None
