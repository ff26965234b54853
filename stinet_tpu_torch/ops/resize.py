"""Antialiased separable image resize with resize_right semantics, as two
dense products: a copy of `stinet_tpu/ops/resize.py`'s weight matrices
(numpy) with the products in torch.

The reference's VGG perceptual loss resizes its inputs to 224 with
Shocher's resize_right at its default cubic kernel (Keys, a = -0.5). Per
axis: the projected source coordinate of output pixel i is
c(i) = (i + 0.5) / scale - 0.5; the taps are ceil(support / scale') pixels
from ceil(c(i) - support / (2 scale') - eps), scale' = min(scale, 1)
(antialiasing widens the kernel when shrinking only); the weights
kernel((c(i) - j) * scale') are normalized over the full window, and taps
outside the image read zeros after the normalization. The weights are
computed in f32 in resize_right's order of operations, as the JAX
package's are, so the matrices are bitwise the JAX package's.
"""
import functools

import numpy as np
import torch


def _cubic(x):
    """Keys cubic convolution kernel, a = -0.5 (the resize_right /
    MATLAB-imresize default)."""
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return ((1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0)
            * ((ax > 1) & (ax <= 2)))


def _linear(x):
    ax = np.abs(x)
    return np.maximum(1.0 - ax, 0.0)


_KERNELS = {"cubic": (_cubic, 4.0), "linear": (_linear, 2.0)}


@functools.lru_cache(maxsize=None)
def resize_matrix(in_size: int, out_size: int, method: str = "cubic",
                  antialias: bool = True) -> np.ndarray:
    """Dense [out_size, in_size] f32 weight matrix realizing a 1-D
    resize_right resize along one axis."""
    kernel, support = _KERNELS[method]
    scale = out_size / in_size
    aa = antialias and scale < 1.0
    k_scale = scale if aa else 1.0
    eff_support = support / k_scale
    eps = float(np.finfo(np.float32).eps)

    # weights are computed in FLOAT32 with resize_right's exact expression
    # order (it runs in the torch input dtype, f32 in the reference trainer)
    # so the matrices agree to ~1e-7, not just ~1e-5
    i = np.arange(out_size, dtype=np.float32)
    centers = (i / np.float32(scale)
               + np.float32((in_size - 1) / 2)
               - np.float32((out_size - 1) / (2 * scale)))
    # the left-boundary ceil is evaluated in f32 exactly as resize_right
    # does (`projected_grid - cur_support_sz / 2 - eps` on f32 tensors):
    # near-integer boundaries otherwise select a different (near-zero-
    # weight) tap window
    left = np.ceil((centers - np.float32(eff_support / 2))
                   - np.float32(eps)).astype(np.int64)
    n_taps = int(np.ceil(eff_support - eps))
    taps = left[:, None] + np.arange(n_taps)[None, :]  # [out, taps]
    # resize_right shifts grid+taps by the left pad IN F32 before the kernel
    # sees them (calc_pad_sz updates projected_grid in place) — the f32 add
    # quantizes near-tie centers, which changes marginal tap weights; shift
    # the same way for bit-equal weights
    pad_l = np.float32(-left[0])
    arg = ((centers + pad_l)[:, None]
           - (taps.astype(np.float32) + pad_l)) * np.float32(k_scale)
    w = kernel(arg.astype(np.float32)).astype(np.float32)
    s = w.sum(axis=1, keepdims=True, dtype=np.float32)
    w = w / np.where(s == 0, np.float32(1.0), s)
    # constant-zero padding AFTER normalization: drop out-of-bounds taps
    inb = (taps >= 0) & (taps < in_size)

    rows = np.broadcast_to(i.astype(np.int64)[:, None], taps.shape)
    m = np.zeros((out_size, in_size), np.float32)
    np.add.at(m, (rows[inb], taps[inb]), w.astype(np.float32)[inb])
    return m


def resize_image(img: torch.Tensor, out_hw, method: str = "cubic",
                 antialias: bool = True) -> torch.Tensor:
    """Resize NHWC (or HWC) images to `out_hw` with resize_right semantics:
    two dense products with the per-axis weight matrices."""
    squeeze = img.dim() == 3
    if squeeze:
        img = img[None]
    _, h, w, _ = img.shape
    mh, mw = (torch.as_tensor(resize_matrix(n, o, method, antialias),
                              dtype=img.dtype, device=img.device)
              for n, o in ((h, out_hw[0]), (w, out_hw[1])))
    out = torch.einsum("oh,nhwc->nowc", mh, img)
    out = torch.einsum("ow,nhwc->nhoc", mw, out)
    return out[0] if squeeze else out
