"""InceptionV3 feature extractor for FID: the counterpart of
`stinet_tpu/models/inception.py`, the pytorch-fid network the reference
uses (models/inception.py:16-328, a port of mseitzer/pytorch-fid).

The FID variant differs from torchvision's in blocks A, C and E: average
pooling excludes the padding from its count, and E-2 pools by max in its
pool branch. Submodules carry pytorch-fid's names
(`Conv2d_1a_3x3.conv.weight`, `Mixed_5b.branch1x1.bn.running_mean`, ...),
so the state dicts that the JAX package's `convert_torch_state_dict` reads
load here unchanged (`load_inception_weights`).

Input and output as the JAX module's: NHWC images [N, H, W, 3] in [0, 1]
(resized to 299 x 299 with `resize_input`, by `jax.image.resize`'s
bilinear weights, antialiased where a side shrinks; mapped to [-1, 1] with
`normalize_input`) -> pool3 features [N, 2048]. Batch norm always uses its
running statistics, with eps 1e-3. Padding follows the JAX module's: its
"SAME" convolutions have stride 1 and odd kernels, so `k // 2` a side;
"VALID" is none, and so are the max pools but E-2's (3 x 3, stride 1,
-inf padding).

Without a weights file the module runs with random features drawn from a
`torch.Generator` (the trainers' `allow_random_features`).
"""
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

FID_POOL_DIM = 2048
_SIZE = 299


class BasicConv(nn.Module):
    """conv (no bias) -> batch norm on running statistics -> relu."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 same: bool = True):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        pad = (kh // 2, kw // 2) if same else (0, 0)   # SAME: stride 1 only
        self.conv = nn.Conv2d(cin, cout, (kh, kw), stride=stride,
                              padding=pad, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var,
                         bn.weight, bn.bias, training=False, eps=bn.eps)
        return F.relu(x)


def _avg_pool_nopad(x):
    """3 x 3, stride 1 average pooling that leaves the padding out of the
    count (the FID network's blocks A, C and E-1)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, 1)
        self.branch5x5_1 = BasicConv(cin, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3)
        self.branch_pool = BasicConv(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_nopad(x))
        return torch.cat([self.branch1x1(x), b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2, same=False)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2, same=False)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 192, 1)
        self.branch7x7_1 = BasicConv(cin, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1))
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_3(self.branch7x7dbl_2(self.branch7x7dbl_1(x)))
        bd = self.branch7x7dbl_5(self.branch7x7dbl_4(bd))
        bp = self.branch_pool(_avg_pool_nopad(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2, same=False)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2, same=False)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(
            self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_type: str):
        super().__init__()
        self.pool_type = pool_type      # "avg" (E-1) or "max" (E-2)
        self.branch1x1 = BasicConv(cin, 320, 1)
        self.branch3x3_1 = BasicConv(cin, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1))
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd),
                        self.branch3x3dbl_3b(bd)], 1)
        if self.pool_type == "avg":
            bp = _avg_pool_nopad(x)
        else:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(bp)], 1)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] f32 weights of `jax.image.resize`'s bilinear kernel
    along one axis, computed in f32 as `compute_weight_mat` computes them
    (jax/_src/image/scale.py): half-pixel centres, the triangle kernel
    widened by the shrink factor where the axis shrinks (antialiasing),
    each row normalized to sum 1."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[:, None] - np.arange(n_in, dtype=f32)[None, :]) \
        / np.maximum(inv_scale, f32(1.0))
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=1, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=None)
def _weights_on(n_in: int, n_out: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """`_resize_weights(n_in, n_out)` as a tensor on `device`, made once."""
    return torch.as_tensor(_resize_weights(n_in, n_out), dtype=dtype,
                           device=device)


def resize_bilinear(x_nchw: torch.Tensor, size: int = _SIZE) -> torch.Tensor:
    """`jax.image.resize(..., "bilinear")` of NCHW images to size x size,
    as two dense products with its per-axis weight matrices."""
    h, w = x_nchw.shape[-2:]
    wh, ww = (_weights_on(int(n), size, x_nchw.dtype, x_nchw.device)
              for n in (h, w))
    return torch.einsum("oh,nchw,pw->ncop", wh, x_nchw, ww)


class InceptionV3(nn.Module):
    """FID InceptionV3 trunk up to the 2048-dim pool3 features.
    forward(x [N, H, W, 3] in [0, 1]) -> [N, 2048]."""

    def __init__(self, resize_input: bool = True,
                 normalize_input: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2, same=False)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3, same=False)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1, same=False)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3, same=False)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        random_conv_init(self, generator or torch.Generator().manual_seed(0))
        self.eval()

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        if self.resize_input:
            x = resize_bilinear(x)
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for blk in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d,
                    self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                    self.Mixed_6d, self.Mixed_6e, self.Mixed_7a,
                    self.Mixed_7b, self.Mixed_7c):
            x = blk(x)
        return x.mean(dim=(2, 3))


def random_conv_init(module: nn.Module, generator: torch.Generator):
    """Every conv weight (and bias) drawn from N(0, 1 / fan_in), as
    flax's default LeCun init scales them; batch norms keep their
    identity init (scale 1, shift 0, mean 0, variance 1)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator)
                               * fan_in ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()


def load_inception_weights(model: InceptionV3, state_dict) -> InceptionV3:
    """Load a pytorch-fid keyed state dict (torch tensors or numpy) into
    `model`. The classifier (`fc.*`) is ignored, as the JAX package's
    converter ignores it, and a missing `num_batches_tracked` is allowed;
    any other missing or unexpected key raises."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()
          if not k.startswith("fc.")}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"InceptionV3 state dict: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    return model


def inception_from_file(path: str, **kw) -> InceptionV3:
    """InceptionV3 with the weights of a torch state-dict file."""
    if str(path).endswith(".msgpack"):
        raise NotImplementedError(
            "msgpack perceptual weights are the JAX package's format; "
            "utils/convert_perceptual_weights.py is not ported (ROADMAP.md, "
            "Queue 1 item 3): pass the torch state-dict file instead")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return load_inception_weights(InceptionV3(**kw), sd)
