"""Resnet2D: the conv2d baseline generator of the 2D inpainting workload,
the counterpart of `stinet_tpu/models/resnet2d.py` (the reference's
surfacetextureinpaintingnet.py:524-659). NCHW.

The knobs are the JAX module's: io receptive field (large 7x7, normal 3x3,
dilated), reflect / replicate / zero padding, stride or mean / max pooling
down, transposed convolutions or nearest upsampling up, and exponentially
dilated bottleneck blocks (the `d_start` schedule). Norms: instance (no
affine, no running statistics), batch (affine; the running statistics
move by 0.1 of the batch's mean and BIASED variance a training forward,
as flax's `nn.BatchNorm(momentum=0.9)` does, where torch's BatchNorm2d
takes the unbiased variance), none.

Every module keeps its layers in lists by kind, in the order the JAX
module creates them, and its forward takes them in that order: flax's
auto-names map one to one (`Conv_k` -> `convs.k`, `ConvTranspose_k` ->
`tconvs.k`, `ForwardConv_k` -> `fconvs.k`, `Norm2D_k` -> `norms.k`,
`ResnetBlock2D_k` -> `blocks.k`; `utils/convert.py:
resnet2d_state_dict_from_jax_params`). Weights follow torch.nn.Linear's
law, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in = in channels x kernel
area for a convolution and a transposed one alike, drawn from a
`torch.Generator`; biases are 0 (the JAX modules' `torch_linear_init`).

`dtype` (None = the parameters' dtype, or torch.bfloat16) is the compute
dtype of the convolutions, as flax's `Conv(dtype=...)`: the parameters
stay f32, and each convolution casts its input, kernel and bias to it
(`conv_in`). The norms take the dtype their input arrives in, as JAX's
`Norm2D` does (`Norm2D.forward`), so a bf16 model's output is bf16.
"""
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from stinet_tpu_torch.models.factory import weak_scalar

_PAD_MODE = {"reflect": "reflect", "replicate": "replicate", "zero": None}
EPS = 1e-5


def pad2d(x, p, padding_type):
    """Pad H and W by `p` with `padding_type`'s mode; zero padding is left
    to the convolution."""
    if padding_type not in _PAD_MODE:
        raise NotImplementedError(f"padding {padding_type!r}")
    mode = _PAD_MODE[padding_type]
    if p == 0 or mode is None:
        return x
    return F.pad(x, (p, p, p, p), mode=mode)


def conv_in(conv: nn.Module, x, dtype: Optional[torch.dtype]):
    """`conv(x)` of a Conv2d or ConvTranspose2d in the compute `dtype`, as
    flax's Conv(dtype=...): input and kernel cast to it, the convolution
    rounded to it, then the bias, cast too, added in it; None computes in
    the parameters' dtype."""
    if dtype is None:
        return conv(x)
    weight = conv.weight.to(dtype)
    if isinstance(conv, nn.ConvTranspose2d):
        out = F.conv_transpose2d(x.to(dtype), weight, None, conv.stride,
                                 conv.padding, conv.output_padding,
                                 conv.groups, conv.dilation)
    else:
        out = conv._conv_forward(x.to(dtype), weight, None)
    if conv.bias is None:
        return out
    return out + conv.bias.to(dtype)[:, None, None]


def _instance_norm_bf16(x):
    """JAX's instance `Norm2D` on a bf16 input, op for op: each mean summed
    in f32 and rounded to bf16 (jnp.mean), every other step in bf16."""
    def mean(t):
        return t.mean(dim=(2, 3), keepdim=True,
                      dtype=torch.float32).to(t.dtype)
    centered = x - mean(x)
    var = mean(centered * centered)
    return centered / torch.sqrt(var + weak_scalar(EPS, x.dtype))


def _avg_pool2(x, k=2):
    """flax's avg_pool over k x k = 2 x 2 windows at stride 2: in bf16 the
    window's sum taken in bf16, its elements added in raster order, then
    divided (XLA's reduce_window in the input's dtype)."""
    if x.dtype != torch.bfloat16:
        return F.avg_pool2d(x, k)
    x = x[:, :, :x.shape[2] // 2 * 2, :x.shape[3] // 2 * 2]
    total = x[:, :, 0::2, 0::2] + x[:, :, 0::2, 1::2]
    total = total + x[:, :, 1::2, 0::2]
    return (total + x[:, :, 1::2, 1::2]) / 4


@torch.no_grad()
def init_conv_weights(module: nn.Module,
                      generator: Optional[torch.Generator] = None) -> None:
    """torch.nn.Linear's weight law over every (transposed) convolution of
    `module`, drawn from `generator` (torch.Generator() when None), and
    zero biases."""
    generator = generator if generator is not None else torch.Generator()
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.weight[0].numel() if isinstance(m, nn.Conv2d) \
                else m.weight.shape[0] * m.weight[0, 0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()


class Norm2D(nn.Module):
    """instance: per sample and channel over H, W; batch: over N, H, W
    with an affine map and running statistics (module docstring); none:
    the identity. On a bf16 input, as JAX's: instance norm keeps bf16
    (`_instance_norm_bf16`), batch norm takes its statistics in f32 and
    returns f32 (flax's BatchNorm promotes to its parameters' dtype)."""

    def __init__(self, features: int, norm: str = "instance",
                 momentum: float = 0.1):
        super().__init__()
        if norm not in ("instance", "batch", "none"):
            raise NotImplementedError(f"norm {norm!r}")
        self.norm, self.momentum = norm, momentum
        if norm == "batch":
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
            self.register_buffer("running_mean", torch.zeros(features))
            self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if self.norm == "none":
            return x
        if self.norm == "instance":
            if x.dtype == torch.bfloat16:
                return _instance_norm_bf16(x)
            return F.instance_norm(x, eps=EPS)
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        if self.training:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight * torch.rsqrt(var + EPS)
        return ((x - mean[:, None, None]) * scale[:, None, None]
                + self.bias[:, None, None])


class ForwardConv(nn.Module):
    """`n_repeated` same-size convolutions (the reference's forward_conv);
    all but the last keep `in_c` channels."""

    def __init__(self, in_c: int, out_c: int, n_repeated: int = 1,
                 dilation: int = 1, receptive_field_type: str = "normal",
                 padding_type: str = "zero", use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        kernels = {"large": (7, 3), "dilated": (3, dilation),
                   "normal": (3, 1)}
        if receptive_field_type not in kernels:
            raise NotImplementedError(receptive_field_type)
        k, self.pad = kernels[receptive_field_type]
        self.padding_type = padding_type
        inner = self.pad if padding_type == "zero" else 0
        self.convs = nn.ModuleList(
            nn.Conv2d(in_c, out_c if i == n_repeated - 1 else in_c, k,
                      padding=inner, dilation=dilation, bias=use_bias)
            for i in range(n_repeated))

    def forward(self, x):
        for conv in self.convs:
            x = conv_in(conv, pad2d(x, self.pad, self.padding_type),
                        self.dtype)
        return x


class ResnetBlock2D(nn.Module):
    """(dilated) conv, norm, relu (and dropout) plus the input, projected
    by a 1x1 convolution when the widths differ (the reference's
    ResnetBlock)."""

    def __init__(self, dim_in: int, dim_out: int, norm: str,
                 padding_type: str = "reflect", use_dropout: bool = False,
                 use_bias: bool = True, dilation: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.fconvs = nn.ModuleList([ForwardConv(
            dim_in, dim_out, receptive_field_type="dilated",
            dilation=dilation, padding_type=padding_type,
            use_bias=use_bias, dtype=dtype)])
        self.norms = nn.ModuleList([Norm2D(dim_out, norm)])
        self.dropout = nn.Dropout(0.5) if use_dropout else None
        self.convs = nn.ModuleList(
            [nn.Conv2d(dim_in, dim_out, 1, bias=use_bias)]
            if dim_in != dim_out else [])

    def forward(self, x):
        out = F.relu(self.norms[0](self.fconvs[0](x)))
        if self.dropout is not None:
            out = self.dropout(out)
        if len(self.convs):
            x = conv_in(self.convs[0], x, self.dtype)
        return x + out


class Resnet2D(nn.Module):
    """forward(x [B, input_nc, H, W]) -> [B, output_nc, H, W] in [-1, 1]."""

    def __init__(self, input_nc: int, output_nc: int = 3, ngf: int = 64,
                 norm: str = "instance", use_dropout: bool = False,
                 n_blocks: int = 6, dilation_order: int = 0,
                 n_levels: int = 2, n_repeated_io_convs: int = 1,
                 padding_type: str = "reflect", pooling_type: str = "stride",
                 io_receptive_field_type: str = "large",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dilation_order >= n_blocks:
            raise ValueError(f"dilation_order {dilation_order} needs more "
                             f"than {n_blocks} blocks")
        if pooling_type not in ("stride", "mean", "max"):
            raise NotImplementedError(pooling_type)
        self.n_levels, self.pooling_type = n_levels, pooling_type
        self.dtype = dtype
        use_bias = norm == "instance"
        convs, tconvs, norms = [], [], [Norm2D(ngf, norm)]
        io = dict(n_repeated=n_repeated_io_convs,
                  receptive_field_type=io_receptive_field_type,
                  padding_type=padding_type, dtype=dtype)
        fconvs = [ForwardConv(input_nc, ngf, use_bias=use_bias, **io)]
        for i in range(n_levels):
            c_in, c_out = ngf * 2 ** i, ngf * 2 ** (i + 1)
            if pooling_type == "stride":
                convs.append(nn.Conv2d(c_in, c_out, 3, stride=2, padding=1,
                                       bias=use_bias))
            else:
                fconvs.append(ForwardConv(c_in, c_out, use_bias=use_bias,
                                          dtype=dtype))
            norms.append(Norm2D(c_out, norm))
        width = ngf * 2 ** n_levels
        d_start = n_blocks - dilation_order - 1
        self.blocks = nn.ModuleList(
            ResnetBlock2D(width, width, norm, padding_type=padding_type,
                          use_dropout=use_dropout, use_bias=use_bias,
                          dilation=(2 ** (i - d_start) if d_start <= i
                                    <= d_start + dilation_order else 1),
                          dtype=dtype)
            for i in range(n_blocks))
        for i in range(n_levels):
            c_in = ngf * 2 ** (n_levels - i)
            if pooling_type == "stride":
                tconvs.append(nn.ConvTranspose2d(
                    c_in, c_in // 2, 3, stride=2, padding=1,
                    output_padding=1, bias=use_bias))
            else:
                fconvs.append(ForwardConv(c_in, c_in // 2,
                                          use_bias=use_bias, dtype=dtype))
            norms.append(Norm2D(c_in // 2, norm))
        fconvs.append(ForwardConv(ngf, output_nc, use_bias=True, **io))
        self.convs, self.tconvs = nn.ModuleList(convs), nn.ModuleList(tconvs)
        self.fconvs, self.norms = nn.ModuleList(fconvs), nn.ModuleList(norms)
        init_conv_weights(self, generator)

    def forward(self, x):
        convs, tconvs = iter(self.convs), iter(self.tconvs)
        fconvs, norms = iter(self.fconvs), iter(self.norms)
        x = F.relu(next(norms)(next(fconvs)(x)))
        for _ in range(self.n_levels):
            if self.pooling_type == "stride":
                x = conv_in(next(convs), x, self.dtype)
            else:
                pool = (F.max_pool2d if self.pooling_type == "max"
                        else _avg_pool2)
                x = next(fconvs)(pool(x, 2))
            x = F.relu(next(norms)(x))
        for block in self.blocks:
            x = block(x)
        for _ in range(self.n_levels):
            if self.pooling_type == "stride":
                x = conv_in(next(tconvs), x, self.dtype)
            else:
                x = next(fconvs)(x.repeat_interleave(2, dim=2)
                                 .repeat_interleave(2, dim=3))
            x = F.relu(next(norms)(x))
        return torch.tanh(next(fconvs)(x))
