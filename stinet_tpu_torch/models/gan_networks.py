"""The GAN network zoo and its losses, the counterpart of
`stinet_tpu/models/gan_networks.py` (the reference's pix2pix/CycleGAN
module): ResnetGenerator, UnetGenerator, NLayerDiscriminator (PatchGAN),
PixelDiscriminator, `gan_loss` (lsgan, vanilla, wgangp), the WGAN-GP
gradient penalty and the epoch -> lr multiplier schedules. NCHW modules
with their layers in lists by kind in flax's creation order, weights from
a `torch.Generator`, and a compute `dtype` for the convolutions, as
`models/resnet2d.py` sets out."""
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from stinet_tpu_torch.models.factory import weak_scalar
from stinet_tpu_torch.models.resnet2d import (
    Norm2D, ResnetBlock2D, conv_in, init_conv_weights, pad2d)


def _conv(c_in, c_out, k, stride=1, padding=0, bias=True):
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=padding,
                     bias=bias)


def _leaky(x):
    """flax's leaky_relu(x, 0.2), its slope in x's dtype."""
    return F.leaky_relu(x, weak_scalar(0.2, x.dtype))


class ResnetGenerator(nn.Module):
    """7x7 conv, two stride-2 convs down, `n_blocks` resnet blocks, two
    transposed convs up, 7x7 conv, tanh (the reference's
    gan_networks.py:325-392). As in JAX, zero padding pads nothing around
    the 7x7 convs."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 64,
                 norm: str = "batch", use_dropout: bool = False,
                 n_blocks: int = 6, padding_type: str = "reflect",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.padding_type, self.dtype = padding_type, dtype
        use_bias = norm == "instance"
        convs = [_conv(input_nc, ngf, 7, bias=use_bias)]
        norms = [Norm2D(ngf, norm)]
        for i in range(2):
            c = ngf * 2 ** i
            convs.append(_conv(c, 2 * c, 3, 2, 1, bias=use_bias))
            norms.append(Norm2D(2 * c, norm))
        self.blocks = nn.ModuleList(
            ResnetBlock2D(4 * ngf, 4 * ngf, norm, padding_type=padding_type,
                          use_dropout=use_dropout, use_bias=use_bias,
                          dtype=dtype)
            for _ in range(n_blocks))
        tconvs = []
        for i in range(2):
            c = ngf * 2 ** (2 - i)
            tconvs.append(nn.ConvTranspose2d(c, c // 2, 3, stride=2,
                                             padding=1, output_padding=1,
                                             bias=use_bias))
            norms.append(Norm2D(c // 2, norm))
        convs.append(_conv(ngf, output_nc, 7))
        self.convs, self.tconvs = nn.ModuleList(convs), nn.ModuleList(tconvs)
        self.norms = nn.ModuleList(norms)
        init_conv_weights(self, generator)

    def forward(self, x):
        convs, norms, dt = iter(self.convs), iter(self.norms), self.dtype
        x = pad2d(x, 3, self.padding_type)
        x = F.relu(next(norms)(conv_in(next(convs), x, dt)))
        for _ in range(2):
            x = F.relu(next(norms)(conv_in(next(convs), x, dt)))
        for block in self.blocks:
            x = block(x)
        for tconv in self.tconvs:
            x = F.relu(next(norms)(conv_in(tconv, x, dt)))
        return torch.tanh(conv_in(next(convs), pad2d(x, 3, self.padding_type),
                                  dt))


class UnetGenerator(nn.Module):
    """U-Net of `num_downs` stride-2 4x4 convs down and as many transposed
    convs up, skips concatenated (the reference's gan_networks.py:456-555,
    built from the outermost layer in, as JAX builds it: every down conv
    but the first is normalized, and dropout follows every up conv but the
    innermost when `use_dropout`)."""

    def __init__(self, input_nc: int, output_nc: int, num_downs: int = 7,
                 ngf: int = 64, norm: str = "batch",
                 use_dropout: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        use_bias = norm == "instance"
        chans = [ngf, ngf * 2, ngf * 4] + [ngf * 8] * (num_downs - 3)
        convs = [_conv(input_nc, chans[0], 4, 2, 1, bias=use_bias)]
        norms = []
        for c_in, c in zip(chans, chans[1:]):
            convs.append(_conv(c_in, c, 4, 2, 1, bias=use_bias))
            norms.append(Norm2D(c, norm))
        tconvs, c_in = [], chans[-1]
        for c in reversed(chans[:-1]):
            tconvs.append(nn.ConvTranspose2d(c_in, c, 4, stride=2, padding=1,
                                             bias=use_bias))
            norms.append(Norm2D(c, norm))
            c_in = 2 * c
        tconvs.append(nn.ConvTranspose2d(c_in, output_nc, 4, stride=2,
                                         padding=1))
        self.convs, self.tconvs = nn.ModuleList(convs), nn.ModuleList(tconvs)
        self.norms = nn.ModuleList(norms)
        self.dropout = nn.Dropout(0.5) if use_dropout else None
        init_conv_weights(self, generator)

    def forward(self, x):
        norms, dt = iter(self.norms), self.dtype
        skips = [conv_in(self.convs[0], x, dt)]
        for conv in self.convs[1:]:
            skips.append(next(norms)(conv_in(conv, _leaky(skips[-1]), dt)))
        h = skips.pop()
        for i, tconv in enumerate(self.tconvs[:-1]):
            h = next(norms)(conv_in(tconv, F.relu(h), dt))
            if i > 0 and self.dropout is not None:
                h = self.dropout(h)
            h = torch.cat([skips.pop(), h], dim=1)
        return torch.tanh(conv_in(self.tconvs[-1], F.relu(h), dt))


class NLayerDiscriminator(nn.Module):
    """PatchGAN: `n_layers` stride-2 4x4 convs, one stride-1, then a 1-channel
    stride-1 conv (the reference's gan_networks.py:558-603)."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 norm: str = "batch", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        use_bias = norm == "instance"
        convs, norms, c_in = [_conv(input_nc, ndf, 4, 2, 1)], [], ndf
        for n in range(1, n_layers + 1):
            c = ndf * min(2 ** n, 8)
            convs.append(_conv(c_in, c, 4, 2 if n < n_layers else 1, 1,
                               bias=use_bias))
            norms.append(Norm2D(c, norm))
            c_in = c
        convs.append(_conv(c_in, 1, 4, 1, 1))
        self.convs, self.norms = nn.ModuleList(convs), nn.ModuleList(norms)
        init_conv_weights(self, generator)

    def forward(self, x):
        dt = self.dtype
        x = _leaky(conv_in(self.convs[0], x, dt))
        for conv, norm in zip(self.convs[1:-1], self.norms):
            x = _leaky(norm(conv_in(conv, x, dt)))
        return conv_in(self.convs[-1], x, dt)


class PixelDiscriminator(nn.Module):
    """1x1 PatchGAN (the reference's gan_networks.py:606-635)."""

    def __init__(self, input_nc: int, ndf: int = 64, norm: str = "batch",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        use_bias = norm == "instance"
        self.convs = nn.ModuleList([
            _conv(input_nc, ndf, 1), _conv(ndf, 2 * ndf, 1, bias=use_bias),
            _conv(2 * ndf, 1, 1, bias=use_bias)])
        self.norms = nn.ModuleList([Norm2D(2 * ndf, norm)])
        init_conv_weights(self, generator)

    def forward(self, x):
        dt = self.dtype
        x = _leaky(conv_in(self.convs[0], x, dt))
        x = _leaky(self.norms[0](conv_in(self.convs[1], x, dt)))
        return conv_in(self.convs[2], x, dt)


# --- losses ------------------------------------------------------------------

def gan_loss(prediction, target_is_real: bool, gan_mode: str = "lsgan"):
    """The reference's GANLoss: lsgan the mean squared distance to the 0/1
    target, vanilla binary cross entropy on logits, wgangp -mean (real) or
    mean (fake)."""
    if gan_mode == "lsgan":
        return ((prediction - float(target_is_real)) ** 2).mean()
    if gan_mode == "vanilla":
        target = (torch.ones_like if target_is_real
                  else torch.zeros_like)(prediction)
        return F.binary_cross_entropy_with_logits(prediction, target)
    if gan_mode == "wgangp":
        return -prediction.mean() if target_is_real else prediction.mean()
    raise NotImplementedError(f"gan mode {gan_mode!r} not implemented")


def cal_gradient_penalty(disc, real, fake, generator=None, constant=1.0,
                         lambda_gp=10.0, gp_type="mixed"):
    """WGAN-GP's penalty lambda_gp * mean((|grad_x disc(x)| - constant)^2)
    at x = real, fake, or ("mixed") alpha * real + (1 - alpha) * fake with
    one alpha ~ U(0, 1) a sample drawn from `generator` (the reference's
    gan_networks.py:288-322). Differentiable in disc's parameters."""
    if gp_type == "real":
        interp = real
    elif gp_type == "fake":
        interp = fake
    else:
        alpha = torch.rand((real.shape[0], 1, 1, 1),
                           generator=generator).to(real.device, real.dtype)
        interp = alpha * real + (1 - alpha) * fake
    if not interp.requires_grad:
        interp = interp.detach().requires_grad_(True)
    grads, = torch.autograd.grad(disc(interp).sum(), interp,
                                 create_graph=True)
    grads = grads.reshape(grads.shape[0], -1)
    gnorm = torch.sqrt((grads ** 2).sum(dim=1) + 1e-16)
    return ((gnorm - constant) ** 2).mean() * lambda_gp


def get_scheduler(policy: str, args, n_epochs=100):
    """Epoch -> lr multiplier (the reference's gan_networks.py:39-65):
    linear, step and cosine; plateau is a `graph_common.PlateauLR` that
    the trainer feeds the monitored metric (`observe`)."""
    if policy == "linear":
        n_keep = args.get("n_epochs", n_epochs)
        n_decay = args.get("n_epochs_decay", 100)
        return lambda epoch: 1.0 - max(0, epoch - n_keep) / float(
            n_decay + 1)
    if policy == "step":
        step_size = args.get("step_size", args.get("lr_decay_iters", 50))
        gamma = args.get("gamma", 0.1)
        return lambda epoch: gamma ** (epoch // step_size)
    if policy == "cosine":
        total = args.get("n_epochs", n_epochs)
        return lambda epoch: 0.5 * (1 + math.cos(math.pi * epoch / total))
    if policy == "plateau":
        from stinet_tpu_torch.trainers.graph_common import PlateauLR
        return PlateauLR(1.0, mode="min", factor=0.2, threshold=0.01,
                         patience=5)
    raise NotImplementedError(f"lr policy {policy!r} not implemented")
