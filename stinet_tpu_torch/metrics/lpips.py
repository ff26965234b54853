"""LPIPS perceptual metric with an AlexNet trunk: the counterpart of
`stinet_tpu/metrics/lpips.py` (the `lpips(alex)` metric of the reference's
2D trainer, inpainting2d_trainer.py:158-167; Zhang et al. 2018). AlexNet
conv features at 5 stages, unit-normalized over channels, squared
differences weighted by the learned 1x1 heads (clamped at 0) and summed
over channels, then averaged over space and summed over stages; without
heads, each stage's mean over H, W and C.

The trunk is torchvision's `alexnet.features` layout, so its state dict
keys are `alex.features.{0,3,6,8,10}.{weight,bias}`; the heads are the
buffers `lin0` ... `lin4` ([C] each). `lpips_from_state_dict` reads every
torch key layout the JAX package's `convert_torch_lpips` reads. Without
weights, `random_lpips` draws the trunk from a `torch.Generator` (random
features: relative trends only, tagged by the trainer).
"""
from typing import Optional, Sequence

import torch
import torch.nn as nn

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# (out channels, kernel, stride, padding) of the 5 convs, and their
# indices in torchvision's alexnet.features
_ALEX = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
         (256, 3, 1, 1)]
_TORCH_IDX = (0, 3, 6, 8, 10)
_POOL_AFTER = {0, 1}    # a 3 x 3, stride 2 max pool after stages 0 and 1


class AlexFeatures(nn.Module):
    """forward(x NCHW) -> the 5 relu feature maps."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for i, (c, k, s, p) in enumerate(_ALEX):
            layers += [nn.Conv2d(cin, c, k, stride=s, padding=p), nn.ReLU()]
            if i in _POOL_AFTER:
                layers.append(nn.MaxPool2d(3, 2))
            cin = c
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        feats = []
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                feats.append(x)
        return feats


def _norm_feat(f):
    return f / torch.sqrt((f ** 2).sum(dim=1, keepdim=True) + 1e-10)


class LPIPS(nn.Module):
    """forward(x, y: [N, H, W, 3] in [-1, 1]) -> [N] distances."""

    def __init__(self, lin_weights: Optional[Sequence] = None):
        super().__init__()
        self.alex = AlexFeatures()
        self.has_lins = lin_weights is not None
        if self.has_lins:
            for i, w in enumerate(lin_weights):
                self.register_buffer(f"lin{i}", torch.as_tensor(
                    w, dtype=torch.float32).reshape(-1).clone())
        self.eval()

    def forward(self, x, y):
        if min(x.shape[1], x.shape[2]) < 32:
            raise ValueError(
                f"LPIPS(alex) needs images >= 32px per side, got "
                f"{x.shape[1]}x{x.shape[2]} (the stride-4 trunk collapses "
                "smaller inputs to empty feature maps)")
        shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
        scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
        fx = self.alex(((x - shift) / scale).permute(0, 3, 1, 2))
        fy = self.alex(((y - shift) / scale).permute(0, 3, 1, 2))
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = (_norm_feat(a) - _norm_feat(b)) ** 2
            if self.has_lins:
                w = getattr(self, f"lin{i}").clamp(min=0.0)
                total = total + (d * w[:, None, None]).sum(1).mean(dim=(1, 2))
            else:
                total = total + d.mean(dim=(1, 2, 3))
        return total


def random_lpips(generator: Optional[torch.Generator] = None) -> LPIPS:
    """LPIPS without heads, its trunk drawn from `generator` (LeCun-scaled
    normal weights, zero biases, as flax's default init)."""
    from stinet_tpu_torch.models.inception import random_conv_init
    model = LPIPS()
    random_conv_init(model, generator or torch.Generator().manual_seed(0))
    return model


def lpips_from_state_dict(state_dict) -> LPIPS:
    """LPIPS from torch weights in any layout the JAX package's
    `convert_torch_lpips` reads: the trunk as `features.N.*` or `N.*`
    (torchvision alexnet) or `net.sliceK.N.*` (the lpips package), the
    heads as `lin{i}.model.1.weight` (without them, the unweighted stage
    means); or {"alex": trunk, "lins": heads} as the JAX trainer reads a
    file; or the port's own `LPIPS.state_dict()`. A missing trunk conv
    raises KeyError."""
    sd = dict(state_dict)
    if "alex" in sd:
        alex, heads = sd["alex"], sd.get("lins")
    elif "alex.features.0.weight" in sd:    # the port's own layout
        alex = {k[len("alex."):]: v for k, v in sd.items()
                if k.startswith("alex.")}
        heads = {f"lin{i}.model.1.weight": sd[f"lin{i}"] for i in range(5)
                 if f"lin{i}" in sd}
    else:
        alex = heads = sd
    trunk = {}
    for i, ti in enumerate(_TORCH_IDX):
        for prefix in (f"features.{ti}", str(ti), f"net.slice{i + 1}.{ti}"):
            if prefix + ".weight" in alex:
                for leaf in ("weight", "bias"):
                    trunk[f"features.{ti}.{leaf}"] = torch.as_tensor(
                        alex[f"{prefix}.{leaf}"])
                break
        else:
            raise KeyError(f"AlexNet conv {i} (torch features index {ti}) "
                           "not found in state dict")
    lins = None
    if heads is not None and "lin0.model.1.weight" in heads:
        lins = [torch.as_tensor(heads[f"lin{i}.model.1.weight"]).reshape(-1)
                for i in range(5)]
    model = LPIPS(lins)
    model.alex.load_state_dict(trunk)
    return model


def lpips_from_file(path: str) -> LPIPS:
    """LPIPS with the weights of a torch state-dict file."""
    if str(path).endswith(".msgpack"):
        raise NotImplementedError(
            "msgpack perceptual weights are the JAX package's format; "
            "utils/convert_perceptual_weights.py is not ported (ROADMAP.md, "
            "Queue 1 item 3): pass the torch state-dict file instead")
    return lpips_from_state_dict(
        torch.load(path, map_location="cpu", weights_only=True))
