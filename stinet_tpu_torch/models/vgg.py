"""VGG16 perceptual loss: the counterpart of `stinet_tpu/models/vgg.py`
(the reference's models/losses/vgg16.py). Feature slices at relu1_2,
relu2_2, relu3_3 and relu4_3; the input mapped with clamp(x + 0.5, 0, 1)
(which saturates on the [-1, 1] images the trainer feeds it, as the
reference's does), its channels swapped to BGR, normalized with the
ImageNet statistics and resized with resize_right's cubic kernel
(`ops/resize.py`); the content loss is the layer-weighted mean absolute
feature difference, the style loss the same of the normalized Gram
matrices.

The trunk is torchvision's `vgg16.features` layout up to relu4_3, so its
state dict keys are `features.{0,2,5,7,10,12,14,17,19,21}.{weight,bias}`
and a torchvision state dict loads as it is (`vgg_from_state_dict`, which
reads the keys the JAX package's `convert_torch_vgg16` reads). Without
weights, `random_vgg` draws it from a `torch.Generator`. The trunk's
parameters are frozen: gradients flow to the images only.
"""
from typing import Optional

import torch
import torch.nn as nn

from stinet_tpu_torch.ops.resize import resize_image

_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512]
_TORCH_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)    # the convs' indices
_SLICE_AFTER = (3, 8, 15, 22)   # relu1_2, relu2_2, relu3_3, relu4_3
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
LAYER_WEIGHTS = (0.125, 0.25, 0.5, 1.0)


class VGG16Features(nn.Module):
    """forward(x NCHW, VGG-normalized) -> the four feature slices."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for c in _CFG:
            if c == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, c, 3, padding=1), nn.ReLU()]
                cin = c
        self.features = nn.Sequential(*layers)
        self.requires_grad_(False)

    def forward(self, x):
        feats = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _SLICE_AFTER:
                feats.append(x)
        return feats


def gram_matrix(feat):
    """[N, C, H, W] -> [N, C, C], normalized by C * H * W."""
    n, c, h, w = feat.shape
    f = feat.reshape(n, c, h * w)
    return torch.bmm(f, f.transpose(1, 2)) / (c * h * w)


class VGGLoss(nn.Module):
    """forward(pred, target: [N, H, W, 3] in [-1, 1]) -> (content, style)."""

    def __init__(self, vgg: VGG16Features, resize_to: int = 224):
        super().__init__()
        self.vgg = vgg
        self.resize_to = resize_to
        self.eval()

    def _prep(self, img):
        img = torch.clamp(img + 0.5, 0.0, 1.0).flip(-1)
        mean = torch.tensor(_IMAGENET_MEAN, dtype=img.dtype,
                            device=img.device)
        std = torch.tensor(_IMAGENET_STD, dtype=img.dtype, device=img.device)
        img = resize_image((img - mean) / std,
                           (self.resize_to, self.resize_to))
        return img.permute(0, 3, 1, 2)

    def forward(self, pred, target):
        fp = self.vgg(self._prep(pred))
        ft = self.vgg(self._prep(target))
        content = style = 0.0
        for w, a, b in zip(LAYER_WEIGHTS, fp, ft):
            content = content + w * (a - b).abs().mean()
            style = style + w * (gram_matrix(a) - gram_matrix(b)).abs().mean()
        return content, style


def random_vgg(generator: Optional[torch.Generator] = None) -> VGG16Features:
    """The trunk drawn from `generator` (LeCun-scaled normal weights, zero
    biases, as flax's default init)."""
    from stinet_tpu_torch.models.inception import random_conv_init
    vgg = VGG16Features()
    random_conv_init(vgg, generator or torch.Generator().manual_seed(0))
    return vgg


def vgg_from_state_dict(state_dict) -> VGG16Features:
    """The trunk from a torchvision vgg16 (`features.N.*` or `N.*` keys;
    convs past relu4_3 are ignored, as the JAX package's converter ignores
    them). A missing conv raises KeyError."""
    trunk = {}
    for ti in _TORCH_IDX:
        for prefix in (f"features.{ti}", str(ti)):
            if prefix + ".weight" in state_dict:
                for leaf in ("weight", "bias"):
                    trunk[f"features.{ti}.{leaf}"] = torch.as_tensor(
                        state_dict[f"{prefix}.{leaf}"])
                break
        else:
            raise KeyError(f"VGG16 conv (torch features index {ti}) not "
                           "found in state dict")
    vgg = VGG16Features()
    vgg.load_state_dict(trunk)
    return vgg


def vgg_from_file(path: str) -> VGG16Features:
    """The trunk with the weights of a torch state-dict file."""
    if str(path).endswith(".msgpack"):
        raise NotImplementedError(
            "msgpack perceptual weights are the JAX package's format; "
            "utils/convert_perceptual_weights.py is not ported (ROADMAP.md, "
            "Queue 1 item 3): pass the torch state-dict file instead")
    return vgg_from_state_dict(
        torch.load(path, map_location="cpu", weights_only=True))
