"""The model's weights from the seed, made on the device in one draw: each
weight and bias uniform in +-1/sqrt(fan_in), torch.nn.Linear's law, in
f32 (the dtype both configurations keep their parameters in). The same
tensors go to the program and to the reference."""
import math

import torch

from reference.stinet_ref import param_shapes


def make(args: dict, seed: int, device) -> dict:
    shapes = param_shapes(args)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    u = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        weight = name[:-len("bias")] + "weight" if name.endswith(
            "bias") else name
        bound = 1.0 / math.sqrt(shapes[weight][1])
        out[name] = ((u[off:off + n] * 2.0 - 1.0) * bound).view(shape)
        off += n
    return out
