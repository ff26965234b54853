"""Plain reference of what the training cells' first steps compute: the
loader's sample of a room file, the masked-composite L1 with the 0.99^mask
weighting, and torch's Adam with amsgrad, written out.

The sample is read from the room's file (the raw file both sides read) and
worked out again: the split list's order, the loader's shuffle and its
per-sample generator keyed (seed, epoch, index), the mask pick, and the
config's train transforms, each a frozen copy of what the reference
project's loader does (CoordsNormalization, RandomLinearTransformation
with its flip, RandomRotation about z), drawn in the same order.
"""
import math
import os
from typing import Dict, List

import numpy as np
import torch

from reference import stinet_ref


def schedule(names: List[str], seed: int, epoch: int) -> List[int]:
    """Dataset indices in the order an epoch visits them: the scenes
    sorted by name, shuffled by a generator seeded with the loader's seed
    and advanced once an epoch."""
    rng = np.random.default_rng(seed)
    idx = np.arange(len(names))
    for _ in range(epoch + 1):
        idx = np.arange(len(names))
        rng.shuffle(idx)
    return [int(i) for i in idx]


def _transforms(x: np.ndarray, rng, spec: List[dict]) -> np.ndarray:
    for t in spec:
        args = t.get("args", {})
        if t["type"] == "CoordsNormalization":
            x[:, 6:9] = x[:, 6:9] / np.asarray(args["max_sizes"], np.float32)
        elif t["type"] == "RandomLinearTransformation":
            m = (np.eye(3) + rng.normal(size=(3, 3))
                 * args.get("pertubation_factor", 0.1)).astype(np.float32)
            if args.get("flip", True):
                m[0, 0] *= -1.0
            x[:, 6:9] = x[:, 6:9] @ m
        elif t["type"] == "RandomRotation":
            th = float(rng.uniform(0.0, 2.0 * math.pi))
            rot = np.array([[math.cos(th), math.sin(th), 0.0],
                            [-math.sin(th), math.cos(th), 0.0],
                            [0.0, 0.0, 1.0]], dtype=np.float32)
            x[:, 3:6] = x[:, 3:6] @ rot
            x[:, 6:9] = x[:, 6:9] @ rot
        else:
            raise NotImplementedError(t["type"])
    return x


def load_sample(root: str, name: str, index: int, seed: int, epoch: int,
                transforms: List[dict], end_level: int, coarse_dists):
    """(num_vertices, edges, traces, dilated at the coarsest level, x,
    color, mask) of dataset item `index` (scene `name`) at `epoch`."""
    rng = np.random.default_rng((int(seed), int(epoch), int(index)))
    rng.integers(0, 1)      # the pick among the scene's one mask set
    z = np.load(os.path.join(root, "graphs", name + ".npz"))
    L = min(int(z["num_levels"]), end_level)
    v0 = z["vertices_0"].astype(np.float32)
    color = v0[:, 3:6] * 2.0 - 1.0
    mask = np.load(os.path.join(root, "masks", "rad_16", name, "0.npz"))[
        "vertex_mask"].astype(np.float32)[:, None]
    kept = (mask == 0).astype(np.float32)
    x = np.concatenate([color * kept, v0[:, 6:9], v0[:, 0:3], kept], -1)
    x = _transforms(x.astype(np.float32), rng, transforms)
    nv = [int(z[f"vertices_{l}"].shape[0]) for l in range(L)]
    edges = [z[f"edges_{l}"] for l in range(L)]
    traces = [z[f"traces_{l}"] for l in range(1, L)]
    dilated = {int(d): z[f"dil_{int(d)}_edges_{L - 1}"] for d in coarse_dists}
    return nv, edges, traces, dilated, x, color.astype(np.float32), mask


def loss(out, color, mask, half=False):
    """Masked-composite L1, 0.99^mask weighted, a mean over vertices and
    channels. `half` leaves out every other vertex and takes the mean
    over the rest (a planted fault of the comparison's own tests)."""
    comp = torch.where(mask > 0, out, color)
    per = (comp - color).abs() * torch.pow(0.99, mask)
    if half:
        per = per[::2]
    return per.sum() / per.numel()


class Adam:
    """torch.optim.Adam(amsgrad=True) with no weight decay, written out:
    m, v, v_max, bias-corrected step."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, betas=(0.9, 0.999),
                 eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.t = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.vmax = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            torch.maximum(self.vmax[k], self.v[k], out=self.vmax[k])
            denom = self.vmax[k].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def train(W0: Dict[str, torch.Tensor], args: dict, samples, lr: float,
          device, precision: str = "f32", half: bool = False):
    """Follow len(samples) steps from weights W0. Returns (losses, first
    gradients {name: tensor}, final weights {name: tensor}, the first
    step's output rows)."""
    W = {k: v.detach().to(device, torch.float32).clone() for k, v in
         W0.items()}
    opt = Adam(W, lr)
    losses, first, first_out = [], None, None
    with stinet_ref.full_f32():
        for nv, edges, traces, dilated, x, color, mask in samples:
            room = stinet_ref.RoomTensors(nv, edges, traces, dilated, device)
            leaves = {k: v.requires_grad_(True) for k, v in W.items()}
            out = stinet_ref.forward(leaves, args, room,
                                     torch.as_tensor(x, device=device),
                                     precision)
            lv = loss(out, torch.as_tensor(color, device=device),
                      torch.as_tensor(mask, device=device), half)
            names = list(leaves)
            grads = torch.autograd.grad(lv, [leaves[k] for k in names])
            grads = dict(zip(names, grads))
            losses.append(float(lv.detach()))
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
                first_out = out.detach().clone()
            W = {k: v.detach() for k, v in W.items()}
            opt.step(W, grads)
            del out, lv, grads, room
    return losses, first, W, first_out
