"""Checkpoints of the port, with the layout of `stinet_tpu/core/checkpoint.py`.

A checkpoint file holds one dict,

    {"state_dicts": {name: model state dict},
     "optimizers":  {name: optimizer state dict},
     "extra":       {...}},

written with `torch.save`, and beside it `<path>.meta.json` holds the
metadata (archs, epoch, monitor_best, the resolved config), as the JAX
package writes it. The JAX package's files are flax msgpack and are not
read here; the port reads only its own.

Files are loaded with `weights_only=True`: tensors, numbers, strings and
containers of them, which is all a state dict holds.
"""
import json
from pathlib import Path

import torch


def save_checkpoint(path, models, opt_states, epoch, monitor_best, config,
                    archs=None, extra=None):
    """models / opt_states: dicts name -> state dict (`module.state_dict()`,
    `optimizer.state_dict()`)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dicts": dict(models), "optimizers": dict(opt_states),
                "extra": dict(extra or {})}, path)
    meta = {
        "archs": archs or {name: name for name in models},
        "epoch": int(epoch),
        "monitor_best": float(monitor_best),
        "config": config,
    }
    with open(str(path) + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(path):
    """Returns (state_dicts, optimizer states, extra, meta), each a dict
    of CPU tensors and values; load them into fresh modules and optimizers
    with `load_state_dict`."""
    state = _load(path)
    with open(str(path) + ".meta.json") as f:
        meta = json.load(f)
    return state["state_dicts"], state["optimizers"], state["extra"], meta


def latest_checkpoint(run_dir):
    """Newest checkpoint of a run directory: model_best if present, else
    the highest epoch (None when there is neither)."""
    run_dir = Path(run_dir)
    best = run_dir / "model_best.ckpt"
    if best.exists():
        return best
    cands = sorted(run_dir.glob("checkpoint-epoch*.ckpt"),
                   key=lambda p: int("".join(filter(str.isdigit, p.stem))))
    return cands[-1] if cands else None


def load_model_params(path, name):
    """The state dict of model `name` (CPU tensors), without the optimizer
    states (serving, standalone evaluation)."""
    return _load(path)["state_dicts"][name]
