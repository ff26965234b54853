"""Trained-model IO, the port's `stinet_tpu/utils/model_io.py`: browse the
runs under `<save_root>/models/<experiment>/` and find a run's checkpoint,
model_best first, else the highest epoch (the reference's
utils/model_io_utils.py:57-84), over `core/checkpoint.py`'s
`latest_checkpoint`; and export a served forward so it runs later without
model code (`export_serving`, `load_serving`), the counterpart of the
reference's TorchScript export (model_io_utils.py:88-133).

The artifact is `torch.export`'s own format (`torch.export.save`). The JAX
package writes serialized StableHLO from `jax.export`; the two formats are
not interchangeable, and neither package reads the other's."""
from pathlib import Path

import torch
from torch import nn

from stinet_tpu_torch.core.checkpoint import latest_checkpoint
from stinet_tpu_torch.graph.hierarchy import map_tensors, tensor_leaves


def list_runs(experiment_name: str, save_root: str = "saved"):
    """The run directories of an experiment, sorted by name (the trainer
    names them by start time, so the last is the newest)."""
    base = Path(save_root) / "models" / experiment_name
    return sorted(p for p in base.glob("*") if p.is_dir())


def find_checkpoint(experiment_name: str, run_id: str = None,
                    save_root: str = "saved"):
    """The checkpoint of the newest run (run_id None) or of the last run
    whose name holds `run_id`: model_best, else the highest epoch. Raises
    FileNotFoundError when there is no such run or it has no checkpoint."""
    runs = list_runs(experiment_name, save_root)
    if not runs:
        raise FileNotFoundError(
            f"no runs for experiment {experiment_name!r} under {save_root}")
    if run_id is not None:
        matches = [r for r in runs if run_id in r.name]
        if not matches:
            raise FileNotFoundError(f"no run matching {run_id!r}")
        run = matches[-1]
    else:
        run = runs[-1]
    ckpt = latest_checkpoint(run)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoints in {run}")
    return ckpt


class _FlatArgs(nn.Module):
    """`module(*args)` called with the tensor leaves of `args` (in
    `tensor_leaves` order) and the rest of `args` (dataclass layout, None
    leaves, static ints such as a halo) fixed to the example's."""

    def __init__(self, module: nn.Module, example_args):
        super().__init__()
        self.module = module
        self._template = example_args

    def forward(self, *leaves):
        it = iter(leaves)
        args = map_tensors(self._template, lambda _: next(it))
        return self.module(*args)


def export_serving(module: nn.Module, example_args, out_path: str) -> str:
    """Export `module(*example_args)` with `torch.export` (its parameters
    as the program's) and save it to `out_path`; load it with
    `load_serving` and call it without model code.

    The program's calling convention is the FLAT tensor-leaf list of
    `example_args` (graph dataclasses, with int-keyed dicts of dilated
    edge sets, are flattened here as the JAX export flattens them), and it
    is specialised to the example: every shape, every static int (halo,
    num_graphs) and the device. Pass arguments congruent with
    `example_args`, on its device. The kernels of the served path enter the
    program as the custom ops of ops/library.py."""
    with torch.no_grad():
        program = torch.export.export(
            _FlatArgs(module, tuple(example_args)),
            tuple(tensor_leaves(tuple(example_args))), strict=False)
    torch.export.save(program, out_path)
    return out_path


def load_serving(path: str):
    """A callable taking the same (structured) arguments as the exported
    module; they are flattened to the program's leaf convention. It runs
    with gradients off and f32 matmuls in full f32 (TF32 off), as the
    server's forward does."""
    from stinet_tpu_torch.ops import library  # noqa: F401 (the custom ops)
    from stinet_tpu_torch.serving import full_f32_matmuls
    program = torch.export.load(path).module()

    def call(*args):
        with torch.no_grad(), full_f32_matmuls():
            return program(*tensor_leaves(args))

    return call
