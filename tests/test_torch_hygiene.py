"""The port stands alone: stinet_tpu_torch and chip_smoke.py import neither
JAX nor the JAX package, and entry points never quietly fall back to the
CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.serving import SceneInpainter

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "stinet_tpu_torch"


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "stinet_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_and_stinet_tpu_unloaded():
    code = (
        "import importlib, pkgutil, sys\n"
        "import stinet_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'stinet_tpu'))\n"
        "print(len([m for m in sys.modules if m.startswith(pkg.__name__)]))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15  # every submodule was imported


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_scene_inpainter_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = define_G(10, 3, 8, "edgeconvtransinv", norm="instance",
                     n_blocks=1, pooling_type="max")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SceneInpainter(model, model.state_dict())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SceneInpainter(model, model.state_dict(), device="cuda:0")
    assert SceneInpainter(model, model.state_dict(),
                          device="cpu").device.type == "cpu"
