"""The port stands alone: stinet_tpu_torch and chip_smoke.py import neither
JAX nor the JAX package (nor msgpack, which the card's image lacks), and
entry points never quietly fall back to the CPU."""
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
    # msgpack: the card's image lacks it; the port decodes flax's format
    # itself (utils/convert_perceptual_weights.py)
    return top in ("jax", "jaxlib", "flax", "optax", "stinet_tpu", "msgpack")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "sweep_k1.py"]


def test_import_leaves_jax_and_stinet_tpu_unloaded():
    code = (
        "import importlib, pkgutil, sys\n"
        "import stinet_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'stinet_tpu', 'msgpack'))\n"
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


def _c_param_type(param: str):
    from stinet_tpu_torch.ops import _cuda
    if "*" in param or param.startswith("cudaStream_t"):
        return _cuda._VP
    kind = param.split()[0]
    return {"int": _cuda._I, "int64_t": _cuda._I64, "float": _cuda._F}[kind]


@pytest.mark.parametrize("source", ["ell_edge_conv", "instance_norm",
                                    "windowed_edge_conv"])
def test_ctypes_signatures_match_the_c_launchers(source):
    """Each launcher's ctypes argtypes (ops/_cuda.py) name its C
    parameters one for one: a missing int shifts the stream pointer."""
    import re
    from stinet_tpu_torch.ops import _cuda
    text = (PORT / "ops" / "cuda" / f"{source}.cu").read_text()
    declared = {
        m.group(1): [_c_param_type(p.strip())
                     for p in m.group(2).split(",")]
        for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*\{', text,
                             re.S)}
    signatures = _cuda._SIGNATURES[source]
    assert signatures and set(signatures) <= set(declared)
    for fn, argtypes in signatures.items():
        assert argtypes == declared[fn], fn


def test_native_builder_compiles_the_ports_own_source():
    """graph/native builds and loads its own copy of graph_builder.cpp
    into stinet_tpu_torch/_build/, never the JAX package's file or
    library, and its binding is among the sources checked above."""
    from stinet_tpu_torch.graph import native
    assert PORT / "graph" / "native" / "__init__.py" in _port_sources()
    assert native.SRC == PORT / "graph" / "native" / "graph_builder.cpp"
    assert native.lib_path().parent == PORT / "_build"
    assert pathlib.Path(native.get_lib()._name).parent == PORT / "_build"
