"""The port's small utilities (stinet_tpu_torch/utils/misc.py, model_io.py,
convert_perceptual_weights.py) against the JAX package's, on the CPU.

- misc: the same files, strings and loops as JAX's functions;
- list_runs / find_checkpoint: model_best first, else the highest epoch,
  else FileNotFoundError, on the same run directories as JAX's;
- load_msgpack: the port's own decoder gives flax's `msgpack_restore` tree
  bitwise on files written by flax (every type the format holds, chunked
  arrays included). The perceptual loaders on files written by the JAX
  package's `_save` are held in tests/test_torch_perceptual.py;
- export_serving / load_serving (`SceneInpainter.export`): the exported
  forward, saved, reloaded and called on the CPU, equals `predict`'s
  forward bitwise (the same torch ops; the kernels enter as the custom ops
  of ops/library.py, which run the plain versions on the CPU).
No JAX compile.
"""
import argparse

import numpy as np
import pytest
import torch
from flax import serialization

from stinet_tpu.utils import misc as jax_misc
from stinet_tpu.utils import model_io as jax_model_io
from stinet_tpu.utils.convert_perceptual_weights import (
    _save as jax_save, load_msgpack as jax_load_msgpack)
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.parallel.mesh import make_mesh
from stinet_tpu_torch.serving import SceneInpainter
from stinet_tpu_torch.utils import misc, model_io
from stinet_tpu_torch.utils.convert_perceptual_weights import (
    load_msgpack, unpackb)
from stinet_tpu_torch.utils.synthetic import synthetic_scene


def test_read_write_json_match_jax(tmp_path):
    obj = {"b": [1, 2.5, None], "a": {"nested": "x"}}
    misc.write_json(obj, tmp_path / "port.json")
    jax_misc.write_json(obj, tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    assert misc.read_json(tmp_path / "jax.json") == obj


def test_inf_loop_repeats_the_loader():
    it = misc.inf_loop([1, 2, 3])
    assert [next(it) for _ in range(7)] == [1, 2, 3, 1, 2, 3, 1]


@pytest.mark.parametrize("args", [
    argparse.Namespace(config="c.json", device=None, resume="r"),
    {"lr": 0.1, "a_long_name": True}, {}])
def test_pretty_print_arguments_matches_jax(args):
    assert misc.pretty_print_arguments(args) == \
        jax_misc.pretty_print_arguments(args)


def test_clear_folder(tmp_path):
    folder = tmp_path / "out"
    misc.clear_folder(folder)
    (folder / "stale.txt").write_text("x")
    misc.clear_folder(folder)
    assert folder.is_dir() and not any(folder.iterdir())


def _run(root, name, files):
    run = root / "models" / "exp" / name
    run.mkdir(parents=True)
    for f in files:
        (run / f).write_bytes(b"")
    return run


def test_list_runs_and_find_checkpoint_match_jax(tmp_path):
    root = tmp_path / "saved"
    for mod in (model_io, jax_model_io):
        with pytest.raises(FileNotFoundError, match="no runs"):
            mod.find_checkpoint("exp", save_root=str(root))
    a = _run(root, "0101_000000", ["checkpoint-epoch2.ckpt",
                                   "checkpoint-epoch10.ckpt",
                                   "checkpoint-epoch9.ckpt"])
    b = _run(root, "0102_000000", ["checkpoint-epoch1.ckpt",
                                   "model_best.ckpt"])
    c = _run(root, "0103_000000", [])
    (root / "models" / "exp" / "not_a_run.txt").write_text("")
    assert model_io.list_runs("exp", str(root)) == [a, b, c] == \
        jax_model_io.list_runs("exp", str(root))
    cases = [("0101", a / "checkpoint-epoch10.ckpt"),
             ("0102", b / "model_best.ckpt")]
    for run_id, want in cases:
        for mod in (model_io, jax_model_io):
            assert mod.find_checkpoint("exp", run_id, str(root)) == want
    for mod in (model_io, jax_model_io):
        with pytest.raises(FileNotFoundError, match="no checkpoints"):
            mod.find_checkpoint("exp", save_root=str(root))   # newest: c
        with pytest.raises(FileNotFoundError, match="no run matching"):
            mod.find_checkpoint("exp", "0199", str(root))
    assert model_io.list_runs("other", str(root)) == []


def _assert_same(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.shape == want.shape, path
        if want.dtype.name == "bfloat16":
            assert got.dtype == np.float32, path
            want = want.astype(np.float32)
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def _tree():
    rng = np.random.default_rng(0)
    import ml_dtypes
    return {
        "params": {"conv_0": {"kernel": rng.normal(size=(3, 3, 4, 8))
                              .astype(np.float32),
                              "bias": np.zeros(8, np.float32)},
                   "Dense_1": {"kernel": rng.normal(size=(30, 700))
                               .astype(np.float32)}},
        "lins": [rng.random((1, 64, 1, 1)).astype(np.float32),
                 np.arange(5, dtype=np.int64)],
        "scalars": {"i": -3, "big": 2 ** 40, "neg_big": -(2 ** 40),
                    "small": 7, "f": 1.5, "t": True, "n": None,
                    "s": "x" * 40, "b": b"\x00\x01",
                    "np": np.float32(2.5), "c": 1 + 2j},
        "dtypes": {str(d): np.arange(6).astype(d).reshape(2, 3)
                   for d in (np.int8, np.uint16, np.int32, np.float16,
                             np.float64, np.bool_)},
        "bf16": rng.normal(size=(4, 5)).astype(ml_dtypes.bfloat16),
        "empty": {}, "long_list": list(range(20)),
        "wide_map": {f"k{i}": i for i in range(20)},
    }


def test_load_msgpack_matches_flax(tmp_path, monkeypatch):
    """Every type flax's msgpack holds, and an array above the chunk size
    (the chunk size made small, as flax splits arrays above 2**30 bytes)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 2 ** 16)
    tree = _tree()
    path = tmp_path / "tree.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    raw = unpackb(path.read_bytes())
    assert raw["params"]["Dense_1"]["kernel"]["__msgpack_chunked_array__"]
    want = jax_load_msgpack(str(path))
    got = load_msgpack(str(path))
    _assert_same(got, want)
    assert got["params"]["Dense_1"]["kernel"].shape == (30, 700)


def test_load_msgpack_of_the_jax_packages_save(tmp_path):
    """A file written by the JAX package's converter (`_save`) reads back
    as its `load_msgpack` reads it."""
    tree = {"params": {f"conv_{i}": {
        "kernel": np.full((3, 3, 2, 2), i, np.float32),
        "bias": np.arange(2, dtype=np.float32)} for i in range(3)}}
    jax_save(tree, str(tmp_path / "w.msgpack"))
    _assert_same(load_msgpack(str(tmp_path / "w.msgpack")),
                 jax_load_msgpack(str(tmp_path / "w.msgpack")))


@pytest.mark.parametrize("data,match", [
    (b"\x92\x01", "truncated"), (b"\xc1", "unknown type byte"),
    (b"\x01\x02", "after the object"), (b"\xd4\x09\x00", "extension")])
def test_unpackb_refuses_bad_input(data, match):
    with pytest.raises(ValueError, match=match):
        unpackb(data)


EXPORT_MODELS = {
    # the tiny flagship layout, f32, plain tables
    "f32": (dict(ngf=8, n_blocks=2, dilations=[1, 2]), None, False, 600),
    # flagship widths, bf16, windowed: convs at H = 128 take K3a's op
    "bf16-windowed": (dict(ngf=64, n_blocks=1, dilations=[2]),
                      torch.bfloat16, True, 4096),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's intra-op pool at one thread while this module runs (under
    pytest-xdist every worker's default pool takes all the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", list(EXPORT_MODELS))
def test_exported_forward_equals_predict(tmp_path, case):
    widths, dtype, windowed, n = EXPORT_MODELS[case]
    model = define_G(input_nc=10, output_nc=3, filter_type="edgeconvtransinv",
                     norm="instance", pooling_type="max", n_levels=2,
                     n_repeated_io_convs=1, dtype=dtype,
                     generator=torch.Generator().manual_seed(4), **widths)
    scene = synthetic_scene(num_vertices=n, levels=3, seed=2,
                            dilation_dists=(2, 4))
    server = SceneInpainter(model, model.state_dict(), device="cpu",
                            windowed=windowed, mesh=make_mesh(2, "cpu"))
    path = server.export(scene, str(tmp_path / "served.pt2"))
    graph, order = server._build_scene(scene)
    got = model_io.load_serving(path)(server._inference_graph(graph))
    want = server.forward(server.place(graph))
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    ops = {str(node.target) for node in torch.export.load(path).graph.nodes}
    need = {"stinet.ell_edge_conv_sum.default",
            "stinet.masked_instance_norm.default"}
    if windowed:
        need.add("stinet.windowed_edge_conv_sum.default")
    assert need <= ops, sorted(o for o in ops if "stinet" in o)
