"""The port's config parser, transforms, prefetch thread and ScanNet loader
(stinet_tpu_torch/core/config.py, stinet_tpu_torch/data/) against the JAX
package's, on the CPU.

Every comparison here is exact: the transforms, the loader's per-sample
randomness and the graph build are numpy code that the port copies, so the
same scenes, seed and epoch give the same bits, leaf for leaf.
"""
import argparse
import collections
import copy
import json
import os
import threading
import time

import numpy as np
import pytest

from stinet_tpu.core import config as jax_config
from stinet_tpu.data import prefetch as jax_prefetch
from stinet_tpu.data import scannet as jax_scannet
from stinet_tpu.data import transforms as jax_transforms
from stinet_tpu.graph import build as jax_build
from stinet_tpu_torch.core import config as port_config
from stinet_tpu_torch.data import prefetch as port_prefetch
from stinet_tpu_torch.data import scannet as port_scannet
from stinet_tpu_torch.data import transforms as port_transforms
from stinet_tpu_torch.graph import build as port_build
from stinet_tpu_torch.utils.synthetic import (
    synthetic_scene, write_loader_scene)
from test_torch_graph import assert_same_tree
from test_train_e2e import make_3d_config, write_fake_scene


# --- transforms -------------------------------------------------------------

def _sample(mod, rng):
    nv = [150, 50, 17]
    x = rng.normal(size=(nv[0], 10)).astype(np.float32)
    edges = [rng.integers(0, v, size=(2, 4 * v)) for v in nv]
    edges[0][:, :20] = np.arange(20)        # a few self loops to remove
    return mod.RawHierarchy(
        x=x, color=rng.uniform(-1, 1, size=(nv[0], 3)).astype(np.float32),
        mask=np.zeros((nv[0], 1), np.float32), num_vertices=nv,
        level_edges=edges,
        traces=[rng.integers(0, nv[1], size=nv[0]),
                rng.integers(0, nv[2], size=nv[1])], name="s")


TRANSFORMS = [
    ("ColorNormalization", {"begin": -1.0, "end": 1.0}),
    ("CoordsNormalization", {"max_sizes": [1.5, 2.0, 0.5]}),
    ("RandomRotation", {}),
    ("RandomLinearTransformation", {"flip": True}),
    ("MoveToOrigin", {}),
    ("AddSelfLoops", {}),
]


@pytest.mark.parametrize("name,args", TRANSFORMS, ids=[t[0] for t in
                                                       TRANSFORMS])
def test_transform_matches_jax_bitwise(name, args):
    want = jax_transforms.TRANSFORMS.get(name)(**args)(
        _sample(jax_build, np.random.default_rng(0)),
        np.random.default_rng(7))
    got = port_transforms.TRANSFORMS.get(name)(**args)(
        _sample(port_build, np.random.default_rng(0)),
        np.random.default_rng(7))
    np.testing.assert_array_equal(got.x, want.x)
    assert got.x.dtype == want.x.dtype
    for a, b in zip(got.level_edges, want.level_edges):
        np.testing.assert_array_equal(a, b)


def test_compose_matches_jax_and_names_unknown_types():
    cfg = [{"type": n, "args": a} for n, a in TRANSFORMS]
    want = jax_transforms.compose(cfg)(
        _sample(jax_build, np.random.default_rng(1)),
        np.random.default_rng(2))
    got = port_transforms.compose(cfg)(
        _sample(port_build, np.random.default_rng(1)),
        np.random.default_rng(2))
    np.testing.assert_array_equal(got.x, want.x)
    with pytest.raises(KeyError, match="Unknown transform type 'Nope'"):
        port_transforms.compose([{"type": "Nope"}])


# --- prefetch ---------------------------------------------------------------

def test_prefetch_keeps_order():
    assert list(port_prefetch.PrefetchIterator(iter(range(50)),
                                               buffer_size=3)) == list(
        jax_prefetch.PrefetchIterator(iter(range(50)), buffer_size=3))


def test_prefetch_raises_the_producers_error_at_next():
    def gen():
        yield 1
        yield 2
        raise ValueError("scene 3 is broken")

    it = port_prefetch.PrefetchIterator(gen())
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(ValueError, match="scene 3 is broken"):
        next(it)


def test_prefetch_close_ends_the_producer_and_wakes_the_consumer():
    started = threading.Event()

    def endless():
        i = 0
        while True:
            started.set()
            yield i
            i += 1

    it = port_prefetch.PrefetchIterator(endless(), buffer_size=2)
    assert next(it) == 0
    started.wait(5)
    time.sleep(0.3)                  # the producer parks on a full queue
    it.close()
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)

    # a consumer blocked in next() on a producer that yields nothing
    gate = threading.Event()

    def stalled():
        gate.wait(10)
        yield "late"

    it = port_prefetch.PrefetchIterator(stalled())
    got = []
    consumer = threading.Thread(target=lambda: got.extend(it))
    consumer.start()
    time.sleep(0.2)
    it.close()
    consumer.join(timeout=5)
    assert not consumer.is_alive() and got == []
    gate.set()
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()


# --- config -----------------------------------------------------------------

CustomArgs = collections.namedtuple("CustomArgs", "flags type target")
OPTIONS = [CustomArgs(["--lr", "--learning_rate"], type=float,
                      target="optimizer;args;lr"),
           CustomArgs(["--ld", "--log_dir"], type=str,
                      target="trainer;save_dir")]


def _parser():
    """The root train.py's flags."""
    ap = argparse.ArgumentParser()
    for flags in (("-c", "--config"), ("-r", "--resume"), ("-d", "--device"),
                  ("-n", "--name"), ("-m", "--message"),
                  ("-g", "--git_hash"), ("-e", "--eval")):
        ap.add_argument(*flags, default=None, type=str)
    ap.add_argument("-t", "--dry_run", default=False, type=bool)
    ap.add_argument("-v", "--vis", default=False, action="store_true")
    return ap


def _parse(mod, argv, monkeypatch):
    monkeypatch.setattr("sys.argv", ["train.py", *argv])
    return mod.ConfigParser.from_args(_parser(), options=OPTIONS)


def test_config_parser_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = make_3d_config(tmp_path, "train", "val")
    cfg["trainer"]["save_dir"] = "ignored"
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    argv = ["-c", str(path), "--lr", "0.5", "--ld", str(tmp_path / "runs"),
            "-n", "run", "-m", "a message", "-g", "abc"]
    want = _parse(jax_config, argv, monkeypatch)
    got = _parse(port_config, argv, monkeypatch)
    assert got.config == want.config
    assert got["optimizer"]["args"]["lr"] == 0.5
    assert got.config["description"] == "a message"
    assert got.config["git_hash"] == "abc"
    assert got.save_dir.parent == want.save_dir.parent == (
        tmp_path / "runs" / "models" / cfg["name"])
    assert got.log_dir.parent == want.log_dir.parent == (
        tmp_path / "runs" / "log" / cfg["name"])
    for d in (got.save_dir, got.log_dir):
        assert d.name.endswith("_run")
        assert json.loads((d / "config.json").read_text()) == got.config
    assert (got.log_dir / "info.log").exists()
    assert got.device is None

    # resume: the config is found next to the checkpoint
    ckpt = got.save_dir / "checkpoint-epoch1.ckpt"
    ckpt.write_bytes(b"")
    argv = ["-r", str(ckpt), "-t", "1", "-e", "valid", "-v"]
    want = _parse(jax_config, argv, monkeypatch)
    got = _parse(port_config, argv, monkeypatch)
    assert got.config == want.config
    assert got.resume == want.resume == ckpt
    assert got.config["eval"] == "valid" and got.config["vis"]
    assert got.dry_run


def test_config_device_flag(tmp_path, monkeypatch):
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"name": "x", "trainer": {
        "save_dir": str(tmp_path)}}))
    for device in ("cpu", "cuda", "cuda:1"):
        assert _parse(port_config, ["-c", str(path), "-t", "1", "-d",
                                    device], monkeypatch).device == device
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    got = _parse(port_config, ["-c", str(path), "-t", "1", "-d", "0,1"],
                 monkeypatch)
    assert got.device is None
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0,1"
    with pytest.raises(ValueError, match="Configuration file"):
        _parse(port_config, ["-t", "1"], monkeypatch)


# --- the ScanNet loader -----------------------------------------------------

SPLIT_TRAIN = port_scannet.read_split(port_scannet.SCANNET_TRAIN_FILE)
SPLIT_VAL = port_scannet.read_split(port_scannet.SCANNET_VAL_FILE)


def test_split_lists_are_the_jax_packages():
    for name in ("TRAIN", "VAL", "TEST"):
        key = f"SCANNET_{name}_FILE"
        assert port_scannet.read_split(getattr(port_scannet, key)) == \
            jax_scannet.read_split(getattr(jax_scannet, key))
    with pytest.raises(AssertionError, match="leak"):
        port_scannet.compare_train_val(["a_00", "b_00"], ["b_00"])


@pytest.fixture(scope="module")
def scene_roots(tmp_path_factory):
    """4 train and 2 val scenes, each written twice: random-edge scenes
    (tests/test_train_e2e.py's writer) and grid scenes that band under
    RCM, so the windowed build keeps banded tables."""
    base = tmp_path_factory.mktemp("scenes")
    roots = {}
    rng = np.random.default_rng(0)
    for kind in ("random", "grid"):
        for split, names in (("train", SPLIT_TRAIN[:4]),
                             ("val", SPLIT_VAL[:2])):
            root = str(base / kind / split)
            for i, name in enumerate(names):
                if kind == "random":
                    write_fake_scene(root, name, rng, v0=120 + 30 * i)
                else:
                    write_loader_scene(root, name, synthetic_scene(
                        num_vertices=1024 + 256 * i, levels=3, seed=i,
                        dilation_dists=(2, 4)))
            roots[kind, split] = root
    return roots


def _loader_config(tmp_path, roots, kind, batch, windowed):
    args = make_3d_config(tmp_path, roots[kind, "train"],
                          roots[kind, "val"])["data_loader"]["args"]
    args.update(train_batch_size=batch, test_batch_size=batch,
                windowed_graphs=windowed)
    return args


@pytest.mark.parametrize("windowed", [False, True],
                         ids=["plain", "windowed"])
@pytest.mark.parametrize("batch", [1, 2])
def test_loader_matches_jax_leaf_for_leaf(tmp_path, scene_roots, monkeypatch,
                                          batch, windowed):
    """Two epochs of train and val batches (the train set shuffled and
    augmented by RandomLinearTransformation and RandomRotation): every
    batch equal leaf for leaf, with the same scene names. Both builders
    take their numpy paths, RCM through scipy."""
    monkeypatch.setattr(jax_build._native, "available", lambda: False)
    monkeypatch.setattr(port_build._native, "available", lambda: False)
    _loader_matches_jax(tmp_path, scene_roots, batch, windowed)


@pytest.mark.parametrize("batch", [1, 2])
def test_native_windowed_loader_matches_jax_native(tmp_path, scene_roots,
                                                   batch):
    """The windowed batches with both native builders (one C++ RCM)."""
    assert port_build._native.available() and jax_build._native.available()
    _loader_matches_jax(tmp_path, scene_roots, batch, True)


def _loader_matches_jax(tmp_path, scene_roots, batch, windowed):
    kind = "grid" if windowed else "random"
    args = _loader_config(tmp_path, scene_roots, kind, batch, windowed)
    want = jax_scannet.ScanNetGraphColorDataLoader(copy.deepcopy(args),
                                                   seed=5)
    got = port_scannet.ScanNetGraphColorDataLoader(copy.deepcopy(args),
                                                   seed=5)
    assert got.train_dataset.index2filenames == \
        want.train_dataset.index2filenames
    halos = 0
    for _ in range(2):
        for name in ("train_loader", "val_loader"):
            a, b = getattr(got, name), getattr(want, name)
            assert len(a) == len(b) == (4 if name == "train_loader" else 2
                                        ) // batch
            pairs = list(zip(a, b))
            assert len(pairs) == len(b)
            for (pg, pnames), (jg, jnames) in pairs:
                assert pnames == jnames
                assert_same_tree(pg, jg)
                halos += pg.levels[0].edges.halo is not None
    assert len(got.train_loader.build_ms) == 2 * len(got.train_loader)
    assert (halos > 0) == windowed


def test_loader_skip_epoch_advances_as_an_iteration(tmp_path, scene_roots):
    args = _loader_config(tmp_path, scene_roots, "random", 1, False)
    a = port_scannet.ScanNetGraphColorDataLoader(copy.deepcopy(args))
    b = port_scannet.ScanNetGraphColorDataLoader(copy.deepcopy(args))
    a.train_loader.skip_epoch()
    list(b.train_loader)
    for (ga, na), (gb, nb) in zip(a.train_loader, b.train_loader):
        assert na == nb
        assert_same_tree(ga, gb)


@pytest.mark.parametrize("kind", ["random", "grid"])
def test_stacked_loader_matches_jax(tmp_path, scene_roots, monkeypatch,
                                    kind):
    """`stacked_batching` at B=2 on the random scenes (spill lists, ragged
    children tables) and the grid scenes: the run's frozen layout (vertex
    buckets and table widths) equal to JAX's, and two epochs of stacked
    train and val batches equal leaf for leaf, with the same names. Both
    builders take their numpy paths. (Windowed stacked batches of these
    grid scenes have different halos, which JAX's `stack_graphs` refuses.)
    """
    monkeypatch.setattr(jax_build._native, "available", lambda: False)
    monkeypatch.setattr(port_build._native, "available", lambda: False)
    args = _loader_config(tmp_path, scene_roots, kind, 2, False)
    args["stacked_batching"] = True
    want = jax_scannet.ScanNetGraphColorDataLoader(copy.deepcopy(args),
                                                   seed=5)
    got = port_scannet.ScanNetGraphColorDataLoader(copy.deepcopy(args),
                                                   seed=5)
    assert got.stacked and want.stacked
    for name in ("train_loader", "val_loader"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.signature == b.signature, name
    for _ in range(2):
        for name in ("train_loader", "val_loader"):
            pairs = list(zip(getattr(got, name), getattr(want, name)))
            assert len(pairs) == (2 if name == "train_loader" else 1)
            for (pg, pnames), (jg, jnames) in pairs:
                assert pnames == jnames and len(pnames) == 2
                assert pg.x.shape[0] == 2
                assert_same_tree(pg, jg)


def test_load_scene_npz_matches_jax(scene_roots):
    path = os.path.join(scene_roots["grid", "train"], "graphs",
                        SPLIT_TRAIN[0] + ".npz")
    for got, want in zip(port_scannet.load_scene_npz(path, 3),
                         jax_scannet.load_scene_npz(path, 3)):
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for l in want:
                for d in want[l]:
                    np.testing.assert_array_equal(got[l][d], want[l][d])
        elif isinstance(want, list) and want and isinstance(
                want[0], np.ndarray):
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)
        else:
            assert got == want


def test_write_loader_scene_round_trips(tmp_path):
    """A scene written by utils/synthetic.py:write_loader_scene reads back
    through the loader's dataset as itself: the same 10 input channels
    (colors to float rounding, since the file holds them in [0, 1]), mask,
    edges, traces and dilated edge sets."""
    scene = synthetic_scene(num_vertices=1500, levels=3, seed=4,
                            dilation_dists=(2, 4))
    name = SPLIT_VAL[0]
    write_loader_scene(str(tmp_path), name, scene)
    ds = port_scannet.ScanNetGraphColorDataSet(
        str(tmp_path), "rad_16", 3, is_train=False, enabled_mask_ids=[0])
    got = ds[0]
    assert got.name == name and got.num_vertices == scene.num_vertices
    np.testing.assert_allclose(got.x, scene.x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.color, scene.color, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.mask, scene.mask)
    for a, b in zip(got.level_edges + got.traces,
                    scene.level_edges + scene.traces):
        np.testing.assert_array_equal(a, b)
    assert sorted(got.dilated) == sorted(scene.dilated)
    for level, dists in scene.dilated.items():
        for d, e in dists.items():
            np.testing.assert_array_equal(got.dilated[level][d], e)
