"""The port's trainer (stinet_tpu_torch/trainers/, stinet_tpu_torch/train.py)
against the JAX package's Inpainting3DTrainer, on the CPU.

The two trainers run on the same fabricated scenes (tests/test_train_e2e.py's
writer and config: ngf 8, 3 blocks, f32, checkpointed bottleneck) from the
same weights: the JAX trainer's initial parameters, carried across by
utils/convert.state_dict_from_jax_params. The loaders give both the same
batches (tests/test_torch_data.py holds them leaf for leaf), so:
- each step's loss agrees within rtol 1e-4, the f32 train step's tolerance
  (tests/test_torch_train.py): the f32 sums run in another order;
- so do the epoch logs, train and val, key for key;
- with num_cumulated_train_batches 2 (optax.MultiSteps in JAX, which steps
  on the running mean of the gradients; the port sums loss / 2) as well.
The config's seed (49) is tests/test_train_e2e.py's; no step of it puts a
relu argument within rounding of 0 (tests/test_torch_train.py says why that
matters), and nothing here was tuned to it.
"""
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stinet_tpu.core.config import ConfigParser as JaxConfigParser
from stinet_tpu.core.registry import TRAINERS as JAX_TRAINERS
import stinet_tpu.trainers  # noqa: F401
from stinet_tpu.trainers import base as jax_base
from stinet_tpu_torch.core import checkpoint
from stinet_tpu_torch.core.config import ConfigParser
from stinet_tpu_torch.data.prefetch import PrefetchIterator
from stinet_tpu_torch.data.scannet import (
    SCANNET_TRAIN_FILE, SCANNET_VAL_FILE, read_split)
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.serving import SceneInpainter
from stinet_tpu_torch.trainers import base as port_base
from stinet_tpu_torch.trainers import graph_common as gc
from stinet_tpu_torch.trainers.inpainting3d import Inpainting3DTrainer
from stinet_tpu_torch.utils.convert import state_dict_from_jax_params
from test_train_e2e import make_3d_config, write_fake_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4
ARGS = ("SurfaceTextureInpaintingNet", "args")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("scenes")
    rng = np.random.default_rng(0)
    out = {}
    for split, names, sizes in (
            ("train", read_split(SCANNET_TRAIN_FILE)[:2], (180, 240)),
            ("val", read_split(SCANNET_VAL_FILE)[:1], (210,))):
        out[split] = str(base / split)
        for name, v0 in zip(names, sizes):
            write_fake_scene(out[split], name, rng, v0=v0)
    return out


def _config(tmp_path, roots, accumulate=1, epochs=2):
    cfg = make_3d_config(tmp_path, roots["train"], roots["val"])
    cfg["data_loader"]["args"]["num_cumulated_train_batches"] = accumulate
    cfg["trainer"]["epochs"] = epochs
    return cfg


def _record_losses(trainer, jax_side):
    losses, step = [], trainer._train_step

    def recorded(*args):
        out = step(*args)
        losses.append(float((out[1] if jax_side else out)["loss"]))
        return out

    trainer._train_step = recorded
    return losses


@pytest.mark.parametrize("accumulate", [1, 2])
def test_trainer_matches_jax(tmp_path, roots, accumulate):
    cfg = _config(tmp_path, roots, accumulate)
    want_trainer = JAX_TRAINERS.get("Inpainting3DTrainer")(
        JaxConfigParser(copy.deepcopy(cfg), dry_run=True))
    trainer = Inpainting3DTrainer(
        ConfigParser(copy.deepcopy(cfg), dry_run=True), device="cpu")
    trainer.model.load_state_dict(
        state_dict_from_jax_params(want_trainer.state.params))
    step = trainer._train_step
    want_losses = _record_losses(want_trainer, jax_side=True)
    losses = _record_losses(trainer, jax_side=False)
    for epoch in (1, 2):
        want, got = (want_trainer._train_epoch(epoch),
                     trainer._train_epoch(epoch))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       err_msg=f"epoch {epoch} {k}")
    assert len(losses) == len(want_losses) == 4
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL)
    assert step.mini_step == 0
    assert [t["steps"] for t in trainer.epoch_timings] == [2, 2]


def test_train_checkpoint_resume_and_serve(tmp_path, roots):
    """One epoch with the accumulation left half way (k = 3, 2 steps), its
    checkpoints, a resume from them, model_best under min val_loss, and a
    server built from model_best."""
    cfg = _config(tmp_path, roots, accumulate=3, epochs=1)
    config = ConfigParser(copy.deepcopy(cfg))
    trainer = Inpainting3DTrainer(config, device="cpu")
    trainer.train()
    ckpt = config.save_dir / "checkpoint-epoch1.ckpt"
    best = config.save_dir / "model_best.ckpt"
    for path in (ckpt, best):
        assert path.exists() and os.path.exists(str(path) + ".meta.json")
    _, _, extra, meta = checkpoint.load_checkpoint(best)
    assert meta["epoch"] == 1 and meta["archs"] == {
        "graph": "SurfaceTextureInpaintingNet"}
    assert meta["monitor_best"] == trainer.mnt_best < np.inf
    assert extra["accumulation"]["mini_step"] == 2
    assert trainer._train_step.mini_step == 2

    resumed = Inpainting3DTrainer(
        ConfigParser(copy.deepcopy(cfg), resume=ckpt, dry_run=True),
        device="cpu")
    assert resumed.start_epoch == 2 and resumed.mnt_best == trainer.mnt_best
    for (k, a), b in zip(trainer.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(a, b), k
        assert torch.equal(a.grad, b.grad), k
    assert resumed._train_step.mini_step == 2
    want, got = trainer.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for i, st in want["state"].items():
        for k, v in st.items():
            assert torch.equal(v, got["state"][i][k]), (i, k)

    scene = trainer.data_loader.val_dataset[0]
    server = SceneInpainter.from_checkpoint(best, scene, device="cpu")
    model = define_G(**cfg["archs"][ARGS[0]]["args"])
    direct = SceneInpainter(model, trainer.model.state_dict(), device="cpu")
    np.testing.assert_array_equal(server.predict(scene),
                                  direct.predict(scene))


class _Scripted:
    """A trainer whose epochs return scripted val losses and which records
    what it saves."""

    def __init__(self, base, val_losses, early_stop, tmp_path):
        cfg = {"name": "s", "trainer": {
            "epochs": len(val_losses), "save_period": 2,
            "monitor": "min val_loss", "early_stop": early_stop,
            "verbosity": 0, "save_dir": str(tmp_path)}}
        parser = (ConfigParser if base is port_base else JaxConfigParser)(
            cfg, dry_run=False)
        saved = self.saved = []

        class T(base.BaseTrainer):
            def _train_epoch(self, epoch):
                return {"loss": 1.0, "val_loss": val_losses[epoch - 1]}

            def _eval(self, mode):
                pass

            def _save_checkpoint(self, epoch):
                saved.append(("checkpoint", epoch))

            def _save_best(self, epoch):
                saved.append(("best", epoch))

        self.trainer = T(parser)


@pytest.mark.parametrize("early_stop,want", [
    (1, [("best", 1), ("checkpoint", 2), ("best", 2), ("checkpoint", 4),
         ("best", 4)]),
    (10, [("best", 1), ("checkpoint", 2), ("best", 2), ("checkpoint", 4),
          ("best", 4), ("checkpoint", 6), ("best", 7)])])
def test_model_best_and_early_stop_match_jax(tmp_path, early_stop, want):
    """min val_loss: an equal loss counts as better; the run stops once
    more than early_stop epochs in a row did not improve, before it saves
    that epoch; checkpoints every save_period (2) epochs."""
    losses = [1.0, 0.5, 0.7, 0.5, 0.8, 0.9, 0.3]
    runs = [_Scripted(base, losses, early_stop, tmp_path / base.__name__)
            for base in (port_base, jax_base)]
    for r in runs:
        r.trainer.train()
    assert runs[0].saved == runs[1].saved == want
    assert runs[0].trainer.mnt_best == runs[1].trainer.mnt_best


def _cli(args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "stinet_tpu_torch.train", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **(env or {})))


def test_cli_trains_evaluates_and_needs_a_card(tmp_path, roots):
    cfg = _config(tmp_path, roots, epochs=1)
    cfg["trainer"]["verbosity"] = 1     # epoch logs at INFO
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    res = _cli(["-c", str(path), "-d", "cpu", "-n", "cli", "--lr", "1e-4"])
    assert res.returncode == 0, res.stderr[-3000:]
    run_dirs = list((tmp_path / "saved" / "models" / "test3d").glob("*_cli"))
    assert len(run_dirs) == 1
    run = run_dirs[0]
    for name in ("config.json", "checkpoint-epoch1.ckpt", "model_best.ckpt",
                 "model_best.ckpt.meta.json"):
        assert (run / name).exists(), name
    saved = json.loads((run / "config.json").read_text())
    assert saved["optimizer"]["args"]["lr"] == 1e-4
    assert "val_loss" in res.stdout

    res = _cli(["-r", str(run / "model_best.ckpt"), "-e", "valid", "-d",
                "cpu"])
    assert res.returncode == 0, res.stderr[-3000:]
    assert "psnr_mask_only" in res.stdout

    # no -d and no card: the trainer does not fall back to the CPU
    res = _cli(["-c", str(path), "-t", "1"], env={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert "pass device='cpu'" in res.stderr


def test_trainer_refuses_a_missing_card(tmp_path, roots, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(tmp_path, roots)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Inpainting3DTrainer(ConfigParser(cfg, dry_run=True))


def test_host_metrics_is_one_copy_of_every_value():
    metrics = {"loss": torch.tensor(0.25), "psnr": torch.tensor(
        31.5, dtype=torch.float64), "n": torch.tensor(7)}
    assert gc.host_metrics(metrics) == {"loss": 0.25, "psnr": 31.5,
                                        "n": 7.0}


def test_iter_placed_on_cpu_moves_and_stops_the_loader():
    """On a CPU device the graphs come through unchanged, in order; a
    caller that stops early stops the loader's prefetch thread too."""
    graphs = [(torch.full((3,), float(i)), [f"s{i}"]) for i in range(6)]

    class Graph:
        def __init__(self, x):
            self.x = x

        def to(self, device):
            return Graph(self.x.to(device))

    source = PrefetchIterator(iter([(Graph(x), n) for x, n in graphs]),
                              buffer_size=1)
    it = gc.iter_placed(source, torch.device("cpu"))
    got = [next(it) for _ in range(2)]
    assert [n for _, n in got] == [["s0"], ["s1"]]
    assert torch.equal(got[1][0].x, graphs[1][0])
    it.close()
    source._thread.join(timeout=5)
    assert not source._thread.is_alive()
