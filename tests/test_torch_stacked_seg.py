"""Stacked segmentation training in the port (stinet_tpu_torch/trainers/
segmentation.py:make_stacked_segmentation_steps and the trainer's stacked
paths, data/scannetlabel.py's `stacked_batching`), on the CPU, on the
scenes and schedules of JAX's tests/test_stacked_seg.py (4 train and 2
val label scenes, SGD with momentum):

- at B = 1 the stacked trainer equals the concatenated one (each scene's
  own batch statistics are the batch's): losses within rtol 1e-5 (JAX's
  bound), weights and running statistics within rtol 1e-4, atol 1e-6;
- the port's stacked trainer against JAX's stacked trainer at B = 2 from
  JAX's initial weights and statistics (converted): each epoch-log loss
  within rtol 1e-4 (the f32 trainer's tolerance), the IoU-derived keys
  within 0.02 (a vertex whose top two logits lie within rounding may take
  the other class; tests/test_torch_segmentation.py), and the running
  statistics after the epoch within rtol 1e-4, atol 1e-6;
- 2 gloo ranks (one scene each of every global batch of 2) against one
  process: losses within rtol 1e-5, IoU keys within 0.02, weights and
  running statistics within rtol 1e-4, atol 1e-6, both ranks bitwise
  alike;
- a 2-scene val set at test_batch_size 4 is padded with 2 repeats that
  weigh 0: the val log equals test_batch_size 2's within rtol 1e-6.

JAX compiles: one stacked segmentation trainer.
"""
import copy

import numpy as np
import pytest
import torch

from stinet_tpu_torch.core.config import ConfigParser
from stinet_tpu_torch.data.scannet import (
    SCANNET_TRAIN_FILE, SCANNET_VAL_FILE, read_split)
from stinet_tpu_torch.trainers.segmentation import GraphSegmentationTrainer
from test_torch_multihost import run_gloo
from test_train_e2e import make_seg_config, write_fake_label_scene

IOU_KEYS = ("mean_iou", "mean_precision", "overall_accuracy",
            "full_scene_mean_iou")


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("labels")
    rng = np.random.default_rng(0)
    out = {}
    for split, names in (("train", read_split(SCANNET_TRAIN_FILE)[:4]),
                         ("val", read_split(SCANNET_VAL_FILE)[:2])):
        out[split] = str(base / split)
        for name in names:
            write_fake_label_scene(out[split], name, rng)
    return out


def _config(tmp, roots, stacked, batch=1, test_batch=None, epochs=1):
    cfg = make_seg_config(tmp, roots["train"], roots["val"])
    cfg["data_loader"]["args"].update(
        train_batch_size=batch, test_batch_size=test_batch or batch,
        stacked_batching=stacked)
    cfg["trainer"]["epochs"] = epochs
    cfg["optimizer"] = {"type": "SGD", "args": {"lr": 1e-2,
                                                "momentum": 0.9}}
    return cfg


def _trainer(cfg):
    return GraphSegmentationTrainer(ConfigParser(copy.deepcopy(cfg),
                                                 dry_run=True), device="cpu")


def _state(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def _assert_logs(got, want, rtol):
    assert sorted(got) == sorted(want)
    for k in want:
        if k.removeprefix("val_") in IOU_KEYS:
            assert abs(got[k] - want[k]) <= 0.02, k
        elif k != "time elapsed":
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       err_msg=k)


def _assert_states(got, want):
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_stacked_equals_concatenated_at_batch_one(tmp_path, roots):
    tc = _trainer(_config(tmp_path / "c", roots, False))
    ts = _trainer(_config(tmp_path / "s", roots, True))
    assert ts._stacked and not tc._stacked
    tc.train()
    ts.train()
    for m in ("train_metrics", "valid_metrics"):
        np.testing.assert_allclose(getattr(ts, m).avg("loss"),
                                   getattr(tc, m).avg("loss"), rtol=1e-5)
    _assert_states(_state(ts), _state(tc))
    assert ts._train_step.mini_step == 0


def test_stacked_trainer_matches_jax(tmp_path, roots):
    from stinet_tpu.core.config import ConfigParser as JaxConfigParser
    from stinet_tpu.core.registry import TRAINERS as JAX_TRAINERS
    import stinet_tpu.trainers  # noqa: F401
    from stinet_tpu_torch.utils.convert import seg_state_dict_from_jax_params
    cfg = _config(tmp_path, roots, True, batch=2)
    want_trainer = JAX_TRAINERS.get("GraphSegmentationTrainer")(
        JaxConfigParser(copy.deepcopy(cfg), dry_run=True))
    assert want_trainer._stacked
    trainer = _trainer(cfg)
    trainer.model.load_state_dict(seg_state_dict_from_jax_params(
        want_trainer.state.params, want_trainer.state.batch_stats))
    want, got = want_trainer._train_epoch(1), trainer._train_epoch(1)
    assert "val_full_scene_mean_iou" in got
    _assert_logs(got, want, 1e-4)
    stats = seg_state_dict_from_jax_params(want_trainer.state.params,
                                           want_trainer.state.batch_stats)
    _assert_states({k: v for k, v in _state(trainer).items()
                    if k.endswith(("running_mean", "running_var"))},
                   {k: v for k, v in stats.items()
                    if k.endswith(("running_mean", "running_var"))})


def _seg_rank(rank, world, cfg):
    trainer = _trainer(cfg)
    seen = []
    step = trainer._train_step

    def recorded(graph, lr):
        seen.append(int(graph.x.shape[0]))
        return step(graph, lr)

    trainer._train_step = recorded
    logs = [trainer._train_epoch(e) for e in (1, 2)]
    return {"logs": logs, "seen": seen, "state": _state(trainer),
            "weights": trainer._stacked_val_weights().tolist()}


def test_two_gloo_ranks_equal_one_process(tmp_path, roots):
    cfg = _config(tmp_path, roots, True, batch=2)
    ranks = run_gloo(_seg_rank, 2, copy.deepcopy(cfg))
    want = _seg_rank(0, 1, copy.deepcopy(cfg))
    assert want["seen"] == [2, 2, 2, 2] and want["weights"] == [1.0, 1.0]
    for r in ranks:
        assert r["seen"] == [1, 1, 1, 1] and r["weights"] == [1.0]
        for g, w in zip(r["logs"], want["logs"]):
            _assert_logs(g, w, 1e-5)
        _assert_states(r["state"], want["state"])
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k


def test_val_tail_repeats_weigh_zero(tmp_path, roots):
    logs = {}
    for tbs in (4, 2):
        trainer = _trainer(_config(tmp_path / str(tbs), roots, True,
                                   batch=2, test_batch=tbs))
        assert trainer._stacked
        w = trainer._stacked_val_weights().tolist()
        assert w == [1.0, 1.0] + [0.0] * (tbs - 2)
        logs[tbs] = trainer._valid_epoch(1)
    assert sorted(logs[4]) == sorted(logs[2])
    assert "full_scene_mean_iou" in logs[2]
    for k in logs[2]:
        np.testing.assert_allclose(logs[4][k], logs[2][k], rtol=1e-6,
                                   err_msg=k)
