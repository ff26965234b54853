"""Stacked training in the port (trainers/graph_common.py
`make_stacked_inpainting_steps`, the ScanNet loader's `stacked_batching`,
graph/build.py `freeze_stacked_signature`), on the CPU.

The counterpart of tests/test_stacked.py::test_stacked_trainer_matches_
concatenated, on its scenes and schedule (4 train scenes, 2 val, B=2,
accumulation 2, SGD with momentum, one epoch):
- the stacked trainer against the concatenated one in the port: the loss
  sum_b wsum_b / sum_b n_b is the concatenated batch's up to summation
  order, so losses agree within rtol 1e-5 (JAX's bound) and the
  parameters after the epoch within rtol 1e-4 / atol 1e-6;
- the port's stacked trainer against JAX's from the same initial weights
  (the JAX trainer's, carried across by `state_dict_from_jax_params`):
  every epoch-log entry within rtol 1e-4, the f32 trainer's tolerance
  (tests/test_torch_trainer.py).
"""
import copy

import numpy as np
import pytest
import torch

from stinet_tpu.core.config import ConfigParser as JaxConfigParser
from stinet_tpu.core.registry import TRAINERS as JAX_TRAINERS
import stinet_tpu.trainers  # noqa: F401
from stinet_tpu_torch.core.config import ConfigParser
from stinet_tpu_torch.data.scannet import (
    SCANNET_TRAIN_FILE, SCANNET_VAL_FILE, read_split)
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.trainers import graph_common as gc
from stinet_tpu_torch.trainers.inpainting3d import Inpainting3DTrainer
from stinet_tpu_torch.utils.convert import state_dict_from_jax_params
from test_train_e2e import make_3d_config, write_fake_scene

ARGS = ("SurfaceTextureInpaintingNet", "args")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("scenes")
    rng = np.random.default_rng(0)
    out = {}
    for split, names in (("train", read_split(SCANNET_TRAIN_FILE)[:4]),
                         ("val", read_split(SCANNET_VAL_FILE)[:2])):
        out[split] = str(base / split)
        for name in names:
            write_fake_scene(out[split], name, rng)
    return out


def _config(tmp_path, roots, stacked):
    cfg = make_3d_config(tmp_path, roots["train"], roots["val"])
    cfg["data_loader"]["args"].update(train_batch_size=2, test_batch_size=2,
                                      stacked_batching=stacked)
    cfg["optimizer"] = {"type": "SGD", "args": {"lr": 1e-2,
                                                "momentum": 0.9}}
    return cfg


def _port_trainer(tmp_path, roots, stacked):
    return Inpainting3DTrainer(
        ConfigParser(_config(tmp_path / str(stacked), roots, stacked),
                     dry_run=True), device="cpu")


def test_stacked_trainer_matches_concatenated(tmp_path, roots):
    tc = _port_trainer(tmp_path, roots, False)
    ts = _port_trainer(tmp_path, roots, True)
    assert ts._stacked and not tc._stacked
    assert ts.data_loader.train_loader.signature is not None
    start = {k: v.clone() for k, v in ts.model.state_dict().items()}
    tc.train()
    ts.train()
    lc, ls = tc.train_metrics.avg("loss"), ts.train_metrics.avg("loss")
    assert np.isfinite(ls)
    np.testing.assert_allclose(ls, lc, rtol=1e-5)
    np.testing.assert_allclose(ts.valid_metrics.avg("loss"),
                               tc.valid_metrics.avg("loss"), rtol=1e-5)
    want = tc.model.state_dict()
    for k, v in ts.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert not torch.equal(ts.model.final_linear2.weight,
                           start["final_linear2.weight"])
    assert ts._train_step.mini_step == 0


def test_stacked_trainer_matches_jax(tmp_path, roots):
    cfg = _config(tmp_path, roots, True)
    want_trainer = JAX_TRAINERS.get("Inpainting3DTrainer")(
        JaxConfigParser(copy.deepcopy(cfg), dry_run=True))
    assert want_trainer._stacked
    trainer = Inpainting3DTrainer(
        ConfigParser(copy.deepcopy(cfg), dry_run=True), device="cpu")
    trainer.model.load_state_dict(
        state_dict_from_jax_params(want_trainer.state.params))
    want, got = want_trainer._train_epoch(1), trainer._train_epoch(1)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_stacked_steps_refuse_batch_norm(tmp_path):
    args = make_3d_config(tmp_path, "", "")["archs"][ARGS[0]][ARGS[1]]
    model = define_G(**dict(args, norm="batch"))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(ValueError, match="batch-norm"):
        gc.make_stacked_inpainting_steps(model, opt, True)
