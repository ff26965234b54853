"""The 2D workload's Resnet2D branch and its conditional PatchGAN in the
port's Inpainting2DTrainer (stinet_tpu_torch/trainers/inpainting2d.py:
`make_resnet2d_steps`, `GanStep`) against the JAX package's trainer, on
the CPU, from the same weights on the same batches; then checkpoints,
resume, evaluation and the CLI.

Tolerances: each step's loss and every epoch-log key within rtol 1e-4,
the f32 train step's tolerance (tests/test_torch_train.py), with the
hermetic config's Adam(amsgrad) at lr 1.4e-4 as tests/test_torch_
inpainting2d.py runs it; FID keys as that file bounds them (within rtol
1e-4 or 1e-5 of the size of the terms an FID is the difference of, on the
first 64 pool3 features); checkpoints and resume bitwise.

Models are cut to ngf 8, 2 blocks, 32 px images (LPIPS's floor), and the
discriminator to ndf 8, 2 layers (the config's: 64, 5).
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
from stinet_tpu_torch.core import checkpoint
from stinet_tpu_torch.core.config import ConfigParser
from stinet_tpu_torch.models.gan_networks import NLayerDiscriminator
from stinet_tpu_torch.models.resnet2d import Resnet2D
from stinet_tpu_torch.trainers.inpainting2d import (
    GanStep, Inpainting2DTrainer)
from stinet_tpu_torch.utils.convert import (
    resnet2d_state_dict_from_jax_params)
from test_torch_inpainting2d import (  # noqa: F401  (weights: a fixture)
    HERMETIC, _fid_terms, _first_features, weights)
from test_train_e2e import make_2d_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's intra-op pool at one thread while this module runs (under
    pytest-xdist every worker's default pool takes all the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(tmp_path, weights=None, accumulate=1, epochs=2, gan=False,
            fid=False):
    """The 2D test config with Resnet2D enabled (ngf 8, 2 blocks, instance
    norm, max pooling, dilation order 1) at 32 px with LPIPS; with `fid`,
    FID every epoch; at accumulation 2 also the VGG loss (at 32 px) and
    total variation; with `gan`, the PatchGAN and total variation."""
    cfg = make_2d_config(tmp_path, arch="Resnet2D")
    cfg["data_loader"]["args"].update(
        img_size=32, crop_half_width=4, circle_radius=5, max_items=12,
        num_static_samples=2, num_cumulated_train_batches=accumulate)
    cfg["trainer"].update(epochs=epochs, use_lpips=True, use_gan=gan,
                          ndf=8, n_layers_D=2)
    if fid:
        cfg["trainer"].update(use_train_fid=True, use_val_fid=True,
                              epochs_per_fid=1)
    with open(HERMETIC) as f:   # Adam(amsgrad) at lr 1.4e-4, not 1e-3
        cfg["optimizer"] = json.load(f)["optimizer"]
    if accumulate == 2:
        cfg["trainer"].update(use_vgg=True, vgg_resize=32,
                              vgg_style_weight=1.0)
    if accumulate == 2 or gan:
        cfg["trainer"]["use_total_variation"] = True
    if weights is None:
        cfg["trainer"]["allow_random_features"] = True
    else:
        cfg["trainer"].update(weights)
    return cfg


def _record(trainer, name, graph_arg):
    """Wrap a train step (`name`): record each call's loss and masked
    pixels; the batch is positional argument `graph_arg`."""
    out, step = {"loss": [], "mask": []}, getattr(trainer, name)

    def recorded(*args):
        res = step(*args)
        metrics = res[-1] if isinstance(res, tuple) else res
        out["loss"].append(float(metrics["loss"]))
        out["mask"].append(float(np.asarray(args[graph_arg].mask).sum()))
        return res

    setattr(trainer, name, recorded)
    return out


@pytest.mark.parametrize("case", ["2d", "2d_accumulate2", "gan"])
def test_trainer_matches_jax(tmp_path, weights, case):
    """Two epochs of the JAX trainer and the port's from JAX's weights
    (the generator's and, for the GAN, the discriminator's): the same
    masks, each step's loss, and every key of both epoch logs."""
    gan, fid = case == "gan", case == "2d"
    cfg = _config(tmp_path, weights, 2 if case == "2d_accumulate2" else 1,
                  gan=gan, fid=fid)
    want_trainer = JAX_TRAINERS.get("Inpainting2DTrainer")(
        JaxConfigParser(copy.deepcopy(cfg), dry_run=True))
    trainer = Inpainting2DTrainer(
        ConfigParser(copy.deepcopy(cfg), dry_run=True), device="cpu")
    assert trainer.branch == "2d" and isinstance(trainer.model, Resnet2D)
    assert isinstance(trainer._train_step, GanStep) == gan
    trainer.model.load_state_dict(resnet2d_state_dict_from_jax_params(
        want_trainer.state.params))
    if gan:
        assert isinstance(trainer.disc, NLayerDiscriminator)
        trainer.disc.load_state_dict(resnet2d_state_dict_from_jax_params(
            want_trainer.disc_state.params))
    if fid:
        for t in (trainer, want_trainer):
            _first_features(t._fid)
    step = trainer._train_step
    want_rec = _record(want_trainer, "_gan_step" if gan else "_train_step",
                       2 if gan else 1)
    rec = _record(trainer, "_train_step", 0)
    for epoch in (1, 2):
        want, got = (want_trainer._train_epoch(epoch),
                     trainer._train_epoch(epoch))
        assert sorted(got) == sorted(want)
        for k in ("lpips", "val_lpips") + (
                ("train_fid", "val_fid") if fid else ()) + (
                ("loss_D_fake", "loss_D_real", "loss_G", "accuracy_D_fake",
                 "accuracy_D_real") if gan else ()):
            assert k in got and np.isfinite(got[k]), k
        for k in want:
            atol = 0.0
            if k.endswith("fid"):
                gt = "train_gt" if k.startswith("train_") else "val_gt"
                atol = 1e-5 * _fid_terms(want_trainer._fid, gt,
                                         gt[:-2] + "pred")
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=atol,
                                       err_msg=f"epoch {epoch} {k}")
    assert len(rec["loss"]) == len(want_rec["loss"]) == 8
    assert rec["mask"] == want_rec["mask"]
    np.testing.assert_allclose(rec["loss"], want_rec["loss"], rtol=RTOL)
    assert step.mini_step == 0


def test_checkpoint_resume_and_eval_with_the_discriminator(tmp_path):
    """One GAN epoch with the generator's accumulation left half way (k =
    3, 4 steps), its checkpoints ("2d" and "discriminator"), a resume
    (both models, both Adam states, the partial gradients and the mini
    step bitwise), and -e valid."""
    cfg = _config(tmp_path, accumulate=3, epochs=1, gan=True)
    config = ConfigParser(copy.deepcopy(cfg))
    trainer = Inpainting2DTrainer(config, device="cpu")
    trainer.train()
    best = config.save_dir / "model_best.ckpt"
    ckpt = config.save_dir / "checkpoint-epoch1.ckpt"
    models, opts, extra, meta = checkpoint.load_checkpoint(best)
    assert meta["archs"] == {"2d": "Resnet2D",
                             "discriminator": "NLayerDiscriminator"}
    assert sorted(models) == sorted(opts) == ["2d", "discriminator"]
    assert extra["accumulation"]["mini_step"] == 1

    resumed = Inpainting2DTrainer(
        ConfigParser(copy.deepcopy(cfg), resume=ckpt, dry_run=True),
        device="cpu")
    assert resumed.start_epoch == 2 and resumed.mnt_best == trainer.mnt_best
    assert resumed._train_step.mini_step == 1
    for a, b in ((trainer.model, resumed.model),
                 (trainer.disc, resumed.disc)):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k
    for (k, a), b in zip(trainer.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(a.grad, b.grad), k
    for a, b in ((trainer.optimizer, resumed.optimizer),
                 (trainer.disc_optimizer, resumed.disc_optimizer)):
        want, got = a.state_dict()["state"], b.state_dict()["state"]
        assert sorted(want) == sorted(got) and want
        for i, st in want.items():
            for k, v in st.items():
                assert torch.equal(v, got[i][k]), (i, k)
    ev = Inpainting2DTrainer(
        ConfigParser(copy.deepcopy(cfg), resume=best, dry_run=True),
        device="cpu")
    ev.eval("valid")
    result = ev.valid_metrics.result()
    assert "loss_D_fake" not in result     # validation runs the 2d step
    assert all(np.isfinite(v) for v in result.values())


def test_cli_trains_the_gan_evaluates_and_needs_a_card(tmp_path):
    """The hermetic config with Resnet2D and the GAN through `python -m
    stinet_tpu_torch.train`, shrunk (width, depth, image size, epochs; FID
    off, see test_torch_inpainting2d.py): -d cpu trains and evaluates;
    without -d and without a card it raises."""
    with open(HERMETIC) as f:
        cfg = json.load(f)
    cfg["archs"]["SurfaceTextureInpaintingNet"]["enabled"] = False
    cfg["archs"]["Resnet2D"]["enabled"] = True
    cfg["archs"]["Resnet2D"]["args"].update(ngf=8, n_blocks=2)
    cfg["data_loader"]["args"].update(
        root_dir=str(tmp_path / "textures"), img_size=32, crop_half_width=4,
        circle_radius=5, max_items=8, train_batch_size=2,
        num_static_samples=2)
    cfg["trainer"].update(epochs=1, epochs_per_fid=0, verbosity=1,
                          tensorboard=False, save_dir=str(tmp_path / "saved"),
                          use_gan=True, ndf=8, n_layers_D=2)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    env = dict(os.environ, STINET_DISABLE_GIT_TAG="1", OMP_NUM_THREADS="1")

    def cli(*args, **extra_env):
        return subprocess.run(
            [sys.executable, "-m", "stinet_tpu_torch.train", *args],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=dict(env, **extra_env))

    res = cli("-c", str(cfg_path), "-d", "cpu", "-n", "cli")
    out = res.stdout + res.stderr
    assert res.returncode == 0, res.stderr[-3000:]
    for key in ("loss_D_fake", "accuracy_D_real", "val_lpips_random_features",
                "Number of parameters in 2d"):
        assert key in out, key
    run = next((tmp_path / "saved" / "models" / cfg["name"]).glob("*_cli"))
    models, _, _, _ = checkpoint.load_checkpoint(run / "model_best.ckpt")
    assert sorted(models) == ["2d", "discriminator"]
    res = cli("-r", str(run / "model_best.ckpt"), "-e", "valid", "-d", "cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "psnr" in res.stdout + res.stderr
    res = cli("-c", str(cfg_path), "-t", "1", CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
