"""The port's 2D texture-inpainting workload, graph branch
(stinet_tpu_torch/graph/build.py's grid builders, data/imagegraph.py,
trainers/inpainting2d.py, and the STINet converter on the 2D config's
edgeconv model) against the JAX package's, on the CPU, on the same numpy
inputs and the same weights.

Tolerances:
- the grid builders, the grid batch build and the loader: every leaf
  equal (numpy code the port copies);
- the edgeconv STINet with JAX's weights: the output within 1e-5 of JAX's
  (f32 sums in another order);
- the trainer against the JAX trainer, accumulation 1 and 2, 2 epochs
  with FID every epoch: each step's loss and every epoch-log key within
  rtol 1e-4, the f32 train step's tolerance (tests/test_torch_train.py).
  Both trainers run the hermetic config's Adam(amsgrad) at lr 1.4e-4 (at
  1e-3, elements whose gradient lies within rounding of 0 step where
  rounding points, as tests/test_torch_segmentation.py found) and load the
  same LPIPS and InceptionV3 weights from torch state-dict files. Their
  FID sessions take the first 64 of the 2048 pool3 features (the same
  columns on both sides): scipy's sqrtm of a 2048 x 2048 product takes
  about 12 s here, and the FID functions themselves are held to JAX's on
  their own (tests/test_torch_perceptual.py). FID is the difference of
  terms about 200 times its value here (feature means of squared norm
  20-25 against FIDs of 0.04-0.5 from 2 to 4 samples), so the FID keys
  hold within rtol 1e-4 or 1e-5 of those terms' size, whichever is
  looser (`_fid_terms`; measured: up to 1.1e-3 relative, 1.3e-4
  absolute, with the terms about 50);
- checkpoints and resume: bitwise.
"""
import copy
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from stinet_tpu.core.config import ConfigParser as JaxConfigParser
from stinet_tpu.core.registry import TRAINERS as JAX_TRAINERS
from stinet_tpu.data import imagegraph as jax_imagegraph
from stinet_tpu.graph import build as jax_build
from stinet_tpu.models.factory import define_G as jax_define_G
import stinet_tpu.trainers  # noqa: F401
from stinet_tpu_torch.core import checkpoint
from stinet_tpu_torch.core.config import ConfigParser
from stinet_tpu_torch.core.registry import DATALOADERS, TRAINERS
from stinet_tpu_torch.data import imagegraph
from stinet_tpu_torch.graph import build as port_build
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.trainers.inpainting2d import Inpainting2DTrainer
from stinet_tpu_torch.utils.convert import state_dict_from_jax_params
from test_torch_graph import assert_same_tree
from test_torch_perceptual import (
    inception_state_dict, lpips_state_dicts, vgg_state_dict)
from test_train_e2e import make_2d_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERMETIC = os.path.join(ROOT, "experiments/2d_inpainting/config/"
                        "config_stinet_imageinpainting_hermetic.json")
RTOL = 1e-4
FID_DIMS = 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's intra-op pool at one thread while this module runs: under
    pytest-xdist every worker's default pool takes all the cores, and the
    spinning pools slow each other tenfold (the trainer test: 225 s among
    six workers, 20 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- grid builders and the grid batch ----------------------------------------

@pytest.mark.parametrize("end_level", [1, 2, 3])
@pytest.mark.parametrize("img_size", [8, 32, 128])
def test_grid_hierarchy_matches_jax(img_size, end_level):
    got = port_build.grid_hierarchy(img_size, end_level)
    want = jax_build.grid_hierarchy(img_size, end_level)
    assert got[0] == want[0]
    for a, b in zip(got[1] + got[2], want[1] + want[2], strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert port_build.grid_hierarchy(img_size, end_level) is got  # cached
    np.testing.assert_array_equal(port_build.grid_edges(img_size),
                                  jax_build.grid_edges(img_size))
    np.testing.assert_array_equal(port_build.grid_trace(img_size // 2),
                                  jax_build.grid_trace(img_size // 2))


@pytest.mark.parametrize("native", [True, False])
def test_grid_batch_build_matches_jax(monkeypatch, native):
    if not native:
        monkeypatch.setenv("STINET_NATIVE_BUILD", "0")
    assert port_build._native.available() == native
    assert jax_build._native.available() == native
    args = dict(end_level=3, is_train=True, img_size=32, crop_half_width=4,
                circle_radius=5, random_mask=True, random_augmentation=True,
                seed=3)
    rng = np.random.default_rng(7)
    images = [jax_imagegraph.synth_texture(rng, 32) for _ in range(2)]
    np.testing.assert_array_equal(
        imagegraph.synth_texture(np.random.default_rng(7), 32), images[0])
    port_ds = imagegraph.ImageGraphTextureDataSet(images, **args)
    jax_ds = jax_imagegraph.ImageGraphTextureDataSet(images, **args)
    got = port_build.build_hierarchical_graph([port_ds[0], port_ds[1]])
    want = jax_build.build_hierarchical_graph([jax_ds[0], jax_ds[1]])
    assert got.num_graphs == 2
    assert_same_tree(got, want)


# --- the loader ---------------------------------------------------------------

def _loader_args(**kw):
    with open(HERMETIC) as f:
        args = json.load(f)["data_loader"]["args"]
    args.update(root_dir="", img_size=32, crop_half_width=4, circle_radius=5,
                train_batch_size=2, num_static_samples=4, **kw)
    return args


def _walk(loader, names):
    """The batches of one pass over loader `names` in the trainer's order."""
    return [b for name in names for b in getattr(loader, name)]


def test_loader_matches_jax_in_the_trainers_order():
    """Two epochs as the trainer walks the loaders (the train epoch, the
    train FID samples, validation, then the visualized samples): every
    batch equal leaf for leaf with the same names, since the train loaders
    share one dataset generator."""
    args = _loader_args()
    got = DATALOADERS.get("ImageGraphTextureDataLoader")(
        copy.deepcopy(args), seed=5)
    want = jax_imagegraph.ImageGraphTextureDataLoader(copy.deepcopy(args),
                                                      seed=5)
    assert len(got.train_dataset) == 32 and len(got.val_dataset) == 8
    order = ("train_loader", "sample_train_loader", "val_loader",
             "sample_train_loader", "sample_val_loader")
    n = 0
    for _ in range(2):
        pairs = list(zip(_walk(got, order), _walk(want, order),
                         strict=True))
        for (pg, pnames), (jg, jnames) in pairs:
            assert pnames == jnames
            assert_same_tree(pg, jg)
        n += len(pairs)
    assert n == 2 * (16 + 2 + 8 + 2 + 4)
    # the topology is built once a loader, then shared by its batches
    train = got.train_loader
    assert len(train.build_ms) == 32
    assert train._skeleton is not None
    g1, _ = next(iter(train))
    assert g1.levels[0].edges.nbr is train._skeleton.levels[0].edges.nbr


def test_loader_refuses_stacked_batching():
    """`stacked_batching`, which the loader once refused, builds stacked
    batches (one image a slice of a leading sample axis, the skeleton
    built once) leaf for leaf JAX's, in the trainer's order, over two
    epochs."""
    args = _loader_args(stacked_batching=True, test_batch_size=2)
    got = imagegraph.ImageGraphTextureDataLoader(copy.deepcopy(args), seed=5)
    want = jax_imagegraph.ImageGraphTextureDataLoader(copy.deepcopy(args),
                                                      seed=5)
    assert got.stacked and want.stacked
    order = ("train_loader", "sample_train_loader", "val_loader",
             "sample_train_loader", "sample_val_loader")
    n = 0
    for _ in range(2):
        pairs = list(zip(_walk(got, order), _walk(want, order),
                         strict=True))
        for (pg, pnames), (jg, jnames) in pairs:
            assert pnames == jnames
            assert_same_tree(pg, jg)
            assert pg.x.shape[0] == 2 and pg.x.dim() == 3
        n += len(pairs)
    assert n == 2 * (16 + 2 + 4 + 2 + 2)
    g1, _ = next(iter(got.train_loader))
    assert g1.levels[0].edges.nbr is \
        got.train_loader._skeleton.levels[0].edges.nbr


# --- the 2D config's generator -----------------------------------------------

def test_edgeconv_generator_matches_jax():
    """The 2D configs' STINet (edgeconv, instance norm, max pooling) with
    JAX's weights, carried by `state_dict_from_jax_params`, on a B=2 grid
    batch."""
    arch = make_2d_config(__import__("pathlib").Path(ROOT))["archs"]["SurfaceTextureInpaintingNet"]
    loader = jax_imagegraph.ImageGraphTextureDataLoader(_loader_args())
    want_graph, _ = next(iter(loader.train_loader))
    model = jax_define_G(**arch["args"])
    params = jax.jit(model.init)(jax.random.key(0), want_graph)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32), params)
    want = np.asarray(jax.jit(model.apply)({"params": params}, want_graph))
    port = define_G(**arch["args"])
    port.load_state_dict(state_dict_from_jax_params(params))
    graph, _ = next(iter(imagegraph.ImageGraphTextureDataLoader(
        _loader_args()).train_loader))
    with torch.no_grad():
        got = port.eval()(graph).numpy()
    n = 2 * 32 * 32
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:n], want[:n], rtol=0, atol=1e-5)


# --- the trainer --------------------------------------------------------------

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """LPIPS, InceptionV3 and VGG16 torch state-dict files both trainers
    load."""
    d = tmp_path_factory.mktemp("weights")
    alex, heads = lpips_state_dicts()
    torch.save(dict(alex, **heads), d / "lpips.pt")
    torch.save(inception_state_dict(), d / "inception.pt")
    torch.save(vgg_state_dict(), d / "vgg.pt")
    return {"lpips_weights": str(d / "lpips.pt"),
            "inception_weights": str(d / "inception.pt"),
            "vgg_weights": str(d / "vgg.pt")}


def _config(tmp_path, weights=None, accumulate=1, epochs=2):
    """The 2D test config at img_size 32 with LPIPS and FID every epoch
    (weights from `weights`' files, else random features); at
    accumulation 2 also the VGG loss (at 32 px) and total variation."""
    cfg = make_2d_config(tmp_path)
    cfg["data_loader"]["args"].update(
        img_size=32, crop_half_width=4, circle_radius=5, max_items=12,
        num_static_samples=2, num_cumulated_train_batches=accumulate)
    cfg["trainer"].update(epochs=epochs, use_lpips=True, use_train_fid=True,
                          use_val_fid=True, epochs_per_fid=1)
    with open(HERMETIC) as f:   # Adam(amsgrad) at lr 1.4e-4, not 1e-3
        cfg["optimizer"] = json.load(f)["optimizer"]
    if accumulate == 2:
        cfg["trainer"].update(use_vgg=True, vgg_resize=32,
                              vgg_style_weight=1.0, use_total_variation=True)
    if weights is None:
        cfg["trainer"]["allow_random_features"] = True
    else:
        cfg["trainer"].update(weights)
    return cfg


def _record(trainer, jax_side):
    """Wrap the train step: record each step's loss and masked pixels."""
    out, step = {"loss": [], "mask": []}, trainer._train_step

    def recorded(*args):
        res = step(*args)
        graph = args[1] if jax_side else args[0]
        out["loss"].append(float((res[1] if jax_side else res)["loss"]))
        out["mask"].append(float(np.asarray(graph.mask).sum()))
        return res

    trainer._train_step = recorded
    return out


def _first_features(fid, dims=FID_DIMS):
    feature_fn = fid.feature_fn
    fid.feature_fn = lambda imgs: np.asarray(
        feature_fn(imgs), np.float64)[:, :dims]


def _fid_terms(fid, key1, key2):
    """|mu1|^2 + |mu2|^2 + tr(s1) + tr(s2): the size of the terms an FID is
    the difference of."""
    (m1, s1), (m2, s2) = fid.get_statistics(key1), fid.get_statistics(key2)
    return float(m1 @ m1 + m2 @ m2 + np.trace(s1) + np.trace(s2))


@pytest.mark.parametrize("accumulate", [1, 2])
def test_trainer_matches_jax(tmp_path, weights, accumulate):
    cfg = _config(tmp_path, weights, accumulate)
    want_trainer = JAX_TRAINERS.get("Inpainting2DTrainer")(
        JaxConfigParser(copy.deepcopy(cfg), dry_run=True))
    trainer = Inpainting2DTrainer(
        ConfigParser(copy.deepcopy(cfg), dry_run=True), device="cpu")
    assert trainer.lpips_tag == "lpips" and trainer._fid_tag == "fid"
    assert (trainer.vgg_loss is not None) == (accumulate == 2)
    trainer.model.load_state_dict(
        state_dict_from_jax_params(want_trainer.state.params))
    for t in (trainer, want_trainer):
        _first_features(t._fid)
    step = trainer._train_step
    want_rec = _record(want_trainer, jax_side=True)
    rec = _record(trainer, jax_side=False)
    for epoch in (1, 2):
        want, got = (want_trainer._train_epoch(epoch),
                     trainer._train_epoch(epoch))
        assert sorted(got) == sorted(want)
        for k in ("lpips", "train_fid", "val_fid", "val_lpips"):
            assert k in got and np.isfinite(got[k]), k
        for k in want:
            atol = 0.0
            if k.endswith("fid"):
                gt = "train_gt" if k.startswith("train_") else "val_gt"
                atol = 1e-5 * _fid_terms(want_trainer._fid, gt, gt[:-2] + "pred")
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=atol,
                                       err_msg=f"epoch {epoch} {k}")
    assert len(rec["loss"]) == len(want_rec["loss"]) == 8
    assert rec["mask"] == want_rec["mask"]
    np.testing.assert_allclose(rec["loss"], want_rec["loss"], rtol=RTOL)
    assert step.mini_step == 0
    assert [t["steps"] for t in trainer.epoch_timings] == [4, 4]
    assert [(t["epoch"], t["split"]) for t in trainer.fid_timings] == [
        (1, "train"), (1, "val"), (2, "train"), (2, "val")]


def test_checkpoint_resume_and_eval(tmp_path):
    """One epoch with the accumulation left half way (k = 3, 4 steps) and
    random features, its checkpoints, a resume (weights, gradients, Adam
    state and mini step bitwise), and -e valid."""
    cfg = _config(tmp_path, accumulate=3, epochs=1)
    cfg["trainer"]["epochs_per_fid"] = 0
    config = ConfigParser(copy.deepcopy(cfg))
    trainer = Inpainting2DTrainer(config, device="cpu")
    assert trainer.lpips_tag == "lpips_random_features"
    assert trainer._fid is None
    trainer.train()
    ckpt = config.save_dir / "checkpoint-epoch1.ckpt"
    best = config.save_dir / "model_best.ckpt"
    for path in (ckpt, best):
        assert path.exists() and os.path.exists(str(path) + ".meta.json")
    models, _, extra, meta = checkpoint.load_checkpoint(best)
    assert meta["archs"] == {"graph": "SurfaceTextureInpaintingNet"}
    assert meta["monitor_best"] == trainer.mnt_best < np.inf
    assert extra["accumulation"]["mini_step"] == 1

    resumed = Inpainting2DTrainer(
        ConfigParser(copy.deepcopy(cfg), resume=ckpt, dry_run=True),
        device="cpu")
    assert resumed.start_epoch == 2 and resumed.mnt_best == trainer.mnt_best
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    for (k, a), b in zip(trainer.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(a.grad, b.grad), k
    assert resumed._train_step.mini_step == 1
    want, got = trainer.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i, st in want["state"].items():
        for k, v in st.items():
            assert torch.equal(v, got["state"][i][k]), (i, k)
    ev = Inpainting2DTrainer(
        ConfigParser(copy.deepcopy(cfg), resume=best, dry_run=True),
        device="cpu")
    ev.eval("valid")
    assert np.isfinite(ev.valid_metrics.avg("lpips_random_features"))


def test_cli_trains_evaluates_and_needs_a_card(tmp_path):
    """The hermetic config through `python -m stinet_tpu_torch.train`,
    shrunk (width, depth, image size, epochs; FID off, since scipy's sqrtm
    of its 2048 x 2048 product takes about 12 s a pass here, and the
    trainer test runs FID): -d cpu trains, with LPIPS on random features,
    and evaluates; without -d and without a card it raises."""
    with open(HERMETIC) as f:
        cfg = json.load(f)
    assert cfg["trainer"]["type"] == "Inpainting2DTrainer"
    assert cfg["data_loader"]["type"] == "ImageGraphTextureDataLoader"
    cfg["archs"]["SurfaceTextureInpaintingNet"]["args"].update(
        ngf=8, n_blocks=2, dilations=[1, 1])
    cfg["data_loader"]["args"].update(
        root_dir=str(tmp_path / "textures"), img_size=32, crop_half_width=4,
        circle_radius=5, max_items=8, train_batch_size=2,
        num_static_samples=2)
    cfg["trainer"].update(epochs=1, epochs_per_fid=0, verbosity=1,
                          tensorboard=False, save_dir=str(tmp_path / "saved"))
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
    assert "val_lpips_random_features" in out
    assert "fid_random_features" not in out
    run = next((tmp_path / "saved" / "models" / cfg["name"]).glob("*_cli"))
    res = cli("-r", str(run / "model_best.ckpt"), "-e", "valid", "-d", "cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "psnr" in res.stdout + res.stderr
    res = cli("-c", str(cfg_path), "-t", "1", CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr


def test_trainer_refuses_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Inpainting2DTrainer(ConfigParser(_config(tmp_path), dry_run=True))


@pytest.mark.parametrize("flag", ["use_lpips", "fid", "use_vgg"])
def test_random_features_fail_closed(tmp_path, flag):
    """A perceptual net without weights and without allow_random_features
    raises, as JAX's does (tests/test_fid_vgg_trainer.py); with the opt-in
    its scalars are tagged."""
    cfg = make_2d_config(tmp_path)
    if flag == "fid":
        cfg["trainer"].update(use_val_fid=True, epochs_per_fid=1)
    else:
        cfg["trainer"][flag] = True
    with pytest.raises(ValueError, match="allow_random_features"):
        Inpainting2DTrainer(ConfigParser(copy.deepcopy(cfg), dry_run=True),
                            device="cpu")
    cfg["trainer"]["allow_random_features"] = True
    trainer = Inpainting2DTrainer(ConfigParser(cfg, dry_run=True),
                                  device="cpu")
    assert {"use_lpips": trainer.lpips_tag, "fid": trainer._fid_tag,
            "use_vgg": "vgg" * (trainer.vgg_loss is not None)}[flag] in (
        "lpips_random_features", "fid_random_features", "vgg")


def test_trainer_refuses_other_archs(tmp_path):
    """Exactly one arch enabled; on the Resnet2D branch neither norm="batch"
    nor use_dropout, which JAX's 2d step cannot train (it applies the model
    without a batch_stats collection or a dropout RNG)."""
    cfg = make_2d_config(tmp_path, arch="Resnet2D")
    args = cfg["archs"]["Resnet2D"]["args"]
    for change, match in ((dict(norm="batch"), "batch_stats"),
                          (dict(use_dropout=True), "dropout RNG")):
        bad = copy.deepcopy(cfg)
        bad["archs"]["Resnet2D"]["args"] = dict(args, **change)
        with pytest.raises(NotImplementedError, match=match):
            Inpainting2DTrainer(ConfigParser(bad, dry_run=True),
                                device="cpu")
    trainer = Inpainting2DTrainer(ConfigParser(copy.deepcopy(cfg),
                                               dry_run=True), device="cpu")
    assert trainer.branch == "2d" and trainer.disc is None
    cfg["archs"]["SurfaceTextureInpaintingNet"]["enabled"] = True
    with pytest.raises(ValueError, match="Exactly one"):
        Inpainting2DTrainer(ConfigParser(cfg, dry_run=True), device="cpu")
    assert TRAINERS.get("Inpainting2DTrainer") is Inpainting2DTrainer
