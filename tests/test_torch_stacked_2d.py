"""Stacked 2D training in the port (stinet_tpu_torch/trainers/
inpainting2d.py: `make_stacked_inpainting2d_steps`, the 2d and GAN steps
on stacked images, data/imagegraph.py's `stacked_batching`), on the CPU,
on the config of JAX's tests/test_stacked_2d.py (32 px, 8 images, ngf 8,
SGD with momentum; the PatchGAN at ndf 8, 2 layers):

- stacked against concatenated in the port: the graph branch's images run
  one by one, and every image has the same pixel count, so the mean of
  their losses is the batch's. From the same weights, on each batch of an
  epoch, the two gradients agree within atol 1e-6 (f32 sums in another
  order). Trained for one epoch (3 steps), the losses agree within rtol
  1e-5 (JAX's bound) and the weights within rtol 1e-4, atol 5e-5: at the
  third step an edge conv's relu argument lies within rounding of 0, and
  the 3e-8 the two runs' weights differ by then flips its step, which
  moves one gradient element by 1.5e-3 and the weights by up to 1.5e-5
  (JAX's bound, atol 1e-6, holds before it). The 2d branch and the GAN
  take the same images as one batch, so their epoch logs and weights are
  bitwise the concatenated runs' (8 images split 6 / 1 leave no val batch
  of 2);
- the port's stacked trainer against JAX's stacked trainer from JAX's
  weights (graph branch and GAN): every epoch-log entry within rtol 1e-4,
  the f32 trainer's tolerance (tests/test_torch_inpainting2d.py);
- rank 0 and rank 1 of 2 (the process index and count patched in both
  packages): the loader's stacked batches equal JAX's local batches leaf
  for leaf;
- 2 gloo ranks (one image each of every global batch of 2) against one
  process, graph branch, 2d branch and GAN: every epoch-log entry within
  rtol 1e-5, weights (the discriminator's too) within rtol 1e-4, atol
  1e-6, both ranks bitwise alike.

JAX compiles: two stacked 2D trainers.
"""
import copy
import pathlib

import numpy as np
import pytest
import torch

from stinet_tpu_torch.core.config import ConfigParser
from stinet_tpu_torch.trainers.inpainting2d import (
    GanStep, Inpainting2DTrainer)
from test_torch_multihost import run_gloo

@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def make_config(tmp, branch, stacked, batch=2, epochs=2, gan=False):
    """JAX's tests/test_stacked_2d.py:make_2d_config, the PatchGAN cut to
    ndf 8 and 2 layers."""
    graph = branch == "graph"
    return {
        "name": "test2d", "n_gpu": 1, "seed": 7,
        "archs": {
            "SurfaceTextureInpaintingNet": {"enabled": graph, "args": {
                "input_nc": 4, "output_nc": 3, "ngf": 8, "n_blocks": 2,
                "dilations": [1, 1], "norm": "instance",
                "pooling_type": "mean", "n_levels": 2,
                "n_repeated_io_convs": 1, "filter_type": "edgeconv"}},
            "Resnet2D": {"enabled": not graph, "args": {
                "input_nc": 4, "output_nc": 3, "ngf": 8, "n_blocks": 2,
                "norm": "instance", "filter_type": "conv2d",
                "use_dropout": False}}},
        "data_loader": {"type": "ImageGraphTextureDataLoader", "args": {
            "root_dir": "", "img_size": 32, "end_level": 3,
            "crop_half_width": 8, "circle_radius": 4, "num_circles": 2,
            "random_mask": False, "random_augmentation": False,
            "max_items": 8, "train_batch_size": batch,
            "test_batch_size": batch, "num_workers": 0,
            "num_static_samples": 2, "stacked_batching": stacked}},
        "lr_scheduler": {"type": "StepLR",
                         "args": {"step_size": 100, "gamma": 0.5}},
        "optimizer": {"type": "SGD", "args": {"lr": 1e-2, "momentum": 0.9}},
        "loss": "", "metrics": [],
        "trainer": {"type": "Inpainting2DTrainer", "epochs": epochs,
                    "save_dir": str(tmp / "saved"),
                    "do_validation": True, "batches_per_log": 100,
                    "save_period": 1, "verbosity": 0,
                    "monitor": "min val_loss", "early_stop": 10,
                    "tensorboard": False, "use_gan": gan, "ndf": 8,
                    "n_layers_D": 2, "use_total_variation": gan,
                    "visualize_samples": False},
        "eval": None, "vis": False, "git_hash": "test",
    }


def _trainer(cfg):
    return Inpainting2DTrainer(ConfigParser(copy.deepcopy(cfg),
                                            dry_run=True), device="cpu")


def _run(cfg):
    """Train `cfg`'s epochs: (epoch logs, batch sizes seen, weights of
    every checkpointed model)."""
    trainer = _trainer(cfg)
    seen, step = [], trainer._train_step

    def recorded(graph, lr):
        seen.append(int(graph.x.shape[0]) if graph.x.dim() == 3
                    else graph.num_graphs)
        return step(graph, lr)

    trainer._train_step = recorded
    logs = [trainer._train_epoch(e)
            for e in range(1, cfg["trainer"]["epochs"] + 1)]
    state = {f"{key}.{k}": v.clone()
             for key, (m, _) in trainer._checkpointed().items()
             for k, v in m.state_dict().items()}
    return {"logs": logs, "seen": seen, "state": state,
            "stacked": trainer._stacked}


CASES = {"graph": dict(branch="graph", epochs=1), "2d": dict(branch="2d"),
         "gan": dict(branch="2d", gan=True, epochs=1)}


def test_stacked_graph_gradient_is_the_concatenated_ones(tmp_path):
    cat = _trainer(make_config(tmp_path / "c", "graph", False))
    st = _trainer(make_config(tmp_path / "s", "graph", True))
    st.model.load_state_dict(cat.model.state_dict())
    pairs = list(zip(cat.data_loader.train_loader,
                     st.data_loader.train_loader))
    assert len(pairs) == 3
    for (gc_, _), (gs, _) in pairs:
        assert gs.x.shape[0] == 2 and gc_.num_graphs == 2
        want, got = cat._train_step(gc_, 0.0), st._train_step(gs, 0.0)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-6)
        for (k, a), b in zip(cat.model.named_parameters(),
                             st.model.parameters()):
            np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_stacked_matches_concatenated(tmp_path, case):
    kw = CASES[case]
    cat = _run(make_config(tmp_path / "c", stacked=False, **kw))
    st = _run(make_config(tmp_path / "s", stacked=True, **kw))
    assert st["stacked"] and not cat["stacked"]
    assert st["seen"] == cat["seen"] == [2] * len(st["seen"])
    for g, w in zip(st["logs"], cat["logs"]):
        assert sorted(g) == sorted(w)
        if case == "graph":     # PSNR and lap_var pool per image there
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        else:
            assert g == w
    for k, v in cat["state"].items():
        if case == "graph":
            np.testing.assert_allclose(st["state"][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=5e-5, err_msg=k)
        else:
            assert torch.equal(st["state"][k], v), k


@pytest.mark.parametrize("case", ["graph", "gan"])
def test_stacked_trainer_matches_jax(tmp_path, case):
    from stinet_tpu.core.config import ConfigParser as JaxConfigParser
    from stinet_tpu.core.registry import TRAINERS as JAX_TRAINERS
    import stinet_tpu.trainers  # noqa: F401
    from stinet_tpu_torch.utils.convert import (
        resnet2d_state_dict_from_jax_params, state_dict_from_jax_params)
    cfg = make_config(tmp_path, stacked=True, **dict(CASES[case], epochs=1))
    want_trainer = JAX_TRAINERS.get("Inpainting2DTrainer")(
        JaxConfigParser(copy.deepcopy(cfg), dry_run=True))
    assert want_trainer._stacked
    trainer = _trainer(cfg)
    convert = (state_dict_from_jax_params if case == "graph"
               else resnet2d_state_dict_from_jax_params)
    trainer.model.load_state_dict(convert(want_trainer.state.params))
    if case == "gan":
        assert isinstance(trainer._train_step, GanStep)
        trainer.disc.load_state_dict(resnet2d_state_dict_from_jax_params(
            want_trainer.disc_state.params))
    want, got = want_trainer._train_epoch(1), trainer._train_epoch(1)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_batches_are_jax_local_batches(monkeypatch, rank):
    """Rank `rank` of 2 (both packages' process index and count patched):
    the image-graph loader forces the stacked layout, and its batches in
    the trainer's order over two epochs equal JAX's local batches leaf for
    leaf (one image a rank of every global batch of 2)."""
    from stinet_tpu.data import imagegraph as jax_imagegraph
    from stinet_tpu.parallel import multihost as jax_multihost
    from stinet_tpu_torch.data import imagegraph
    from stinet_tpu_torch.parallel import multihost
    from test_torch_graph import assert_same_tree
    for mod in (jax_multihost, multihost):
        monkeypatch.setattr(mod, "process_index", lambda: rank)
        monkeypatch.setattr(mod, "process_count", lambda: 2)
    args = make_config(pathlib.Path("unused"), "graph", False)[
        "data_loader"]["args"]
    got = imagegraph.ImageGraphTextureDataLoader(copy.deepcopy(args), seed=5)
    want = jax_imagegraph.ImageGraphTextureDataLoader(copy.deepcopy(args),
                                                      seed=5)
    assert got.stacked and want.stacked
    order = ("train_loader", "sample_train_loader", "val_loader",
             "sample_val_loader")
    n = 0
    for _ in range(2):
        for name in order:
            for (pg, pn), (jg, jn) in zip(getattr(got, name),
                                          getattr(want, name), strict=True):
                assert pn == jn and len(pn) == 1
                assert_same_tree(pg, jg)
                n += 1
    assert n == 2 * (3 + 1)


def _ranks_run(rank, world, tmp):
    return {case: _run(make_config(pathlib.Path(tmp) / case, stacked=True,
                                   **kw))
            for case, kw in CASES.items()}


def test_two_gloo_ranks_equal_one_process(tmp_path):
    ranks = run_gloo(_ranks_run, 2, str(tmp_path))
    for case, kw in CASES.items():
        want = _run(make_config(tmp_path / case, stacked=True, **kw))
        for r in ranks:
            got = r[case]
            assert got["seen"] == [1] * len(want["seen"]), case
            for g, w in zip(got["logs"], want["logs"]):
                assert sorted(g) == sorted(w)
                for k in w:
                    np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                               err_msg=f"{case} {k}")
            for k, v in want["state"].items():
                np.testing.assert_allclose(got["state"][k].numpy(),
                                           v.numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=f"{case} {k}")
        for k, v in ranks[0][case]["state"].items():
            assert torch.equal(v, ranks[1][case]["state"][k]), (case, k)
