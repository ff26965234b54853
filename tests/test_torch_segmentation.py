"""The port's segmentation workload (stinet_tpu_torch/models/
singleconvmeshnet.py, models/losses.py, metrics/{metric,iou}.py,
data/scannetlabel.py, trainers/segmentation.py, utils/convert.py) against
the JAX package's, on the CPU, on the same numpy inputs and the same
weights (JAX's, carried across by `seg_state_dict_from_jax_params`).

Tolerances:
- EdgeConvWithNorm and SingleConvMeshNet (filter_sizes [8, 16, 32], 2
  steps, a 3000-vertex scene), in train and eval mode: the output within
  1e-5 of its largest magnitude, every gradient (parameters and input)
  within 1e-5 of the largest (f32 sums in another order), and the running
  statistics within 1e-6 after the backward, which for the model ran every
  checkpointed block a second time;
- the losses and metrics: 1e-6 relative (f32 reductions), the confusion
  matrices and IoU values of the same counts exactly;
- the loader: every leaf equal (numpy code the port copies);
- the trainer against the JAX trainer, accumulation 1 and 2: each step's
  loss and the epoch logs' loss keys within rtol 1e-4, the f32 train
  step's tolerance (tests/test_torch_train.py); the first step's confusion
  matrix equal; the IoU-derived keys (mean_iou, mean_precision,
  overall_accuracy, full_scene_mean_iou) within 0.02, since a vertex whose
  top two logits lie within rounding may take the other class.
  The trainers run the shipped config's Adam at lr 1e-4, not its 1e-3:
  Adam's first updates are about lr * sign(gradient) per element, so an
  element whose gradient lies within rounding of 0 moves by a whole step
  in a direction rounding picks. `head_lin1.bias` is one (the head's batch
  norm cancels it, its gradient is 1e-8 noise on both sides). At 1e-3 such
  steps moved the loss by 4.7e-4 by step 8 on these scenes, with every
  gradient from equal weights within 5e-6 of JAX's; at 1e-4 the per-step
  losses agree within 2e-7.
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stinet_tpu.core.config import ConfigParser as JaxConfigParser
from stinet_tpu.data import scannetlabel as jax_label
from stinet_tpu.graph.build import build_hierarchical_graph as jax_build
from stinet_tpu.metrics import iou as jax_iou
from stinet_tpu.metrics import metric as jax_metric
from stinet_tpu.models import losses as jax_losses
from stinet_tpu.models import singleconvmeshnet as jax_scm
import stinet_tpu.trainers  # noqa: F401
from stinet_tpu.core.registry import TRAINERS as JAX_TRAINERS
from stinet_tpu.utils import scannet_utils as jax_scannet_utils
from stinet_tpu.utils import visualization_utils as jax_vis_utils
from stinet_tpu.utils.synthetic import synthetic_scene as jax_scene
from stinet_tpu_torch.core import checkpoint
from stinet_tpu_torch.core.config import ConfigParser
from stinet_tpu_torch.data import scannetlabel
from stinet_tpu_torch.data.scannet import (
    SCANNET_TRAIN_FILE, SCANNET_VAL_FILE, read_split)
from stinet_tpu_torch.graph.build import build_hierarchical_graph
from stinet_tpu_torch.metrics import iou, metric
from stinet_tpu_torch.models import losses
from stinet_tpu_torch.models import singleconvmeshnet as scm
from stinet_tpu_torch.trainers.segmentation import GraphSegmentationTrainer
from stinet_tpu_torch.utils import scannet_utils, visualization_utils
from stinet_tpu_torch.utils.convert import seg_state_dict_from_jax_params
from stinet_tpu_torch.utils.synthetic import synthetic_scene
from stinet_tpu_torch.utils.visualization import SemSegVisualizer
from test_train_e2e import make_seg_config, write_fake_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = dict(num_vertices=3000, levels=3, dilation_dists=(), seed=3)
ARCH = dict(feature_number=9, num_propagation_steps=2,
            filter_sizes=[8, 16, 32], num_classes=21)
RTOL = 1e-4
IOU_KEYS = ("mean_iou", "mean_precision", "overall_accuracy",
            "full_scene_mean_iou")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def graphs():
    """The same 3-level scene from each package's builder, with 9 input
    channels drawn from a numpy generator."""
    jg = jax_build([jax_scene(**SCENE)])
    pg = build_hierarchical_graph([synthetic_scene(**SCENE)])
    x = np.random.default_rng(0).normal(
        size=(pg.x.shape[0], 9)).astype(np.float32)
    return jg.replace(x=jnp.asarray(x)), dataclasses.replace(pg, x=t(x))


def _random_variables(variables, seed=0):
    """Every parameter and running statistic of `variables` drawn from a
    numpy generator (variances positive)."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape) if p[-1].key == "var"
                      else rng.normal(0, 0.5, a.shape)).astype(np.float32),
        dict(variables["batch_stats"]))
    return params, stats


def _jax_run(apply, params, x, r, train):
    """JAX's output, its gradients (params, x) of sum(out * r), and the new
    batch_stats (the old ones in eval mode), in one jit."""
    def f(prm, x):
        out, new = apply(prm, x, train)
        return jnp.sum(out * r), (out, new)
    (_, (out, new)), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return np.asarray(out), grads, new


def _assert_close_to_jax(module, got, x_grad, want, grads, new_stats,
                         to_state_dict):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    want_sd = to_state_dict(grads[0], new_stats)
    g_max = max(float(g.abs().max()) for k, g in want_sd.items()
                if "running" not in k)
    for k, p in module.named_parameters():
        d = float((p.grad - want_sd[k]).abs().max())
        assert d <= 1e-5 * g_max, (k, d, g_max)
    if x_grad is not None:
        gx = np.asarray(grads[1])
        np.testing.assert_allclose(x_grad.numpy(), gx, rtol=0,
                                   atol=1e-5 * np.abs(gx).max())
    for k, b in module.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(b.numpy(), want_sd[k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)


# --- the model ---------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("trans_inv", [True, False],
                         ids=["transinv", "plain"])
def test_edge_conv_matches_jax(graphs, trans_inv, train):
    """One EdgeConvWithNorm over level 0's edges: output, gradients with
    respect to x and every weight, and the new running statistics."""
    jg, pg = graphs
    c_in, c_out = 9, 8
    rng = np.random.default_rng(1)
    x = rng.normal(size=(pg.x.shape[0], c_in)).astype(np.float32)
    r = rng.normal(size=(pg.x.shape[0], c_out)).astype(np.float32)
    conv = jax_scm.EdgeConvWithNorm(c_in, c_out, trans_inv=trans_inv)
    edges = jg.levels[0].edges
    params, stats = _random_variables(conv.init(
        jax.random.key(0), jnp.asarray(x), edges))

    def apply(prm, x, train):
        variables = {"params": prm, "batch_stats": stats}
        if train:
            out, upd = conv.apply(variables, x, edges, True,
                                  mutable=["batch_stats"])
            return out, upd["batch_stats"]
        return conv.apply(variables, x, edges, False), stats
    want, grads, new_stats = _jax_run(apply, params, x, r, train)

    def to_state_dict(prm, bs):
        """The converter on the conv wrapped as a block's filter."""
        sd = seg_state_dict_from_jax_params(
            {"left_0": {"filter_0": prm}}, {"left_0": {"filter_0": bs}})
        return {k.removeprefix("left_0.filter_0."): v for k, v in sd.items()}

    module = scm.EdgeConvWithNorm(c_in, c_out, trans_inv=trans_inv)
    module.load_state_dict(to_state_dict(params, stats))
    module.train(train)
    xt = t(x).requires_grad_()
    got = module(xt, pg.levels[0].edges)
    (got * t(r)).sum().backward()
    _assert_close_to_jax(module, got, xt.grad, want, grads, new_stats,
                         to_state_dict)


@pytest.mark.parametrize("pool", ["mean", "max"])
def test_model_matches_jax(graphs, pool):
    """A train forward with every block but left_0 checkpointed, and its
    backward: logits, every gradient, and the running statistics, which
    the recomputed forwards must leave as the one forward moved them."""
    jg, pg = graphs
    jm = jax_scm.SingleConvMeshNet(**ARCH, pooling_method=pool, aggr=pool)
    params, stats = _random_variables(jm.init(jax.random.key(0), jg))
    r = np.random.default_rng(2).normal(
        size=(pg.x.shape[0], 21)).astype(np.float32)

    def apply(prm, x, train):
        out, upd = jm.apply({"params": prm, "batch_stats": stats},
                            jg.replace(x=x), train=True,
                            mutable=["batch_stats"])
        return out, upd["batch_stats"]
    want, grads, new_stats = _jax_run(apply, params, np.asarray(jg.x), r,
                                      True)

    model = scm.SingleConvMeshNet(**ARCH, pooling_method=pool, aggr=pool)
    model.load_state_dict(seg_state_dict_from_jax_params(params, stats))
    assert [n for n, b in model.named_children()
            if getattr(b, "checkpointed", False)] == [
        "left_1", "left_2", "right_1", "right_0"]
    model.train()
    got = model(pg)
    (got * t(r)).sum().backward()
    _assert_close_to_jax(model, got, None, want, grads, new_stats,
                         seg_state_dict_from_jax_params)


def test_model_eval_matches_jax(graphs):
    """Eval mode: the running statistics normalize, and nothing moves."""
    jg, pg = graphs
    jm = jax_scm.SingleConvMeshNet(**ARCH)
    params, stats = _random_variables(jm.init(jax.random.key(0), jg), 3)
    want = np.asarray(jax.jit(lambda p: jm.apply(
        {"params": p, "batch_stats": stats}, jg, train=False))(params))
    model = scm.SingleConvMeshNet(**ARCH)
    sd = seg_state_dict_from_jax_params(params, stats)
    model.load_state_dict(sd)
    model.eval()
    with torch.no_grad():
        got = model(pg).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_edge_mask_and_masked_batch_norm():
    """edge_mask is arange(E_pad) < num_edges; the masked batch norm's
    statistics ignore the pad rows, and n = 1 keeps the variance finite."""
    edges = scm.EdgeSet(src=torch.zeros(6, dtype=torch.int32),
                        dst=torch.zeros(6, dtype=torch.int32),
                        num_edges=torch.tensor(4, dtype=torch.int32),
                        degree=torch.zeros(3))
    assert scm.edge_mask(edges).tolist() == [1, 1, 1, 1, 0, 0]
    bn = scm._MaskedEdgeBatchNorm(2)
    m = torch.tensor([[1., 2.], [3., 6.], [100., -100.]])
    mask = torch.tensor([1., 1., 0.])
    out = bn(m, mask)
    np.testing.assert_allclose(out[:2].detach().numpy(),
                               [[-1, -1], [1, 1]], atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), [0.2, 0.4],
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               [0.9 + 0.1 * 2.0, 0.9 + 0.1 * 8.0], atol=1e-6)
    bn(m, torch.tensor([1., 0., 0.]))       # one valid row
    assert torch.isfinite(bn.running_var).all()


def test_converter_refuses_an_unknown_leaf(graphs):
    jg, _ = graphs
    params, stats = _random_variables(jax_scm.SingleConvMeshNet(**ARCH).init(
        jax.random.key(0), jg))
    sd = seg_state_dict_from_jax_params(params, stats)
    model = scm.SingleConvMeshNet(**ARCH)
    assert sorted(sd) == sorted(model.state_dict())
    bad = dict(params, extra={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="extra"):
        seg_state_dict_from_jax_params(bad, stats)
    bad = jax.tree.map(lambda a: a, params)
    bad["left_0"]["filter_0"]["lin3_kernel"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="lin3_kernel"):
        seg_state_dict_from_jax_params(bad, stats)
    with pytest.raises(ValueError, match="batch_stats"):
        seg_state_dict_from_jax_params(params, {})


# --- losses and metrics ------------------------------------------------------

def _logits(rng, n=500, c=21):
    return rng.normal(0, 2, size=(n, c)).astype(np.float32)


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    logits = _logits(rng)
    targets = rng.integers(0, 21, size=500).astype(np.int32)
    # targets 19 and 20 lie past the weights: clip semantics
    weights = rng.uniform(0.5, 5, size=19).astype(np.float32)
    mask = (rng.uniform(size=500) < 0.8).astype(np.float32)
    for kw in ({}, {"weights": weights}, {"ignore_index": 0},
               {"weights": weights, "ignore_index": 3, "valid_mask": mask}):
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        pkw = {k: t(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        want = jax_losses.cse_loss_terms(jnp.asarray(logits),
                                         jnp.asarray(targets), **jkw)
        got = losses.cse_loss_terms(t(logits), t(targets), **pkw)
        for a, b in zip(got, want):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
        np.testing.assert_allclose(
            float(losses.cse_loss(t(logits), t(targets), **pkw)),
            float(jax_losses.cse_loss(jnp.asarray(logits),
                                      jnp.asarray(targets), **jkw)),
            rtol=1e-6)
    img = rng.normal(size=(2, 7, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.total_variation_loss(t(img), 0.5)),
        float(jax_losses.total_variation_loss(jnp.asarray(img), 0.5)),
        rtol=1e-6)
    for lg, tr in ((logits, targets), (img, rng.integers(0, 3, (2, 7, 5)))):
        np.testing.assert_allclose(
            float(losses.dice_loss(t(lg), t(tr))),
            float(jax_losses.dice_loss(jnp.asarray(lg), jnp.asarray(tr))),
            rtol=1e-6)


def test_accuracy_and_top_k_match_jax():
    rng = np.random.default_rng(5)
    logits = _logits(rng, c=6)
    logits[:50, 1] = logits[:50, 2]                     # ties
    target = rng.integers(0, 6, size=500)
    mask = (rng.uniform(size=500) < 0.5).astype(np.float32)
    for m in (None, mask):
        jm, pm = (None, None) if m is None else (jnp.asarray(m), t(m))
        np.testing.assert_allclose(
            float(metric.accuracy(t(logits), t(target), pm)),
            float(jax_metric.accuracy(jnp.asarray(logits),
                                      jnp.asarray(target), jm)), rtol=1e-6)
        for k in (1, 3):
            np.testing.assert_allclose(
                float(metric.top_k_acc(t(logits), t(target), k, pm)),
                float(jax_metric.top_k_acc(jnp.asarray(logits),
                                           jnp.asarray(target), k, jm)),
                rtol=1e-6)


def test_confusion_and_iou_match_jax():
    """Confusion matrices equal; IoU with ignore_index, classes that never
    occur (NaN, out of the mean), precision and overall accuracy equal."""
    rng = np.random.default_rng(6)
    c = 8
    want_iou, got_iou = jax_iou.IoU(c, ignore_index=0), iou.IoU(
        c, ignore_index=0)
    for step in range(3):
        pred = rng.integers(0, c - 2, size=400)        # 6, 7 never predicted
        target = rng.integers(0, c - 1, size=400)      # 7 never a target
        mask = (rng.uniform(size=400) < 0.7).astype(np.float32)
        want = np.asarray(jax_iou.confusion_matrix_update(
            jnp.asarray(pred), jnp.asarray(target), c, jnp.asarray(mask)))
        got = iou.confusion_matrix_update(t(pred), t(target), c, t(mask))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        if step < 2:
            want_iou.add_matrix(want)
            got_iou.add_matrix(got)
        else:
            want_iou.add(pred, target, mask)
            got_iou.add(pred, target, mask)
    np.testing.assert_array_equal(got_iou.conf_metric.value(),
                                  want_iou.conf_metric.value())
    for name in ("value", "precision"):
        (a, am), (b, bm) = getattr(got_iou, name)(), getattr(want_iou,
                                                             name)()
        np.testing.assert_array_equal(a, b)
        assert am == bm and np.isnan(a[0]) and np.isnan(a[7])
    assert got_iou.overall_accuracy() == want_iou.overall_accuracy()
    got_iou.reset()
    assert not got_iou.conf_metric.value().any()


def test_confusion_counts_past_f32_integers():
    """The running matrix stays exact past 2^24 counts of one class."""
    m = iou.ConfusionMatrix(3)
    one = torch.zeros(3, 3, dtype=torch.int64)
    one[1, 1] = 2 ** 24
    m.add_matrix(one)
    m.add_matrix(iou.confusion_matrix_update(
        torch.tensor([1]), torch.tensor([1]), 3))
    assert m.value()[1, 1] == 2 ** 24 + 1


# --- the loader --------------------------------------------------------------

def _write_label_scene(root, scene, rng, v0):
    """tests/test_train_e2e.py's scene with `labels_0` over 0..20 added,
    as its write_fake_label_scene adds them, at v0 vertices."""
    write_fake_scene(root, scene, rng, v0=v0, seed_mask=False)
    path = os.path.join(root, "graphs", scene + ".npz")
    d = dict(np.load(path))
    d["labels_0"] = rng.integers(0, 21, size=v0)
    np.savez(path, **d)


def _as_crop(root, scene, crop):
    """Rewrite a full scene as a training crop `<scene>_<crop>`: a crop
    stores no original-mesh trace, so traces_l maps level l to l + 1."""
    path = os.path.join(root, "graphs", scene + ".npz")
    d = dict(np.load(path))
    levels = int(d["num_levels"])
    for l in range(levels - 1):
        d[f"traces_{l}"] = d[f"traces_{l + 1}"]
    del d[f"traces_{levels - 1}"]
    os.remove(path)
    np.savez(os.path.join(root, "graphs", f"{scene}_{crop}.npz"), **d)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Label scenes: 3 full train
    scenes, 2 crops of 2 more, and 2 full val scenes."""
    base = tmp_path_factory.mktemp("labels")
    rng = np.random.default_rng(0)
    out = {k: str(base / k) for k in ("train", "crops", "val")}
    train, val = read_split(SCANNET_TRAIN_FILE), read_split(SCANNET_VAL_FILE)
    for name, v0 in zip(train[:3], (240, 300, 270)):
        _write_label_scene(out["train"], name, rng, v0=v0)
    for i, name in enumerate(train[3:5]):
        for crop in (0, 1):
            _write_label_scene(out["crops"], name, rng, v0=150 + 30 * i)
            _as_crop(out["crops"], name, crop)
    for name, v0 in zip(val[:2], (210, 330)):
        _write_label_scene(out["val"], name, rng, v0=v0)
    return out


def _loader_args(tmp_path, roots, cropped):
    args = make_seg_config(tmp_path, roots["crops" if cropped else "train"],
                           roots["val"])["data_loader"]["args"]
    args["no_train_cropped"] = not cropped
    args["train_transform"] = [{"type": "RandomRotation", "args": {}}]
    return args


@pytest.mark.parametrize("cropped", [False, True], ids=["full", "crops"])
def test_loader_matches_jax_leaf_for_leaf(tmp_path, roots, cropped):
    """Two epochs of train and val batches: every graph equal leaf for
    leaf, labels included, with the same names; each sample's traces and
    original_index_traces equal (None on crops)."""
    from test_torch_graph import assert_same_tree
    args = _loader_args(tmp_path, roots, cropped)
    want = jax_label.ScanNetGraphDataLoader(copy.deepcopy(args), seed=5)
    got = scannetlabel.ScanNetGraphDataLoader(copy.deepcopy(args), seed=5)
    for split in ("train", "val"):
        a = getattr(got, f"{split}_dataset")
        b = getattr(want, f"{split}_dataset")
        assert a.index2filenames == b.index2filenames
        for i in range(len(b)):
            sa, sb = a[i], b[i]
            np.testing.assert_array_equal(sa.x, sb.x)
            np.testing.assert_array_equal(sa.labels, sb.labels)
            assert len(sa.traces) == len(sb.traces) == 2
            for ta, tb in zip(sa.traces, sb.traces):
                np.testing.assert_array_equal(ta, tb)
            oa, ob = sa.original_index_traces, sb.original_index_traces
            assert (oa is None) == (ob is None) == (split == "train"
                                                    and cropped)
            if ob is not None:
                np.testing.assert_array_equal(oa, ob)
    assert len(got.train_dataset) == (4 if cropped else 3)
    for _ in range(2):
        for name in ("train_loader", "val_loader"):
            pairs = list(zip(getattr(got, name), getattr(want, name)))
            assert len(pairs) == len(getattr(want, name))
            for (g, gn), (w, wn) in pairs:
                assert gn == wn
                assert_same_tree(g, w)
                assert g.labels is not None


def test_loader_refuses_stacked_batching(tmp_path, roots):
    args = _loader_args(tmp_path, roots, False)
    args["stacked_batching"] = True
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        scannetlabel.ScanNetGraphDataLoader(args)


def test_loader_tables_are_the_jax_packages():
    assert scannetlabel.CLASS_LABELS == jax_label.CLASS_LABELS
    np.testing.assert_array_equal(scannetlabel.CLASS_WEIGHTS,
                                  jax_label.CLASS_WEIGHTS)
    assert scannetlabel.VALID_CLASS_IDS == jax_label.VALID_CLASS_IDS
    assert scannetlabel.SCANNET_COLOR_MAP == jax_label.SCANNET_COLOR_MAP


# --- the trainer -------------------------------------------------------------

def _config(tmp_path, roots, accumulate=1, epochs=2):
    cfg = make_seg_config(tmp_path, roots["crops"], roots["val"])
    args = cfg["data_loader"]["args"]
    args.update(no_train_cropped=False,
                num_cumulated_train_batches=accumulate)
    cfg["trainer"]["epochs"] = epochs
    # the shipped config's optimizer at a tenth of its rate (see the
    # module docstring)
    cfg["optimizer"] = {"type": "Adam", "args": {
        "lr": 1e-4, "weight_decay": 0, "amsgrad": False}}
    return cfg


def _record(trainer, jax_side):
    """Wrap the train step: record each step's loss and confusion matrix."""
    out, step = {"loss": [], "conf": []}, trainer._train_step

    def recorded(*args):
        res = step(*args)
        metrics, conf = res[1:] if jax_side else res
        out["loss"].append(float(metrics["loss"]))
        out["conf"].append(np.asarray(conf))
        return res

    trainer._train_step = recorded
    return out


@pytest.mark.parametrize("accumulate", [1, 2])
def test_trainer_matches_jax(tmp_path, roots, accumulate):
    cfg = _config(tmp_path, roots, accumulate)
    want_trainer = JAX_TRAINERS.get("GraphSegmentationTrainer")(
        JaxConfigParser(copy.deepcopy(cfg), dry_run=True))
    trainer = GraphSegmentationTrainer(
        ConfigParser(copy.deepcopy(cfg), dry_run=True), device="cpu")
    trainer.model.load_state_dict(seg_state_dict_from_jax_params(
        want_trainer.state.params, want_trainer.state.batch_stats))
    step = trainer._train_step
    want_rec = _record(want_trainer, jax_side=True)
    rec = _record(trainer, jax_side=False)
    for epoch in (1, 2):
        want, got = (want_trainer._train_epoch(epoch),
                     trainer._train_epoch(epoch))
        assert sorted(got) == sorted(want)
        assert "val_full_scene_mean_iou" in got
        for k in want:
            if k.removeprefix("val_") in IOU_KEYS:
                assert abs(got[k] - want[k]) <= 0.02, (epoch, k)
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           err_msg=f"epoch {epoch} {k}")
    assert len(rec["loss"]) == len(want_rec["loss"]) == 8
    np.testing.assert_allclose(rec["loss"], want_rec["loss"], rtol=RTOL)
    np.testing.assert_array_equal(rec["conf"][0], want_rec["conf"][0])
    assert step.mini_step == 0
    assert [e["steps"] for e in trainer.epoch_timings] == [4, 4]


def test_checkpoint_resume_and_eval(tmp_path, roots, monkeypatch):
    """One epoch with the accumulation left half way (k = 3, 4 steps), its
    checkpoints under max val_mean_iou, a resume (weights, running
    statistics, gradients, Adam state and mini step bitwise), and -e valid
    with vis writing .ply files."""
    cfg = _config(tmp_path, roots, accumulate=3, epochs=1)
    cfg["trainer"]["monitor"] = "max val_mean_iou"
    config = ConfigParser(copy.deepcopy(cfg))
    trainer = GraphSegmentationTrainer(config, device="cpu")
    trainer.train()
    ckpt = config.save_dir / "checkpoint-epoch1.ckpt"
    best = config.save_dir / "model_best.ckpt"
    for path in (ckpt, best):
        assert path.exists() and os.path.exists(str(path) + ".meta.json")
    models, _, extra, meta = checkpoint.load_checkpoint(best)
    assert meta["archs"] == {"seg": "SingleConvMeshNet"}
    assert meta["monitor_best"] == trainer.mnt_best > -np.inf
    assert extra["accumulation"]["mini_step"] == 1
    assert "head_bn.running_var" in models["seg"]

    resumed = GraphSegmentationTrainer(
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

    cfg["vis"] = True
    monkeypatch.chdir(tmp_path)
    ev = GraphSegmentationTrainer(
        ConfigParser(copy.deepcopy(cfg), resume=best, dry_run=True),
        device="cpu")
    ev.eval("valid")
    names = ev.data_loader.val_dataset.index2filenames
    for name in names:
        assert (tmp_path / "visualizations" / f"{name}_pred.ply").exists()


def test_cli_trains_evaluates_and_needs_a_card(tmp_path, roots):
    """The shipped config through `python -m stinet_tpu_torch.train`,
    shrunk (filter sizes, levels, epochs) and its roots repointed: -d cpu
    trains and evaluates; without -d and without a card it raises."""
    path = os.path.join(
        ROOT, "experiments/semantic_segmentation/config/"
        "config_scmnet_segmentation.json")
    with open(path) as f:
        cfg = json.load(f)
    assert cfg["trainer"]["type"] == "GraphSegmentationTrainer"
    small = _config(tmp_path, roots, epochs=1)
    cfg["archs"]["SingleConvMeshNet"]["args"].update(
        small["archs"]["SingleConvMeshNet"]["args"])
    cfg["data_loader"]["args"].update(
        {k: small["data_loader"]["args"][k] for k in (
            "train_root_dir", "val_root_dir", "end_level", "num_workers")})
    cfg["trainer"].update(epochs=1, save_period=1, verbosity=1,
                          tensorboard=False, save_dir=str(tmp_path / "saved"))
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    env = dict(os.environ, STINET_DISABLE_GIT_TAG="1")

    def cli(*args, **extra_env):
        return subprocess.run(
            [sys.executable, "-m", "stinet_tpu_torch.train", *args],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=dict(env, **extra_env))

    res = cli("-c", str(cfg_path), "-d", "cpu", "-n", "cli")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "val_full_scene_mean_iou" in res.stdout + res.stderr
    run = next((tmp_path / "saved" / "models" / cfg["name"]).glob("*_cli"))
    res = cli("-r", str(run / "model_best.ckpt"), "-e", "valid", "-d", "cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "mean_precision" in res.stdout + res.stderr
    res = cli("-c", str(cfg_path), "-t", "1", CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr


def test_trainer_refuses_a_missing_card(tmp_path, roots, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GraphSegmentationTrainer(ConfigParser(_config(tmp_path, roots),
                                              dry_run=True))


# --- visualization and label utilities --------------------------------------

def test_visualization_and_label_utils_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    images = rng.uniform(size=(5, 4, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        visualization_utils.make_image_grid(images, nrow=2),
        jax_vis_utils.make_image_grid(images, nrow=2))
    labels = rng.integers(-2, 25, size=50)
    cmap = scannetlabel.SCANNET_COLOR_MAP
    np.testing.assert_array_equal(
        visualization_utils.colorize_labels(labels, cmap),
        jax_vis_utils.colorize_labels(labels, cmap))
    raw = rng.integers(-3, 45, size=80)
    np.testing.assert_array_equal(scannet_utils.remap_labels(raw),
                                  jax_scannet_utils.remap_labels(raw))
    tsv = tmp_path / "labels.tsv"
    tsv.write_text("raw_category\tnyu40id\nchair\t5\ntable\t7\n")
    assert scannet_utils.read_label_map(str(tsv)) == \
        jax_scannet_utils.read_label_map(str(tsv)) == {"chair": 5,
                                                       "table": 7}
    vis = SemSegVisualizer(None, cmap, str(tmp_path / "vis"))
    vis.interactive = False
    vis.visualize_result("s", np.array([1, 2, 3]), np.array([1, 2, 4]))
    assert (tmp_path / "vis" / "s_mask.ply").read_text().count(
        "25 229 25") == 1
