"""The port's graph and batch norms (stinet_tpu_torch/ops/norms.py,
models/stinet.py:GraphNormLayer) against the JAX package's, on the CPU, on
the same numpy inputs.

Tolerances:
- masked_graph_norm and masked_batch_norm_stats, one graph and G graphs:
  forward and gradient within 1e-5 (f32 sums in another order);
- the model (ngf 8, 2 bottleneck blocks, max pooling) with norm="batch" and
  norm="graph", in eval and in train mode (JAX's train=True with the
  batch_stats collection mutable): the output and every parameter's
  gradient within 1e-5 of the largest, and the updated running statistics
  within 1e-6;
- the running statistics after one train step with checkpointed blocks
  (remat_io_blocks and checkpoint_bottleneck): within 1e-6 of JAX's
  has_batch_stats step, and moved exactly once (num_batches_tracked 1);
- the weights' conversion and a trainer's resume: bitwise.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stinet_tpu.graph.build import build_hierarchical_graph as jax_build
from stinet_tpu.models.factory import define_G as jax_define_G
from stinet_tpu.ops import norms as jax_norms
from stinet_tpu.trainers import graph_common as jax_gc
from stinet_tpu.utils.convert_reference_checkpoint import (
    convert_stinet_state_dict)
from stinet_tpu.utils.synthetic import synthetic_scene as jax_scene
from stinet_tpu_torch.core.config import ConfigParser
from stinet_tpu_torch.graph.build import build_hierarchical_graph
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.models.stinet import GraphNormLayer
from stinet_tpu_torch.ops import norms
from stinet_tpu_torch.trainers import graph_common as gc
from stinet_tpu_torch.trainers.inpainting3d import Inpainting3DTrainer
from stinet_tpu_torch.utils.convert import state_dict_from_jax_params
from stinet_tpu_torch.utils.synthetic import synthetic_scene
from test_torch_trainer import ARGS, _config, roots  # noqa: F401 (fixture)

CFG = dict(input_nc=10, output_nc=3, ngf=8, filter_type="edgeconvtransinv",
           n_blocks=2, n_levels=2, n_repeated_io_convs=1,
           pooling_type="max", dilations=[1, 2])
SCENE = dict(num_vertices=2000, levels=3, dilation_dists=(2,), seed=3)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(sizes, v):
    """graph_id and valid count of graphs of `sizes` rows laid out one
    after another, pad rows to v carrying len(sizes)."""
    gid = np.full(v, len(sizes), np.int32)
    start = 0
    for g, n in enumerate(sizes):
        gid[start:start + n] = g
        start += n
    return gid, start


@pytest.mark.parametrize("sizes,v", [((200,), 256), ((200,), 200),
                                     ((90, 1, 150), 300)])
def test_graph_norm_matches_jax(sizes, v):
    rng = np.random.default_rng(0)
    c = 12
    x = (rng.normal(size=(v, c)) * 3 + 1).astype(np.float32)
    wt, b, ms = (rng.normal(size=c).astype(np.float32) for _ in range(3))
    gout = rng.normal(size=(v, c)).astype(np.float32)
    gid, nv = _rows(sizes, v)
    vmask = jnp.asarray(np.arange(v) < nv, jnp.float32)
    ng = len(sizes)

    def jfn(x, wt, b, ms):
        return jnp.sum(jax_norms.masked_graph_norm(
            x, jnp.asarray(gid), ng, vmask, wt, b, ms) * gout)
    want = jax_norms.masked_graph_norm(jnp.asarray(x), jnp.asarray(gid), ng,
                                       vmask, wt, b, ms)
    want_g = jax.grad(jfn, argnums=(0, 1, 2, 3))(x, wt, b, ms)

    leaves = [t(a).requires_grad_() for a in (x, wt, b, ms)]
    got = norms.masked_graph_norm(leaves[0], t(gid), ng,
                                  torch.tensor(nv), *leaves[1:])
    (got * t(gout)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    assert not got[nv:].any()
    for name, leaf, ref in zip(("x", "weight", "bias", "mean_scale"),
                               leaves, want_g):
        np.testing.assert_allclose(leaf.grad.numpy(), ref, atol=1e-5,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("nv", [1, 300, 512])
def test_batch_norm_stats_match_jax(nv):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(512, 16)) * 2 - 3).astype(np.float32)
    vmask = jnp.asarray(np.arange(512) < nv, jnp.float32)
    want = jax_norms.masked_batch_norm_stats(jnp.asarray(x), vmask)
    got = norms.masked_batch_norm_stats(t(x), torch.tensor(nv))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=1e-6)


def _random_variables(model, graph):
    """The JAX model's variables with every parameter and running
    statistic drawn from a numpy generator (variances positive)."""
    variables = model.init(jax.random.key(0), graph)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape) if p[-1].key == "var"
                      else rng.normal(0, 0.5, a.shape)).astype(np.float32),
        dict(variables.get("batch_stats", {})))
    return params, stats


@pytest.fixture(scope="module")
def graphs():
    return (jax_build([jax_scene(**SCENE)]),
            build_hierarchical_graph([synthetic_scene(**SCENE)]))


def _port(norm, params, stats, **kw):
    model = define_G(**CFG, norm=norm, **kw)
    model.load_state_dict(state_dict_from_jax_params(params, stats))
    return model


def _buffers(model):
    return {k: v for k, v in model.state_dict().items() if "running" in k}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("norm", ["batch", "graph"])
def test_model_matches_jax(graphs, norm, train):
    jg, pg = graphs
    jm = jax_define_G(**CFG, norm=norm)
    params, stats = _random_variables(jm, jg)
    assert bool(stats) == (norm == "batch")
    rng = np.random.default_rng(2)
    r = rng.normal(size=tuple(pg.color.shape)).astype(np.float32)

    def jfn(prm):
        variables = {"params": prm, "batch_stats": stats}
        if train:
            out, upd = jm.apply(variables, jg, train=True,
                                mutable=["batch_stats"])
            return jnp.sum(out * r), (out, upd["batch_stats"])
        out = jm.apply(variables, jg, train=False)
        return jnp.sum(out * r), (out, stats)
    (_, (want, new_stats)), grads = jax.value_and_grad(
        jfn, has_aux=True)(params)

    model = _port(norm, params, stats)
    model.train(train)
    got = model(pg)
    (got * t(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    want_g = state_dict_from_jax_params(grads, stats)
    g_max = max(float(g.abs().max()) for g in want_g.values())
    for k, p in model.named_parameters():
        d = float((p.grad - want_g[k]).abs().max())
        assert d <= 1e-5 * g_max, (k, d, g_max)
    want_b = _buffers(_port(norm, params, new_stats))
    for k, b in _buffers(model).items():
        np.testing.assert_allclose(b.numpy(), want_b[k].numpy(), atol=1e-6,
                                   err_msg=k)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(train), k


def test_train_step_moves_running_stats_once(graphs):
    """One step of make_inpainting_steps with every block checkpointed: the
    recomputed forwards in the backward leave the running statistics
    alone, as JAX's nn.remat does."""
    jg, pg = graphs
    kw = dict(remat_io_blocks=True, checkpoint_bottleneck=True)
    jm = jax_define_G(**CFG, norm="batch", **kw)
    params, stats = _random_variables(jm, jg)
    opt_config = {"type": "Adam", "args": {"lr": 1e-3, "amsgrad": True}}
    tx, lr = jax_gc.build_optimizer(opt_config)
    state = jax_gc.TrainState(params=params, opt_state=tx.init(params),
                              step=jnp.zeros((), jnp.int32),
                              batch_stats=stats)
    jstep, _ = jax_gc.make_inpainting_steps(jm, tx, True,
                                            has_batch_stats=True)
    state, want_m = jstep(state, jg, jnp.float32(lr))

    model = _port("batch", params, stats, **kw)
    opt, lr = gc.build_optimizer(model.parameters(), opt_config)
    step, _ = gc.make_inpainting_steps(model, opt, True)
    got_m = step(pg, lr)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               rtol=1e-5)
    want_b = _buffers(_port("batch", state.params, state.batch_stats))
    moved = 0
    for k, b in _buffers(model).items():
        np.testing.assert_allclose(b.numpy(), want_b[k].numpy(), atol=1e-6,
                                   err_msg=k)
        moved += not np.array_equal(
            b.numpy(), state_dict_from_jax_params(params, stats)[k].numpy())
    assert moved == len(want_b)
    tracked = [int(v) for k, v in model.state_dict().items()
               if k.endswith("num_batches_tracked")]
    assert tracked == [1] * (len(want_b) // 2)


@pytest.mark.parametrize("norm", ["batch", "graph"])
def test_convert_round_trip(graphs, norm):
    """JAX params (and batch_stats) -> the port's state dict, which the
    port model loads strictly and which keeps every value; back through
    the JAX package's reference-checkpoint converter, every leaf returns
    but for what that converter maps elsewhere: a graph norm's `weight`
    (to `scale`, which the JAX graph norm does not have) and final_norm1's
    running statistics (dropped)."""
    jg, _ = graphs
    params, stats = _random_variables(jax_define_G(**CFG, norm=norm), jg)
    sd = state_dict_from_jax_params(params, stats)
    model = define_G(**CFG, norm=norm)
    model.load_state_dict(sd)
    assert sorted(model.state_dict()) == sorted(sd)
    first = "input_blocks.0.first_norm"
    if norm == "batch":
        assert {f"{first}.module.{k}" for k in (
            "weight", "bias", "running_mean", "running_var",
            "num_batches_tracked")} <= set(sd)
    else:
        assert {f"{first}.{k}" for k in ("weight", "bias",
                                         "mean_scale")} <= set(sd)

    back_p, back_s = convert_stinet_state_dict(sd)
    flat = {p: np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(back_p)[0]}
    flat.update({p: np.asarray(v) for p, v in
                 jax.tree_util.tree_flatten_with_path(back_s)[0]})
    ref = {p: np.asarray(v) for p, v in
           jax.tree_util.tree_flatten_with_path(params)[0]}
    ref.update({p: np.asarray(v) for p, v in
                jax.tree_util.tree_flatten_with_path(stats)[0]})
    if norm == "graph":
        moved = {p for p in ref if p[-1].key == "weight"}
        assert {p[:-1] + (jax.tree_util.DictKey("scale"),)
                for p in moved} <= set(flat)
    else:
        moved = {p for p in ref
                 if p[0].key == "final_norm1" and p[-1].key in ("mean",
                                                                "var")}
        assert len(moved) == 2
    assert not moved & set(flat)
    for p, v in ref.items():
        if p not in moved:
            np.testing.assert_array_equal(flat[p], v, err_msg=str(p))


def test_norm_layer_refuses_an_unknown_type():
    with pytest.raises(NotImplementedError):
        GraphNormLayer(8, "layer")


def test_trainer_resume_restores_the_running_stats(tmp_path, roots):
    """A batch-norm model trained for one epoch by the trainer: its
    checkpoint holds the running statistics, which a resume restores
    bit for bit."""
    cfg = _config(tmp_path, roots, epochs=1)
    cfg["archs"][ARGS[0]][ARGS[1]]["norm"] = "batch"
    config = ConfigParser(copy.deepcopy(cfg))
    trainer = Inpainting3DTrainer(config, device="cpu")
    trainer.train()
    got = dict(trainer.model.named_buffers())
    assert int(got["final_norm1.module.num_batches_tracked"]) == 2
    assert not torch.equal(got["final_norm1.module.running_var"],
                           torch.ones(8))
    resumed = Inpainting3DTrainer(ConfigParser(
        copy.deepcopy(cfg), resume=config.save_dir / "checkpoint-epoch1.ckpt",
        dry_run=True), device="cpu")
    back = dict(resumed.model.named_buffers())
    assert sorted(back) == sorted(got)
    for k, b in got.items():
        assert torch.equal(b, back[k]), k
