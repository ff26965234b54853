"""The port's train step (stinet_tpu_torch/trainers/graph_common.py) against
the JAX package's, on the CPU, from the same weights and scenes.

Tolerances:
- optimizer updates: params within 1e-6 of the largest parameter after 20
  steps (torch and the hand-written JAX Adam round in a different order);
- learning-rate schedules: equal to 1e-12;
- loss and metrics: 1e-5 relative (f32 sums in another order);
- f32 train step, 5 steps at the bf16 config's learning rate: each loss
  within 1e-4 relative; every parameter within 1e-4, leaving out the
  leaves whose first-step JAX gradient is zero to rounding (at most 1e-5 of
  the largest gradient component: lin2's bias ahead of an instance norm has
  a zero gradient in exact arithmetic, and Adam scales the rounding noise
  to +-lr). The weights come from init key 1: under key 0 one relu argument
  of the output block lies within rounding of 0, the two frameworks take
  its step on opposite sides, and Adam turns that into 1.4e-4 on weights
  with gradients far from 0;
- bf16 windowed train step (the Pallas kernels in interpret mode): the
  forward within mean |diff| 0.03 and max 0.3 (tests/test_bf16.py's bound),
  each of 3 losses within 2% relative: bf16 matmuls round differently in
  the two frameworks.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stinet_tpu.graph import build as jax_build
from stinet_tpu.models.factory import define_G as jax_define_G
from stinet_tpu.ops import message_passing as jax_mp
from stinet_tpu.trainers import graph_common as jax_gc
from stinet_tpu.utils.synthetic import synthetic_scene as jax_scene
from stinet_tpu_torch.graph import build as port_build
from stinet_tpu_torch.graph.build import build_hierarchical_graph
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.models.stinet import EdgeConvFilter
from stinet_tpu_torch.ops.message_passing import windowed_kernel_applies
from stinet_tpu_torch.trainers import graph_common as gc
from stinet_tpu_torch.utils.convert import state_dict_from_jax_params
from stinet_tpu_torch.utils.synthetic import synthetic_scene

ROOT = pathlib.Path(__file__).resolve().parents[1]
BF16_CONFIG = json.loads((ROOT / "experiments/3d_inpainting/config/"
                          "config_stinet_surfacetextureinpainting_bf16.json")
                         .read_text())
CFG = dict(input_nc=10, output_nc=3, ngf=8, filter_type="edgeconvtransinv",
           norm="instance", n_blocks=2, n_levels=2, n_repeated_io_convs=1,
           pooling_type="max", dilations=[1, 2])
SCENE = dict(num_vertices=2000, levels=3, dilation_dists=(2,), seed=3)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("opt_config", [
    {"type": "Adam", "args": {"lr": 1e-3, "amsgrad": True}},
    {"type": "Adam", "args": {"lr": 7e-5, "weight_decay": 0.01,
                              "amsgrad": True}},
    {"type": "Adam", "args": {"lr": 1e-3, "weight_decay": 0,
                              "amsgrad": False}},
    {"type": "SGD", "args": {"lr": 1e-2, "momentum": 0.9}}])
def test_optimizer_matches_jax_over_20_steps(opt_config):
    rng = np.random.default_rng(0)
    shapes = {"w": (16, 8), "b": (8,)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-3, 2))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(20)]
    tx, lr = jax_gc.build_optimizer(opt_config)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    port = {k: t(v.copy()).requires_grad_() for k, v in init.items()}
    opt, port_lr = gc.build_optimizer(list(port.values()), opt_config)
    assert port_lr == lr
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, params)
        params = optax.apply_updates(
            params, jax.tree.map(lambda u: u * lr, upd))
        for k, p in port.items():
            p.grad = t(g[k])
        opt.step()
    for k, p in port.items():
        want = np.asarray(params[k])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("sched", [
    {"type": "StepLR", "args": {"step_size": 3, "gamma": 0.5}},
    {"type": "ExponentialLR", "args": {"gamma": 0.9}},
    {"type": "CosineAnnealingLR", "args": {"T_max": 10, "eta_min": 1e-6}},
    {"type": "LinearLR", "args": {"start_factor": 0.25, "total_iters": 4}},
    {"type": "ConstantLR"}])
def test_step_lr_matches_jax(sched):
    want, got = jax_gc.step_lr(7e-5, sched), gc.step_lr(7e-5, sched)
    for epoch in range(1, 25):
        assert got(epoch) == pytest.approx(want(epoch), rel=1e-12)


def test_plateau_lr_matches_jax():
    sched = {"type": "ReduceLROnPlateau",
             "args": {"factor": 0.5, "patience": 1, "cooldown": 1}}
    want, got = jax_gc.step_lr(1e-3, sched), gc.step_lr(1e-3, sched)
    for epoch, val in enumerate([1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7,
                                 0.8, 0.9], start=1):
        assert got(epoch) == want(epoch)
        got.observe(val)
        want.observe(val)


def _graphs(windowed=False, scene=SCENE):
    return (jax_build.build_hierarchical_graph([jax_scene(**scene)],
                                               windowed=windowed),
            build_hierarchical_graph([synthetic_scene(**scene)],
                                     windowed=windowed))


@pytest.mark.parametrize("weighted", [False, True])
def test_loss_and_metrics_match_jax(weighted):
    jg, pg = _graphs()
    rng = np.random.default_rng(1)
    out = rng.uniform(-1, 1, size=tuple(pg.color.shape)).astype(np.float32)
    vmask = np.asarray(jg.levels[0].vertex_mask())
    loss, comp = jax_gc.inpainting_loss(jnp.asarray(out), jg.color, jg.mask,
                                        jnp.asarray(vmask), weighted)
    want = jax_gc.inpainting_metrics(comp, jg, loss)
    ploss, pcomp = gc.inpainting_loss(t(out), pg.color, pg.mask,
                                      gc.vertex_mask(pg), weighted)
    got = gc.inpainting_metrics(pcomp, pg, ploss)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def _jax_train(model, params, graph, opt_config, steps, weighted=True):
    tx, lr = jax_gc.build_optimizer(opt_config)
    state = jax_gc.TrainState(params=params, opt_state=tx.init(params),
                              step=jnp.zeros((), jnp.int32))
    train_step, _ = jax_gc.make_inpainting_steps(model, tx, weighted)
    losses = []
    for _ in range(steps):
        state, m = train_step(state, graph, jnp.float32(lr))
        losses.append(float(m["loss"]))
    return np.asarray(losses), state.params


def _port_train(model, graph, opt_config, steps, weighted=True):
    opt, lr = gc.build_optimizer(model.parameters(), opt_config)
    train_step, _ = gc.make_inpainting_steps(model, opt, weighted)
    return np.asarray([float(train_step(graph, lr)["loss"])
                       for _ in range(steps)])


def test_f32_train_step_matches_jax():
    jg, pg = _graphs()
    jm = jax_define_G(**CFG)
    params = jm.init(jax.random.key(1), jg)["params"]
    model = define_G(**CFG)
    model.load_state_dict(state_dict_from_jax_params(params))
    vmask = jg.levels[0].vertex_mask()
    grad = state_dict_from_jax_params(jax.grad(
        lambda prm: jax_gc.inpainting_loss(
            jm.apply({"params": prm}, jg, train=True), jg.color, jg.mask,
            vmask, True)[0])(params))
    g_max = max(float(g.abs().max()) for g in grad.values())
    opt_config = BF16_CONFIG["optimizer"]
    want, jparams = _jax_train(jm, params, jg, opt_config, 5)
    got = _port_train(model, pg, opt_config, 5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert want[-1] < want[0]
    back = state_dict_from_jax_params(jparams)
    held = [k for k in back if float(grad[k].abs().max()) > 1e-5 * g_max]
    # only biases ahead of an instance norm may be left out
    assert set(back) - set(held) <= {
        k for k in back if k.endswith("nn.2.bias")} | {"final_linear1.bias"}
    for k in held:
        d = float((model.state_dict()[k] - back[k]).abs().max())
        assert d <= 1e-4, (k, d)


def test_bf16_windowed_train_step_matches_jax(monkeypatch):
    """The bf16 config's model (ngf=64, so the level-0 and level-1 tables
    have H = 128 and 256 and take the windowed kernels) with 2 bottleneck
    blocks, its optimizer and its mask-weighted loss, on a shuffled scene
    built windowed; JAX reaches its Pallas kernels in interpret mode."""
    monkeypatch.setenv("STINET_WINDOWED_INTERPRET", "1")
    monkeypatch.setattr(jax_build._native, "available", lambda: False)
    monkeypatch.setattr(port_build._native, "available", lambda: False)
    args = dict(BF16_CONFIG["archs"]["SurfaceTextureInpaintingNet"]["args"],
                n_blocks=2, dilations=[1, 2])
    jg, pg = _graphs(windowed=True, scene=dict(SCENE, num_vertices=2048))
    for level, h in ((0, 128), (1, 256)):
        e = pg.levels[level].edges
        v = e.nbr.shape[0]
        assert windowed_kernel_applies(torch.zeros(v, h, dtype=torch.bfloat16),
                                       e.halo)
        assert jax_mp._windowed_kernel_applies(
            jnp.zeros((v, h), jnp.bfloat16), jg.levels[level].edges.halo)

    jm = jax_define_G(**args)
    params = jm.init(jax.random.key(0), jg)["params"]
    model = define_G(**args)
    model.load_state_dict(state_dict_from_jax_params(params))
    want_out = np.asarray(jm.apply({"params": params}, jg), np.float32)
    with torch.no_grad():
        got_out = model(pg).float().numpy()
    n = int(pg.levels[0].num_vertices)
    d = np.abs(got_out[:n] - want_out[:n])
    assert d.mean() < 0.03 and d.max() < 0.3, (d.mean(), d.max())

    opt_config = BF16_CONFIG["optimizer"]
    weighted = BF16_CONFIG["trainer"]["use_mask_weighted_loss"]
    want, _ = _jax_train(jm, params, jg, opt_config, 3, weighted)
    got = _port_train(model, pg, opt_config, 3, weighted)
    np.testing.assert_allclose(got, want, rtol=0.02)
    for p in model.parameters():
        assert p.dtype == torch.float32 and torch.isfinite(p).all()


def test_checkpointed_blocks_run_twice_and_change_nothing():
    """Checkpointing recomputes each block's forward in the backward and
    gives the same loss and gradients as keeping the activations."""
    graph = build_hierarchical_graph([synthetic_scene(**SCENE)])
    grads, calls = [], []
    for remat in (False, True):
        model = define_G(**CFG, remat_io_blocks=remat,
                         checkpoint_bottleneck=remat,
                         generator=torch.Generator().manual_seed(0))
        count = [0]
        for m in model.modules():
            if isinstance(m, EdgeConvFilter):
                m.register_forward_pre_hook(
                    lambda *_: count.__setitem__(0, count[0] + 1))
        loss, _ = gc.inpainting_loss(model(graph), graph.color, graph.mask,
                                     gc.vertex_mask(graph), True)
        loss.backward()
        grads.append([p.grad.clone() for p in model.parameters()])
        calls.append(count[0])
    n_filters = 1 + 2 + CFG["n_blocks"] + 2 + 1
    assert calls == [n_filters, 2 * n_filters]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
