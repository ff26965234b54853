"""The port's server (stinet_tpu_torch/serving.py) against the JAX server,
on the CPU: windowed f32 serving with the exact-f32 windowed op (K3b), and
batched, streamed and warmed-up serving and checkpoints, mirroring
tests/test_serving.py.

The JAX weights are carried across by `state_dict_from_jax_params`.
Tolerances: 1e-4 max |diff| between the frameworks and between layouts
(matmuls and norm statistics sum in different orders, TOL of
tests/test_torch_model.py); 1e-6 where the port serves the same graph two
ways.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_windowed import scipy_rcm  # noqa: F401 (a fixture)

from stinet_tpu.graph import native as jax_native
from stinet_tpu.graph.build import build_hierarchical_graph as jax_build
from stinet_tpu.models.factory import define_G as jax_define_G
from stinet_tpu.ops.pallas import onehot_gather
from stinet_tpu.serving import SceneInpainter as JaxSceneInpainter
from stinet_tpu.utils.synthetic import synthetic_scene as jax_scene
from stinet_tpu_torch.core import checkpoint
from stinet_tpu_torch.graph import native as port_native
from stinet_tpu_torch.graph.build import (
    build_hierarchical_graph, windowed_layout)
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.ops import message_passing
from stinet_tpu_torch.serving import SceneInpainter
from stinet_tpu_torch.utils.convert import state_dict_from_jax_params
from stinet_tpu_torch.utils.synthetic import synthetic_scene

TOL = 1e-4
TINY = dict(input_nc=10, output_nc=3, ngf=8, n_blocks=2, dilations=[1, 1],
            norm="instance", pooling_type="max", n_levels=2,
            n_repeated_io_convs=1, filter_type="edgeconvtransinv")


def scene(seed, n=500, **kw):
    return synthetic_scene(num_vertices=n, levels=3, seed=seed, **kw)


@pytest.fixture(scope="module")
def served():
    """The tiny JAX model and params of tests/test_serving.py, and the
    port's CPU server with the same weights."""
    model = jax_define_G(**TINY, dtype="float32")
    graph = jax_build([jax_scene(num_vertices=500, levels=3, seed=0)])
    params = jax.jit(model.init)(jax.random.key(0), graph)["params"]
    weights = state_dict_from_jax_params(params)
    return model, params, weights


def port_server(weights, **kw):
    return SceneInpainter(define_G(**TINY), weights, device="cpu", **kw)


def assert_close(got, want, tol=TOL):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


# --- windowed f32 serving: K3b on the convs at H = 256 ---------------------

def test_windowed_f32_predict_matches_jax(scipy_rcm, monkeypatch):
    """Flagship widths (ngf = 64: H = 256 at level 1) with 2 bottleneck
    blocks on a 4096-vertex scene: JAX's windowed server (Pallas in
    interpret mode) and the port's send the same convs to the exact-f32
    windowed kernel, and their outputs agree. JAX's server returns the rows
    in the build's RCM order, the port's in the scene's order, so JAX's are
    put back in the scene's order first. Both builders take scipy's RCM."""
    _windowed_f32_predict_matches_jax(monkeypatch)


def test_native_windowed_f32_predict_matches_jax_native(monkeypatch):
    """The same with both native builders (one C++ RCM)."""
    assert port_native.available() and jax_native.available()
    _windowed_f32_predict_matches_jax(monkeypatch)


def _windowed_f32_predict_matches_jax(monkeypatch):
    monkeypatch.setenv("STINET_WINDOWED_INTERPRET", "1")
    cfg = dict(TINY, ngf=64, dilations=[1, 2])
    kw = dict(num_vertices=4096, levels=3, seed=3, dilation_dists=(2,))
    model = jax_define_G(**cfg, dtype="float32")
    params = jax.jit(model.init)(jax.random.key(1),
                                 jax_build([jax_scene(**kw)]))["params"]

    jax_calls, port_calls = [], []
    jax_fn = onehot_gather.windowed_ell_edge_conv_sum_f32
    port_fn = message_passing.WindowedEdgeConvSumF32

    def jax_spy(halo, tile, interpret, p, *args):
        jax_calls.append((tuple(p.shape), halo, tile))
        return jax_fn(halo, tile, interpret, p, *args)

    class PortSpy(torch.autograd.Function):
        @staticmethod
        def forward(ctx, p, q, nbr, rev, deg_in, deg_out, halo, tile, *rest):
            port_calls.append((tuple(p.shape), halo, tile))
            return port_fn.forward(
                ctx, p, q, nbr, rev, deg_in, deg_out, halo, tile, *rest)

    monkeypatch.setattr(onehot_gather, "windowed_ell_edge_conv_sum_f32",
                        jax_spy)
    monkeypatch.setattr(message_passing, "WindowedEdgeConvSumF32", PortSpy)
    want = JaxSceneInpainter(model, params, windowed=True).predict(
        jax_scene(**kw))
    server = SceneInpainter(define_G(**cfg), state_dict_from_jax_params(
        params), windowed=True, device="cpu")
    got = server.predict(synthetic_scene(**kw))
    _, order = windowed_layout(synthetic_scene(**kw))
    assert order is not None
    want = np.asarray(want)[np.argsort(order)]
    # JAX traces its forward twice (the live-leaf analysis of its packed
    # copy, then jit), the port runs it once: the level-1 encoder and
    # decoder convs
    assert len(port_calls) == 2
    assert all(shape[1] == 256 for shape, _, _ in port_calls)
    assert jax_calls == port_calls * 2
    assert got.shape == want.shape == (kw["num_vertices"], 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


# --- batched dispatch --------------------------------------------------------

def test_predict_batch_matches_jax_and_single_scenes(served):
    """Stacked and concatenated batches against the JAX server's batch and
    against single-scene predicts (norms are per graph in both
    layouts)."""
    model, params, weights = served
    seeds = (0, 1)
    want = JaxSceneInpainter(model, params).predict_batch(
        [jax_scene(num_vertices=500, levels=3, seed=s) for s in seeds])
    server = port_server(weights)
    scenes = [scene(s) for s in seeds]
    singles = [server.predict(s) for s in scenes]
    stacked = server.predict_batch(scenes, stacked=True)
    concat = server.predict_batch(scenes, stacked=False)
    assert [a.shape for a in stacked] == [(500, 3)] * 2
    assert_close(stacked, want)
    assert_close(stacked, singles, 1e-6)
    assert_close(concat, singles)
    assert_close(stacked, concat)


def test_stacked_batch_is_placed_in_one_copy(served):
    _, _, weights = served
    server = port_server(weights)
    placed = []
    place = server.place
    server.place = lambda g: placed.append(g.x.shape) or place(g)
    server.predict_batch([scene(s) for s in (2, 3, 4)], stacked=True)
    assert len(placed) == 1 and placed[0][0] == 3


def test_predict_batch_auto_falls_back_on_bucket_mismatch(served):
    """Scenes on different vertex buckets cannot share a stacked layout:
    stacked=True raises, "auto" serves them concatenated, as JAX's does."""
    model, params, weights = served
    server = port_server(weights)
    scenes = [scene(0), scene(5, n=2500)]
    with pytest.raises(ValueError):
        server.predict_batch(scenes, stacked=True)
    got = server.predict_batch(scenes, stacked="auto")
    assert_close(got, [server.predict(s) for s in scenes])
    want = JaxSceneInpainter(model, params).predict_batch(
        [jax_scene(num_vertices=500, levels=3, seed=0),
         jax_scene(num_vertices=2500, levels=3, seed=5)], stacked="auto")
    assert_close(got, want)


def test_predict_batch_heterogeneous_dilated_falls_back(served):
    """Scenes with different dilation-distance sets cannot share a stacked
    layout: "auto" serves them concatenated, where a scene missing a
    distance adds no edges."""
    _, _, weights = served
    server = port_server(weights)
    scenes = [scene(0), scene(9, dilation_dists=(2, 4))]
    assert_close(server.predict_batch(scenes),
                 [server.predict(s) for s in scenes])


def test_unify_static_halos_takes_batch_max(served):
    """A stacked batch's halos are unified to the batch maximum, so the
    stacked graphs share one structure, and only per batch."""
    _, _, weights = served
    server = port_server(weights, windowed=True)
    ga = server.build(scene(10, n=3000))
    h0 = ga.levels[0].edges.halo
    assert h0 is not None
    lv0 = ga.levels[0]
    gb = dataclasses.replace(ga, levels=(dataclasses.replace(
        lv0, edges=dataclasses.replace(lv0.edges, halo=max(h0 // 2, 1))),
        *ga.levels[1:]))
    out = server._stack([gb, ga])
    assert out.levels[0].edges.halo == h0
    assert out.x.shape[0] == 2
    assert gb.levels[0].edges.halo == max(h0 // 2, 1)   # inputs untouched
    assert server._stack([gb, gb]).levels[0].edges.halo == max(h0 // 2, 1)


def test_windowed_server_returns_the_scene_order(served):
    """A windowed server serves RCM-ordered builds and returns every
    layout's rows in the scene's own vertex order: the same colors as the
    non-windowed server, whose builds keep that order."""
    _, _, weights = served
    scenes = [scene(s, n=3000) for s in (12, 13)]
    assert all(windowed_layout(s)[1] is not None for s in scenes)
    want = [port_server(weights).predict(s) for s in scenes]
    server = port_server(weights, windowed=True)
    assert_close([server.predict(s) for s in scenes], want)
    assert_close(server.predict_batch(scenes, stacked=True), want)
    assert_close(server.predict_batch(scenes, stacked=False), want)
    assert_close(list(server.predict_stream(iter(scenes))), want)


def test_windowed_stacked_batch_matches_single_scenes(served):
    _, _, weights = served
    server = port_server(weights, windowed=True)
    scenes = [scene(s, n=3000) for s in (10, 11)]
    assert server.build(scenes[0]).levels[0].edges.halo is not None
    assert_close(server.predict_batch(scenes, stacked=True),
                 [server.predict(s) for s in scenes], 1e-6)


# --- streaming, warmup, checkpoints ------------------------------------------

def test_predict_stream_matches_predict_in_order(served):
    _, _, weights = served
    server = port_server(weights)
    scenes = [scene(s) for s in (20, 21, 22, 23, 24)]
    want = [port_server(weights).predict(s) for s in scenes]
    got = list(server.predict_stream(iter(scenes)))
    assert_close(got, want, 1e-6)
    stats = server.stream_stats()
    assert set(stats) == {"build_ms", "pack_ms", "wire_mbytes", "put_ms",
                          "dispatch_ms", "d2h_wait_ms"}
    assert stats["wire_mbytes"] > 0
    assert len(server._stream_stats["build_ms"]) == len(scenes)


def test_warmup_serves_each_signature_once(served):
    _, _, weights = served
    server = port_server(weights)
    calls = []
    forward = server.forward
    server.forward = lambda g: calls.append(g.num_graphs) or forward(g)
    same = scene(0)
    assert server.warmup([same, same, same]) == 1
    # predict, then predict_batch of one scene (stacked: one forward)
    assert calls == [1, 1]
    calls.clear()
    pair = [scene(1), scene(2)]
    n = server.warmup(pair, batch_sizes=(2,))
    assert n == 1
    # stacked (one forward a scene) and then concatenated (one of 2 graphs)
    assert calls == [1, 1, 2]
    out = server.predict_batch(pair)
    assert_close(out, [server.predict(s) for s in pair], 1e-6)


def test_from_checkpoint_round_trip(served, tmp_path):
    _, _, weights = served
    ckpt = tmp_path / "model_best.ckpt"
    config = {"archs": {"graph": {"type": "define_G",
                                  "args": dict(TINY, dtype="float32")}}}
    model = define_G(**TINY)
    model.load_state_dict(weights)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, amsgrad=True)
    checkpoint.save_checkpoint(ckpt, models={"graph": model.state_dict()},
                               opt_states={"graph": opt.state_dict()},
                               epoch=3, monitor_best=0.5, config=config,
                               archs={"graph": "STINet"})
    assert checkpoint.latest_checkpoint(tmp_path) == ckpt
    sds, opts, extra, meta = checkpoint.load_checkpoint(ckpt)
    assert meta["epoch"] == 3 and meta["archs"] == {"graph": "STINet"}
    assert extra == {} and set(opts) == {"graph"}
    for k, v in weights.items():
        assert torch.equal(sds["graph"][k], v)
    s = scene(0)
    server = SceneInpainter.from_checkpoint(ckpt, s, device="cpu")
    np.testing.assert_array_equal(server.predict(s),
                                  port_server(weights).predict(s))


def test_latest_checkpoint_takes_the_highest_epoch(tmp_path):
    assert checkpoint.latest_checkpoint(tmp_path) is None
    for e in (2, 10, 9):
        checkpoint.save_checkpoint(tmp_path / f"checkpoint-epoch{e}.ckpt",
                                   {}, {}, e, 0.0, {})
    assert checkpoint.latest_checkpoint(tmp_path).name == (
        "checkpoint-epoch10.ckpt")


def test_num_compiles_counts_what_jax_compiles(served):
    """`num_compiles` after each request of a sequence over two vertex
    buckets (500 and 1500 vertices): single scenes, a same-bucket repeat,
    a stacked pair and a pair that falls back to the concatenated layout.
    The port's count equals JAX's jit-cache count after every request."""
    model, params, weights = served
    jax_server = JaxSceneInpainter(model, params)
    server = port_server(weights)
    a, b, c = scene(3), scene(4), scene(5, n=1500)
    requests = [("predict", [a]), ("predict", [b]), ("predict", [a]),
                ("predict", [c]), ("predict_batch", [a, b]),
                ("predict_batch", [b, a]), ("predict_batch", [a, c])]
    counts = []
    for name, scenes in requests:
        for s in (jax_server, server):
            if name == "predict":
                s.predict(scenes[0])
            else:
                s.predict_batch(scenes)
        counts.append((jax_server.num_compiles(), server.num_compiles()))
    assert [j for j, _ in counts] == [p for _, p in counts], counts
    assert counts[-1][0] >= 4
