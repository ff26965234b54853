"""The port's STINet (stinet_tpu_torch/models) and its serving path against
the JAX package's, with the JAX params carried across by
`state_dict_from_jax_params`, on a small scene (ngf=8, 2 bottleneck
blocks with dilations [1, 2], 2 levels). Tolerance 1e-4 max |diff| on the
tanh output: the two frameworks sum matmuls and norm statistics in
different orders (f32)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from stinet_tpu.graph.build import build_hierarchical_graph as jax_build
from stinet_tpu.models.factory import define_G as jax_define_G
from stinet_tpu.serving import SceneInpainter as JaxSceneInpainter
from stinet_tpu.utils.convert_reference_checkpoint import (
    convert_stinet_state_dict)
from stinet_tpu.utils.synthetic import synthetic_scene as jax_scene
from stinet_tpu_torch.graph.build import build_hierarchical_graph
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.serving import SceneInpainter, full_f32_matmuls
from stinet_tpu_torch.utils.convert import state_dict_from_jax_params
from stinet_tpu_torch.utils.synthetic import synthetic_scene

CFG = dict(input_nc=10, output_nc=3, ngf=8, filter_type="edgeconvtransinv",
           norm="instance", n_blocks=2, n_levels=2, n_repeated_io_convs=1,
           pooling_type="max", dilations=[1, 2])
SCENE = dict(num_vertices=2000, levels=3, dilation_dists=(2,))
TOL = 1e-4


@pytest.fixture(scope="module")
def jax_model_params():
    """The JAX model and params drawn from a numpy generator (biases
    included, so the bias paths are exercised too)."""
    model = jax_define_G(**CFG)
    graph = jax_build([jax_scene(seed=3, **SCENE)])
    params = model.init(jax.random.key(0), graph)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32), params)
    return model, params


def _port_model(params):
    model = define_G(**CFG)
    model.load_state_dict(state_dict_from_jax_params(params))
    return model.eval()


def _drop_children(g):
    """Pool through segment ops, as the flagship's level 0 does (its
    clusters exceed the children-table cap)."""
    return dataclasses.replace(g, children=(None,) + g.children[1:],
                               child_counts=(None,) + g.child_counts[1:])


@pytest.mark.parametrize("pool", ["children", "segment"])
@pytest.mark.parametrize("seeds", [(3,), (4, 5)])
def test_forward_matches_jax(jax_model_params, seeds, pool):
    model, params = jax_model_params
    ref_graph = jax_build([jax_scene(seed=s, **SCENE) for s in seeds],
                          geometric=True)
    graph = build_hierarchical_graph(
        [synthetic_scene(seed=s, **SCENE) for s in seeds], geometric=True)
    assert graph.children[0] is not None
    if pool == "segment":
        graph = _drop_children(graph)
        ref_graph = ref_graph.replace(
            children=(None,) + ref_graph.children[1:],
            child_counts=(None,) + ref_graph.child_counts[1:])
    want = np.asarray(model.apply({"params": params}, ref_graph))
    with torch.inference_mode():
        got = _port_model(params)(graph).numpy()
    nv = int(graph.levels[0].num_vertices)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:nv], want[:nv], rtol=0, atol=TOL)


def test_scene_inpainter_predict_matches_jax(jax_model_params):
    model, params = jax_model_params
    want = JaxSceneInpainter(model, params).predict(jax_scene(seed=6, **SCENE))
    server = SceneInpainter(define_G(**CFG),
                            state_dict_from_jax_params(params), device="cpu")
    server.warmup([synthetic_scene(seed=7, **SCENE)])
    got = server.predict(synthetic_scene(seed=6, **SCENE))
    assert got.shape == (SCENE["num_vertices"], 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_place_drops_leaves_the_forward_does_not_read():
    model = define_G(**CFG, generator=torch.Generator().manual_seed(1))
    server = SceneInpainter(model, model.state_dict(), device="cpu")
    graph = build_hierarchical_graph([synthetic_scene(seed=3, **SCENE)],
                                     geometric=True)
    placed = server.place(graph)
    assert placed.color is None and placed.mask is None
    assert placed.labels is None
    for lv in placed.levels:
        for e in (lv.edges, *lv.dilated.values()):
            assert e.rev_dst is None and e.out_degree is None
            assert (e.src is None) == (e.dst is None) == (e.nbr is not None)
    torch.testing.assert_close(server.forward(placed), server.forward(graph),
                               rtol=0, atol=0)


def test_scene_inpainter_leaves_the_callers_model_and_settings():
    model = define_G(**CFG, generator=torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    weights = define_G(**CFG, generator=torch.Generator().manual_seed(2))
    precision = torch.get_float32_matmul_precision()
    server = SceneInpainter(model, weights.state_dict(), device="cpu")
    server.predict(synthetic_scene(seed=3, **SCENE))
    assert server.model is not model
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert torch.get_float32_matmul_precision() == precision


def test_full_f32_matmuls_restores_the_process_settings():
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with full_f32_matmuls():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)


def test_state_dict_round_trips_to_jax_params(jax_model_params):
    _, params = jax_model_params
    back, stats = convert_stinet_state_dict(_port_model(params).state_dict())
    assert stats == {}
    flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_back) == len(flat_ref)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], np.asarray(leaf))


def test_state_dict_uses_reference_keys():
    """Key layout of a reference STINet checkpoint
    (tests/test_reference_parity_psnr.py:make_reference_checkpoint)."""
    sd = define_G(**CFG).state_dict()
    ngf = CFG["ngf"]
    want = {}
    blocks = [("input_blocks.0", 10, ngf),
              ("encoder_blocks.0", ngf, 2 * ngf),
              ("encoder_blocks.1", 2 * ngf, 4 * ngf),
              ("bottleneck_blocks.0", 4 * ngf, 4 * ngf),
              ("bottleneck_blocks.1", 4 * ngf, 4 * ngf),
              ("decoder_blocks.0", 4 * ngf, 2 * ngf),
              ("decoder_blocks.1", 2 * ngf, ngf),
              ("output_blocks.0", ngf, ngf)]
    for prefix, ci, co in blocks:
        # the first conv is translation-invariant: it sees x_j - x_i only
        fan_in = ci if prefix == "input_blocks.0" else 2 * ci
        want[f"{prefix}.first_filter.nn.0.weight"] = (2 * co, fan_in)
        want[f"{prefix}.first_filter.nn.0.bias"] = (2 * co,)
        want[f"{prefix}.first_filter.nn.2.weight"] = (co, 2 * co)
        want[f"{prefix}.first_filter.nn.2.bias"] = (co,)
        if ci != co:
            want[f"{prefix}.shortcut.weight"] = (co, ci)
            want[f"{prefix}.shortcut.bias"] = (co,)
    want.update({"final_linear1.weight": (ngf, ngf), "final_linear1.bias":
                 (ngf,), "final_linear2.weight": (3, ngf),
                 "final_linear2.bias": (3,)})
    assert {k: tuple(v.shape) for k, v in sd.items()} == want


def test_init_is_drawn_from_the_generator():
    a = define_G(**CFG, generator=torch.Generator().manual_seed(1))
    b = define_G(**CFG, generator=torch.Generator().manual_seed(1))
    c = define_G(**CFG, generator=torch.Generator().manual_seed(2))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["final_linear1.weight"],
                           sc["final_linear1.weight"])
    for k, v in sa.items():
        if k.endswith(".bias"):
            assert torch.all(v == 0), k
        else:
            assert v.abs().max() <= 1.0 / np.sqrt(v.shape[1]), k


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        define_G(**CFG, dtype="float16")
    with pytest.raises(NotImplementedError):
        define_G(**{**CFG, "filter_type": "gcnconv"})
    with pytest.raises(ValueError):
        state_dict_from_jax_params({"label_embedding": {"table": 0}})
