"""The port's SageConv filter family (models/stinet.py `SageConvFilter`,
`make_filter`) against the JAX package's, with the JAX parameters carried
across (`state_dict_from_jax_params` for the model: lin_l with its bias,
lin_r without), on the same numpy inputs.

- The filter alone, plain and trans-inv, on a graph with one vertex that
  has no in-edge (its mean is 0 and the trans-inv filter still subtracts
  the vertex's channels 3:9, as JAX does): within 1e-5, relative and
  absolute (its outputs reach tens, and f32 holds about 7 digits).
- A small sage STINet (ngf 8, 2 bottleneck blocks, dilations [1, 2]),
  `sageconv` and `sageconvtransinv`, f32: the forward within 1e-5 of JAX's
  (the frameworks sum matmuls and norm statistics in other orders), the
  parameter gradients of a fixed linear loss, as one vector, within 1e-4
  of its L2 norm.
- The same model in bf16, whose dtype flow is JAX's (the aggregation in
  the dtype x arrives in, the degree in the compute dtype, each Dense cast
  to it): within 0.1 max and 1e-2 mean |diff|. A bf16 step is 2^-8
  relative, and the two sides part by such steps: the f32 norm statistics
  sum in other orders, so a value near a bf16 rounding boundary lands on
  the other side, and torch adds a bf16 linear's bias inside the matmul
  (one rounding) where XLA adds it after (two); the steps compound through
  the model's 14 filters and norms (measured: 0.053 max, 0.0058 mean).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stinet_tpu.graph import build as jax_build
from stinet_tpu.graph.build import build_hierarchical_graph as jax_build_graph
from stinet_tpu.models.factory import define_G as jax_define_G
from stinet_tpu.models.stinet import SageConvFilter as JaxSageConvFilter
from stinet_tpu.utils.synthetic import synthetic_scene as jax_scene
from stinet_tpu_torch.graph import build as port_build
from stinet_tpu_torch.graph.build import build_hierarchical_graph
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.models.stinet import SageConvFilter, make_filter
from stinet_tpu_torch.utils.convert import state_dict_from_jax_params
from stinet_tpu_torch.utils.synthetic import synthetic_scene

CFG = dict(input_nc=10, output_nc=3, ngf=8, norm="instance", n_blocks=2,
           n_levels=2, n_repeated_io_convs=1, pooling_type="max",
           dilations=[1, 2])
SCENE = dict(num_vertices=1200, levels=3, dilation_dists=(2,), seed=3)
TOL, GRAD_TOL = 1e-5, 1e-4
BF16_TOL, BF16_MEAN_TOL = 0.1, 1e-2
ISOLATED = 5


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.mark.parametrize("trans_inv", [False, True])
def test_sage_filter_matches_jax(trans_inv):
    rng = np.random.default_rng(0)
    v = 300
    e = rng.integers(0, v, size=(2, 4 * v))
    e = e[:, e[1] != ISOLATED].astype(np.int64)
    v_pad = port_build.bucket_size(v + 1)
    e_pad = port_build.bucket_size(e.shape[1])
    port_es = port_build._pad_edge_set(e, e_pad, v_pad - 1, v_pad)
    ref_es = jax_build._pad_edge_set(e, e_pad, v_pad - 1, v_pad)
    x = rng.normal(size=(v_pad, 10)).astype(np.float32)
    jf = JaxSageConvFilter(10, 16, trans_inv=trans_inv)
    params = jf.init(jax.random.key(0), jnp.asarray(x), ref_es)["params"]
    params = jax.tree.map(
        lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32), params)
    want = np.asarray(jf.apply({"params": params}, jnp.asarray(x), ref_es))
    pf = make_filter("sageconvtransinv" if trans_inv else "sageconv", 10,
                     16, first=True)
    assert isinstance(pf, SageConvFilter) and pf.trans_inv == trans_inv
    assert pf.lin_r.bias is None
    pf.load_state_dict({
        "lin_l.weight": t(params["lin_l"]["kernel"]).T,
        "lin_l.bias": t(params["lin_l"]["bias"]),
        "lin_r.weight": t(params["lin_r"]["kernel"]).T})
    with torch.no_grad():
        got = pf(t(x), port_es).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # no in-edge: lin_l of the (shifted) zero aggregate plus lin_r(x_i)
    agg = np.zeros(10, np.float32)
    if trans_inv:
        agg[3:9] -= x[ISOLATED, 3:9]
    alone = (agg @ np.asarray(params["lin_l"]["kernel"])
             + np.asarray(params["lin_l"]["bias"])
             + x[ISOLATED] @ np.asarray(params["lin_r"]["kernel"]))
    np.testing.assert_allclose(got[ISOLATED], alone, rtol=TOL, atol=TOL)


def test_only_the_first_conv_is_trans_inv():
    model = define_G(**CFG, filter_type="sageconvtransinv")
    firsts = [b.first_filter.trans_inv for blocks in (
        model.input_blocks, model.encoder_blocks, model.bottleneck_blocks,
        model.decoder_blocks, model.output_blocks) for b in blocks]
    assert firsts == [True] + [False] * (len(firsts) - 1)
    keys = model.state_dict().keys()
    assert "input_blocks.0.first_filter.lin_l.bias" in keys
    assert "input_blocks.0.first_filter.lin_r.bias" not in keys


@pytest.fixture(scope="module", params=["sageconv", "sageconvtransinv"])
def jax_model(request):
    """(filter type, JAX model, params from a numpy generator, JAX graph,
    port graph)."""
    model = jax_define_G(**CFG, filter_type=request.param)
    ref_graph = jax_build_graph([jax_scene(**SCENE)])
    params = model.init(jax.random.key(0), ref_graph)["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32), params)
    graph = build_hierarchical_graph([synthetic_scene(**SCENE)])
    return request.param, model, params, ref_graph, graph


def _port(filter_type, params, dtype=None):
    model = define_G(**CFG, filter_type=filter_type, dtype=dtype)
    model.load_state_dict(state_dict_from_jax_params(params))
    return model


def test_sage_model_forward_and_gradients_match_jax(jax_model):
    filter_type, model, params, ref_graph, graph = jax_model
    nv = int(graph.levels[0].num_vertices)
    w = np.random.default_rng(2).normal(
        size=(graph.x.shape[0], 3)).astype(np.float32)
    w[nv:] = 0

    def loss(p):
        return jnp.sum(model.apply({"params": p}, ref_graph) * w)

    want = np.asarray(model.apply({"params": params}, ref_graph))
    want_grads = state_dict_from_jax_params(jax.grad(loss)(params))
    port = _port(filter_type, params)
    out = port(graph)
    np.testing.assert_allclose(out.detach().numpy()[:nv], want[:nv], rtol=0,
                               atol=TOL)
    (out * t(w)).sum().backward()
    got = dict(port.named_parameters())
    assert sorted(got) == sorted(want_grads)
    diff = torch.cat([(got[k].grad - want_grads[k]).reshape(-1)
                      for k in sorted(got)])
    norm = torch.cat([want_grads[k].reshape(-1) for k in sorted(got)])
    assert float(diff.norm()) <= GRAD_TOL * float(norm.norm()), (
        float(diff.norm()), float(norm.norm()))


def test_sage_model_bf16_matches_jax(jax_model):
    filter_type, _, params, ref_graph, graph = jax_model
    model = jax_define_G(**CFG, filter_type=filter_type, dtype="bfloat16")
    want = np.asarray(model.apply({"params": params}, ref_graph)
                      ).astype(np.float32)
    with torch.no_grad():
        got = _port(filter_type, params, "bfloat16")(graph).float().numpy()
    nv = int(graph.levels[0].num_vertices)
    diff = np.abs(got[:nv] - want[:nv])
    assert diff.max() <= BF16_TOL and diff.mean() <= BF16_MEAN_TOL, (
        diff.max(), diff.mean())
