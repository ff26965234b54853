"""The port's label embedding (models/stinet.py, `use_label_embedding`)
against the JAX package's, the counterpart of tests/test_label_embedding.py
on its graph and model (V = 512 with a quarter of the labels 0; ngf 8, 2
bottleneck blocks, 2 repeated io convs, 5 classes, 4 dims), the JAX
parameters carried across by `state_dict_from_jax_params`
(`label_embedding/embedding` -> `label_embedding.weight`, untransposed).

- The forward within 1e-5 of JAX's (the frameworks sum matmuls and norm
  statistics in other orders), and the parameter gradients of a fixed
  linear loss, as one vector, within 1e-4 of its L2 norm;
- padding: label 0 embeds to zeros whatever row 0 of the table holds
  (row 0 set to 123 leaves the outputs bit for bit as they were), and row
  0 gets a gradient of exactly 0 while the other rows' are not;
- the concat comes after the input blocks, so encoder block 0 is
  `num_embedding` wider; a graph without labels raises;
- in bf16, from JAX's initial parameters, bit for bit with JAX's bf16
  model; from random ones within 0.1 max and 2e-2 mean |diff|, for the
  reasons tests/test_torch_sage.py gives.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stinet_tpu.graph.build import build_hierarchical_graph as jax_build
from stinet_tpu.models.factory import define_G as jax_define_G
from stinet_tpu.utils.synthetic import synthetic_scene as jax_scene
from stinet_tpu_torch.graph.build import build_hierarchical_graph
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.utils.convert import state_dict_from_jax_params
from stinet_tpu_torch.utils.synthetic import synthetic_scene

CFG = dict(input_nc=10, output_nc=3, ngf=8, n_blocks=2, dilations=[1, 2],
           norm="instance", pooling_type="max", n_levels=2,
           n_repeated_io_convs=2, filter_type="edgeconvtransinv",
           use_label_embedding=True, num_classes=5, num_embedding=4)
TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _labelled(mod_scene, v=512, num_classes=5, seed=0):
    scene = mod_scene(num_vertices=v, levels=3, seed=seed,
                      dilation_dists=(2,))
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=v).astype(np.int64)
    labels[: v // 4] = 0    # a padding-label region
    return dataclasses.replace(scene, labels=labels)


@pytest.fixture(scope="module")
def case():
    """(JAX model, its params from a numpy generator, JAX graph, port
    graph, the port model with those params)."""
    model = jax_define_G(**CFG)
    ref_graph = jax_build([_labelled(jax_scene)])
    params = model.init(jax.random.key(0), ref_graph)["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32), params)
    graph = build_hierarchical_graph([_labelled(synthetic_scene)])
    assert graph.labels is not None
    port = define_G(**CFG)
    port.load_state_dict(state_dict_from_jax_params(params))
    return model, params, ref_graph, graph, port


def test_forward_and_gradients_match_jax(case):
    model, params, ref_graph, graph, port = case
    nv = int(graph.levels[0].num_vertices)
    w = np.random.default_rng(2).normal(
        size=(graph.x.shape[0], 3)).astype(np.float32)
    w[nv:] = 0
    want = np.asarray(model.apply({"params": params}, ref_graph))
    want_grads = state_dict_from_jax_params(jax.grad(
        lambda p: jnp.sum(model.apply({"params": p}, ref_graph) * w))(params))
    port.zero_grad(set_to_none=True)
    out = port(graph)
    np.testing.assert_allclose(out.detach().numpy()[:nv], want[:nv], rtol=0,
                               atol=TOL)
    (out * torch.from_numpy(w)).sum().backward()
    got = dict(port.named_parameters())
    assert sorted(got) == sorted(want_grads)
    diff = torch.cat([(got[k].grad - want_grads[k]).reshape(-1)
                      for k in sorted(got)])
    norm = torch.cat([want_grads[k].reshape(-1) for k in sorted(got)])
    assert float(diff.norm()) <= GRAD_TOL * float(norm.norm())


def test_padding_row_embeds_to_zeros_and_gets_no_gradient(case):
    _, _, _, graph, port = case
    with torch.no_grad():
        out = port(graph)
        table = port.label_embedding.weight
        saved = table[0].clone()
        table[0] = 123.0
        try:
            out2 = port(graph)
        finally:
            table[0] = saved
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    port.zero_grad(set_to_none=True)
    (port(graph) ** 2).sum().backward()
    grad = port.label_embedding.weight.grad
    assert torch.all(grad[0] == 0)
    assert grad[1:].abs().max() > 0


def test_encoder_block_0_is_widened_and_labels_are_read(case):
    _, params, _, graph, port = case
    assert port.reads_labels
    assert tuple(port.label_embedding.weight.shape) == (5, 4)
    assert params["label_embedding"]["embedding"].shape == (5, 4)
    # the first conv is trans-inv (fan-in C); encoder block 0 sees
    # [x_i, x_j - x_i] of ngf + num_embedding channels
    assert port.input_blocks[0].first_filter.nn[0].weight.shape[1] == 10
    assert port.encoder_blocks[0].first_filter.nn[0].weight.shape[1] == \
        2 * (8 + 4)
    with pytest.raises(ValueError, match="labels"):
        port(dataclasses.replace(graph, labels=None))
    with torch.no_grad():
        other = port(dataclasses.replace(graph,
                                         labels=(graph.labels % 4) + 1))
        assert (other - port(graph)).abs().max() > 0


def test_flag_off_has_no_embedding(case):
    model = define_G(**dict(CFG, use_label_embedding=False))
    assert not model.reads_labels
    assert not any(k.startswith("label_embedding")
                   for k in model.state_dict())


@pytest.mark.parametrize("weights", ["init", "random"])
def test_bf16_matches_jax(case, weights):
    """The lookup in the compute dtype, cast to the features' before the
    concat. From JAX's own initial parameters (zero biases) with a random
    table, bit for bit; from the random parameters, bounded as
    tests/test_torch_sage.py bounds a bf16 model and for its reasons
    (measured: 0.049 max, 0.0104 mean)."""
    model, params, ref_graph, graph, _ = case
    if weights == "init":
        params = model.init(jax.random.key(0), ref_graph)["params"]
        params["label_embedding"]["embedding"] = np.random.default_rng(
            3).normal(size=(5, 4)).astype(np.float32)
    bf16 = jax_define_G(**CFG, dtype="bfloat16")
    want = np.asarray(bf16.apply({"params": params}, ref_graph)
                      ).astype(np.float32)
    port = define_G(**CFG, dtype="bfloat16")
    port.load_state_dict(state_dict_from_jax_params(params))
    with torch.no_grad():
        out = port(graph)
    assert out.dtype == torch.bfloat16
    nv = int(graph.levels[0].num_vertices)
    got = out.float().numpy()[:nv]
    if weights == "init":
        np.testing.assert_array_equal(got, want[:nv])
        return
    diff = np.abs(got - want[:nv])
    assert diff.max() <= 0.1 and diff.mean() <= 2e-2, (diff.max(),
                                                       diff.mean())
