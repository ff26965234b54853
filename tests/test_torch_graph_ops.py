"""The SageConv filter's neighbour mean and the max pooling's segment max
against the JAX package's, on the same numpy inputs (a seeded graph of
V = 500 with one vertex that has no in-edge), and what the server keeps of
a graph for the models that read more than the flagship does.

- `neighbor_mean` within 1e-6, since torch's `index_add_` and XLA's
  scatter add in other orders;
- the max's gradient routed to the same row as JAX's, bit for bit;
- the flagship's served graph leaf for leaf what it was (COO lists of ELL
  edge sets, labels, colours, masks and reverse tables dropped) and its
  byte count that of those leaves; a SageConv model's server keeps the
  COO lists, a label-embedded one's the labels.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stinet_tpu.graph import build as jax_build
from stinet_tpu.ops import message_passing as jax_mp
from stinet_tpu.ops import segment as jax_segment
from stinet_tpu_torch.graph import build as port_build
from stinet_tpu_torch.graph.hierarchy import tensor_leaves
from stinet_tpu_torch.models.factory import FLAGSHIP, define_G
from stinet_tpu_torch.ops import message_passing, segment
from stinet_tpu_torch.serving import SceneInpainter, inference_graph
from stinet_tpu_torch.utils.synthetic import synthetic_scene

V = 500
ISOLATED = 7        # a vertex with no in-edge
TOL = 1e-6


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def edge_sets():
    """(port EdgeSet, JAX EdgeSet, V_pad) over the same random edges with
    a few hubs, so the builder makes ELL tables and a spill list."""
    rng = np.random.default_rng(0)
    e = rng.integers(0, V, size=(2, 5 * V))
    hubs = np.stack([rng.integers(0, V, 120), rng.integers(0, 4, 120)])
    e = np.concatenate([e, hubs], axis=1)
    e = e[:, e[1] != ISOLATED].astype(np.int64)
    v_pad = port_build.bucket_size(V + 1)
    e_pad = port_build.bucket_size(e.shape[1])
    port = port_build._pad_edge_set(e, e_pad, v_pad - 1, v_pad)
    ref = jax_build._pad_edge_set(e, e_pad, v_pad - 1, v_pad)
    assert port.nbr is not None and port.spill_src is not None
    assert float(port.degree[ISOLATED]) == 0
    return port, ref, v_pad


def _features(v_pad, h, seed):
    return np.random.default_rng(seed).normal(
        size=(v_pad, h)).astype(np.float32)


def test_neighbor_mean_matches_jax(edge_sets):
    """The SageConv filter's aggregation, against JAX's
    `neighbor_aggregate` with aggr "mean"; the ELL tables are there and
    not taken."""
    port_es, ref_es, v_pad = edge_sets
    x = _features(v_pad, 16, 1)
    want = np.asarray(jax_mp.neighbor_aggregate(
        jnp.asarray(x), ref_es.src, ref_es.dst, v_pad, aggr="mean",
        degree=jnp.asarray(ref_es.degree)))
    got = message_passing.neighbor_mean(t(x), port_es,
                                        port_es.degree).numpy()
    assert np.all(got[ISOLATED] == 0)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_segment_max_gradient_routed_as_jax(edge_sets):
    """Per-edge messages with many ties: the gradient of each (receiver,
    channel) reaches the same one message as in JAX, bit for bit."""
    port_es, ref_es, v_pad = edge_sets
    rng = np.random.default_rng(11)
    m = rng.integers(-2, 3, size=(ref_es.src.shape[0], 8)).astype(np.float32)
    g = _features(v_pad, 8, 12)
    _, vjp = jax.vjp(lambda m: jax_segment.segment_max(m, ref_es.dst, v_pad),
                     jnp.asarray(m))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    tm = t(m).requires_grad_()
    segment.segment_max(tm, port_es.dst, v_pad).backward(t(g))
    np.testing.assert_array_equal(tm.grad.numpy(), want)
    assert np.count_nonzero(want) < want.size    # ties routed to one


# --- the server keeps what the model reads ---------------------------------

SCENE = dict(num_vertices=1500, levels=3, dilation_dists=(2, 4, 8, 16))
SMALL = dict(input_nc=10, output_nc=3, ngf=8, norm="instance", n_blocks=2,
             n_levels=2, pooling_type="max", dilations=[1, 2])


def _labelled_scene(seed=0):
    scene = synthetic_scene(seed=seed, **SCENE)
    labels = np.random.default_rng(seed).integers(
        0, 5, size=scene.num_vertices[0])
    return dataclasses.replace(scene, labels=labels)


def _edge_sets_of(graph):
    return [e for lv in graph.levels for e in (lv.edges,
                                                *lv.dilated.values())]


def test_flagship_served_graph_and_bytes_unchanged():
    model = define_G(**FLAGSHIP)
    assert not model.reads_coo and not model.reads_labels
    server = SceneInpainter(model, model.state_dict(), device="cpu")
    graph = server.build(_labelled_scene())
    served = server._inference_graph(graph)
    # what the server has always sent: every leaf but these
    dropped = [graph.color, graph.mask, graph.labels]
    for e in _edge_sets_of(graph):
        dropped += [e.rev_dst, e.out_degree]
        if e.nbr is not None:
            dropped += [e.src, e.dst]
    dropped_ids = {id(x) for x in dropped if x is not None}
    kept = [x for x in tensor_leaves(graph) if id(x) not in dropped_ids]
    assert [id(x) for x in tensor_leaves(served)] == [id(x) for x in kept]
    assert (sum(x.nbytes for x in tensor_leaves(served))
            == sum(x.nbytes for x in kept))
    assert served.labels is None and served.color is None
    assert all(e.src is None for e in _edge_sets_of(served)
               if e.nbr is not None)
    assert any(e.nbr is not None for e in _edge_sets_of(served))
    torch.testing.assert_close(
        tensor_leaves(served), tensor_leaves(inference_graph(graph)),
        rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["sageconv", "sageconvtransinv",
                                  "labels"])
def test_server_keeps_what_the_model_reads(kind):
    args = dict(SMALL, filter_type="edgeconvtransinv")
    if kind.startswith("sage"):
        args["filter_type"] = kind
    else:
        args.update(use_label_embedding=True, num_classes=5,
                    num_embedding=4)
    model = define_G(**args, generator=torch.Generator().manual_seed(0))
    assert model.reads_coo == (kind != "labels")
    assert model.reads_labels == (kind == "labels")
    server = SceneInpainter(model, model.state_dict(), device="cpu")
    scene = _labelled_scene(1)
    graph = server.build(scene)
    served = server.place(graph)
    for e in _edge_sets_of(served):
        assert (e.src is None) == (e.nbr is not None and kind == "labels")
        assert e.rev_dst is None and e.out_degree is None
    assert (served.labels is None) == (kind != "labels")
    got = server.predict(scene)
    with torch.inference_mode():
        want = server.model(graph)[:scene.num_vertices[0]].numpy()
    np.testing.assert_array_equal(got, want)
