"""Batched graphs in the port against the JAX package, on the CPU: the
multi-graph instance norm of the concatenated layout, and the stacked-batch
helpers of graph/build.py.

Tolerances:
- multi-graph instance norm, forward and gradient: 1e-5 (the port sums a
  graph's rows through a one-hot product in torch's order, JAX in XLA's);
- table widths, padded tables and stacked graphs: every leaf equal, value
  and dtype (the windowed builds with the JAX native RCM off, as in
  tests/test_torch_windowed.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_graph import assert_same_tree
from test_torch_windowed import scipy_rcm  # noqa: F401 (a fixture)

from stinet_tpu.graph import build as jax_build
from stinet_tpu.ops import norms as jax_norms
from stinet_tpu.utils import synthetic as jax_synthetic
from stinet_tpu_torch.graph import build as port_build
from stinet_tpu_torch.graph.hierarchy import (
    scene_of, tensor_leaves, tree_structure)
from stinet_tpu_torch.ops import norms
from stinet_tpu_torch.utils import synthetic as port_synthetic


def _batched_rows(sizes, v):
    """graph_id of graphs with `sizes` valid rows, laid out in order, pad
    rows = len(sizes); and the valid count."""
    gid = np.full(v, len(sizes), np.int32)
    off = 0
    for g, n in enumerate(sizes):
        gid[off:off + n] = g
        off += n
    return gid, off


@pytest.mark.parametrize("sizes,v,c", [
    ((300, 1), 512, 8),                   # a graph with one valid row
    ((100, 250, 37), 512, 16),
    ((1, 60, 200, 7, 90), 384, 4)])
def test_multigraph_instance_norm_matches_jax(sizes, v, c):
    rng = np.random.default_rng(v + c + len(sizes))
    gid, nv = _batched_rows(sizes, v)
    x = (rng.normal(size=(v, c)) * 2
         + rng.normal(size=(len(sizes) + 1, c))[gid]).astype(np.float32)
    g = rng.normal(size=(v, c)).astype(np.float32)
    vmask = (np.arange(v) < nv).astype(np.float32)

    def jax_norm(x):
        return jax_norms.masked_instance_norm(
            x, jnp.asarray(gid), len(sizes), jnp.asarray(vmask))

    want = np.asarray(jax_norm(jnp.asarray(x)))
    want_grad = np.asarray(jax.grad(
        lambda x: jnp.sum(jax_norm(x) * g))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = norms.masked_instance_norm(xt, torch.from_numpy(gid), len(sizes),
                                     nv)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=0, atol=1e-5)
    assert np.all(got.detach().numpy()[nv:] == 0)


SCENE = dict(levels=3, dilation_dists=(2, 4))


def _scenes(sizes, seeds, dists=None):
    """The same synthetic scenes from each package's generator."""
    out = []
    for mod in (jax_synthetic, port_synthetic):
        out.append([mod.synthetic_scene(
            num_vertices=n, seed=s, **dict(SCENE, **(
                {} if d is None else {"dilation_dists": d})))
            for n, s, d in zip(sizes, seeds, dists or [None] * len(sizes))])
    return out


@pytest.mark.parametrize("windowed", [False, True])
def test_table_widths_and_padding_match_jax(scipy_rcm, windowed):
    (ja, jb), (pa, pb) = _scenes((1500, 1500), (0, 1))
    kw = dict(geometric=True, windowed=windowed)
    ref = [jax_build.build_hierarchical_graph([s], **kw) for s in (ja, jb)]
    got = [port_build.build_hierarchical_graph([s], **kw) for s in (pa, pb)]
    widths = [port_build.table_widths(g) for g in got]
    assert widths == [jax_build.table_widths(g) for g in ref]
    merged = port_build.merge_widths(widths)
    assert merged == jax_build.merge_widths(
        [jax_build.table_widths(g) for g in ref])
    # grow every width (and halo) by a margin, so every field pads
    grown = {k: v + 32 for k, v in merged.items()}
    for g, r in zip(got, ref):
        padded = port_build.pad_tables_to_widths(g, grown)
        assert_same_tree(padded, jax_build.pad_tables_to_widths(r, grown))
        assert port_build.table_widths(padded) == {
            k: grown[k] for k in port_build.table_widths(g)}


@pytest.mark.parametrize("windowed", [False, True])
def test_build_stacked_graph_matches_jax(scipy_rcm, windowed):
    """Three scenes of one bucket, of two sizes: the stacked graph, leaf
    for leaf, and the widths."""
    _stacked_graph_matches_jax(windowed)


def test_native_windowed_stacked_graph_matches_jax_native():
    """The same, windowed, with both native builders (one C++ RCM)."""
    assert port_build._native.available() and jax_build._native.available()
    _stacked_graph_matches_jax(True)


def _stacked_graph_matches_jax(windowed):
    ref_scenes, scenes = _scenes((1500, 1400, 1500), (0, 1, 2))
    kw = dict(geometric=True, windowed=windowed)
    ref, ref_w = jax_build.build_stacked_graph(ref_scenes, **kw)
    got, got_w = port_build.build_stacked_graph(scenes, **kw)
    assert got_w == ref_w
    assert_same_tree(got, ref)
    assert got.x.shape[0] == 3 and got.levels[0].num_vertices.shape == (3,)
    # scene i of the stack is scene i built alone at the batch's buckets,
    # padded to its widths
    v_buckets = [lv.graph_id.shape[1] for lv in got.levels]
    for i, s in enumerate(scenes):
        alone = port_build.pad_tables_to_widths(
            port_build.build_hierarchical_graph([s], v_buckets=v_buckets,
                                                **kw), got_w)
        assert tree_structure(alone) == tree_structure(scene_of(got, i))
        for a, b in zip(tensor_leaves(alone),
                        tensor_leaves(scene_of(got, i))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("native", [False, True])
def test_build_stacked_graph_passes_its_build_arguments_as_jax_does(
        monkeypatch, native):
    """Non-default `pad_multiple`, `ell_cap_quantile` and
    `window_quantile` reach every scene's build: the stacked graph and its
    widths equal the JAX package's, leaf for leaf, with both native
    builders off (scipy's RCM) and with both on."""
    if native:
        assert (port_build._native.available()
                and jax_build._native.available())
    else:
        monkeypatch.setattr(jax_build._native, "available", lambda: False)
        monkeypatch.setattr(port_build._native, "available", lambda: False)
    ref_scenes, scenes = _scenes((1500, 1400, 1500), (0, 1, 2))
    kw = dict(pad_multiple=256, geometric=True, ell_cap_quantile=0.8,
              windowed=True, window_quantile=0.99)
    ref, ref_w = jax_build.build_stacked_graph(ref_scenes, **kw)
    got, got_w = port_build.build_stacked_graph(scenes, **kw)
    assert got_w == ref_w
    assert_same_tree(got, ref)
    # the arguments changed the build: the default one differs
    default, _ = port_build.build_stacked_graph(
        scenes, geometric=True, windowed=True)
    assert tree_structure(default) != tree_structure(got) or any(
        a.shape != b.shape or not torch.equal(a, b) for a, b in zip(
            tensor_leaves(default), tensor_leaves(got)))


def test_build_stacked_graph_with_one_worker_builds_in_sequence(
        monkeypatch):
    """STINET_BUILD_WORKERS=1 builds the scenes (and their edge sets) with
    no thread pool, and the result equals the pooled build's."""
    _, scenes = _scenes((1500, 1400, 1500), (0, 1, 2))
    pooled, pooled_w = port_build.build_stacked_graph(scenes, geometric=True)

    def no_pool(*a, **k):
        raise AssertionError("a thread pool was started")

    monkeypatch.setenv("STINET_BUILD_WORKERS", "1")
    monkeypatch.setattr(port_build, "ThreadPoolExecutor", no_pool)
    got, got_w = port_build.build_stacked_graph(scenes, geometric=True)
    assert got_w == pooled_w
    assert tree_structure(got) == tree_structure(pooled)
    for a, b in zip(tensor_leaves(got), tensor_leaves(pooled)):
        assert torch.equal(a, b)


def test_build_stacked_graph_refuses_an_emptied_dilated_set_as_jax_does():
    """A scene without a dilation distance the others have gets an empty
    edge set for it, with no ELL table where theirs have one: the layouts
    differ, and both packages raise."""
    ref_scenes, scenes = _scenes((1500, 1500), (0, 1), [None, (2,)])
    with pytest.raises(ValueError):
        jax_build.build_stacked_graph(ref_scenes, geometric=True)
    with pytest.raises(ValueError):
        port_build.build_stacked_graph(scenes, geometric=True)


def test_stack_graphs_raises_on_a_mismatch_as_jax_does():
    (ja, jb), (pa, pb) = _scenes((1500, 4000), (0, 1))
    ref = [jax_build.build_hierarchical_graph([s], geometric=True)
           for s in (ja, jb)]
    got = [port_build.build_hierarchical_graph([s], geometric=True)
           for s in (pa, pb)]
    with pytest.raises(ValueError):
        jax_build.stack_graphs(ref)
    with pytest.raises(ValueError):        # different buckets
        port_build.stack_graphs(got)
    lv0 = got[0].levels[0]
    halo_b = dataclasses.replace(got[0], levels=(dataclasses.replace(
        lv0, edges=dataclasses.replace(lv0.edges, halo=64)),
        *got[0].levels[1:]))
    with pytest.raises(ValueError):        # a different structure
        port_build.stack_graphs([got[0], halo_b])
