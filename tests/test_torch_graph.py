"""The port's numpy graph builder (stinet_tpu_torch/graph/build.py) against
the JAX package's builder: every leaf of the built HierarchicalGraph must
be equal, value and dtype, and so must the synthetic scenes both packages
generate from one seed."""
import dataclasses

import numpy as np
import pytest
import torch

from stinet_tpu.graph import build as jax_build
from stinet_tpu.utils import synthetic as jax_synthetic
from stinet_tpu_torch.graph import build as port_build
from stinet_tpu_torch.graph.hierarchy import tensor_leaves
from stinet_tpu_torch.utils import synthetic as port_synthetic


def assert_same_tree(port, ref, path="graph"):
    """Walk the JAX graph's dataclass tree and the port's side by side."""
    if ref is None:
        assert port is None, path
    elif dataclasses.is_dataclass(ref):
        assert type(port).__name__ == type(ref).__name__, path
        for f in dataclasses.fields(ref):
            assert_same_tree(getattr(port, f.name), getattr(ref, f.name),
                             f"{path}.{f.name}")
    elif isinstance(ref, (tuple, list)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_same_tree(a, b, f"{path}[{i}]")
    elif isinstance(ref, dict):
        assert sorted(port) == sorted(ref), path
        for k in ref:
            assert_same_tree(port[k], ref[k], f"{path}[{k}]")
    elif isinstance(ref, (int, str)):
        assert port == ref, path
    else:
        ref = np.asarray(ref)
        assert isinstance(port, torch.Tensor), path
        got = port.numpy()
        assert got.dtype == ref.dtype, (path, got.dtype, ref.dtype)
        np.testing.assert_array_equal(got, ref, err_msg=path)


def _random_raw(mod, rng, nv=(300, 90, 30), name="r"):
    """Random (skewed-degree) connectivity: exercises spill lists and
    ragged children tables."""
    edges = [rng.integers(0, v, size=(2, 4 * v)).astype(np.int64)
             for v in nv]
    hub = np.stack([rng.integers(0, nv[0], 40), np.zeros(40, np.int64)])
    edges[0] = np.concatenate([edges[0], hub], axis=1)
    traces = [rng.integers(0, nv[l + 1], size=nv[l]).astype(np.int64)
              for l in range(len(nv) - 1)]
    dilated = {2: {2: rng.integers(0, nv[2], size=(2, 3 * nv[2]))}}
    return mod.RawHierarchy(
        x=rng.normal(size=(nv[0], 4)).astype(np.float32),
        color=rng.normal(size=(nv[0], 3)).astype(np.float32),
        mask=rng.integers(0, 3, size=(nv[0], 1)).astype(np.float32),
        num_vertices=list(nv), level_edges=edges, traces=traces,
        dilated=dilated, name=name)


def _scenes(mod, case):
    if case == "scene4096":
        return [mod.synthetic_scene(4096, levels=3, seed=0,
                                    dilation_dists=(2, 4, 8, 16))]
    if case == "batch2":
        return [mod.synthetic_scene(1500, levels=3, seed=1,
                                    dilation_dists=(2, 4)),
                mod.synthetic_scene(2100, levels=3, seed=2,
                                    dilation_dists=(2, 4))]
    raise KeyError(case)


@pytest.mark.parametrize("geometric", [False, True])
@pytest.mark.parametrize("case", ["scene4096", "batch2"])
def test_builder_matches_jax_leaf_for_leaf(case, geometric):
    ref = jax_build.build_hierarchical_graph(
        _scenes(jax_synthetic, case), geometric=geometric)
    got = port_build.build_hierarchical_graph(
        _scenes(port_synthetic, case), geometric=geometric)
    assert_same_tree(got, ref)
    assert got.num_graphs == ref.num_graphs


def test_builder_matches_jax_on_skewed_random_graph():
    ref = jax_build.build_hierarchical_graph(
        [_random_raw(jax_build, np.random.default_rng(5), name="a"),
         _random_raw(jax_build, np.random.default_rng(6), name="b")])
    got = port_build.build_hierarchical_graph(
        [_random_raw(port_build, np.random.default_rng(5), name="a"),
         _random_raw(port_build, np.random.default_rng(6), name="b")])
    assert got.levels[0].edges.spill_src is not None
    assert_same_tree(got, ref)


def test_synthetic_scene_matches_jax():
    ref = jax_synthetic.synthetic_scene(3000, levels=3, seed=7)
    got = port_synthetic.synthetic_scene(3000, levels=3, seed=7)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, list) and b and isinstance(b[0], np.ndarray):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif isinstance(b, dict):
            for lvl in b:
                for d in b[lvl]:
                    np.testing.assert_array_equal(a[lvl][d], b[lvl][d])
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("n,multiple,geometric",
                         [(1, 128, False), (129, 128, False),
                          (65537, 128, True), (300, 64, True)])
def test_bucket_size_matches_jax(n, multiple, geometric):
    assert (port_build.bucket_size(n, multiple, geometric)
            == jax_build.bucket_size(n, multiple, geometric))


def test_graph_to_device_keeps_every_leaf():
    g = port_build.build_hierarchical_graph(
        [port_synthetic.synthetic_scene(1024, levels=3, seed=0)])
    moved = g.to("cpu")
    before, after = tensor_leaves(g), tensor_leaves(moved)
    assert len(before) == len(after) > 0
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    assert moved.levels[2].dilated.keys() == g.levels[2].dilated.keys()
