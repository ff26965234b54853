"""The port's native host graph builder (stinet_tpu_torch/graph/native)
against its numpy path and against the JAX package's native builder, on the
CPU. Every comparison is exact: each table equal leaf for leaf, value,
dtype and shape (the C++ source is the JAX package's, a bit-for-bit twin of
the numpy bodies)."""
import ctypes

import numpy as np
import pytest
import torch
from test_torch_graph import assert_same_tree

from stinet_tpu.graph import build as jax_build
from stinet_tpu.graph import native as jax_native
from stinet_tpu.utils import synthetic as jax_synthetic
from stinet_tpu_torch.graph import build as B
from stinet_tpu_torch.graph import native
from stinet_tpu_torch.utils.synthetic import synthetic_scene

EDGE_FIELDS = ("src", "dst", "num_edges", "degree", "nbr", "rev_dst",
               "out_degree", "ell_degree", "spill_src", "spill_dst")


@pytest.fixture
def numpy_path(monkeypatch):
    """Runs a callable with STINET_NATIVE_BUILD=0, and checks that the
    native library was not called."""
    def run(fn, *args, **kw):
        monkeypatch.setenv("STINET_NATIVE_BUILD", "0")
        before = dict(native.calls)
        try:
            return fn(*args, **kw)
        finally:
            monkeypatch.delenv("STINET_NATIVE_BUILD")
            assert native.calls == before
    return run


def assert_edge_sets_equal(a, b):
    assert a.halo == b.halo
    for f in EDGE_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            assert va.dtype == vb.dtype and va.shape == vb.shape, f
            assert torch.equal(va, vb), f


def _edge_cases():
    """tests/test_native_build.py's cases, and a mesh with one hub that
    receives 300 edges, past the slot cap: a spill list."""
    rng = np.random.default_rng(0)
    mesh = synthetic_scene(4096, seed=1).level_edges[0]
    hubs = np.concatenate(
        [np.stack([rng.integers(0, 512, 3000), np.full(3000, 7)]),
         rng.integers(0, 512, (2, 4000)),
         np.stack([np.full(900, 3), rng.integers(0, 512, 900)])], axis=1)
    return [
        ("mesh", mesh, B.bucket_size(mesh.shape[1]), None),
        ("mesh_windowed", mesh, B.bucket_size(mesh.shape[1]), 64),
        ("hubs", hubs, B.bucket_size(hubs.shape[1]), None),
        ("hub_spill", np.concatenate(
            [mesh, np.stack([rng.integers(0, 4096, 300), np.full(300, 7)])],
            axis=1), B.bucket_size(mesh.shape[1] + 300), None),
        ("tiny", np.array([[0, 1, 2, 2], [1, 2, 0, 0]]), 128, None),
        ("ring", np.stack([np.arange(1000), (np.arange(1000) + 1) % 1000]),
         1024, None),
        ("far_windowed",
         np.stack([np.arange(500), (np.arange(500) + 250) % 500]), 512, 8),
    ]


def _fuzz_case(seed):
    rng = np.random.default_rng(seed)
    nv = int(rng.integers(50, 2000))
    ne = int(rng.integers(1, 6000))
    style = seed % 3
    if style == 0:        # uniform random
        e = rng.integers(0, nv, (2, ne))
    elif style == 1:      # hub-heavy receivers
        e = np.stack([rng.integers(0, nv, ne),
                      rng.integers(0, max(nv // 50, 1), ne)])
    else:                 # banded
        src = rng.integers(0, nv, ne)
        e = np.stack([src, np.clip(src + rng.integers(-40, 40, ne),
                                   0, nv - 1)])
    halo = [None, 16, 64][int(rng.integers(0, 3))]
    q = float(rng.uniform(0.5, 1.0))
    return e, B.bucket_size(nv + 1, 128), B.bucket_size(ne, 128), halo, q


def _cases():
    out = [(name, edges, B.bucket_size(int(edges.max()) + 2, 128), e_pad,
            halo, 0.97) for name, edges, e_pad, halo in _edge_cases()]
    return out + [(f"fuzz{s}",) + _fuzz_case(s) for s in range(6)]


@pytest.mark.parametrize("name,edges,v_pad,e_pad,halo,q", _cases(),
                         ids=[c[0] for c in _cases()])
def test_edge_set_tables_equal_numpy(numpy_path, name, edges, v_pad, e_pad,
                                     halo, q):
    args = (edges, e_pad, v_pad - 1, v_pad)
    kw = dict(cap_quantile=q, window_halo=halo)
    want = numpy_path(B._pad_edge_set, *args, **kw)
    native.reset_calls()
    got = B._pad_edge_set(*args, **kw)
    assert native.calls == {"edge_set_build": 1}
    assert_edge_sets_equal(got, want)
    if name == "hub_spill":
        assert got.spill_src is not None and got.nbr is not None
    if name == "far_windowed":
        assert got.nbr is None


def test_children_tables_equal_numpy(numpy_path):
    rng = np.random.default_rng(3)
    coarse_pad = 256
    trace = np.concatenate([rng.integers(0, 200, 2000),
                            np.full(48, coarse_pad - 1)]).astype(np.int32)
    want = numpy_path(B._build_children, trace, 2000, coarse_pad, 999)
    got = B._build_children(trace, 2000, coarse_pad, 999)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_children_overflow_gives_none(numpy_path):
    trace = np.zeros(300, np.int32)   # one cluster of 300 > max_children
    assert B._build_children(trace, 300, 64, 63) == (None, None)
    assert numpy_path(B._build_children, trace, 300, 64, 63) == (None, None)


def test_out_of_range_ids_raise():
    bad = np.array([[0, 5000], [1, 2]])   # src 5000 >= v_pad
    with pytest.raises(ValueError, match="out of range"):
        B._pad_edge_set(bad, 128, 127, 128)
    with pytest.raises(ValueError, match="out of range"):
        native.rcm_order(bad, 128)
    with pytest.raises(ValueError, match="out of range"):
        native.Adjacency(bad, 128)
    with pytest.raises(ValueError, match="out of range"):
        native.build_children_table(np.array([0, 1, 300], np.int32), 3, 256,
                                    255)
    with pytest.raises(ValueError, match="out of range"):
        native.edges_from_faces(np.array([[0, 1, 99]]), 10)


def _jax_scenes(nscenes):
    return [jax_synthetic.synthetic_scene(2500, levels=3, seed=s,
                                          dilation_dists=(2, 4))
            for s in range(nscenes)]


@pytest.mark.parametrize("nscenes", [1, 2])
def test_full_build_equals_numpy_and_jax_native(numpy_path, nscenes):
    assert jax_native.available()
    ref = jax_build.build_hierarchical_graph(_jax_scenes(nscenes))
    scenes = [synthetic_scene(2500, levels=3, seed=s, dilation_dists=(2, 4))
              for s in range(nscenes)]
    native.reset_calls()
    got = B.build_hierarchical_graph(scenes)
    assert native.calls == {
        "edge_set_build": sum(1 + len(lev.dilated) for lev in got.levels),
        "build_children": len(got.children)}
    assert_same_tree(got, ref)
    assert_same_tree(got, numpy_path(B.build_hierarchical_graph, scenes))


def test_failed_compile_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message, at the
    first build, instead of falling back to numpy."""
    bad = tmp_path / "graph_builder.cpp"
    bad.write_text(native.SRC.read_text() + "\nint broken( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g[+][+] failed.*error"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="g[+][+] failed"):
        B._pad_edge_set(np.array([[0, 1], [1, 0]]), 128, 127, 128)
    assert not list((tmp_path / "build").glob("*"))   # no half library


def test_library_is_cdll_and_releases_the_lock():
    lib = native.get_lib()
    assert isinstance(lib, ctypes.CDLL)
    assert not isinstance(lib, ctypes.PyDLL)
    assert not lib._func_flags_ & ctypes._FUNCFLAG_PYTHONAPI
    assert native.lib_path().exists()


def test_rcm_order_equals_jax_native():
    scene = synthetic_scene(4096, seed=2)
    for l, nv in enumerate(scene.num_vertices):
        e = scene.level_edges[l]
        got = native.rcm_order(e, nv)
        np.testing.assert_array_equal(got, jax_native.rcm_order(e, nv))
        assert np.array_equal(np.sort(got), np.arange(nv))


def test_edges_from_faces_equals_jax_native():
    rng = np.random.default_rng(7)
    for nf, nv in ((500, 300), (4000, 2100)):
        faces = rng.integers(0, nv, (nf, 3))
        faces[::17, 1] = faces[::17, 0]    # degenerate faces
        got = native.edges_from_faces(faces, nv)
        want = jax_native.edges_from_faces(faces, nv)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_adjacency_disk_updates_equal_jax_native():
    scene = synthetic_scene(3000, seed=5)
    e, nv = scene.level_edges[0], scene.num_vertices[0]
    got, want = native.Adjacency(e, nv), jax_native.Adjacency(e, nv)
    m_got, m_want = np.zeros(nv, np.float32), np.zeros(nv, np.float32)
    rng = np.random.default_rng(0)
    for seed, radius in zip(rng.integers(0, nv, 20), rng.integers(1, 9, 20)):
        assert (got.disk_update(int(seed), int(radius), m_got)
                == want.disk_update(int(seed), int(radius), m_want))
    np.testing.assert_array_equal(m_got, m_want)
    assert (m_got > 0).any()
    with pytest.raises(ValueError, match="float32"):
        got.disk_update(0, 2, np.zeros(nv))


def test_source_is_the_jax_packages_unchanged():
    assert native.SRC.read_bytes() == (
        native.SRC.parents[3] / "stinet_tpu" / "graph" / "native"
        / "graph_builder.cpp").read_bytes()


@pytest.mark.parametrize("windowed", [False, True])
def test_thread_pool_gives_the_sequential_graph(monkeypatch, windowed):
    """STINET_BUILD_WORKERS=6 fans the edge sets out to 6 threads; the
    graph is the one 1 thread builds, leaf for leaf."""
    scenes = [synthetic_scene(2500, levels=3, seed=s, dilation_dists=(2, 4))
              for s in range(2)]
    graphs = []
    for workers in (1, 6):
        monkeypatch.setenv("STINET_BUILD_WORKERS", str(workers))
        graphs.append(B.build_hierarchical_graph(scenes, windowed=windowed))
    assert_same_tree(*graphs)
