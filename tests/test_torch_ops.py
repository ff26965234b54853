"""The port's ops (stinet_tpu_torch/ops) against the JAX package's on the
same numpy inputs. These run the plain versions, which a CPU tensor
dispatches to; the CUDA kernels are held against the same plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py). The JAX Pallas
kernels run in interpret mode, as the JAX package's own tests run them."""
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stinet_tpu.graph import build as jax_build
from stinet_tpu.ops import ell as jax_ell
from stinet_tpu.ops import message_passing as jax_mp
from stinet_tpu.ops import norms as jax_norms
from stinet_tpu.ops import segment as jax_segment
from stinet_tpu.ops.pallas import instance_norm as jax_pin
from stinet_tpu.ops.pallas.gather_pipeline import pallas_ell_edge_conv_sum
from stinet_tpu.ops.pallas.onehot_gather import (
    pallas_windowed_edge_conv_sum_f32)
from stinet_tpu_torch.graph import build as port_build
from stinet_tpu_torch.ops import ell, message_passing, norms, segment


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ell_inputs(rng, v, h, d, q_scale=None):
    p = rng.normal(size=(v, h)).astype(np.float32)
    q = rng.normal(size=(v, h)).astype(np.float32)
    if q_scale is not None:
        q = (q * q_scale).astype(np.float32)
    nbr = rng.integers(0, v, size=(v, d)).astype(np.int32)
    deg = rng.integers(0, d + 1, size=v).astype(np.float32)
    return p, q, nbr, deg


@pytest.mark.parametrize("v,h,d", [(300, 16, 6), (257, 32, 12),
                                   (128, 64, 1), (100, 20, 64)])
def test_ell_sum_bit_identical_to_jax(v, h, d):
    rng = np.random.default_rng(v + h + d)
    # operands spread over many binades so a reordered sum would show
    p, q, nbr, deg = _ell_inputs(
        rng, v, h, d, q_scale=10.0 ** rng.integers(-3, 4, size=(v, 1)))
    want = np.asarray(jax_ell._forward(jnp.asarray(p), jnp.asarray(q),
                                       jnp.asarray(nbr), jnp.asarray(deg)))
    got = ell.ell_edge_conv_sum(t(p), t(q), t(nbr), t(deg)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_ell_sum_matches_pallas_gather_kernel():
    rng = np.random.default_rng(11)
    p, q, nbr, deg = _ell_inputs(rng, 256, 128, 5)
    want = np.asarray(pallas_ell_edge_conv_sum(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(nbr), jnp.asarray(deg),
        tile=128, interpret=True))
    got = ell.ell_edge_conv_sum(t(p), t(q), t(nbr), t(deg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_ell_sum_bit_identical_to_windowed_f32_kernel():
    """Banded tables at H=128, as tests/test_onehot_gather.py builds them:
    the exact-f32 windowed kernel promises bit-identity with ops/ell.py."""
    v, h, d, halo = 512, 128, 6, 64
    rng = np.random.default_rng(2)
    base = np.arange(v)
    nbr = np.clip(base[:, None] + rng.integers(-halo, halo + 1, size=(v, d)),
                  0, v - 1).astype(np.int32)
    deg = rng.integers(0, d + 1, size=v).astype(np.float32)
    p = rng.normal(size=(v, h)).astype(np.float32)
    q = (rng.normal(size=(v, h))
         * (10.0 ** rng.integers(-3, 4, size=(v, 1)))).astype(np.float32)
    want = np.asarray(pallas_windowed_edge_conv_sum_f32(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(nbr), jnp.asarray(deg),
        halo, tile=128, interpret=True))
    got = ell.ell_edge_conv_sum(t(p), t(q), t(nbr), t(deg)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _edge_sets(kind, rng, v=400):
    """(port EdgeSet, JAX EdgeSet) over the same edges. "spill": a few
    high-degree receivers overflow the p97 slot cap into the COO spill
    list; "coo": hub-dominated edges make the builder drop ELL."""
    if kind == "spill":
        e = rng.integers(0, v, size=(2, 5 * v))
        hubs = np.stack([rng.integers(0, v, 120), rng.integers(0, 4, 120)])
        e = np.concatenate([e, hubs], axis=1)
    else:
        e = np.stack([rng.integers(0, v, 6 * v), rng.integers(0, 3, 6 * v)])
    e = e.astype(np.int64)
    v_pad = port_build.bucket_size(v + 1)
    e_pad = port_build.bucket_size(e.shape[1])
    port = port_build._pad_edge_set(e, e_pad, v_pad - 1, v_pad)
    ref = jax_build._pad_edge_set(e, e_pad, v_pad - 1, v_pad)
    return port, ref, v_pad


@pytest.mark.parametrize("kind", ["spill", "coo"])
def test_edge_conv_aggregate_matches_jax(kind):
    rng = np.random.default_rng(3)
    port_es, ref_es, v_pad = _edge_sets(kind, rng)
    if kind == "spill":
        assert port_es.nbr is not None and port_es.spill_src is not None
    else:
        assert port_es.nbr is None
    h = 32
    p = rng.normal(size=(v_pad, h)).astype(np.float32)
    q = rng.normal(size=(v_pad, h)).astype(np.float32)
    want = np.asarray(jax_mp.edge_conv_aggregate(
        jnp.asarray(p), jnp.asarray(q), ref_es.src, ref_es.dst,
        num_segments=v_pad, degree=jnp.asarray(ref_es.degree),
        nbr=ref_es.nbr, rev_dst=ref_es.rev_dst,
        out_degree=ref_es.out_degree, ell_degree=ref_es.ell_degree,
        spill_src=ref_es.spill_src, spill_dst=ref_es.spill_dst))
    got = message_passing.edge_conv_aggregate(t(p), t(q), port_es).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jax_pin.pl, "pallas_call", interp)


def _mask(v, valid):
    return (np.arange(v) < valid).astype(np.float32)


@pytest.mark.parametrize("v,c,valid", [(1024, 32, 900), (512, 64, 512),
                                       (512, 16, 1)])
def test_instance_norm_matches_jax(v, c, valid, interpret_pallas):
    rng = np.random.default_rng(v + c + valid)
    x = (rng.normal(size=(v, c)) * 2 + 0.5).astype(np.float32)
    gid = np.where(np.arange(v) < valid, 0, 1).astype(np.int32)
    got = norms.masked_instance_norm(
        t(x), t(gid), 1, torch.tensor(valid, dtype=torch.int32)).numpy()
    want = np.asarray(jax_norms.masked_instance_norm(
        jnp.asarray(x), jnp.asarray(gid), 1, jnp.asarray(_mask(v, valid))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.all(got[valid:] == 0.0)
    pallas = np.asarray(jax_pin.pallas_instance_norm(
        jnp.asarray(x), jnp.int32(valid)))
    np.testing.assert_allclose(got[:valid], pallas[:valid],
                               rtol=1e-4, atol=1e-5)


def test_instance_norm_two_graphs_matches_jax():
    rng = np.random.default_rng(4)
    v, c, sizes = 640, 24, (300, 211)
    valid = sum(sizes)
    x = rng.normal(size=(v, c)).astype(np.float32)
    gid = np.full(v, 2, np.int32)
    gid[:sizes[0]], gid[sizes[0]:valid] = 0, 1
    got = norms.masked_instance_norm(t(x), t(gid), 2, valid).numpy()
    want = np.asarray(jax_norms.masked_instance_norm(
        jnp.asarray(x), jnp.asarray(gid), 2, jnp.asarray(_mask(v, valid))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.all(got[valid:] == 0.0)


def _graph_rows(sizes, v):
    """graph_id of graphs with `sizes` valid rows laid out in order (pad
    rows = len(sizes)) and the valid count."""
    gid = np.full(v, len(sizes), np.int32)
    off = 0
    for g, n in enumerate(sizes):
        gid[off:off + n] = g
        off += n
    return gid, off


# (sizes of the graphs, V, C, mean, spread, chunk or None for the kernel's)
_CHUNKED_CASES = {
    "c3": ((1000,), 1000, 3, 0.5, 2.0, None),
    "c32-ragged-v": ((900,), 1000, 32, 0.5, 2.0, None),
    "c64": ((1000,), 1000, 64, 0.5, 2.0, None),
    "c100": ((777,), 1000, 100, 0.5, 2.0, None),
    "valid-0": ((0,), 300, 32, 0.5, 2.0, None),
    "valid-1": ((1,), 300, 32, 0.5, 2.0, None),
    "chunk-64": ((1000,), 1000, 32, 0.5, 2.0, 64),
    "one-chunk": ((100,), 128, 64, 0.5, 2.0, None),
    "large-chunks": ((33001,), 33100, 3, 0.5, 2.0, None),
    "g4-ragged-one-empty": ((300, 0, 451, 200), 1000, 32, 0.5, 2.0, None),
    "g4-steps-inside-a-chunk": ((5, 130, 1, 60), 256, 100, 0.5, 2.0, None),
    "g4-all-empty": ((0, 0, 0, 0), 256, 3, 0.5, 2.0, None),
    "large-mean": ((1000,), 1000, 64, 100.0, 0.01, None),
    "large-mean-g4": ((300, 0, 451, 200), 1000, 64, 100.0, 0.01, None),
}


@pytest.mark.parametrize("case", _CHUNKED_CASES)
def test_chunked_statistics_match_plain_and_jax(case, monkeypatch):
    """The kernel's arithmetic (chunked (sum, M2) partials merged by Chan's
    formula, emulated in torch) against the plain version and the JAX
    function, within 1e-5. With mean 100 and spread 0.01 one f32 ulp of the
    mean is 7.6e-4 of the spread, and the f32 versions differ from each
    other by as much as they differ from the truth: there the emulation is
    held within 4e-3 of the plain version run in f64, and within 1e-2 of
    the two f32 versions."""
    sizes, v, c, mean, spread, chunk = _CHUNKED_CASES[case]
    rng = np.random.default_rng(len(case) + v + c)
    gid, nv = _graph_rows(sizes, v)
    g = len(sizes)
    x = (rng.normal(size=(v, c)) * spread + mean).astype(np.float32)
    if chunk:
        monkeypatch.setattr(norms, "CHUNK_ROWS_SMALL", chunk)
    got = norms.masked_instance_norm_chunked(t(x), t(gid), g, nv).numpy()
    plain = norms.masked_instance_norm_plain(t(x), t(gid), g, nv).numpy()
    ref = np.asarray(jax_norms.masked_instance_norm(
        jnp.asarray(x), jnp.asarray(gid), g, jnp.asarray(_mask(v, nv))))
    assert got.dtype == np.float32 and np.all(got[nv:] == 0.0)
    if mean < 10:
        np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        return
    exact = norms.masked_instance_norm_plain(t(x).double(), t(gid), g,
                                             nv).numpy()
    np.testing.assert_allclose(got, exact, rtol=0, atol=4e-3)
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2)
    # the spread of the output (1 / sqrt(1 + eps / var)) is right to f32's
    # resolution there, which sumsq / n - mean^2 would not give
    np.testing.assert_allclose(got[:nv].std(axis=0), exact[:nv].std(axis=0),
                               rtol=0, atol=1e-3)


def test_chunked_statistics_take_a_tensor_count_and_any_chunk(monkeypatch):
    """num_valid as the 0-d int32 tensor the graph carries, and the result
    within 1e-5 whatever the chunk."""
    rng = np.random.default_rng(5)
    v, c, nv = 700, 16, 611
    x = t((rng.normal(size=(v, c)) * 3 - 1).astype(np.float32))
    want = norms.masked_instance_norm_plain(x, None, 1, nv)
    for chunk in (1, 7, 128, 4096):
        monkeypatch.setattr(norms, "CHUNK_ROWS_SMALL", chunk)
        got = norms.masked_instance_norm_chunked(
            x, None, 1, torch.tensor(nv, dtype=torch.int32))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_kernel_layout_numbers():
    """The layout the wrapper sizes its scratch by: 256-row chunks up to
    32768 rows, 512 beyond; a slot for every (chunk, graph) pair; and the
    merge lanes a graph gets."""
    assert norms._chunk_rows(6144) == norms._chunk_rows(32768) == 256
    assert norms._chunk_rows(32769) == norms._chunk_rows(277632) == 512
    # 24 chunks + 1 graph slots of (sum, M2) x 256 columns, mean and
    # inv_std, 8 column tiles x 2 run starts
    assert norms.scratch_floats(6144, 256, 1) == (
        2 * 25 * 256 + 2 * 256 + 8 * 2)
    assert [norms._merge_lanes(64, g) for g in (1, 2, 3, 4, 7, 8, 48)] == [
        32, 16, 16, 8, 8, 4, 4]
    assert [norms._merge_lanes(30, g) for g in (1, 4, 8)] == [8, 2, 1]
    assert norms.scratch_floats(277632, 64, 4) == (
        2 * (543 + 4) * 64 + 2 * 4 * 64 + 2 * 5)


def _pool_case(rng, fine=500, coarse_valid=120, coarse_pad=128):
    """Integer-valued features (many ties), a trace that leaves some coarse
    rows empty, and the builder's children table."""
    x = rng.integers(-3, 4, size=(fine, 8)).astype(np.float32)
    n_valid = fine - 20
    trace = np.full(fine, coarse_pad - 1, np.int32)
    trace[:n_valid] = rng.integers(0, coarse_valid - 10, size=n_valid)
    children, counts = jax_build._build_children(
        trace, n_valid, coarse_pad, fine - 1)
    return x, trace, children, counts


def test_segment_max_equals_jax():
    rng = np.random.default_rng(8)
    x, trace, _, _ = _pool_case(rng)
    want = np.asarray(jax_segment.segment_max(
        jnp.asarray(x), jnp.asarray(trace), 128))
    got = segment.segment_max(t(x), t(trace), 128).numpy()
    np.testing.assert_array_equal(got, want)


def test_segment_mean_matches_jax():
    rng = np.random.default_rng(9)
    x, trace, _, _ = _pool_case(rng)
    x = x + rng.normal(size=x.shape).astype(np.float32)
    want = np.asarray(jax_segment.segment_mean(
        jnp.asarray(x), jnp.asarray(trace), 128))
    got = segment.segment_mean(t(x), t(trace), 128).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", ["ell_pool_max", "ell_pool_mean",
                                "ell_unpool"])
def test_children_table_pooling_equals_jax(op):
    rng = np.random.default_rng(10)
    x, trace, children, counts = _pool_case(rng)
    port_children, port_counts = port_build._build_children(
        trace, 480, 128, 499)
    np.testing.assert_array_equal(port_children, children)
    if op == "ell_unpool":
        x = rng.normal(size=(128, 8)).astype(np.float32)
    args = (trace, children, counts)
    want = np.asarray(getattr(jax_ell, op)(
        jnp.asarray(x), *map(jnp.asarray, args)))
    got = getattr(ell, op)(t(x), *map(t, args)).numpy()
    np.testing.assert_array_equal(got, want)


def test_dispatch_rules():
    p = torch.zeros(8, 4)
    assert not ell._cuda.use_kernel(p, None)
    assert not ell._cuda.use_kernel(p, "plain")
    with pytest.raises(ValueError):
        ell.ell_edge_conv_sum(p, p, torch.zeros(8, 2, dtype=torch.int32),
                              torch.zeros(8), impl="kernel")
    # the kernel wrappers never take a CPU tensor, and count nothing then
    before = (ell.ell_edge_conv_sum_kernel.launches,
              norms.masked_instance_norm_kernel.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ell.ell_edge_conv_sum_kernel(
            p, p, torch.zeros(8, 2, dtype=torch.int32), torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        norms.masked_instance_norm_kernel(p, 8)
    assert (ell.ell_edge_conv_sum_kernel.launches,
            norms.masked_instance_norm_kernel.launches) == before
