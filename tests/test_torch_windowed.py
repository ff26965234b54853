"""The port's windowed build and the gradients of its edge, pooling and norm
ops against the JAX package, on the same numpy inputs, on the CPU (plain
versions; the CUDA kernels are held against these on the card in
tests/test_torch_cuda.py and chip_smoke.py).

Tolerances:
- windowed build: every leaf equal, value and dtype;
- windowed step sums and dq against the Pallas kernels in interpret mode:
  at least 99.5% of the bf16 outputs bitwise equal and the rest within 1
  bf16 ulp (the kernels' f32 -> bf16 cast may break an exact tie another
  way, onehot_gather.py:28-30);
- windowed relu sums: bitwise equal to the JAX ELL path in bf16
  (ops/ell.py:_forward, the arithmetic the Pallas kernel's docstring
  promises), and within 1 bf16 ulp of the Pallas kernel in interpret mode,
  which on the CPU keeps p + q in f32 instead of rounding it to bf16 (XLA's
  excess precision; about 6% of the outputs then differ by 1 ulp);
- ELL backward, max routing, pool and unpool gradients: bitwise;
- instance-norm gradient: 1e-5 (sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_graph import assert_same_tree

from stinet_tpu.graph import build as jax_build
from stinet_tpu.ops import ell as jax_ell
from stinet_tpu.ops import message_passing as jax_mp
from stinet_tpu.ops import norms as jax_norms
from stinet_tpu.ops import segment as jax_segment
from stinet_tpu.ops.pallas.onehot_gather import (
    pallas_windowed_dq, pallas_windowed_edge_conv_sum,
    pallas_windowed_edge_conv_sum_f32, windowed_ell_edge_conv_sum,
    windowed_ell_edge_conv_sum_f32)
from stinet_tpu.utils import synthetic as jax_synthetic
from stinet_tpu_torch.graph import build as port_build
from stinet_tpu_torch.ops import ell, norms, segment, windowed
from stinet_tpu_torch.ops.message_passing import windowed_kernel_applies
from stinet_tpu_torch.utils import synthetic as port_synthetic

SCENE = dict(num_vertices=4096, levels=3, seed=0, dilation_dists=(2, 4, 8))


def t(a, dtype=None):
    out = torch.from_numpy(np.ascontiguousarray(a))
    return out if dtype is None else out.to(dtype)


@pytest.fixture
def scipy_rcm(monkeypatch):
    """The JAX builder's RCM through scipy, as the port's: its native RCM
    may break ties another way (stinet_tpu/graph/build.py:245-246)."""
    monkeypatch.setattr(jax_build._native, "available", lambda: False)


def _banded(mod, scene):
    """The scene relabelled by the port's RCM, marked as not banded so the
    builder has to find that out for itself."""
    r = port_build.reorder_bandwidth(scene)
    return mod.RawHierarchy(**{f.name: getattr(r, f.name)
                               for f in dataclasses.fields(r)})


@pytest.mark.parametrize("case", ["shuffled", "banded"])
def test_windowed_build_matches_jax_leaf_for_leaf(scipy_rcm, case):
    ref_scene = jax_synthetic.synthetic_scene(**SCENE)
    scene = port_synthetic.synthetic_scene(**SCENE)
    if case == "banded":
        ref_scene, scene = _banded(jax_build, scene), _banded(port_build,
                                                              scene)
        assert port_build._is_banded(scene, 0.999)
    else:
        assert not port_build._is_banded(scene, 0.999)
    ref = jax_build.build_hierarchical_graph([ref_scene], windowed=True,
                                             geometric=True)
    got = port_build.build_hierarchical_graph([scene], windowed=True,
                                              geometric=True)
    assert_same_tree(got, ref)
    assert got.levels[0].edges.halo is not None
    for lv in got.levels:
        for e in (lv.edges, *lv.dilated.values()):
            if e.halo is not None:
                tile = windowed.default_tile(e.nbr.shape[0])
                assert windowed.band_violations(e.nbr, e.ell_degree, e.halo,
                                                tile) == 0
                assert windowed.band_violations(e.rev_dst, e.out_degree,
                                                e.halo, tile) == 0


def test_rcm_matches_jax_scipy_path(scipy_rcm):
    scene = port_synthetic.synthetic_scene(**SCENE)
    for l, nv in enumerate(scene.num_vertices):
        got = port_build.rcm_perm(scene.level_edges[l], nv)
        want = jax_build.rcm_perm(scene.level_edges[l], nv)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("band,v_pad", [(1, 4096), (200, 4096), (300, 1024),
                                        (5000, 65536)])
def test_auto_halo_matches_jax(band, v_pad):
    rng = np.random.default_rng(band)
    src = rng.integers(0, v_pad, size=3000)
    dst = np.clip(src + rng.integers(-band, band + 1, size=3000), 0,
                  v_pad - 1)
    edges = np.stack([src, dst])
    assert (port_build._auto_halo(edges, v_pad, 0.999)
            == jax_build._auto_halo(edges, v_pad, 0.999))


@pytest.mark.parametrize("v,h,dtype,halo", [
    (1024, 128, "bf16", 256), (1024, 128, "bf16", 512),
    (2048, 256, "bf16", 384), (2048, 512, "bf16", 96),
    (1000, 128, "bf16", 96), (1024, 256, "f32", 256),
    (1024, 128, "bf16", None)] + [
    (2048, h, "f32", halo) for h in (128, 256, 512)
    for halo in (96, 384, 512)])
def test_dispatch_rule_matches_jax(monkeypatch, v, h, dtype, halo):
    """On the CPU the JAX rule needs STINET_WINDOWED_INTERPRET=1; the port's
    has no backend test. Both send bf16 tables at H in {128, 256} and f32
    tables at H = 256 to the windowed kernels, up to a halo of 384."""
    monkeypatch.setenv("STINET_WINDOWED_INTERPRET", "1")
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    want = jax_mp._windowed_kernel_applies(jnp.zeros((v, h), jdt), halo)
    got = windowed_kernel_applies(torch.zeros(v, h, dtype=tdt), halo)
    assert got == want


# --- windowed sums against the Pallas kernels in interpret mode ----------

def _banded_case(v, h, d, halo, seed=0):
    """A banded table with deg=0 rows, and its reverse table, as
    tests/test_onehot_gather.py builds them."""
    rng = np.random.default_rng(seed)
    base = np.arange(v)
    nbr = np.clip(base[:, None] + rng.integers(-halo, halo + 1, size=(v, d)),
                  0, v - 1).astype(np.int32)
    deg = rng.integers(0, d + 1, size=v).astype(np.float32)
    src = np.concatenate([nbr[i, :int(deg[i])] for i in range(v)])
    dst = np.repeat(np.arange(v), deg.astype(np.int64))
    deg_out = np.bincount(src, minlength=v)
    rev = np.full((v, max(int(deg_out.max()), 1)), v - 1, np.int32)
    order = np.argsort(src, kind="stable")
    slot = np.arange(len(src)) - np.concatenate(
        [[0], np.cumsum(deg_out)])[src[order]]
    rev[src[order], slot] = dst[order]
    p = rng.normal(size=(v, h)).astype(np.float32)
    q = rng.normal(size=(v, h)).astype(np.float32)
    g = rng.normal(size=(v, h)).astype(np.float32)
    return p, q, g, nbr, deg, rev, deg_out.astype(np.float32)


CASES = [(1024, 128, 12, 96, 256), (512, 128, 5, 40, 128),
         (512, 256, 8, 100, 128)]   # the last clamps at both ends


def _bits(got, want):
    a = got.view(torch.int16).numpy().astype(np.int32)
    b = np.asarray(want).view(np.int16).astype(np.int32)
    assert a.shape == b.shape
    return a, b


def assert_bf16_nearly_bitwise(got, want):
    """got: torch bf16; want: a JAX bf16 array. >= 99.5% bitwise equal, the
    rest within 1 ulp."""
    a, b = _bits(got, want)
    assert (a == b).mean() >= 0.995, (a != b).mean()
    assert np.abs(a - b).max() <= 1


def assert_bf16_within_one_ulp(got, want):
    a, b = _bits(got, want)
    assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("mode", ["relu", "step"])
@pytest.mark.parametrize("v,h,d,halo,tile", CASES)
def test_windowed_sum_matches_pallas(v, h, d, halo, tile, mode):
    p, q, _, nbr, deg, _, _ = _banded_case(v, h, d, halo)
    want = pallas_windowed_edge_conv_sum(
        jnp.asarray(p, jnp.bfloat16), jnp.asarray(q, jnp.bfloat16),
        jnp.asarray(nbr), jnp.asarray(deg), halo=halo, tile=tile,
        interpret=True, mode=mode)
    got = windowed.windowed_edge_conv_sum(t(p), t(q), t(nbr), t(deg), halo,
                                          tile, mode)
    assert got.dtype == torch.bfloat16
    assert windowed.band_violations(t(nbr), t(deg), halo, tile) == 0
    if mode == "step":
        assert_bf16_nearly_bitwise(got, want)
        return
    assert_bf16_within_one_ulp(got, want)
    ell_ref = jax_ell._forward(
        jnp.asarray(p, jnp.bfloat16), jnp.asarray(q, jnp.bfloat16),
        jnp.asarray(nbr), jnp.asarray(deg))
    a, b = _bits(got, ell_ref)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("v,h,d,halo,tile", CASES)
def test_windowed_dq_matches_pallas(v, h, d, halo, tile):
    p, q, g, _, _, rev, deg_out = _banded_case(v, h, d, halo)
    want = pallas_windowed_dq(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16),
        jnp.asarray(p, jnp.bfloat16), jnp.asarray(rev), jnp.asarray(deg_out),
        halo, tile=tile, interpret=True)
    got = windowed.windowed_dq(t(q), t(g), t(p), t(rev), t(deg_out), halo,
                               tile)
    assert windowed.band_violations(t(rev), t(deg_out), halo, tile) == 0
    assert_bf16_nearly_bitwise(got, want)


@pytest.mark.parametrize("h", [128, 256])
def test_windowed_autograd_matches_jax_grad(h):
    """Output and gradients of the custom VJP (K3d) under the loss
    sum(out * G): the cotangent does not depend on the relu output, whose
    1-ulp interpret-mode difference the sum test covers."""
    v, d, halo, tile = 512, 6, 64, 128
    p, q, g, nbr, deg, rev, deg_out = _banded_case(v, h, d, halo, seed=1)
    args = [jnp.asarray(a) for a in (nbr, rev, deg, deg_out)]

    def loss(p, q):
        out = windowed_ell_edge_conv_sum(halo, tile, True, p, q, *args)
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, want), (dp, dq) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(p, jnp.bfloat16), jnp.asarray(q, jnp.bfloat16))
    pt = t(p, torch.bfloat16).requires_grad_()
    qt = t(q, torch.bfloat16).requires_grad_()
    out = windowed.WindowedEdgeConvSum.apply(
        pt, qt, t(nbr), t(rev), t(deg), t(deg_out), halo, tile)
    (out.float() * t(g)).sum().backward()
    assert_bf16_within_one_ulp(out.detach(), want)
    assert_bf16_nearly_bitwise(pt.grad, dp)
    assert_bf16_nearly_bitwise(qt.grad, dq)


F32_CASES = [(v, 256, d, halo, tile) for v, _, d, halo, tile in CASES] + [
    CASES[0]]   # three at H = 256 (one clamped at both ends), one at 128


@pytest.mark.parametrize("v,h,d,halo,tile", F32_CASES)
def test_windowed_f32_sum_bitwise_equals_pallas_and_ell(v, h, d, halo, tile):
    """K3b's plain version against the exact-f32 Pallas kernel (bf16x3
    planes) in interpret mode and the JAX ELL path in f32: bit for bit."""
    p, q, _, nbr, deg, _, _ = _banded_case(v, h, d, halo, seed=2)
    q = q * 10.0 ** np.random.default_rng(3).integers(-3, 4, size=(v, 1))
    q = q.astype(np.float32)
    args = (jnp.asarray(p), jnp.asarray(q), jnp.asarray(nbr),
            jnp.asarray(deg))
    want = pallas_windowed_edge_conv_sum_f32(*args, halo=halo, tile=tile,
                                             interpret=True)
    ell_ref = jax_ell._forward(*args)
    got = windowed.windowed_edge_conv_sum_f32(t(p), t(q), t(nbr), t(deg),
                                              halo, tile)
    assert got.dtype == torch.float32
    assert windowed.band_violations(t(nbr), t(deg), halo, tile) == 0
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(ell_ref).view(np.int32))


@pytest.mark.parametrize("h", [128, 256])
def test_windowed_f32_autograd_bitwise_equals_jax(h):
    """The f32 K3d: its output and dp, dq (the ELL backward) under the loss
    sum(out * G), against jax.value_and_grad of
    windowed_ell_edge_conv_sum_f32 in interpret mode, bit for bit."""
    v, d, halo, tile = 512, 6, 64, 128
    p, q, g, nbr, deg, rev, deg_out = _banded_case(v, h, d, halo, seed=4)
    args = [jnp.asarray(a) for a in (nbr, rev, deg, deg_out)]

    def loss(p, q):
        out = windowed_ell_edge_conv_sum_f32(halo, tile, True, p, q, *args)
        return jnp.sum(out * g), out

    (_, want), (dp, dq) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(p), jnp.asarray(q))
    pt, qt = t(p).requires_grad_(), t(q).requires_grad_()
    out = windowed.WindowedEdgeConvSumF32.apply(
        pt, qt, t(nbr), t(rev), t(deg), t(deg_out), halo, tile)
    out.backward(t(g))
    for a, b in ((out.detach(), want), (pt.grad, dp), (qt.grad, dq)):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      np.asarray(b).view(np.int32))


# --- ELL backward, bit for bit --------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("v,h,d", [(300, 16, 6), (257, 130, 12)])
def test_ell_backward_bit_identical_to_jax(v, h, d, dtype):
    rng = np.random.default_rng(v + h)
    p = rng.normal(size=(v, h)).astype(np.float32)
    q = (rng.normal(size=(v, h))
         * 10.0 ** rng.integers(-3, 4, size=(v, 1))).astype(np.float32)
    g = rng.normal(size=(v, h)).astype(np.float32)
    nbr = rng.integers(0, v, size=(v, d)).astype(np.int32)
    deg = rng.integers(0, d + 1, size=v).astype(np.float32)
    src = np.concatenate([nbr[i, :int(deg[i])] for i in range(v)])
    dst = np.repeat(np.arange(v), deg.astype(np.int64))
    deg_out = np.bincount(src, minlength=v)
    rev = np.full((v, int(deg_out.max())), v - 1, np.int32)
    fill = np.zeros(v, np.int64)
    for s_, r_ in zip(src, dst):
        rev[s_, fill[s_]] = r_
        fill[s_] += 1
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    tables = [jnp.asarray(a) for a in (nbr, rev, deg,
                                       deg_out.astype(np.float32))]
    out, vjp = jax.vjp(lambda p, q: jax_ell.ell_edge_conv_sum(p, q, *tables),
                       jnp.asarray(p, jdt), jnp.asarray(q, jdt))
    dp, dq = vjp(jnp.asarray(g, jdt))
    pt, qt = (t(p, tdt).requires_grad_(), t(q, tdt).requires_grad_())
    got = ell.ell_edge_conv_sum(pt, qt, t(nbr), t(deg), t(rev),
                                t(deg_out.astype(np.float32)))
    got.backward(t(g, tdt))
    for a, b in ((got.detach(), out), (pt.grad, dp), (qt.grad, dq)):
        np.testing.assert_array_equal(
            a.float().numpy(), np.asarray(b, np.float32))


# --- max routing with forced ties, pooling gradients -----------------------

def _pool_case(rng, fine=500, coarse_valid=120, coarse_pad=128):
    """Integer features in [-2, 2]: most maxima are tied."""
    x = rng.integers(-2, 3, size=(fine, 8)).astype(np.float32)
    n_valid = fine - 20
    trace = np.full(fine, coarse_pad - 1, np.int32)
    trace[:n_valid] = rng.integers(0, coarse_valid - 10, size=n_valid)
    children, counts = jax_build._build_children(trace, n_valid, coarse_pad,
                                                 fine - 1)
    g = rng.normal(size=(coarse_pad, 8)).astype(np.float32)
    return x, trace, children, counts, g


def _grad_pair(jax_fn, port_fn, x, g):
    _, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = t(x).requires_grad_()
    port_fn(xt).backward(t(g))
    return xt.grad.numpy(), want


def test_segment_max_gradient_routes_like_jax():
    rng = np.random.default_rng(8)
    x, trace, _, _, g = _pool_case(rng)
    got, want = _grad_pair(
        lambda x: jax_segment.segment_max(x, jnp.asarray(trace), 128),
        lambda x: segment.segment_max(x, t(trace), 128), x, g)
    np.testing.assert_array_equal(got, want)
    # one achiever per (segment, feature) takes the whole gradient
    assert np.count_nonzero(got) <= np.count_nonzero(g)


@pytest.mark.parametrize("op", ["ell_pool_max", "ell_pool_mean",
                                "ell_unpool"])
def test_children_table_gradients_equal_jax(op):
    rng = np.random.default_rng(10)
    x, trace, children, counts, g = _pool_case(rng)
    if op == "ell_unpool":
        x, g = g, rng.normal(size=(500, 8)).astype(np.float32)
    tables = (trace, children, counts)
    got, want = _grad_pair(
        lambda x: getattr(jax_ell, op)(x, *map(jnp.asarray, tables)),
        lambda x: getattr(ell, op)(x, *map(t, tables)), x, g)
    np.testing.assert_array_equal(got, want)


# --- instance norm ----------------------------------------------------------

@pytest.mark.parametrize("v,c,valid", [(1024, 32, 900), (512, 16, 512),
                                       (256, 8, 3)])
def test_instance_norm_gradient_matches_jax(v, c, valid):
    rng = np.random.default_rng(v + c)
    x = (rng.normal(size=(v, c)) * 2 + 0.5).astype(np.float32)
    g = rng.normal(size=(v, c)).astype(np.float32)
    gid = np.where(np.arange(v) < valid, 0, 1).astype(np.int32)
    vmask = (np.arange(v) < valid).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(jax_norms.masked_instance_norm(
        x, jnp.asarray(gid), 1, jnp.asarray(vmask)) * g))(jnp.asarray(x))
    xt = t(x).requires_grad_()
    (norms.masked_instance_norm(xt, t(gid), 1, valid) * t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
