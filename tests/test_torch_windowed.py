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
import pathlib

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
    """Both builders' numpy paths, RCM through scipy: the scipy path of the
    port held against the JAX package's (the native RCM breaks ties
    otherwise than scipy's; tests/test_torch_native_build.py and the
    `native_` twins below hold the two native builders together)."""
    monkeypatch.setattr(jax_build._native, "available", lambda: False)
    monkeypatch.setattr(port_build._native, "available", lambda: False)


def _banded(mod, scene):
    """The scene relabelled by the port's RCM, marked as not banded so the
    builder has to find that out for itself."""
    r = port_build.reorder_bandwidth(scene)
    return mod.RawHierarchy(**{f.name: getattr(r, f.name)
                               for f in dataclasses.fields(r)})


@pytest.mark.parametrize("case", ["shuffled", "banded"])
def test_windowed_build_matches_jax_leaf_for_leaf(scipy_rcm, case):
    _windowed_build_matches_jax(case)


@pytest.mark.parametrize("case", ["shuffled", "banded"])
def test_native_windowed_build_matches_jax_native(case):
    """The same with both native builders: one C++ RCM, so one order."""
    assert port_build._native.available() and jax_build._native.available()
    _windowed_build_matches_jax(case)


def _windowed_build_matches_jax(case):
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

def _assert_ell_vjp_bitwise(p, q, g, nbr, deg, rev, deg_out, dtype):
    """The port's ELL sum and its backward (dp, dq) under the cotangent g,
    against jax.vjp of stinet_tpu.ops.ell.ell_edge_conv_sum, bit for bit."""
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
    _assert_ell_vjp_bitwise(p, q, g, nbr, deg, rev, deg_out, dtype)


def _level2_tables(case, v=384, d=16, width=72, seed=5):
    """nbr [v, d], deg, rev [v, width], deg_out shaped like the flagship's
    level-2 tables at a small V (4-8 live slots a row, a receiver-side
    table of 16 slots, a wide reverse table): "skewed", one sender
    referenced by 64 receivers; "past_d", by 80, past rev's width, and ten
    receivers with degrees past D (both clamped); "zero", the skew with a
    quarter of the receivers at degree 0 (and the senders only they
    referenced at out-degree 0). rev lists each sender's receivers in
    order, pad slots at the last row."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, v, size=(v, d)).astype(np.int32)
    deg = rng.integers(4, 9, size=v)
    fans = 80 if case == "past_d" else 64
    nbr[20:20 + fans, 0] = 7
    if case == "past_d":
        deg[:10] = d + 5
    if case == "zero":
        deg[rng.permutation(v)[:v // 4]] = 0
    live = np.arange(d)[None, :] < np.minimum(deg, d)[:, None]
    dst, slot = np.nonzero(live)
    src = nbr[dst, slot]
    deg_out = np.bincount(src, minlength=v)
    rev = np.full((v, width), v - 1, np.int32)
    fill = np.zeros(v, np.int64)
    for s_, r_ in zip(src, dst):
        if fill[s_] < width:
            rev[s_, fill[s_]] = r_
        fill[s_] += 1
    return nbr, deg.astype(np.float32), rev, deg_out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["skewed", "past_d", "zero"])
def test_ell_backward_level2_tables_bit_identical_to_jax(case, dtype):
    """The gradients' oracle on the shapes of the flagship's level-2
    tables: a skewed out-degree, degrees past the tables' widths (clamped)
    and rows of degree 0, bit for bit against JAX. One shape for every
    case, so JAX compiles each op once a dtype."""
    nbr, deg, rev, deg_out = _level2_tables(case)
    v, h = nbr.shape[0], 64
    if case == "past_d":
        assert deg.max() > nbr.shape[1] and deg_out.max() > rev.shape[1]
    else:
        assert deg_out.max() >= 48 and deg_out.max() <= rev.shape[1]
    if case == "zero":
        assert (deg == 0).sum() == v // 4 and (deg_out == 0).any()
    rng = np.random.default_rng(len(case))
    p, q, g = (rng.normal(size=(v, h)).astype(np.float32) for _ in range(3))
    q *= 10.0 ** rng.integers(-3, 4, size=(v, 1))
    _assert_ell_vjp_bitwise(p, q, g, nbr, deg, rev, deg_out, dtype)


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


# --- the ring plan of the CUDA kernels, emulated on the CPU -----------------
#
# `emulate_ring` runs a `window_plan` the way ops/cuda/windowed_edge_conv.cu
# does: per strip and channel slice, the producer's loads (a tile's own
# operands into one of two buffers, then the ring stages of its window, a
# stage only once the consumers released the slot's previous stage), and
# each tile's slot loop reading its operands from its buffer and the staged
# arrays from the ring alone, through the kernel's ring-row map. It raises
# where a live slot lies outside its tile's window (the kernel traps) or
# reads a row that is not resident. The result must be bit for bit the
# plain version's.

FLAGSHIP_PLANS = [
    # (V, H, halo, tile, elem_bytes, arrays), D = 6, 132 SMs ->
    # (cs, sub, ring, bufs, buf_rows, strip_tiles, strips, smem)
    ((72704, 128, 256, 256, 2, 1), (32, 64, 1024, 2, 256, 5, 57, 112928)),
    ((72704, 128, 256, 256, 2, 2), (16, 64, 1024, 2, 256, 9, 32, 96544)),
    ((23680, 256, 192, 128, 2, 1), (64, 64, 640, 2, 64, 3, 62, 102080)),
    ((23680, 256, 192, 128, 2, 2), (32, 64, 640, 2, 128, 6, 31, 105664)),
    ((23680, 256, 192, 128, 4, 1), (32, 64, 640, 2, 64, 6, 31, 102080)),
    ((6144, 256, 96, 256, 2, 1), (32, 32, 704, 2, 256, 1, 24, 92544)),
    ((6144, 256, 96, 256, 2, 2), (32, 32, 704, 2, 128, 1, 24, 114048))]


def _plan_invariants(plan):
    halo, w = windowed.window_geometry(plan.v, plan.tile, plan.halo)
    assert (plan.halo, plan.w) == (halo, w)
    assert plan.cs in windowed.SLICES and plan.tile % plan.sub == 0
    assert plan.w % plan.sub == 0 and plan.ring % plan.sub == 0
    assert plan.ring >= plan.w and plan.bufs >= 2
    assert plan.tile % plan.buf_rows == 0
    assert plan.smem == windowed._smem(plan.arrays, plan.ring, plan.cs,
                                       plan.elem_bytes, plan.sub, plan.bufs,
                                       plan.buf_rows, plan.slots)
    assert plan.smem <= windowed.MAX_BLOCK_SMEM
    tiles = plan.v // plan.tile
    assert (plan.strips - 1) * plan.strip_tiles < tiles <= (
        plan.strips * plan.strip_tiles)
    for i in range(tiles):   # every window starts and ends on a stage
        assert plan.window_start(i) % plan.sub == 0


@pytest.mark.parametrize("args,want", FLAGSHIP_PLANS)
def test_window_plan_at_the_flagship_shapes(args, want):
    plan = windowed.window_plan(*args, 132, 6)
    _plan_invariants(plan)
    assert (plan.cs, plan.sub, plan.ring, plan.bufs, plan.buf_rows,
            plan.strip_tiles, plan.strips, plan.smem) == want
    # a strip copies its windows' union once: less than a window per tile
    assert plan.staged_bytes() < plan.per_tile_staged_bytes() or (
        plan.strip_tiles == 1)


@pytest.mark.parametrize("v,h,halo,tile,sms,what", [
    (4096, 64, 96, 256, 4, "ring smaller than V, long strips"),
    (512, 64, 512, 128, 132, "window all of V"),
    (256, 128, 64, 256, 132, "V = tile"),
    (1024, 72, 96, 128, 132, "H not a multiple of the slice"),
    (1024, 130, 200, 256, 8, "H = 130, ordinary loads on the card")])
def test_window_plan_edge_shapes(v, h, halo, tile, sms, what):
    for arrays in (1, 2):
        plan = windowed.window_plan(v, h, halo, tile, 2, arrays, sms, 12)
        _plan_invariants(plan)
        if what.startswith("ring smaller"):
            assert plan.ring < v and plan.strip_tiles > 1
        if what == "window all of V" or what == "V = tile":
            assert plan.w == v and plan.ring == v
        if what.startswith("H not"):
            assert h % plan.cs != 0 and plan.slices * plan.cs > h


@pytest.mark.parametrize("c_name,py_name", [
    ("kMinBlocks", "TARGET_BLOCKS_PER_SM"), ("kMaxSmem", "MAX_BLOCK_SMEM"),
    ("kBarrierBytes", "BARRIER_BYTES")])
def test_window_plan_limits_match_the_kernel(c_name, py_name):
    """The plan is sized for the limits the kernel is compiled with: the
    blocks an SM its registers are budgeted for, a block's shared memory,
    a ring stage's barriers."""
    import re
    text = (pathlib.Path(windowed.__file__).parent / "cuda"
            / "windowed_edge_conv.cu").read_text()
    m = re.search(rf"constexpr int {c_name} = (\d+);", text)
    assert m and int(m.group(1)) == getattr(windowed, py_name)
    # and the grid counts no more resident blocks than that
    for (v, h, halo, tile, es, arrays), _ in FLAGSHIP_PLANS:
        for sms in (4, 132):
            plan = windowed.window_plan(v, h, halo, tile, es, arrays, sms, 6)
            assert plan.strips * plan.slices <= (
                sms * windowed.TARGET_BLOCKS_PER_SM) or plan.strips == 1


def test_window_plan_refuses_a_window_that_fits_no_block():
    with pytest.raises(RuntimeError):
        windowed.window_plan(65536, 8, 65536, 256, 2, 2, 132, 2)
    with pytest.raises(ValueError):
        windowed.window_plan(1000, 8, 32, 256, 2, 1, 132, 2)


def _strip_actions(plan, s):
    """The producer's and the consumers' steps for strip s, in the kernel's
    order: ("buffer", n, r0) and ("stage", k) for the producer;
    ("window", i), ("chunk", i, n, r0) and ("release", i) for the
    consumers."""
    tiles, chunks = plan.strip_tiles_of(s), plan.tile // plan.buf_rows
    rows = plan.buf_rows
    produce, consume = [], []
    k = plan.strip_stages(s).start
    for i in tiles:
        n0, t0 = (i - tiles.start) * chunks, i * plan.tile
        k_hi = (plan.window_start(i) + plan.w) // plan.sub
        produce.append(("buffer", n0, t0))
        produce += [("stage", kk) for kk in range(k, k_hi)]
        produce += [("buffer", n0 + j, t0 + j * rows)
                    for j in range(1, chunks)]
        k = max(k, k_hi)
        consume.append(("window", i))
        consume += [("chunk", i, n0 + j, t0 + j * rows)
                    for j in range(chunks)]
        consume.append(("release", i))
    return produce, consume


def emulate_ring(plan, staged, own, idx, count, chunk_sum):
    """The kernel's schedule on the CPU: per strip and channel slice, the
    producer's and the consumers' steps, each taken once its barrier would
    let it through (a buffer or a ring slot once the consumers released its
    previous use; a sub-tile once its buffer and its tile's window are
    loaded). staged: the [V, H] arrays the ring holds (q; or g and p); own:
    the [V, H] array of the block's own rows (p; or q); idx, count: the slot
    table and its live counts. chunk_sum(rings, own_rows, local_idx,
    counts) -> a chunk's [buf_rows, cs] output, local_idx the ring rows of
    its slots (0 on dead slots). Raises on a deadlock, a live slot outside
    its tile's window, or a slot that reads a row that is not resident."""
    v, h, cs, sub, rows = plan.v, plan.h, plan.cs, plan.sub, plan.buf_rows
    stages = plan.ring // sub
    live = torch.arange(idx.shape[1])[None, :] < count.to(torch.int64)[:, None]
    width = plan.slices * cs
    out = torch.zeros(v, width, dtype=own.dtype)

    def pad(a):
        return torch.nn.functional.pad(a, (0, width - h))
    padded, own = [pad(a) for a in staged], pad(own)
    for s in range(plan.strips):
        produce, consume = _strip_actions(plan, s)
        k_begin = plan.strip_stages(s).start
        base = k_begin * sub
        for c0 in range(0, width, cs):
            rings = [torch.full((plan.ring, cs), float("nan"),
                                dtype=a.dtype) for a in staged]
            held = torch.full((plan.ring,), -1, dtype=torch.int64)
            buffers = [None] * plan.bufs
            loaded, freed_bufs = set(), set()
            freed_below = k_begin   # stages below it are released
            pi = ci = 0
            while ci < len(consume):
                progress = False
                while pi < len(produce):
                    step = produce[pi]
                    if step[0] == "buffer":
                        _, n, r0 = step
                        if n >= plan.bufs and n - plan.bufs not in freed_bufs:
                            break
                        buffers[n % plan.bufs] = (
                            n, own[r0:r0 + rows, c0:c0 + cs].clone(),
                            idx[r0:r0 + rows].clone(),
                            count[r0:r0 + rows].clone(), live[r0:r0 + rows])
                    else:
                        k = step[1]
                        if k - k_begin >= stages and k - stages >= freed_below:
                            break
                        slot = (k - k_begin) % stages
                        stage = torch.arange(k * sub, (k + 1) * sub)
                        for ring, src in zip(rings, padded):
                            ring[slot * sub:(slot + 1) * sub] = \
                                src[stage, c0:c0 + cs]
                        held[slot * sub:(slot + 1) * sub] = stage
                        loaded.add(k)
                    pi += 1
                    progress = True
                step = consume[ci]
                if step[0] == "window":
                    w0 = plan.window_start(step[1])
                    if all(k in loaded for k in
                           range(w0 // sub, (w0 + plan.w) // sub)):
                        ci += 1
                        progress = True
                elif step[0] == "chunk":
                    _, i, n, r0 = step
                    got = buffers[n % plan.bufs]
                    if got is not None and got[0] == n:
                        w0 = plan.window_start(i)
                        _, own_t, tbl, cnt, lv = got
                        tbl = tbl.to(torch.int64)
                        r = tbl - w0
                        if bool((lv & ((r < 0) | (r >= plan.w))).any()):
                            raise RuntimeError(f"tile {i}: a live slot lies "
                                               "outside its window")
                        ring_row = r + (w0 - base) % plan.ring
                        ring_row = torch.where(ring_row >= plan.ring,
                                               ring_row - plan.ring, ring_row)
                        ring_row = torch.where(lv, ring_row, 0)
                        if bool((held[ring_row][lv] != tbl[lv]).any()):
                            raise RuntimeError(f"tile {i}: a live slot reads "
                                               "a row that is not resident")
                        out[r0:r0 + rows, c0:c0 + cs] = chunk_sum(
                            rings, own_t, ring_row.to(torch.int32), cnt)
                        freed_bufs.add(n)
                        ci += 1
                        progress = True
                else:
                    i = step[1]
                    if i + 1 < plan.strip_tiles_of(s).stop:
                        freed_below = plan.window_start(i + 1) // sub
                    ci += 1
                    progress = True
                if not progress:
                    raise RuntimeError(f"strip {s}: the schedule deadlocks "
                                       f"at {consume[ci]} / {produce[pi]}")
    return out[:, :h]


def ring_sum(plan, p, q, nbr, deg, mode):
    """relu or step sum through the ring, on q's rows."""
    def chunk_sum(rings, p_t, local, cnt):
        if mode == "relu":
            return ell.ell_edge_conv_sum_plain(p_t, rings[0], local, cnt)
        return windowed.windowed_edge_conv_sum_plain(p_t, rings[0], local,
                                                     cnt, "step")
    return emulate_ring(plan, [q], p, nbr, deg, chunk_sum)


def ring_dq(plan, q, g, p, rev, deg_out):
    """dq through the rings of g and p."""
    def chunk_sum(rings, q_t, local, cnt):
        return ell.ell_edge_conv_dq_plain(q_t, rings[0], rings[1], local,
                                          cnt)
    return emulate_ring(plan, [g, p], q, rev, deg_out, chunk_sum)


def _far_edge_table(v, d, halo, tile, seed):
    """Every slot at w0 or w0 + W - 1 of its tile's clamped window, the
    contract's extremes, and random degrees with deg = 0 rows."""
    halo, w = windowed.window_geometry(v, tile, halo)
    rng = np.random.default_rng(seed)
    w0 = np.clip((np.arange(v) // tile) * tile - halo, 0, v - w)
    nbr = np.where(rng.random((v, d)) < 0.5, w0[:, None],
                   w0[:, None] + w - 1).astype(np.int32)
    deg = rng.integers(0, d + 1, size=v).astype(np.float32)
    return nbr, deg


def _assert_bitwise(got, want):
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.contiguous().view(view), want.view(view))


def _check_all_modes(plan16, plan32, plan_dq, p, q, g, nbr, deg, rev, dout):
    p16, q16, g16 = (x.to(torch.bfloat16) for x in (p, q, g))
    for mode in ("relu", "step"):
        _assert_bitwise(ring_sum(plan16, p16, q16, nbr, deg, mode),
                        windowed.windowed_edge_conv_sum_plain(
                            p16, q16, nbr, deg, mode))
    _assert_bitwise(ring_sum(plan32, p, q, nbr, deg, "relu"),
                    ell.ell_edge_conv_sum_plain(p, q, nbr, deg))
    _assert_bitwise(ring_dq(plan_dq, q16, g16, p16, rev, dout),
                    ell.ell_edge_conv_dq_plain(q16, g16, p16, rev, dout))


RING_SHAPES = [
    # v, h, d, halo, tile, sms (the banded tables' reverse tables are wide:
    # rows clipped to 0 and V - 1 take many slots, so chunks shrink)
    (1024, 128, 12, 96, 256, 132),
    (2048, 64, 6, 96, 128, 2),      # long strips, ring smaller than V
    (512, 256, 8, 100, 128, 132),   # clamped at both ends
    (512, 72, 5, 512, 128, 132),    # window all of V; H past the slice
    (256, 40, 6, 64, 256, 132)]     # V = tile


def _plans(v, h, halo, tile, sms, d, d_rev):
    return (windowed.window_plan(v, h, halo, tile, 2, 1, sms, d),
            windowed.window_plan(v, h, halo, tile, 4, 1, sms, d),
            windowed.window_plan(v, h, halo, tile, 2, 2, sms, d_rev))


@pytest.mark.parametrize("table", ["banded", "far_edge"])
@pytest.mark.parametrize("v,h,d,halo,tile,sms", RING_SHAPES)
def test_ring_emulation_bitwise_equals_plain(v, h, d, halo, tile, sms,
                                             table):
    p, q, g, nbr, deg, rev, dout = _banded_case(v, h, d, halo, seed=v + h)
    if table == "far_edge":
        nbr, deg = _far_edge_table(v, d, halo, tile, seed=v)
        rev, dout = _far_edge_table(v, d + 2, halo, tile, seed=v + 1)
    assert windowed.band_violations(t(nbr), t(deg), halo, tile) == 0
    assert windowed.band_violations(t(rev), t(dout), halo, tile) == 0
    _check_all_modes(*_plans(v, h, halo, tile, sms, nbr.shape[1],
                             rev.shape[1]), t(p), t(q), t(g), t(nbr),
                     t(deg), t(rev), t(dout))


def test_ring_emulation_raises_outside_the_window():
    v, d, halo, tile = 1024, 4, 96, 256
    p, q, _, nbr, deg, _, _ = _banded_case(v, 64, d, halo)
    plan = windowed.window_plan(v, 64, halo, tile, 2, 1, 132, d)
    nbr[300, 0], deg[300] = 300 + 256 + 97, 4   # past tile 1's window
    with pytest.raises(RuntimeError, match="outside"):
        ring_sum(plan, t(p, torch.bfloat16), t(q, torch.bfloat16), t(nbr),
                 t(deg), "relu")


def test_ring_emulation_raises_on_a_ring_too_small():
    v, h, d, halo, tile = 1024, 64, 4, 96, 256
    p, q, _, nbr, deg, _, _ = _banded_case(v, h, d, halo)
    plan = windowed.window_plan(v, h, halo, tile, 2, 1, 1, d)._replace(
        ring=256)
    with pytest.raises(RuntimeError, match="deadlocks"):
        ring_sum(plan, t(p, torch.bfloat16), t(q, torch.bfloat16), t(nbr),
                 t(deg), "relu")


def _built_edge_sets(layout):
    """(nbr, deg, rev, deg_out, halo) of every banded edge set of a small
    windowed build: one scene, two scenes concatenated into one graph, or
    each scene of a stacked pair."""
    scenes = [port_synthetic.synthetic_scene(**dict(SCENE, seed=s))
              for s in range(2 if layout != "single" else 1)]
    if layout == "stacked":
        graph, _ = port_build.build_stacked_graph(scenes, geometric=True,
                                                  windowed=True)
    else:
        graph = port_build.build_hierarchical_graph(scenes, geometric=True,
                                                    windowed=True)
    sets = []
    for lv in graph.levels:
        for e in (lv.edges, *lv.dilated.values()):
            if e.halo is None:
                continue
            tables = (e.nbr, e.ell_degree, e.rev_dst, e.out_degree)
            if layout == "stacked":
                sets += [(*(x[b] for x in tables), int(e.halo))
                         for b in range(tables[0].shape[0])]
            else:
                sets.append((*tables, int(e.halo)))
    return sets


@pytest.mark.parametrize("layout", ["single", "concatenated", "stacked"])
def test_ring_emulation_on_built_tables(layout):
    sets = _built_edge_sets(layout)
    assert sets
    rng = np.random.default_rng(7)
    for nbr, deg, rev, dout, halo in sets:
        v, h = nbr.shape[0], 32
        tile = windowed.default_tile(v)
        p, q, g = (t(rng.normal(size=(v, h)).astype(np.float32))
                   for _ in range(3))
        _check_all_modes(*_plans(v, h, halo, tile, 16, nbr.shape[1],
                                 rev.shape[1]), p, q, g, nbr, deg, rev, dout)

