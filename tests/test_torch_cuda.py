"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they need an NVIDIA GPU and nvcc, and skip elsewhere (the
CPU suite holds the plain versions against the JAX package in
tests/test_torch_ops.py and tests/test_torch_model.py). Run on a card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""
import dataclasses
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from stinet_tpu_torch.graph.build import build_hierarchical_graph
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.ops import _cuda, ell, norms, windowed
from stinet_tpu_torch.serving import PackedPlacer
from stinet_tpu_torch.trainers import graph_common as gc
from stinet_tpu_torch.utils.synthetic import synthetic_scene

pytestmark = pytest.mark.cuda
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    try:
        _cuda.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda", torch.cuda.current_device())


def _cuda_t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("v,h,d", [(300, 16, 6), (257, 20, 12),
                                   (1000, 64, 64), (513, 130, 7),
                                   (4096, 128, 6), (64, 512, 16),
                                   (7, 4, 0)])
def test_ell_kernel_bitwise_equals_plain(dev, v, h, d):
    rng = np.random.default_rng(v + h + d)
    p = _cuda_t(rng.normal(size=(v, h)).astype(np.float32), dev)
    q = _cuda_t((rng.normal(size=(v, h))
                 * 10.0 ** rng.integers(-3, 4, size=(v, 1)))
                .astype(np.float32), dev)
    nbr = _cuda_t(rng.integers(0, v, size=(v, d)).astype(np.int32), dev)
    deg = _cuda_t(rng.integers(0, d + 1, size=v).astype(np.float32), dev)
    before = ell.ell_edge_conv_sum_kernel.launches
    got = ell.ell_edge_conv_sum(p, q, nbr, deg)
    assert ell.ell_edge_conv_sum_kernel.launches == before + 1
    want = ell.ell_edge_conv_sum(p, q, nbr, deg, impl="plain")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_ell_kernel_takes_unaligned_rows(dev):
    """A view that starts one element into its storage is not 16-byte
    aligned: the kernel must take its scalar path and still agree."""
    rng = np.random.default_rng(1)
    v, h, d = 200, 64, 5
    buf = _cuda_t(rng.normal(size=(v * h + 1)).astype(np.float32), dev)
    p = buf[1:].view(v, h)
    q = _cuda_t(rng.normal(size=(v, h)).astype(np.float32), dev)
    nbr = _cuda_t(rng.integers(0, v, size=(v, d)).astype(np.int32), dev)
    deg = _cuda_t(rng.integers(0, d + 1, size=v).astype(np.float32), dev)
    got = ell.ell_edge_conv_sum(p, q, nbr, deg)
    want = ell.ell_edge_conv_sum(p, q, nbr, deg, impl="plain")
    assert torch.equal(got, want)


def test_ell_kernel_rejects_what_it_does_not_take(dev):
    p = torch.zeros(8, 4, device=dev)
    nbr = torch.zeros(8, 2, dtype=torch.int32, device=dev)
    deg = torch.zeros(8, device=dev)
    with pytest.raises(TypeError):
        ell.ell_edge_conv_sum(p.double(), p.double(), nbr, deg)
    with pytest.raises(TypeError):
        ell.ell_edge_conv_sum(p, p, nbr.long(), deg)
    with pytest.raises(ValueError):
        ell.ell_edge_conv_sum(p.T, p, nbr, deg)


@pytest.mark.parametrize("v,c,valid", [(1024, 32, 900), (512, 3, 512),
                                       (72704, 64, 65536), (6144, 256, 5898),
                                       (300, 100, 1), (256, 16, 0)])
def test_instance_norm_kernel_matches_plain(dev, v, c, valid):
    rng = np.random.default_rng(v + c + valid)
    x = _cuda_t((rng.normal(size=(v, c)) * 3 + 2).astype(np.float32), dev)
    gid = torch.zeros(v, dtype=torch.int32, device=dev)
    nv = torch.tensor(valid, dtype=torch.int32, device=dev)
    before = norms.masked_instance_norm_kernel.launches
    got = norms.masked_instance_norm(x, gid, 1, nv)
    assert norms.masked_instance_norm_kernel.launches == before + 1
    want = norms.masked_instance_norm(x, gid, 1, nv, impl="plain")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.all(got[valid:] == 0)


@pytest.mark.parametrize("v,c,valid", [
    (1000, 30, 900),        # C not a multiple of 4: the scalar path
    (40000, 6, 39000),      # the scalar path with 512-row chunks
    (40000, 64, 40000),     # 16-byte loads with 512-row chunks
    (6144, 257, 5898),      # a last column tile of one column
    (128, 4, 0), (129, 5, 129)])
def test_instance_norm_kernel_paths_and_repeat(dev, v, c, valid):
    """Both load widths and both chunk sizes against the plain version,
    and two runs on the same inputs bit for bit (no sum uses an atomic);
    the ticket counters are left 0."""
    rng = np.random.default_rng(v + c + valid)
    x = _cuda_t((rng.normal(size=(v, c)) * 3 + 2).astype(np.float32), dev)
    nv = torch.tensor(valid, dtype=torch.int32, device=dev)
    got = norms.masked_instance_norm_kernel(x, nv)
    want = norms.masked_instance_norm_plain(x, None, 1, nv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.all(got[valid:] == 0)
    again = norms.masked_instance_norm_kernel(x, nv)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert all(int(t.abs().sum()) == 0 for t in norms._TICKETS.values())


def test_instance_norm_kernel_takes_unaligned_rows(dev):
    """A view one element into its storage is not 16-byte aligned: the
    kernel takes its scalar path at C % 4 == 0 and still agrees."""
    rng = np.random.default_rng(3)
    v, c, valid = 3000, 64, 2900
    buf = _cuda_t((rng.normal(size=(v * c + 1)) * 2 - 1).astype(np.float32),
                  dev)
    x = buf[1:].view(v, c)
    nv = torch.tensor(valid, dtype=torch.int32, device=dev)
    got = norms.masked_instance_norm_kernel(x, nv)
    want = norms.masked_instance_norm_plain(x, None, 1, nv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.all(got[valid:] == 0)


@pytest.mark.parametrize("sizes,v,c", [((65536,), 65536 + 128, 64),
                                       ((5898,), 6144, 256),
                                       ((3000, 0, 2000, 898), 6144, 256)])
def test_instance_norm_kernel_large_mean(dev, sizes, v, c):
    """Mean 100, spread 0.01: one f32 ulp of the mean is 7.6e-4 of the
    spread, so the kernel is held within 4e-3 of the plain version run in
    f64 (as its emulation is on the CPU), which a variance taken as
    sumsq / n - mean^2 would miss by far."""
    rng = np.random.default_rng(v + c)
    gid, valid = _batched_rows(sizes, v)
    x = _cuda_t((rng.normal(size=(v, c)) * 0.01 + 100).astype(np.float32),
                dev)
    gid = _cuda_t(gid, dev)
    nv = torch.tensor(valid, dtype=torch.int32, device=dev)
    g = len(sizes)
    got = norms.masked_instance_norm(x, gid, g, nv)
    exact = norms.masked_instance_norm_plain(x.double(), gid, g, nv)
    torch.testing.assert_close(got.double(), exact, rtol=0, atol=4e-3)
    assert torch.all(got[valid:] == 0)


@pytest.mark.parametrize("v,c,g", [(6144, 256, 1), (277632, 64, 4),
                                   (1000, 30, 7), (40000, 6, 1)])
def test_instance_norm_scratch_size_is_the_least_the_library_takes(dev, v, c,
                                                                   g):
    """The wrapper's `scratch_floats` against the library's own count: the
    library launches with that many floats and refuses one fewer."""
    lib = _cuda.library("instance_norm")
    size = norms.scratch_floats(v, c, g)
    x = torch.ones(v, c, device=dev)
    gid = torch.zeros(v, dtype=torch.int32, device=dev)
    nv = torch.tensor(v, dtype=torch.int32, device=dev)
    out, scratch = torch.empty_like(x), torch.empty(size, device=dev)
    tickets = torch.zeros(norms.MAX_COL_TILES, dtype=torch.int32, device=dev)

    def launch(given):
        return lib.masked_instance_norm_multigraph_f32(
            x.data_ptr(), nv.data_ptr(), gid.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), given, tickets.data_ptr(), v, c, g, 1e-5,
            dev.index, _cuda.stream_of(dev))

    assert launch(size) == 0
    torch.cuda.synchronize()
    assert launch(size - 1) != 0


def test_instance_norm_kernel_on_two_streams(dev):
    """Calls on two streams at once keep their own ticket counters and
    scratch, and give the bits of a call alone."""
    rng = np.random.default_rng(9)
    xs = [_cuda_t((rng.normal(size=(72704, 64)) + i).astype(np.float32), dev)
          for i in range(2)]
    nv = torch.tensor(65536, dtype=torch.int32, device=dev)
    alone = [norms.masked_instance_norm_kernel(x, nv) for x in xs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in xs]
    outs = [[], []]
    for _ in range(20):
        for i, (x, st) in enumerate(zip(xs, streams)):
            with torch.cuda.stream(st):
                outs[i].append(norms.masked_instance_norm_kernel(x, nv))
    torch.cuda.synchronize()
    for i, want in enumerate(alone):
        assert all(torch.equal(o, want) for o in outs[i])


def test_stream_lookup_is_the_current_stream(dev):
    """The kernels launch on torch's current stream, inside a stream
    context too."""
    assert _cuda.stream_of(dev) == torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        assert _cuda.stream_of(dev) == side.cuda_stream
    assert _cuda.stream_of(dev) == torch.cuda.current_stream(dev).cuda_stream


@pytest.mark.parametrize("rows", ["descending", "above-g", "negative"])
def test_graph_id_out_of_order_is_refused(dev, rows):
    """The kernel traps on a graph_id that is not non-decreasing within
    [0, G]. A trap ends the process's CUDA context, so the call runs in a
    process of its own, which must see the error."""
    edit = {"descending": "gid[:512] = 1", "above-g": "gid[-1] = 3",
            "negative": "gid[0] = -1"}[rows]
    code = f"""
import os
import torch
from stinet_tpu_torch.ops import norms
x = torch.randn(1024, 32, device="cuda")
gid = torch.zeros(1024, dtype=torch.int32, device="cuda")
{edit}
nv = torch.tensor(1024, dtype=torch.int32, device="cuda")
try:
    norms.masked_instance_norm_kernel(x, nv, graph_id=gid, num_graphs=2)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("refused:", type(e).__name__, flush=True)
    os._exit(0)
os._exit(1)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "refused" in res.stdout, (
        res.stdout + res.stderr)


def _batched_rows(sizes, v):
    """graph_id for graphs of `sizes` valid rows laid out in order, pad rows
    = len(sizes), and the valid count."""
    gid = np.full(v, len(sizes), np.int32)
    off = 0
    for g, n in enumerate(sizes):
        gid[off:off + n] = g
        off += n
    return gid, off


# 48 ragged graphs, some empty, some of one row
_MANY = tuple(int(n) for n in np.random.default_rng(48).choice(
    [0, 1, 7, 255, 256, 257, 1000, 3000], size=48))


@pytest.mark.parametrize("sizes,v,c", [
    ((900,), 1024, 32),
    ((0, 0, 0), 512, 32),                 # num_valid = 0
    ((5, 130, 1, 60), 256, 30),           # steps inside a chunk, scalar path
    ((50, 0, 700, 3, 129, 256, 1), 2048, 36),   # 7 graphs merged 4 at a time
    ((300, 1), 512, 16),                  # a graph with one valid row
    ((700, 0, 1200, 50), 2048, 64),       # an empty graph
    ((4000, 9000, 3, 250, 7000, 1, 600, 5000), 27008, 64),
    ((65536,) * 4, 262144 + 128, 64),     # four flagship level-0 scenes
    (_MANY, sum(_MANY) + 300, 48),
    ((65536,) * 32, 32 * 65536 + 128, 64)])   # 32 flagship scenes
def test_multigraph_instance_norm_kernel_matches_plain(dev, sizes, v, c):
    rng = np.random.default_rng(v + c)
    gid, nv = _batched_rows(sizes, v)
    x = _cuda_t((rng.normal(size=(v, c)) * 3 + rng.normal(size=(1, c)))
                .astype(np.float32), dev)
    gid = _cuda_t(gid, dev)
    nv = torch.tensor(nv, dtype=torch.int32, device=dev)
    g = len(sizes)
    before = norms.masked_instance_norm_kernel.multigraph_launches
    got = norms.masked_instance_norm_kernel(x, nv, graph_id=gid, num_graphs=g)
    assert norms.masked_instance_norm_kernel.multigraph_launches == before + 1
    want = norms.masked_instance_norm(x, gid, g, nv, impl="plain")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.all(got[int(nv):] == 0)
    again = norms.masked_instance_norm_kernel(x, nv, graph_id=gid,
                                              num_graphs=g)
    assert torch.equal(got, again)   # no atomics: a run repeats bit for bit
    if g > 1:
        before = norms.masked_instance_norm_kernel.multigraph_launches
        via_op = norms.masked_instance_norm(x, gid, g, nv)
        assert norms.masked_instance_norm_kernel.multigraph_launches == (
            before + 1)
        assert torch.equal(via_op, got)


@pytest.mark.parametrize("v,c,valid", [(1024, 32, 900), (72704, 64, 65536),
                                       (6144, 256, 5898), (256, 16, 0)])
def test_multigraph_kernel_at_one_graph_is_the_single_graph_kernel(
        dev, v, c, valid):
    rng = np.random.default_rng(v + c)
    x = _cuda_t((rng.normal(size=(v, c)) * 3 + 2).astype(np.float32), dev)
    gid = _cuda_t(np.where(np.arange(v) < valid, 0, 1).astype(np.int32), dev)
    nv = torch.tensor(valid, dtype=torch.int32, device=dev)
    got = norms.masked_instance_norm_kernel(x, nv, graph_id=gid,
                                            num_graphs=1)
    want = norms.masked_instance_norm_kernel(x, nv)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_model_kernel_path_matches_plain_path(dev):
    model = define_G(10, 3, 16, "edgeconvtransinv", norm="instance",
                     n_blocks=3, dilations=[1, 2, 4], pooling_type="max",
                     generator=torch.Generator().manual_seed(0))
    graph = build_hierarchical_graph(
        [synthetic_scene(6000, levels=3, seed=1, dilation_dists=(2, 4))],
        geometric=True)
    cpu_out = model(graph).detach()
    model = model.to(dev)
    g = graph.to(dev)
    with torch.inference_mode():
        got = model(g)
        want = model(g, impl="plain")
    nv = int(graph.levels[0].num_vertices)
    torch.testing.assert_close(got[:nv], want[:nv], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[:nv].cpu(), cpu_out[:nv], rtol=0,
                               atol=1e-4)


def _bitwise(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(view), b.view(view))


def _table_case(rng, v, h, d, dtype, dev, halo=None):
    """p, q, g, nbr, deg, rev, deg_out on the card; banded to `halo` when
    given, with deg = 0 rows either way."""
    base = np.arange(v)
    if halo is None:
        nbr = rng.integers(0, v, size=(v, d))
    else:
        nbr = np.clip(base[:, None] + rng.integers(-halo, halo + 1,
                                                   size=(v, d)), 0, v - 1)
    nbr = nbr.astype(np.int32)
    deg = rng.integers(0, d + 1, size=v).astype(np.float32)
    src = np.concatenate([nbr[i, :int(deg[i])] for i in range(v)])
    dst = np.repeat(base, deg.astype(np.int64))
    deg_out = np.bincount(src, minlength=v)
    rev = np.full((v, max(int(deg_out.max()), 1)), v - 1, np.int32)
    order = np.argsort(src, kind="stable")
    slot = np.arange(len(src)) - np.concatenate(
        [[0], np.cumsum(deg_out)])[src[order]]
    rev[src[order], slot] = dst[order]
    feats = [_cuda_t((rng.normal(size=(v, h))
                      * 10.0 ** rng.integers(-2, 3, size=(v, 1)))
                     .astype(np.float32), dev).to(dtype) for _ in range(3)]
    return (*feats, _cuda_t(nbr, dev), _cuda_t(deg, dev), _cuda_t(rev, dev),
            _cuda_t(deg_out.astype(np.float32), dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,h,d", [(300, 16, 6), (257, 20, 12),
                                   (1000, 130, 9), (4096, 128, 6),
                                   (64, 512, 16), (7, 4, 0)])
def test_ell_forward_and_backward_kernels_bitwise(dev, v, h, d, dtype):
    rng = np.random.default_rng(v + h + d)
    p, q, g, nbr, deg, rev, deg_out = _table_case(rng, v, h, d, dtype, dev)
    counts = (ell.ell_edge_conv_sum_kernel.launches,
              ell.ell_edge_conv_dp_kernel.launches,
              ell.ell_edge_conv_dq_kernel.launches)
    pairs = [
        (ell.ell_edge_conv_sum_kernel(p, q, nbr, deg),
         ell.ell_edge_conv_sum_plain(p, q, nbr, deg)),
        (ell.ell_edge_conv_dp_kernel(p, q, nbr, deg, g),
         ell.ell_edge_conv_dp_plain(p, q, nbr, deg, g)),
        (ell.ell_edge_conv_dq_kernel(q, g, p, rev, deg_out),
         ell.ell_edge_conv_dq_plain(q, g, p, rev, deg_out))]
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(pairs):
        assert _bitwise(got, want), i
    assert (ell.ell_edge_conv_sum_kernel.launches,
            ell.ell_edge_conv_dp_kernel.launches,
            ell.ell_edge_conv_dq_kernel.launches) == tuple(
                c + 1 for c in counts)


def _forward_case(rng, v, h, d, dtype, dev):
    """p, q, nbr, deg for the K1 forward: degrees past D (clamped) and 0
    among the rows, NaN, +inf and -inf among q's elements."""
    p = rng.normal(size=(v, h)) * 10.0 ** rng.integers(-2, 3, size=(v, 1))
    q = rng.normal(size=(v, h)) * 10.0 ** rng.integers(-2, 3, size=(v, 1))
    for value in (np.nan, np.inf, -np.inf):
        q[rng.integers(0, v, 5), rng.integers(0, h, 5)] = value
    nbr = rng.integers(0, v, size=(v, d)).astype(np.int32)
    deg = rng.integers(0, d + 4, size=v).astype(np.float32)
    deg[rng.integers(0, v, 8)] = 0
    deg[rng.integers(0, v, 8)] = d + 7
    return (_cuda_t(p.astype(np.float32), dev).to(dtype),
            _cuda_t(q.astype(np.float32), dev).to(dtype),
            _cuda_t(nbr, dev), _cuda_t(deg, dev))


def _launched(plan):
    return dict(lanes=plan.lanes, chunks=plan.chunks, groups=plan.groups,
                blocks=plan.blocks, threads=ell.THREADS,
                vector=int(plan.vector))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [4, 8, 20, 128, 130, 256, 512, 520])
@pytest.mark.parametrize("d", [0, 6, 16, 33, 148])
def test_ell_forward_rows_bitwise(dev, d, h, dtype):
    """ell_fwd_rows against the plain version, bit for bit, at widths of
    every layout class (one lane to 32 lanes a row, 1 or 2 chunks a lane,
    2 or 3 groups a row at f32 H=512 and 520 and bf16 H=520, element loads
    at H*es % 16 != 0), on
    V = 1001 rows (no multiple of the rows a block); the launch is
    `ell_plan`'s; twice the same bits; every split of the rows that the
    plan allows gives the same bits too."""
    v = 1001
    rng = np.random.default_rng(h * 1000 + d)
    p, q, nbr, deg = _forward_case(rng, v, h, d, dtype, dev)
    before = ell.ell_edge_conv_sum_kernel.launches
    got = ell.ell_edge_conv_sum_kernel(p, q, nbr, deg)
    launched = ell.last_launch()
    want = ell.ell_edge_conv_sum_plain(p, q, nbr, deg)
    again = ell.ell_edge_conv_sum_kernel(p, q, nbr, deg)
    torch.cuda.synchronize()
    assert ell.ell_edge_conv_sum_kernel.launches == before + 2
    plan = ell.ell_plan(v, h, dtype)
    assert launched == _launched(plan)
    assert _bitwise(got, want) and _bitwise(again, got)
    for groups in range(plan.groups + 1, 4 * plan.groups + 1):
        try:
            split = ell.ell_plan(v, h, dtype, groups=groups)
        except ValueError:
            continue
        out = ell.launch_sum(split, p, q, nbr, deg)
        assert ell.last_launch() == _launched(split)
        torch.cuda.synchronize()
        assert _bitwise(out, want), split


def _fwd_raw(lib_fn, p, q, nbr, deg, out, plan):
    # the sum: no mean degree (a null pointer)
    return lib_fn(p.data_ptr(), q.data_ptr(), nbr.data_ptr(),
                  deg.data_ptr(), 0, out.data_ptr(), p.shape[0], p.shape[1],
                  nbr.shape[1], *ell._plan_args(plan), p.device.index,
                  _cuda.stream_of(p.device))


def _offset_view(t, dev):
    """A copy of t one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [128, 512])
def test_ell_forward_unaligned_views_take_element_loads(dev, h, dtype):
    """p, q and out one element past 16-byte alignment: the wrapper picks
    the element body for p and q, and the launcher takes an unaligned out
    with it; 16-byte loads on such pointers are refused; the bits are the
    plain version's."""
    v, d = 1001, 16
    rng = np.random.default_rng(h + 7)
    p, q, nbr, deg = _forward_case(rng, v, h, d, dtype, dev)
    want = ell.ell_edge_conv_sum_plain(p, q, nbr, deg)
    lib = _cuda.library("ell_edge_conv")
    fn = getattr(lib, f"ell_edge_conv_sum_fwd_{ell._DTYPES[dtype]}")
    plan = ell.ell_plan(v, h, dtype, aligned=False)
    for which in ("p", "q", "out"):
        args = dict(p=p, q=q)
        if which != "out":
            args[which] = _offset_view(args[which], dev)
            got = ell.ell_edge_conv_sum_kernel(args["p"], args["q"], nbr,
                                               deg)
            assert ell.last_launch() == _launched(plan), which
        else:
            got = _offset_view(torch.zeros_like(p), dev)
            assert _fwd_raw(fn, p, q, nbr, deg, got, plan) == 0
            assert _fwd_raw(fn, p, q, nbr, deg, got,
                            plan._replace(vector=True)) == 1
        torch.cuda.synchronize()
        assert _bitwise(got, want), which


def test_ell_forward_launcher_checks_the_plan(dev):
    """The C launcher launches the plan it is given and refuses one that
    does not describe the shapes."""
    v, h, d = 1001, 512, 6
    p = torch.zeros(v, h, dtype=torch.bfloat16, device=dev)
    nbr = torch.zeros(v, d, dtype=torch.int32, device=dev)
    deg = torch.zeros(v, device=dev)
    out = torch.empty_like(p)
    fn = _cuda.library("ell_edge_conv").ell_edge_conv_sum_fwd_bf16
    plan = ell.ell_plan(v, h, torch.bfloat16)
    assert _fwd_raw(fn, p, p, nbr, deg, out, plan) == 0
    torch.cuda.synchronize()
    bad = [plan._replace(lanes=24), plan._replace(lanes=64),
           plan._replace(chunks=0), plan._replace(chunks=3),
           plan._replace(chunks=1),                  # a chunk uncovered
           plan._replace(groups=3),                  # a group left empty
           plan._replace(blocks=plan.blocks + 1),
           plan._replace(blocks=plan.blocks - 1)]
    for pl in bad:
        assert _fwd_raw(fn, p, p, nbr, deg, out, pl) == 1, pl
    odd = torch.zeros(v, 130, dtype=torch.bfloat16, device=dev)
    odd_plan = ell.ell_plan(v, 130, torch.bfloat16)
    assert not odd_plan.vector
    assert _fwd_raw(fn, odd, odd, nbr, deg, torch.empty_like(odd),
                    odd_plan._replace(vector=True)) == 1


def _gradient_case(rng, v, h, d, dtype, dev):
    """p, q, g, nbr, deg, rev, deg_out for K1's dp and dq: NaN, +inf and
    -inf among the elements of all three rows; receivers' degrees past D
    (clamped) and 0 among the rows; a skewed out-degree: most senders
    referenced a few times, a few by a full row of D receivers or past it
    (clamped), some by none."""
    rows = []
    for _ in range(3):
        x = rng.normal(size=(v, h)) * 10.0 ** rng.integers(-2, 3, (v, 1))
        for value in (np.nan, np.inf, -np.inf):
            x[rng.integers(0, v, 3), rng.integers(0, h, 3)] = value
        rows.append(_cuda_t(x.astype(np.float32), dev).to(dtype))
    nbr = rng.integers(0, v, size=(v, d)).astype(np.int32)
    deg = rng.integers(0, d + 4, size=v).astype(np.float32)
    deg[rng.integers(0, v, 8)] = 0
    deg[rng.integers(0, v, 8)] = d + 7
    rev = rng.integers(0, v, size=(v, d)).astype(np.int32)
    deg_out = rng.integers(0, min(d, 8) + 1, size=v).astype(np.float32)
    deg_out[rng.integers(0, v, 8)] = 0
    deg_out[rng.integers(0, v, 4)] = d
    deg_out[rng.integers(0, v, 4)] = d + 7
    return (*rows, *(_cuda_t(a, dev) for a in (nbr, deg, rev, deg_out)))


def _gradients(p, q, g, nbr, deg, rev, deg_out):
    """{kind: (wrapper, plain version, raw launcher, the launcher's
    tensors)} of K1's dp and dq on one case."""
    return {
        "dp": (lambda: ell.ell_edge_conv_dp_kernel(p, q, nbr, deg, g),
               lambda: ell.ell_edge_conv_dp_plain(p, q, nbr, deg, g),
               ell.launch_dp, (p, q, nbr, deg, g)),
        "dq": (lambda: ell.ell_edge_conv_dq_kernel(q, g, p, rev, deg_out),
               lambda: ell.ell_edge_conv_dq_plain(q, g, p, rev, deg_out),
               ell.launch_dq, (q, g, p, rev, deg_out))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [4, 8, 20, 128, 130, 256, 512, 520])
@pytest.mark.parametrize("d", [0, 6, 16, 33, 148])
def test_ell_gradient_rows_bitwise(dev, d, h, dtype):
    """ell_dp_rows and ell_dq_rows against their plain versions, bit for
    bit, at widths of every layout class (1 chunk a lane: a row split
    into twice the forward's groups where the forward holds 2), on V =
    1001 rows, with NaN and +-inf in p, q and g
    (an inf g times a step of 0 is NaN in both), clamped and zero degrees
    and a skewed out-degree up to D; the launch is `ell_plan`'s of its
    kind; twice the same bits; every split of the rows that the plan
    allows gives the same bits too; each wrapper counts one launch a
    call."""
    v = 1001
    rng = np.random.default_rng(h * 1000 + d + 7)
    case = _gradient_case(rng, v, h, d, dtype, dev)
    for kind, (kernel, plain, launch, args) in _gradients(*case).items():
        counter = getattr(ell, f"ell_edge_conv_{kind}_kernel")
        before = counter.launches
        got = kernel()
        launched = ell.last_launch(kind)
        want = plain()
        again = kernel()
        torch.cuda.synchronize()
        assert counter.launches == before + 2, kind
        plan = ell.ell_plan(v, h, dtype, kind=kind)
        assert launched == _launched(plan), kind
        assert _bitwise(got, want) and _bitwise(again, got), kind
        for groups in range(1, 4 * plan.groups + 1):
            try:
                split = ell.ell_plan(v, h, dtype, groups=groups, kind=kind)
            except ValueError:
                continue
            out = launch(split, *args)
            assert ell.last_launch(kind) == _launched(split)
            torch.cuda.synchronize()
            assert _bitwise(out, want), (kind, split)


def _raw(kind, args, out, plan):
    """Call the C launcher of `kind` with `plan` as it stands; its code."""
    fn = getattr(_cuda.library("ell_edge_conv"),
                 ell.launcher_name(kind, args[0].dtype))
    d = args[3 if kind == "dq" else 2].shape[1]
    return fn(*[t.data_ptr() for t in args], out.data_ptr(),
              args[0].shape[0], args[0].shape[1], d, *ell._plan_args(plan),
              args[0].device.index, _cuda.stream_of(args[0].device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [128, 512])
def test_ell_gradients_unaligned_views_take_element_loads(dev, h, dtype):
    """Each of dp's and dq's row operands, and out, one element past
    16-byte alignment: the wrapper picks the element body, the launcher
    takes an unaligned out with it and refuses 16-byte loads on it; the
    bits are the plain version's."""
    v, d = 1001, 16
    rng = np.random.default_rng(h + 11)
    p, q, g, nbr, deg, rev, deg_out = _gradient_case(rng, v, h, d, dtype,
                                                     dev)
    for kind, (_, plain, _, args) in _gradients(
            p, q, g, nbr, deg, rev, deg_out).items():
        want = plain()
        plan = ell.ell_plan(v, h, dtype, aligned=False, kind=kind)
        wrapper = getattr(ell, f"ell_edge_conv_{kind}_kernel")
        for i, row in enumerate(args):
            if row.dim() != 2 or row.dtype != dtype:
                continue
            moved = list(args)
            moved[i] = _offset_view(row, dev)
            got = wrapper(*moved)
            assert ell.last_launch(kind) == _launched(plan), (kind, i)
            torch.cuda.synchronize()
            assert _bitwise(got, want), (kind, i)
        out = _offset_view(torch.zeros_like(args[0]), dev)
        assert _raw(kind, args, out, plan) == 0
        torch.cuda.synchronize()
        assert _bitwise(out, want), kind
        assert _raw(kind, args, out, plan._replace(vector=True)) == 1


@pytest.mark.parametrize("kind", ["dp", "dq"])
def test_ell_gradient_launcher_checks_the_plan(dev, kind):
    """The C launchers of dp and dq launch the plan they are given and
    refuse one that does not describe the shapes."""
    v, h, d = 1001, 512, 6
    z = torch.zeros(v, h, dtype=torch.bfloat16, device=dev)
    idx = torch.zeros(v, d, dtype=torch.int32, device=dev)
    count = torch.zeros(v, device=dev)
    args = ((z, z, idx, count, z) if kind == "dp"
            else (z, z, z, idx, count))
    out = torch.empty_like(z)
    plan = ell.ell_plan(v, h, torch.bfloat16, kind=kind)
    assert _raw(kind, args, out, plan) == 0
    torch.cuda.synchronize()
    assert ell.last_launch(kind) == _launched(plan)
    bad = [plan._replace(lanes=24), plan._replace(lanes=64),
           plan._replace(chunks=0), plan._replace(chunks=3),
           plan._replace(groups=plan.groups + 2),   # groups left empty
           plan._replace(blocks=plan.blocks + 1),
           plan._replace(blocks=plan.blocks - 1)]
    if plan.chunks == 1:
        bad.append(plan._replace(groups=1))           # a chunk uncovered
    else:
        bad.append(plan._replace(chunks=1))
    for pl in bad:
        assert _raw(kind, args, out, pl) == 1, pl
    odd = torch.zeros(v, 130, dtype=torch.bfloat16, device=dev)
    odd_args = tuple(odd if t.dim() == 2 and t.dtype == odd.dtype else t
                     for t in args)
    odd_plan = ell.ell_plan(v, 130, torch.bfloat16, kind=kind)
    assert not odd_plan.vector
    assert _raw(kind, odd_args, torch.empty_like(odd),
                odd_plan._replace(vector=True)) == 1


@pytest.mark.parametrize("v,h,d,halo,tile", [
    (1024, 128, 12, 96, 256), (512, 72, 5, 40, 128),
    (1024, 130, 12, 200, 256),   # window clamped at both ends of V
    (72704, 128, 6, 256, 256), (23680, 256, 6, 192, 128),
    (512, 64, 8, 512, 128)])     # halo past V: the window is all of V
def test_windowed_kernels_bitwise(dev, v, h, d, halo, tile):
    rng = np.random.default_rng(v + h)
    p, q, g, nbr, deg, rev, deg_out = _table_case(
        rng, v, h, d, torch.bfloat16, dev, halo=halo)
    assert windowed.band_violations(nbr, deg, halo, tile) == 0
    assert windowed.band_violations(rev, deg_out, halo, tile) == 0
    before = (windowed.windowed_edge_conv_sum_kernel.launches,
              windowed.windowed_dq_kernel.launches)
    for mode in ("relu", "step"):
        got = windowed.windowed_edge_conv_sum(p, q, nbr, deg, halo, tile,
                                              mode)
        want = windowed.windowed_edge_conv_sum(p, q, nbr, deg, halo, tile,
                                               mode, impl="plain")
        torch.cuda.synchronize()
        assert _bitwise(got, want), mode
    got = windowed.windowed_dq(q, g, p, rev, deg_out, halo, tile)
    want = windowed.windowed_dq(q, g, p, rev, deg_out, halo, tile,
                                impl="plain")
    torch.cuda.synchronize()
    assert _bitwise(got, want)
    assert (windowed.windowed_edge_conv_sum_kernel.launches,
            windowed.windowed_dq_kernel.launches) == (before[0] + 2,
                                                       before[1] + 1)


@pytest.mark.parametrize("v,h,d,halo,tile", [
    (1024, 128, 12, 96, 256),
    (1024, 256, 12, 200, 256),   # window clamped at both ends of V
    (23680, 256, 6, 192, 128),   # the flagship's level 1
    (4096, 512, 6, 96, 256),
    (512, 512, 8, 512, 128),     # halo past V: the window is all of V
    (2048, 256, 8, 384, 128),    # W = 896: 64 channels, 224 KiB, the most
    (4096, 256, 6, 768, 256)])   # W = 1792: the slice halves to 32
def test_windowed_f32_kernel_bitwise(dev, v, h, d, halo, tile):
    """K3b against its plain version and against f32 K1 on the same
    inputs, with deg = 0 rows; then the f32 K3d's forward and backward on
    the card against the plain path's."""
    rng = np.random.default_rng(v + h + halo)
    p, q, g, nbr, deg, rev, deg_out = _table_case(
        rng, v, h, d, torch.float32, dev, halo=halo)
    assert windowed.band_violations(nbr, deg, halo, tile) == 0
    assert int((deg == 0).sum()) > 0
    before = windowed.windowed_edge_conv_sum_f32_kernel.launches
    got = windowed.windowed_edge_conv_sum_f32(p, q, nbr, deg, halo, tile)
    assert windowed.windowed_edge_conv_sum_f32_kernel.launches == before + 1
    want = windowed.windowed_edge_conv_sum_f32(p, q, nbr, deg, halo, tile,
                                               impl="plain")
    k1 = ell.ell_edge_conv_sum_kernel(p, q, nbr, deg)
    torch.cuda.synchronize()
    assert _bitwise(got, want) and _bitwise(got, k1)

    grads = []
    for impl in (None, "plain"):
        pt, qt = p.clone().requires_grad_(), q.clone().requires_grad_()
        out = windowed.WindowedEdgeConvSumF32.apply(
            pt, qt, nbr, rev, deg, deg_out, halo, tile, impl)
        out.backward(g)
        grads.append((out.detach(), pt.grad, qt.grad))
    for a, b in zip(*grads):
        assert _bitwise(a, b)


def _far_edge_tables(v, d, halo, tile, dev, seed):
    """Every slot at w0 or w0 + W - 1 of its tile's clamped window (the
    contract's extremes, wider than graph/build.py's |nbr - v| <= halo band),
    with deg = 0 rows."""
    halo, w = windowed.window_geometry(v, tile, halo)
    rng = np.random.default_rng(seed)
    w0 = np.clip((np.arange(v) // tile) * tile - halo, 0, v - w)
    idx = np.where(rng.random((v, d)) < 0.5, w0[:, None],
                   w0[:, None] + w - 1).astype(np.int32)
    count = rng.integers(0, d + 1, size=v).astype(np.float32)
    return _cuda_t(idx, dev), _cuda_t(count, dev)


def _windowed_all_bitwise(p, q, g, nbr, deg, rev, deg_out, halo, tile):
    """Every windowed kernel of the rows' dtype against its plain version;
    returns last_launch() of each launch."""
    launched = []
    if p.dtype == torch.float32:
        got = windowed.windowed_edge_conv_sum_f32_kernel(p, q, nbr, deg,
                                                         halo, tile)
        launched.append(windowed.last_launch())
        want = ell.ell_edge_conv_sum_plain(p, q, nbr, deg)
        torch.cuda.synchronize()
        assert _bitwise(got, want)
        return launched
    for mode in ("relu", "step"):
        got = windowed.windowed_edge_conv_sum_kernel(p, q, nbr, deg, halo,
                                                     tile, mode)
        launched.append(windowed.last_launch())
        want = windowed.windowed_edge_conv_sum_plain(p, q, nbr, deg, mode)
        torch.cuda.synchronize()
        assert _bitwise(got, want), mode
    got = windowed.windowed_dq_kernel(q, g, p, rev, deg_out, halo, tile)
    launched.append(windowed.last_launch())
    want = ell.ell_edge_conv_dq_plain(q, g, p, rev, deg_out)
    torch.cuda.synchronize()
    assert _bitwise(got, want), "dq"
    return launched


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("v,h,d,halo,tile", [
    (1024, 128, 12, 96, 256), (512, 256, 8, 100, 128),
    (72704, 128, 6, 256, 256), (23680, 256, 6, 192, 128)])
def test_windowed_kernels_take_far_edge_slots(dev, v, h, d, halo, tile,
                                              dtype):
    """Slots at the far edges of the clamped windows of every tile, the
    first and last included: computed, not trapped."""
    rng = np.random.default_rng(v + h + 7)
    p, q, g, _, _, _, _ = _table_case(rng, v, h, 1, dtype, dev)
    nbr, deg = _far_edge_tables(v, d, halo, tile, dev, seed=v)
    rev, deg_out = _far_edge_tables(v, d + 2, halo, tile, dev, seed=v + 1)
    assert windowed.band_violations(nbr, deg, halo, tile) == 0
    assert windowed.band_violations(rev, deg_out, halo, tile) == 0
    _windowed_all_bitwise(p, q, g, nbr, deg, rev, deg_out, halo, tile)


def test_windowed_launch_is_window_plan_and_strips_end_at_v(dev):
    """The library launches window_plan's layout (grid, shared memory,
    slice, stage, ring, strip) with TMA on aligned rows; the flagship's
    level 0 has a last strip shorter than the others, ending at V; two
    calls give the same bits."""
    v, h, d, halo, tile = 72704, 128, 6, 256, 256
    rng = np.random.default_rng(11)
    p, q, g, nbr, deg, rev, deg_out = _table_case(
        rng, v, h, d, torch.bfloat16, dev, halo=halo)
    launched = _windowed_all_bitwise(p, q, g, nbr, deg, rev, deg_out, halo,
                                     tile)
    for got, arrays, table in zip(launched, (1, 1, 2), (nbr, nbr, rev)):
        plan = windowed.launch_plan(q, halo, tile, arrays, table.shape[1])
        assert got == dict(strips=plan.strips, slices=plan.slices,
                           threads=windowed.BLOCK_THREADS, smem=plan.smem,
                           cs=plan.cs, sub=plan.sub, ring=plan.ring,
                           bufs=plan.bufs, buf_rows=plan.buf_rows,
                           strip_tiles=plan.strip_tiles, tma=1)
        assert (v // tile) % plan.strip_tiles != 0   # a short last strip
    for call in (
            lambda: windowed.windowed_edge_conv_sum_kernel(
                p, q, nbr, deg, halo, tile, "relu"),
            lambda: windowed.windowed_dq_kernel(q, g, p, rev, deg_out, halo,
                                                tile)):
        a, b = call(), call()
        torch.cuda.synchronize()
        assert _bitwise(a, b)


@pytest.mark.parametrize("case", ["h130", "unaligned"])
def test_windowed_ring_filled_by_ordinary_loads(dev, case):
    """Rows a tensor map cannot take (a 260-byte row stride; a base one
    element past 16-byte alignment) fill the same ring by ordinary loads."""
    v, d, halo, tile = 1024, 12, 200, 256
    h = 130 if case == "h130" else 128
    rng = np.random.default_rng(v + h + 3)
    for dtype in (torch.bfloat16, torch.float32):
        p, q, g, nbr, deg, rev, deg_out = _table_case(
            rng, v, h, d, dtype, dev, halo=halo)
        if case == "unaligned":
            buf = torch.empty(v * h + 1, dtype=dtype, device=dev)
            buf[1:].view(v, h).copy_(q)
            q = buf[1:].view(v, h)
            buf2 = torch.empty(v * h + 1, dtype=dtype, device=dev)
            buf2[1:].view(v, h).copy_(g)
            g = buf2[1:].view(v, h)
        launched = _windowed_all_bitwise(p, q, g, nbr, deg, rev, deg_out,
                                         halo, tile)
        assert all(x["tma"] == 0 for x in launched), launched


def test_windowed_launcher_checks_the_plan(dev):
    """The C launcher takes the plan as given and refuses one that does not
    describe the shapes or does not fit a block."""
    v, h, halo, tile = 1024, 128, 96, 256
    p = torch.zeros(v, h, dtype=torch.bfloat16, device=dev)
    nbr = torch.zeros(v, 4, dtype=torch.int32, device=dev)
    deg = torch.zeros(v, device=dev)
    plan = windowed.launch_plan(p, halo, tile, 1, 4)
    lib = _cuda.library("windowed_edge_conv")

    def rc(pl):
        return lib.windowed_edge_conv_sum_bf16(
            p.data_ptr(), p.data_ptr(), nbr.data_ptr(), deg.data_ptr(), 0, 0,
            p.data_ptr(), v, h, 4, *windowed._plan_args(pl), 0, dev.index,
            _cuda.stream_of(dev))

    assert rc(plan) == 0
    torch.cuda.synchronize()
    bad_value = [plan._replace(ring=plan.w - plan.sub),
                 plan._replace(sub=plan.sub * 3),
                 plan._replace(cs=24),
                 plan._replace(strips=plan.strips + 1),
                 plan._replace(bufs=0),
                 plan._replace(buf_rows=3),
                 plan._replace(smem=plan.smem + 16)]
    for pl in bad_value:
        assert rc(pl) == 1, pl   # cudaErrorInvalidValue
    big = plan._replace(cs=64, ring=2048)
    big = big._replace(smem=windowed._smem(1, 2048, 64, 2, big.sub,
                                           big.bufs, big.buf_rows, 4))
    assert rc(big) == 9   # cudaErrorInvalidConfiguration


def test_windowed_kernels_reject_what_they_do_not_take(dev):
    p = torch.zeros(256, 128, dtype=torch.bfloat16, device=dev)
    nbr = torch.zeros(256, 4, dtype=torch.int32, device=dev)
    deg = torch.zeros(256, device=dev)
    with pytest.raises(TypeError):
        windowed.windowed_edge_conv_sum_kernel(p.float(), p.float(), nbr,
                                               deg, 32, 128)
    with pytest.raises(ValueError):
        windowed.windowed_edge_conv_sum_kernel(p, p, nbr, deg, 32, 96)
    with pytest.raises(TypeError):   # K3b takes f32 rows only
        windowed.windowed_edge_conv_sum_f32_kernel(p, p, nbr, deg, 32, 128)
    with pytest.raises(RuntimeError):   # a window taller than shared memory
        big = torch.zeros(65536, 8, dtype=torch.bfloat16, device=dev)
        windowed.windowed_dq_kernel(
            big, big, big, torch.zeros(65536, 2, dtype=torch.int32,
                                       device=dev),
            torch.zeros(65536, device=dev), 65536, 256)


def test_bf16_train_step_kernel_path_matches_plain_path(dev):
    """One bf16 step on a windowed scene: every kernel of the path runs,
    and the loss equals the plain path's from the same weights."""
    args = dict(input_nc=10, output_nc=3, ngf=64,
                filter_type="edgeconvtransinv", norm="instance", n_blocks=2,
                dilations=[1, 2], pooling_type="max", dtype="bfloat16",
                checkpoint_bottleneck=True)
    graph = build_hierarchical_graph(
        [synthetic_scene(4096, levels=3, seed=2, dilation_dists=(2,))],
        geometric=True, windowed=True)
    g = PackedPlacer(dev)(graph)
    losses = []
    for impl in (None, "plain"):
        model = define_G(**args, generator=torch.Generator().manual_seed(0))
        model = model.to(dev)
        opt, lr = gc.build_optimizer(model.parameters(),
                                     {"type": "Adam", "args": {
                                         "lr": 7e-5, "amsgrad": True}})
        step, _ = gc.make_inpainting_steps(model, opt, True, impl=impl)
        before = windowed.windowed_dq_kernel.launches
        losses.append(float(step(g, lr)["loss"]))
        assert (windowed.windowed_dq_kernel.launches > before) == (
            impl is None)
    assert np.isfinite(losses).all()
    assert abs(losses[0] - losses[1]) <= 1e-3 * abs(losses[1])


def test_iter_placed_never_refills_a_buffer_a_pending_step_reads(dev):
    """Batches of one shape through a ring of 3 slots, each read by a step
    that first sleeps on the stream (about 10 ms): the placing thread runs
    ahead of the card, and every batch still reads back as its host graph.
    Stopping early ends the placing thread."""
    import dataclasses
    import threading
    base = build_hierarchical_graph([synthetic_scene(
        num_vertices=4096, levels=3, seed=0, dilation_dists=(2,))])
    graphs = [dataclasses.replace(base, x=base.x + i) for i in range(9)]
    read = []
    batches = [(g, [str(i)]) for i, g in enumerate(graphs)]
    for graph, names in gc.iter_placed(batches, dev, slots=3):
        torch.cuda._sleep(20_000_000)
        read.append((names, graph.x.clone(),
                     graph.levels[0].edges.nbr.clone()))
    torch.cuda.synchronize()
    assert [n for n, _, _ in read] == [[str(i)] for i in range(9)]
    for (_, x, nbr), g in zip(read, graphs):
        assert torch.equal(x.cpu(), g.x)
        assert torch.equal(nbr.cpu(), g.levels[0].edges.nbr)

    threads = threading.active_count()
    it = gc.iter_placed(batches, dev, slots=3)
    next(it)
    it.close()
    for _ in range(50):
        if threading.active_count() <= threads:
            break
        time.sleep(0.1)
    assert threading.active_count() <= threads


@pytest.mark.parametrize("pool", ["mean", "max"])
def test_singleconvmeshnet_on_the_card_matches_the_cpu(dev, pool):
    """SingleConvMeshNet (no kernel of its own: torch ops only) in a
    checkpointed train forward and its backward, on the card and on the
    CPU from the same weights, in float64: logits and every parameter
    gradient within 1e-9 of their largest, running statistics within
    1e-12. In f32 a relu argument within rounding of 0 can take the other
    branch on the other device and move a gradient by a whole row's
    contribution (CPU f32 against f64 at this size: 1.5% of the largest
    gradient); in f64 none does."""
    import dataclasses
    from stinet_tpu_torch.models.singleconvmeshnet import SingleConvMeshNet
    scene = synthetic_scene(num_vertices=4096, levels=3, seed=5,
                            dilation_dists=())
    host = build_hierarchical_graph([scene])
    rng = np.random.default_rng(0)
    host = dataclasses.replace(host, x=torch.from_numpy(
        rng.normal(size=(host.x.shape[0], 9))))
    r = torch.from_numpy(rng.normal(size=(host.x.shape[0], 21)))
    models, outs = [], []
    for device in ("cpu", dev):
        model = SingleConvMeshNet(
            9, 2, [8, 16, 32], pooling_method=pool, aggr=pool,
            generator=torch.Generator().manual_seed(3)).double().to(device)
        model.train()
        out = model(host.to(device))
        (out * r.to(device)).sum().backward()
        models.append(model)
        outs.append(out.detach().cpu())
    scale = float(outs[0].abs().max())
    assert float((outs[1] - outs[0]).abs().max()) <= 1e-9 * scale
    grads = {k: p.grad for k, p in models[0].named_parameters()}
    g_max = max(float(g.abs().max()) for g in grads.values())
    for k, p in models[1].named_parameters():
        assert p.is_cuda
        d = float((p.grad.cpu() - grads[k]).abs().max())
        assert d <= 1e-9 * g_max, (k, d, g_max)
    want = models[0].state_dict()
    moved = 0
    for k, b in models[1].state_dict().items():
        if "running" in k:
            assert b.is_cuda
            np.testing.assert_allclose(b.cpu().numpy(), want[k].numpy(),
                                       rtol=0, atol=1e-12, err_msg=k)
            moved += not torch.equal(want[k], torch.zeros_like(want[k])) \
                and not torch.equal(want[k], torch.ones_like(want[k]))
    assert moved == sum("running" in k for k in want)


# --- the 2D workload's perceptual nets and train step -------------------------

def test_lpips_on_the_card_matches_the_cpu(dev):
    """LPIPS(alex) with random features, with and without heads, on the
    card with TF32 off against the CPU: within 1e-4 relative."""
    from stinet_tpu_torch.metrics.lpips import LPIPS, random_lpips
    from stinet_tpu_torch.serving import full_f32_matmuls
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-1, 1, (3, 64, 64, 3)).astype(
        np.float32))
    y = torch.roll(x, 5, dims=1)
    base = random_lpips(torch.Generator().manual_seed(1))
    heads = LPIPS([rng.uniform(0, 1, c) for c in (64, 192, 384, 256, 256)])
    heads.alex.load_state_dict(base.alex.state_dict())
    for model in (base, heads):
        with torch.no_grad():
            want = model(x, y)
            with full_f32_matmuls():
                got = model.to(dev)(x.to(dev), y.to(dev)).cpu()
        assert float(((got - want).abs() / want.abs()).max()) <= 1e-4


def test_inception_on_the_card_matches_the_cpu(dev):
    """InceptionV3 with random features, resized 32 -> 299, on the card with
    TF32 off against the CPU: pool3 within 1e-4 of the largest feature."""
    from stinet_tpu_torch.models.inception import InceptionV3
    from stinet_tpu_torch.serving import full_f32_matmuls
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (2, 32, 32, 3)).astype(np.float32))
    model = InceptionV3(generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = model(x)
        with full_f32_matmuls():
            got = model.to(dev)(x.to(dev)).cpu()
    assert got.shape == (2, 2048)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_2d_train_step_on_the_card_matches_the_cpu(dev):
    """One 2D train step (edgeconv STINet over a B=2 grid batch, LPIPS in
    its metrics) on the card's kernel path and on the CPU's plain path from
    the same weights: f32 K1, dp, dq and multi-graph K2 launched on the
    card; the loss and every metric within 1e-4 relative; every
    parameter's gradient, taken together as one vector, within 1e-4 of its
    L2 norm (element by element an f32 relu or max pool within rounding of
    a tie may send a gradient element the other way)."""
    from stinet_tpu_torch.data.imagegraph import ImageGraphTextureDataLoader
    from stinet_tpu_torch.metrics.lpips import random_lpips
    from stinet_tpu_torch.trainers.inpainting2d import make_inpainting2d_steps
    loader = ImageGraphTextureDataLoader(dict(
        root_dir="", img_size=32, end_level=3, train_batch_size=2,
        test_batch_size=1, crop_half_width=4, circle_radius=5,
        random_mask=True, random_augmentation=True))
    graph, _ = next(iter(loader.train_loader))
    args = dict(input_nc=4, output_nc=3, ngf=16, filter_type="edgeconv",
                norm="instance", n_blocks=2, dilations=[1, 1], n_levels=2,
                pooling_type="max")
    counters = (ell.ell_edge_conv_sum_kernel, ell.ell_edge_conv_dp_kernel,
                ell.ell_edge_conv_dq_kernel)
    results, grads = [], []
    for device in (dev, torch.device("cpu")):
        model = define_G(**args, generator=torch.Generator().manual_seed(0))
        model = model.to(device)
        opt, lr = gc.build_optimizer(model.parameters(), {
            "type": "Adam", "args": {"lr": 1.4e-4, "amsgrad": True}})
        lpips = random_lpips(torch.Generator().manual_seed(1)).to(device)
        step, _ = make_inpainting2d_steps(model, opt, 32, lpips=lpips)
        before = [k.launches for k in counters] + [
            norms.masked_instance_norm_kernel.multigraph_launches]
        results.append(gc.host_metrics(step(graph.to(device), lr)))
        after = [k.launches for k in counters] + [
            norms.masked_instance_norm_kernel.multigraph_launches]
        assert all(a > b for a, b in zip(after, before)) == (
            device.type == "cuda")
        grads.append({n: p.grad.detach().cpu().double()
                      for n, p in model.named_parameters()})
    got, want = results
    assert sorted(got) == sorted(want) and "lpips" in got
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), k
    assert sorted(grads[0]) == sorted(grads[1])
    diff = sum(float((grads[0][k] - g).norm()) ** 2
               for k, g in grads[1].items()) ** 0.5
    norm = sum(float(g.norm()) ** 2 for g in grads[1].values()) ** 0.5
    assert norm > 0 and diff <= 1e-4 * norm, (diff, norm)


def test_vgg_loss_on_the_card_matches_the_cpu(dev):
    """The VGG16 content and style terms and their gradient with respect to
    the prediction, random features, on the card against the CPU in
    float64: within 1e-9 relative (the gradient: of its largest). In f32 a
    max pool's near tie or a relu argument within rounding of 0 routes a
    gradient element otherwise on the other device (measured on an H100:
    7.4e-3 of the largest); in f64 none does."""
    from stinet_tpu_torch.models.vgg import VGGLoss, random_vgg
    rng = np.random.default_rng(5)
    pred = rng.uniform(-1, 1, (2, 64, 64, 3))
    target = np.roll(pred, 3, axis=2)
    loss = VGGLoss(random_vgg(torch.Generator().manual_seed(3)),
                   resize_to=96).double()
    out = []
    for device in ("cpu", dev):
        p = torch.from_numpy(pred).to(device).requires_grad_(True)
        content, style = loss.to(device)(p,
                                         torch.from_numpy(target).to(device))
        (content + 100.0 * style).backward()
        out.append((content.item(), style.item(), p.grad.cpu()))
    (c0, s0, g0), (c1, s1, g1) = out
    assert abs(c1 - c0) <= 1e-9 * abs(c0) and abs(s1 - s0) <= 1e-9 * abs(s0)
    assert float((g1 - g0).abs().max()) <= 1e-9 * float(g0.abs().max())


# --- the 2D workload's Resnet2D branch and PatchGAN ---------------------------

def _f64_card_against_cpu(dev, make, x, r):
    """`make()`'s module in float64 and train mode, forward and the backward
    of sum(out * r), on the CPU and on the card from the same weights:
    (outputs, {parameter: gradient}, state dicts), each a (cpu, card)
    pair on the host."""
    outs, grads, states = [], [], []
    for device in ("cpu", dev):
        model = make().double().to(device).train()
        out = model(torch.from_numpy(x).to(device))
        (out * torch.from_numpy(r).to(device)).sum().backward()
        assert all(p.is_cuda == (device != "cpu") for p in model.parameters())
        outs.append(out.detach().cpu())
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
        states.append({k: v.cpu() for k, v in model.state_dict().items()})
    return outs, grads, states


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_resnet2d_on_the_card_matches_the_cpu(dev, norm):
    """Resnet2D (cuDNN convolutions; no kernel of the port's own) in float64
    on the card against the CPU: the output and every parameter gradient
    within 1e-9 of their largest, batch norm's running statistics within
    1e-12 (in f32 a max pool's near tie may route a gradient element
    otherwise on the other device; in f64 none does)."""
    from stinet_tpu_torch.models.resnet2d import Resnet2D
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 4, 32, 32))
    r = rng.normal(size=(2, 3, 32, 32))
    outs, grads, states = _f64_card_against_cpu(dev, lambda: Resnet2D(
        4, ngf=8, n_blocks=3, norm=norm, dilation_order=1,
        pooling_type="max", io_receptive_field_type="normal",
        generator=torch.Generator().manual_seed(2)), x, r)
    assert float((outs[1] - outs[0]).abs().max()) <= 1e-9 * float(
        outs[0].abs().max())
    g_max = max(float(g.abs().max()) for g in grads[0].values())
    for k, g in grads[0].items():
        assert float((grads[1][k] - g).abs().max()) <= 1e-9 * g_max, k
    running = [k for k in states[0] if "running" in k]
    assert bool(running) == (norm == "batch")
    for k in running:
        assert float((states[1][k] - states[0][k]).abs().max()) <= 1e-12, k


def test_nlayer_discriminator_on_the_card_matches_the_cpu(dev):
    """The PatchGAN discriminator (5 layers, instance norm) in float64 on
    the card against the CPU: output and gradients within 1e-9 of their
    largest."""
    from stinet_tpu_torch.models.gan_networks import NLayerDiscriminator
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 7, 96, 96))
    r = rng.normal(size=(2, 1, 1, 1))
    outs, grads, _ = _f64_card_against_cpu(dev, lambda: NLayerDiscriminator(
        7, ndf=8, n_layers=5, norm="instance",
        generator=torch.Generator().manual_seed(3)), x, r)
    assert outs[0].shape == (2, 1, 1, 1)
    assert float((outs[1] - outs[0]).abs().max()) <= 1e-9 * float(
        outs[0].abs().max())
    g_max = max(float(g.abs().max()) for g in grads[0].values())
    for k, g in grads[0].items():
        assert float((grads[1][k] - g).abs().max()) <= 1e-9 * g_max, k


def test_gan_step_on_the_card_matches_the_cpu(dev):
    """One GAN step of the 2d branch (Resnet2D and the PatchGAN, LPIPS and
    total variation in it) on the card and on the CPU from the same
    weights, f32 with TF32 off: every metric within 1e-4 relative; G's and
    D's gradients, each taken as one vector, within 1e-4 of its L2 norm."""
    from stinet_tpu_torch.data.imagegraph import ImageGraphTextureDataLoader
    from stinet_tpu_torch.metrics.lpips import random_lpips
    from stinet_tpu_torch.models.factory import define_D
    from stinet_tpu_torch.trainers.inpainting2d import make_resnet2d_steps
    loader = ImageGraphTextureDataLoader(dict(
        root_dir="", img_size=32, end_level=3, train_batch_size=2,
        test_batch_size=1, crop_half_width=4, circle_radius=5,
        random_mask=True, random_augmentation=True))
    graph, _ = next(iter(loader.train_loader))
    args = dict(input_nc=4, output_nc=3, ngf=16, filter_type="conv2d",
                norm="instance", n_blocks=2, dilation_order=1,
                pooling_type="max", io_receptive_field_type="normal")
    opt_cfg = {"type": "Adam", "args": {"lr": 1.4e-4, "amsgrad": True}}
    results, grads = [], []
    for device in (dev, torch.device("cpu")):
        model = define_G(**args, generator=torch.Generator().manual_seed(0))
        disc = define_D(7, 8, "n_layers", n_layers_D=2, norm="instance",
                        generator=torch.Generator().manual_seed(1))
        model, disc = model.to(device), disc.to(device)
        opt, lr = gc.build_optimizer(model.parameters(), opt_cfg)
        dopt, _ = gc.build_optimizer(disc.parameters(), opt_cfg)
        lpips = random_lpips(torch.Generator().manual_seed(1)).to(device)
        step, _ = make_resnet2d_steps(model, opt, 32, lpips=lpips,
                                      tv_weight=1e-4, disc=disc,
                                      disc_optimizer=dopt)
        results.append(gc.host_metrics(step(graph.to(device), lr)))
        grads.append({net: {n: p.grad.detach().cpu().double()
                            for n, p in m.named_parameters()}
                      for net, m in (("G", model), ("D", disc))})
    got, want = results
    assert sorted(got) == sorted(want) and "loss_D_fake" in got
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), k
    for net in ("G", "D"):
        a, b = grads[0][net], grads[1][net]
        diff = sum(float((a[k] - g).norm()) ** 2 for k, g in b.items()) ** .5
        norm = sum(float(g.norm()) ** 2 for g in b.values()) ** 0.5
        assert norm > 0 and diff <= 1e-4 * norm, (net, diff, norm)


# --- the rest of the STINet model: SageConv, labels, reference checkpoints ---

VARIANTS = {
    "sageconv": dict(filter_type="sageconvtransinv"),
    "labels": dict(filter_type="edgeconvtransinv", use_label_embedding=True,
                   num_classes=21, num_embedding=12)}


def _variant_case(variant):
    args = dict(input_nc=10, output_nc=3, ngf=16, norm="instance",
                n_blocks=2, dilations=[1, 2], pooling_type="max",
                **VARIANTS[variant])
    scene = synthetic_scene(num_vertices=4096, levels=3, seed=4,
                            dilation_dists=(2,))
    labels = np.random.default_rng(4).integers(0, 21, size=4096)
    scene = dataclasses.replace(scene, labels=labels)
    return args, build_hierarchical_graph([scene], geometric=True)


def _variant_grads(args, graph, device, dtype, impl):
    from stinet_tpu_torch.graph.hierarchy import map_tensors
    model = define_G(**args, generator=torch.Generator().manual_seed(1))
    model = model.to(device, dtype).train()
    g = map_tensors(graph.to(device), lambda t: t.to(dtype)
                    if t.is_floating_point() else t)
    out = model(g, impl=impl)
    loss, _ = gc.inpainting_loss(out, g.color, g.mask, gc.vertex_mask(g),
                                 True)
    loss.backward()
    return (out.detach().cpu().double(), loss.item(),
            {k: p.grad.cpu().double() for k, p in model.named_parameters()})


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_variant_on_the_card_matches_the_cpu(dev, variant):
    """The SageConv and the label-embedded STINet in a train forward and
    its backward, on the card (kernel path, f32) and on the CPU from the
    same weights: outputs within 1e-4; in f64 (the card's plain path: the
    kernels take f32 and bf16) the loss within 1e-10 relative and the
    gradients, as one vector, within 1e-10 of their L2 norm. SageConv
    launches no K1, the label-embedded model does; both launch K2."""
    args, graph = _variant_case(variant)
    before = (ell.ell_edge_conv_sum_kernel.launches,
              norms.masked_instance_norm_kernel.launches)
    card, _, _ = _variant_grads(args, graph, dev, torch.float32, None)
    k1 = ell.ell_edge_conv_sum_kernel.launches - before[0]
    k2 = norms.masked_instance_norm_kernel.launches - before[1]
    assert (k1 > 0) == (variant == "labels") and k2 > 0
    cpu, _, _ = _variant_grads(args, graph, "cpu", torch.float32, None)
    assert float((card - cpu).abs().max()) <= 1e-4
    (_, l_card, g_card), (_, l_cpu, g_cpu) = (
        _variant_grads(args, graph, d, torch.float64, "plain")
        for d in (dev, "cpu"))
    assert abs(l_card - l_cpu) <= 1e-10 * abs(l_cpu)
    diff = sum(float((g_card[k] - g).norm()) ** 2 for k, g in g_cpu.items())
    norm = sum(float(g.norm()) ** 2 for g in g_cpu.values())
    assert diff ** 0.5 <= 1e-10 * norm ** 0.5


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_variant_step_kernel_path_matches_plain_path(dev, variant):
    """One Adam step of each variant on the card: the kernel path's loss
    within 1e-3 of the plain path's, the served prediction of its weights
    finite."""
    from stinet_tpu_torch.serving import SceneInpainter
    args, graph = _variant_case(variant)
    g = PackedPlacer(dev)(graph)
    losses = []
    for impl in (None, "plain"):
        model = define_G(**args, generator=torch.Generator().manual_seed(0))
        model = model.to(dev)
        opt, lr = gc.build_optimizer(model.parameters(), {
            "type": "Adam", "args": {"lr": 7e-5, "amsgrad": True}})
        step, _ = gc.make_inpainting_steps(model, opt, True, impl=impl)
        losses.append(float(step(g, lr)["loss"]))
    assert np.isfinite(losses).all()
    assert abs(losses[0] - losses[1]) <= 1e-3 * abs(losses[1])
    scene = synthetic_scene(num_vertices=4096, levels=3, seed=4,
                            dilation_dists=(2,))
    scene = dataclasses.replace(scene, labels=np.zeros(4096, np.int64))
    out = SceneInpainter(model, model.state_dict(), device=dev).predict(
        scene)
    assert out.shape == (4096, 3) and np.isfinite(out).all()


def test_reference_checkpoint_serves_as_its_source(dev, tmp_path):
    """The flagship's weights saved in the reference's layout, read back by
    `load_reference_state_dict` and served on the card: the served weights
    bit for bit the source model's, the prediction within 1e-5 of the
    source server's (the forward's scatter adds are atomic on the card,
    so two predicts of one server differ in the last bits)."""
    from stinet_tpu_torch.models.factory import FLAGSHIP
    from stinet_tpu_torch.serving import SceneInpainter
    from stinet_tpu_torch.utils.convert_reference_checkpoint import (
        load_reference_state_dict)
    model = define_G(**FLAGSHIP, generator=torch.Generator().manual_seed(0))
    path = tmp_path / "model_best.pth"
    torch.save({"state_dicts": {"graph": model.state_dict()}}, path)
    scene = synthetic_scene(num_vertices=4096, levels=3, seed=0,
                            dilation_dists=(2, 4, 8, 16))
    want = SceneInpainter(model, model.state_dict(), device=dev).predict(
        scene)
    server = SceneInpainter(define_G(**FLAGSHIP), load_reference_state_dict(
        path), device=dev)
    for k, v in model.state_dict().items():
        assert torch.equal(server.model.state_dict()[k].cpu(), v), k
    assert float(np.abs(server.predict(scene) - want).max()) <= 1e-5


def test_texture_optimization_on_the_card_matches_the_cpu(dev):
    """estimate_vertex_colors and five rigid_optimize iterations on the
    card against the CPU, on a seeded room of 4096 vertices seen by 8
    z-buffered frames of 160 x 120: the visibility tests equal, colors
    within 1e-4, the residual history within rtol 1e-4, the deltas within
    1e-6 (a hundredth of the rate), frame 0 anchored."""
    from stinet_tpu_torch.preprocessing import texture_optimization as tex
    from stinet_tpu_torch.utils import synthetic_sensor as ss
    v, f, _ = ss.room_mesh(4096, seed=1)
    intr, w, h = (577.87 / 4, 577.87 / 4, 79.5, 59.5), 160, 120
    poses = ss.look_down_poses(8, seed=1)
    colors, depths = ss.sensor_frames(v, f, poses, intr, w, h)
    noisy = ss.perturb_poses(poses, 0.01, 0.01, seed=2)
    zero = np.zeros((8, 6), np.float32)
    got, gw = tex.estimate_vertex_colors(
        *tex._tensors(dev, v, noisy, zero), intr,
        *tex._tensors(dev, colors, depths), w, h)
    want, ww = tex.estimate_vertex_colors(
        *tex._tensors("cpu", v, noisy, zero), intr,
        *tex._tensors("cpu", colors, depths), w, h)
    assert torch.equal(gw.cpu(), ww) and ww.sum() > 0
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    g = tex.rigid_optimize(*tex._tensors(dev, v, noisy), intr,
                           *tex._tensors(dev, colors, depths), w, h,
                           iters=5, lr=1e-4)
    c = tex.rigid_optimize(v, noisy, intr, colors, depths, w, h, iters=5,
                           lr=1e-4)
    np.testing.assert_allclose(g[2], c[2], rtol=1e-4)
    np.testing.assert_allclose(g[1], c[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(g[0], c[0], rtol=0, atol=1e-4)
    assert not g[1][0].any()


# --- graph-partition serving: K1 over the local-plus-halo sender space -------

PART_TINY = dict(input_nc=10, output_nc=3, ngf=8, n_blocks=3,
                 dilations=[1, 2, 4], norm="instance", pooling_type="max",
                 n_levels=2, n_repeated_io_convs=1,
                 filter_type="edgeconvtransinv")


@pytest.mark.parametrize("n_parts", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_kernel_on_the_halo_layout_bitwise(dev, n_parts, dtype):
    """K1 with q of Vp + S*W rows (more than p's) and nbr in the
    local-plus-halo space of every partition's every edge set, as
    `predict_partitioned` launches it: bit for bit the plain version."""
    from stinet_tpu_torch.graph.partition import partition_hierarchy, shard
    scene = synthetic_scene(num_vertices=3000, levels=3, seed=5,
                            dilation_dists=(2, 4))
    pg, _ = partition_hierarchy(scene, n_parts)
    rng = np.random.default_rng(n_parts)
    for lv in pg.levels:
        for es in [lv.edges, *lv.dilated.values()]:
            for p in range(n_parts):
                e = shard(es, p, n_parts)
                vp, h = e.nbr_halo.shape[0], 64
                ext = vp + e.send_idx.shape[1] * e.send_idx.shape[2]
                pt = _cuda_t(rng.normal(size=(vp, h)), dev).to(dtype)
                qt = _cuda_t(rng.normal(size=(ext, h)), dev).to(dtype)
                nbr, deg = _cuda_t(e.nbr_halo, dev), _cuda_t(e.degree, dev)
                assert qt.shape[0] > pt.shape[0] or n_parts == 1
                got = ell.ell_edge_conv_sum_kernel(pt, qt, nbr, deg)
                want = ell.ell_edge_conv_sum_plain(pt, qt, nbr, deg)
                torch.cuda.synchronize()
                view = torch.int16 if dtype == torch.bfloat16 else torch.int32
                assert torch.equal(got.view(view), want.view(view))


@pytest.mark.parametrize("n_parts", [1, 2, 4])
def test_predict_partitioned_on_the_card_matches_the_cpu(dev, n_parts):
    """The in-process mesh on the card (K1 launched on the halo layout)
    against the same mesh on the CPU's plain versions, and against the
    card's own `predict`, within 1e-5 (the card's scatter adds are atomic
    and sums run in other orders)."""
    from stinet_tpu_torch.parallel.mesh import make_mesh
    from stinet_tpu_torch.serving import SceneInpainter
    scene = synthetic_scene(num_vertices=3000, levels=3, seed=5,
                            dilation_dists=(2, 4))
    model = define_G(**PART_TINY, generator=torch.Generator().manual_seed(2))
    sd = model.state_dict()
    card = SceneInpainter(model, sd, device=dev, mesh=make_mesh(n_parts, dev))
    from stinet_tpu_torch.models.stinet import EdgeConvFilter
    convs = sum(isinstance(m, EdgeConvFilter) for m in model.modules())
    before = ell.ell_edge_conv_sum_kernel.launches
    got = card.predict_partitioned(scene)
    assert ell.ell_edge_conv_sum_kernel.launches - before == convs * n_parts
    cpu = SceneInpainter(model, sd, device="cpu",
                         mesh=make_mesh(n_parts, "cpu"))
    np.testing.assert_allclose(got, cpu.predict_partitioned(scene),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, card.predict(scene), rtol=0, atol=1e-5)


# --- partitioned training: K1's dp and dq on ragged rows -----------------------

@pytest.mark.parametrize("halo", [1, 37, 300, 4100])
@pytest.mark.parametrize("h", [64, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dp_dq_kernels_on_ragged_rows_bitwise(dev, dtype, h, halo):
    """dp and dq with q of V + halo rows (more than p and g), nbr over q's
    rows and the reverse tables over q's rows, as partitioned training
    launches them: bit for bit the plain versions, dq shaped as q."""
    rng = np.random.default_rng(halo + h)
    v, d = 900, 7
    vq = v + halo
    p = _cuda_t(rng.normal(size=(v, h)), dev).to(dtype)
    g = _cuda_t(rng.normal(size=(v, h)), dev).to(dtype)
    q = _cuda_t(rng.normal(size=(vq, h)), dev).to(dtype)
    nbr_np = rng.integers(0, vq, size=(v, d)).astype(np.int32)
    deg_np = rng.integers(0, d + 1, size=v)
    rev = [[] for _ in range(vq)]
    for r in range(v):
        for s in nbr_np[r, :deg_np[r]]:
            rev[s].append(r)
    dr = max(1, max(len(x) for x in rev))
    rev_np = np.zeros((vq, dr), np.int32)
    for s, x in enumerate(rev):
        rev_np[s, :len(x)] = x
    nbr, deg = _cuda_t(nbr_np, dev), _cuda_t(deg_np.astype(np.float32), dev)
    rev_dst = _cuda_t(rev_np, dev)
    dout = _cuda_t(np.asarray([len(x) for x in rev], np.float32), dev)
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    before = (ell.ell_edge_conv_dp_kernel.launches,
              ell.ell_edge_conv_dq_kernel.launches)
    dp = ell.ell_edge_conv_dp_kernel(p, q, nbr, deg, g)
    dq = ell.ell_edge_conv_dq_kernel(q, g, p, rev_dst, dout)
    want_dp = ell.ell_edge_conv_dp_plain(p, q, nbr, deg, g)
    want_dq = ell.ell_edge_conv_dq_plain(q, g, p, rev_dst, dout)
    torch.cuda.synchronize()
    assert dp.shape == p.shape and dq.shape == q.shape
    assert torch.equal(dp.view(view), want_dp.view(view))
    assert torch.equal(dq.view(view), want_dq.view(view))
    assert (ell.ell_edge_conv_dp_kernel.launches,
            ell.ell_edge_conv_dq_kernel.launches) == (before[0] + 1,
                                                      before[1] + 1)
    with pytest.raises(ValueError):     # g must have p's rows
        ell.ell_edge_conv_dp_kernel(p, q, nbr, deg, q)
    with pytest.raises(ValueError):     # the reverse tables have q's rows
        ell.ell_edge_conv_dq_kernel(q, g, p, rev_dst[:v], dout[:v])


@pytest.mark.parametrize("n_parts", [1, 2])
def test_partitioned_train_step_on_the_card_matches_the_cpu(dev, n_parts):
    """One partitioned train step (K1, dp and dq on the halo layout) on
    the card's in-process mesh against the CPU's: the loss, every
    gradient and the weights after one SGD step within 1e-5 (|diff| <=
    1e-5 + 1e-5 |cpu|; the card's scatter adds are atomic)."""
    from stinet_tpu_torch.graph.partition import partition_hierarchy
    from stinet_tpu_torch.parallel.mesh import make_mesh
    from stinet_tpu_torch.parallel.sharded_stinet import (
        make_sharded_train_step, place_partitioned)
    from stinet_tpu_torch.utils.hostile import hostile_scene
    scene = hostile_scene(3000, "terrain", seed=0)
    pg, _ = partition_hierarchy(scene, n_parts)
    out = {}
    for where in ("cpu", dev):
        model = define_G(**PART_TINY,
                         generator=torch.Generator().manual_seed(2)).to(where)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        mesh = make_mesh(n_parts, where)
        step, _ = make_sharded_train_step(mesh, model, opt)
        graphs = place_partitioned(mesh, pg, PackedPlacer(torch.device(where)))
        before = ell.ell_edge_conv_dq_kernel.launches
        loss = step(graphs, 0.1)
        launched = ell.ell_edge_conv_dq_kernel.launches - before
        out[str(where)] = (float(loss), launched, {
            k: p.grad.cpu() for k, p in model.named_parameters()},
            {k: v.cpu() for k, v in model.state_dict().items()})
    (cl, _, cg, cs), (gl, launched, gg, gs) = out["cpu"], out[str(dev)]
    assert launched > 0
    np.testing.assert_allclose(gl, cl, rtol=1e-5, atol=1e-5)
    for got, want in ((gg, cg), (gs, cs)):
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", ["f32", "bf16-windowed"])
def test_exported_forward_on_the_card_equals_the_servers(dev, tmp_path,
                                                        case):
    """`SceneInpainter.export` on the card: the reloaded program launches
    the kernels through the custom ops of ops/library.py (K1 and K2; K3a
    for the bf16 windowed model) as often as the server's forward, and its
    output is the forward's bit for bit (deterministic algorithms on, so
    the spill's index_add_ sums in one order)."""
    from stinet_tpu_torch.serving import SceneInpainter
    from stinet_tpu_torch.utils.model_io import load_serving
    widths, dtype, banded, n = {
        "f32": (dict(ngf=8, n_blocks=2, dilations=[1, 2]), None, False, 600),
        "bf16-windowed": (dict(ngf=64, n_blocks=1, dilations=[2]),
                          torch.bfloat16, True, 4096)}[case]
    model = define_G(input_nc=10, output_nc=3, filter_type="edgeconvtransinv",
                     norm="instance", pooling_type="max", n_levels=2,
                     n_repeated_io_convs=1, dtype=dtype,
                     generator=torch.Generator().manual_seed(4), **widths)
    scene = synthetic_scene(num_vertices=n, levels=3, seed=2,
                            dilation_dists=(2, 4))
    server = SceneInpainter(model, model.state_dict(), device=dev,
                            windowed=banded)
    fn = load_serving(server.export(scene, str(tmp_path / "served.pt2")))
    graph = server.place(server._build_scene(scene)[0])
    counters = [(ell.ell_edge_conv_sum_kernel, "launches"),
                (norms.masked_instance_norm_kernel, "launches"),
                (windowed.windowed_edge_conv_sum_kernel, "launches")]

    def counted(call):
        before = [getattr(f, a) for f, a in counters]
        out = call()
        torch.cuda.synchronize()
        return out, [getattr(f, a) - b for (f, a), b in zip(counters,
                                                            before)]

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want, expect = counted(lambda: server.forward(graph))
        got, launched = counted(lambda: fn(graph))
    finally:
        torch.use_deterministic_algorithms(was)
    assert launched == expect and launched[0] > 0 and launched[1] > 0
    assert (launched[2] > 0) == banded
    assert torch.equal(got, want)


# --- profiling, bf16 outside STINet, tensor-parallel slices ------------------

def test_epoch_profiler_names_the_kernels_on_the_card(dev, tmp_path):
    """`EpochProfiler` at its default schedule over 8 steps of K1 forward
    and K2 calls: the trace of steps 4-6 names `ell_fwd_rows` and K2's two
    launches three times each, and the launch counters move as without a
    profiler (one K1 and one K2 call a step)."""
    import json
    from stinet_tpu_torch.utils.profiling import EpochProfiler
    rng = np.random.default_rng(8)
    v, h, d = 2048, 64, 8
    p = _cuda_t(rng.normal(size=(v, h)).astype(np.float32), dev)
    q = _cuda_t(rng.normal(size=(v, h)).astype(np.float32), dev)
    nbr = _cuda_t(rng.integers(0, v, size=(v, d)).astype(np.int32), dev)
    deg = _cuda_t(rng.integers(0, d + 1, size=v).astype(np.float32), dev)
    nv = torch.tensor(v - 5, dtype=torch.int32, device=dev)
    gid = (torch.arange(v, device=dev) >= v - 5).to(torch.int32)
    prof = EpochProfiler(tmp_path)
    k1, k2 = (ell.ell_edge_conv_sum_kernel.launches,
              norms.masked_instance_norm_kernel.launches)
    for _ in range(8):
        prof.step()
        norms.masked_instance_norm(ell.ell_edge_conv_sum(p, q, nbr, deg),
                                   gid, 1, nv)
        torch.cuda.synchronize()
    prof.close()
    assert ell.ell_edge_conv_sum_kernel.launches == k1 + 8
    assert norms.masked_instance_norm_kernel.launches == k2 + 8
    (trace,) = tmp_path.glob("*.pt.trace.json")
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("cat") == "kernel"]
    for symbol in ("ell_fwd_rows", "instance_norm_stats",
                   "instance_norm_apply"):
        assert sum(symbol in n for n in names) == 3, symbol


def test_bf16_resnet2d_and_discriminator_on_the_card_match_the_cpu(dev):
    """A bf16 Resnet2D and a bf16 PatchGAN discriminator (f32 parameters)
    on the card against the CPU from the same weights: bf16 outputs within
    5e-2 of theirs in L2 (cuDNN's bf16 convolutions round their f32 sums
    at other ties than the CPU's, and the instance norms amplify a flip),
    and the generator's gradients f32 within 5e-2 together."""
    from stinet_tpu_torch.models.gan_networks import NLayerDiscriminator
    from stinet_tpu_torch.models.resnet2d import Resnet2D
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(2, 4, 32, 32)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(2, 7, 64, 64)).astype(np.float32))
    for make, inp in (
            (lambda: Resnet2D(4, ngf=8, n_blocks=3, norm="instance",
                              pooling_type="max", dilation_order=1,
                              dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(2)),
             x),
            (lambda: NLayerDiscriminator(
                7, ndf=8, n_layers=3, norm="instance", dtype=torch.bfloat16,
                generator=torch.Generator().manual_seed(3)), y)):
        outs, grads = [], []
        for device in ("cpu", dev):
            model = make().to(device)
            out = model(inp.to(device))
            assert out.dtype == torch.bfloat16
            out.float().square().sum().backward()
            outs.append(out.detach().float().cpu())
            grads.append(torch.cat([p.grad.reshape(-1).cpu()
                                    for p in model.parameters()]))
            assert all(p.grad.dtype == torch.float32
                       for p in model.parameters())
        assert float((outs[1] - outs[0]).norm()) <= 5e-2 * float(
            outs[0].norm())
        assert float((grads[1] - grads[0]).norm()) <= 5e-2 * float(
            grads[0].norm())


def test_bf16_singleconvmeshnet_on_the_card_matches_the_cpu(dev):
    """A bf16 SingleConvMeshNet (the head bf16, the edge convolutions f32)
    in a train forward on the card against the CPU: bf16 logits within
    2e-2 of theirs in L2."""
    import dataclasses
    from stinet_tpu_torch.models.singleconvmeshnet import SingleConvMeshNet
    scene = synthetic_scene(num_vertices=4096, levels=3, seed=5,
                            dilation_dists=())
    host = build_hierarchical_graph([scene])
    rng = np.random.default_rng(1)
    host = dataclasses.replace(host, x=torch.from_numpy(
        rng.normal(size=(host.x.shape[0], 9)).astype(np.float32)))
    outs = []
    for device in ("cpu", dev):
        model = SingleConvMeshNet(
            9, 2, [8, 16, 32], dtype="bfloat16",
            generator=torch.Generator().manual_seed(3)).to(device)
        with gc.full_f32_matmuls():
            out = model(host.to(device))
        assert out.dtype == torch.bfloat16
        outs.append(out.detach().float().cpu())
    assert float((outs[1] - outs[0]).norm()) <= 2e-2 * float(outs[0].norm())


@pytest.mark.parametrize("kind", ["sum", "dp", "dq"])
def test_ell_kernels_on_a_channel_slice_bitwise(dev, kind):
    """K1, dp and dq on P and Q of a slice of the hidden channels (the
    first half of a 2H = 128 projection, as a model axis of 2 gives each
    rank; a column slice made contiguous): bitwise their plain
    versions."""
    rng = np.random.default_rng(11)
    v, d, h = 3000, 9, 128
    x = _cuda_t(rng.normal(size=(v, 32)).astype(np.float32), dev)
    w = _cuda_t(rng.normal(size=(h, 32)).astype(np.float32), dev)
    p = (x @ w.T)[:, :h // 2].contiguous()
    q = (x.flip(0) @ w.T)[:, :h // 2].contiguous()
    g = _cuda_t(rng.normal(size=(v, h // 2)).astype(np.float32), dev)
    nbr_np = rng.integers(0, v, size=(v, d)).astype(np.int32)
    deg_np = rng.integers(0, d + 1, size=v)
    nbr, deg = _cuda_t(nbr_np, dev), _cuda_t(deg_np.astype(np.float32), dev)
    rev = [[] for _ in range(v)]
    for r in range(v):
        for s_ in nbr_np[r, :deg_np[r]]:
            rev[s_].append(r)
    rev_np = np.zeros((v, max(len(r) for r in rev)), np.int32)
    for s_, r in enumerate(rev):
        rev_np[s_, :len(r)] = r
    dout = _cuda_t(np.asarray([len(r) for r in rev], np.float32), dev)
    args, kernel, plain = {
        "sum": ((p, q, nbr, deg), ell.ell_edge_conv_sum_kernel,
                ell.ell_edge_conv_sum_plain),
        "dp": ((p, q, nbr, deg, g), ell.ell_edge_conv_dp_kernel,
               ell.ell_edge_conv_dp_plain),
        "dq": ((q, g, p, _cuda_t(rev_np, dev), dout),
               ell.ell_edge_conv_dq_kernel, ell.ell_edge_conv_dq_plain),
    }[kind]
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (v, h // 2)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
