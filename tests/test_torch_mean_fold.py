"""The EdgeConv mean taken inside the slot sums against the composition it
replaced.

`edge_conv_aggregate` (ops/message_passing.py) takes the mean over the
total degree inside the slot sum of an edge set with no COO spill
(`mean_degree`: the epilogue of K1, K3a or K3b on a CUDA tensor, one pass
over g in the backward) and keeps the torch tail for a set with a spill or
with no ELL table. `reference_aggregate` below is the function as it stood
before: the slot sum, then the mean in torch ops. Every case is held to it
bit for bit: the output and the gradients in p and q, bf16 and f32, on the
ELL and the windowed dispatch, with and without a spill, in a checkpointed
block's second forward and in the tensor-parallel filter.

The tests marked `cuda` hold the kernels to the same composition on a card
(the slot sum's kernel, then the torch tail on the card) and skip
elsewhere; run them with

    python -m pytest tests/test_torch_mean_fold.py -q -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from stinet_tpu_torch.graph.build import build_hierarchical_graph
from stinet_tpu_torch.graph.hierarchy import EdgeSet
from stinet_tpu_torch.models import stinet
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.models.stinet import EdgeConvFilter
from stinet_tpu_torch.ops import _cuda, ell, windowed
from stinet_tpu_torch.ops.ell import ell_edge_conv_sum
from stinet_tpu_torch.ops.message_passing import (
    edge_conv_aggregate, windowed_kernel_applies)
from stinet_tpu_torch.ops.segment import segment_mean, segment_sum
from stinet_tpu_torch.ops.windowed import (
    WindowedEdgeConvSum, WindowedEdgeConvSumF32, default_tile)
from stinet_tpu_torch.parallel import tensor_parallel
from stinet_tpu_torch.trainers import graph_common as gc
from stinet_tpu_torch.utils.synthetic import synthetic_scene

# the row widths at which each dtype takes the windowed kernels
WIDTHS = {torch.bfloat16: 128, torch.float32: 256}
HALO = 32
CFG = dict(input_nc=10, output_nc=3, ngf=8, filter_type="edgeconvtransinv",
           norm="instance", n_blocks=2, n_levels=2, n_repeated_io_convs=1,
           pooling_type="max", dilations=[1, 2])
SCENE = dict(num_vertices=2000, levels=3, dilation_dists=(2,), seed=3)


def reference_aggregate(p, q, edges: EdgeSet, impl=None):
    """edge_conv_aggregate before the mean moved into the slot sums: the
    sum of the windowed op or K1, the spill, then 1/max(degree, 1) in
    torch ops."""
    num_segments = edges.degree.shape[0]
    acc_dt = torch.promote_types(p.dtype, torch.float32)
    degree = edges.degree.to(p.dtype)
    if edges.nbr is None:
        m = torch.relu(p.index_select(0, edges.dst)
                       + q.index_select(0, edges.src))
        return segment_mean(m, edges.dst, num_segments, counts=degree)
    ell_deg = edges.degree if edges.ell_degree is None else edges.ell_degree
    if windowed_kernel_applies(p, edges.halo):
        fn = (WindowedEdgeConvSum if p.dtype == torch.bfloat16
              else WindowedEdgeConvSumF32)
        out = fn.apply(
            p, q, edges.nbr, edges.rev_dst, ell_deg, edges.out_degree,
            edges.halo, default_tile(p.shape[0]), impl)
    else:
        out = ell_edge_conv_sum(p, q, edges.nbr, ell_deg, edges.rev_dst,
                                edges.out_degree, impl=impl)
    if edges.spill_src is not None:
        m = torch.relu(p.index_select(0, edges.spill_dst)
                       + q.index_select(0, edges.spill_src))
        out = out + segment_sum(m.to(acc_dt), edges.spill_dst,
                                num_segments).to(out.dtype)
    inv = 1.0 / torch.clamp(degree.to(acc_dt), min=1.0)
    return (out.to(acc_dt) * inv[:, None]).to(p.dtype)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        _bits(a), _bits(b))


def _edge_set(rng, v, d, kind, halo=None, device="cpu"):
    """An EdgeSet over v rows. "ell": every edge in a [v, d] table (banded
    to `halo` when given), no spill; "spill": the same table and 1200 edges
    more into four rows through the COO spill list (total degrees past
    256, which bf16 rounds); "coo": the edges as COO lists alone."""
    base = np.arange(v)
    if halo is None:
        nbr = rng.integers(0, v, size=(v, d))
    else:
        nbr = np.clip(base[:, None] + rng.integers(-halo, halo + 1,
                                                   size=(v, d)), 0, v - 1)
    nbr = nbr.astype(np.int32)
    count = rng.integers(0, d + 1, size=v)
    count[:3] = 0
    src = np.concatenate([nbr[i, :count[i]] for i in range(v)])
    dst = np.repeat(base, count)
    deg_out = np.bincount(src, minlength=v)
    rev = np.full((v, max(int(deg_out.max()), 1)), v - 1, np.int32)
    order = np.argsort(src, kind="stable")
    slot = np.arange(len(src)) - np.concatenate(
        [[0], np.cumsum(deg_out)])[src[order]]
    rev[src[order], slot] = dst[order]

    def t(a, dtype=None):
        out = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return out if dtype is None else out.to(dtype)

    coo = dict(src=t(src.astype(np.int32)), dst=t(dst.astype(np.int32)),
               num_edges=torch.tensor(len(src), dtype=torch.int32))
    if kind == "coo":
        return EdgeSet(degree=t(count, torch.float32), **coo)
    tables = dict(nbr=t(nbr), rev_dst=t(rev),
                  out_degree=t(deg_out, torch.float32), halo=halo)
    if kind == "ell":
        return EdgeSet(degree=t(count, torch.float32), **coo, **tables)
    spill_dst = np.repeat(np.arange(4, 8), 300).astype(np.int32)
    spill_src = rng.integers(0, v, size=spill_dst.shape).astype(np.int32)
    total = count + np.bincount(spill_dst, minlength=v)
    assert total.max() > 256
    return EdgeSet(degree=t(total, torch.float32), **coo, **tables,
                   ell_degree=t(count, torch.float32),
                   spill_src=t(spill_src), spill_dst=t(spill_dst))


def _rows(rng, v, h, dtype, device="cpu"):
    """[v, h] rows over several binades, so a rounding moved shows."""
    a = rng.normal(size=(v, h)) * 10.0 ** rng.integers(-2, 3, size=(v, 1))
    return torch.from_numpy(a.astype(np.float32)).to(device).to(dtype)


def _run(fn, p, q, edges, gup, impl=None):
    """fn's output and its gradients in p and q for the cotangent gup."""
    p, q = p.clone().requires_grad_(), q.clone().requires_grad_()
    out = fn(p, q, edges, impl=impl)
    out.backward(gup)
    return out.detach(), p.grad, q.grad


def _counts():
    return edge_conv_aggregate.folded, edge_conv_aggregate.tail


def _case(dtype, dispatch, kind, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    v, d, h = 256, 8, WIDTHS[dtype]
    halo = HALO if dispatch == "windowed" else None
    edges = _edge_set(rng, v, d, kind, halo, device)
    p, q, gup = (_rows(rng, v, h, dtype, device) for _ in range(3))
    if kind != "coo":
        assert windowed_kernel_applies(p, edges.halo) == (
            dispatch == "windowed")
    return p, q, gup, edges


CASES = [(dtype, dispatch, kind)
         for dtype in (torch.bfloat16, torch.float32)
         for dispatch in ("ell", "windowed")
         for kind in ("ell", "spill")] + [
    (torch.bfloat16, "ell", "coo"), (torch.float32, "ell", "coo")]


def _ids(case):
    dtype, dispatch, kind = case
    return f"{str(dtype)[6:]}-{dispatch}-{kind}"


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_aggregate_bitwise_the_torch_tail(case):
    """Output, dp and dq (through autograd) of the plain path equal the
    parent's composition bit for bit; a set with no spill counts as
    folded, one with a spill or no table as the torch tail."""
    dtype, dispatch, kind = case
    p, q, gup, edges = _case(dtype, dispatch, kind)
    before = _counts()
    got = _run(edge_conv_aggregate, p, q, edges, gup)
    folded = int(kind == "ell")
    assert _counts() == (before[0] + folded, before[1] + 1 - folded)
    want = _run(reference_aggregate, p, q, edges, gup)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _same(a, b), ("out", "dp", "dq")[i]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mean_scale_is_the_tail_and_its_backward(dtype):
    """`mean_scale_plain` is the tail's forward, and on g the gradient that
    autograd gives through the tail; degrees past 256 round in bf16."""
    rng = np.random.default_rng(1)
    x, g = _rows(rng, 64, 24, dtype), _rows(rng, 64, 24, dtype)
    degree = torch.from_numpy(rng.integers(0, 1000, 64).astype(np.float32))
    degree[:2] = 0
    acc = torch.promote_types(dtype, torch.float32)
    inv = 1.0 / torch.clamp(degree.to(dtype).to(acc), min=1.0)
    xg = x.clone().requires_grad_()
    tail = (xg.to(acc) * inv[:, None]).to(dtype)
    tail.backward(g)
    assert _same(ell.mean_scale_plain(x, degree), tail.detach())
    assert _same(ell.mean_scale(g, degree), xg.grad)


def test_windowed_step_epilogue_is_the_dp_it_replaced():
    """K3d's dp taken by the step sum (`g=`) equals bf16(f32(g) * f32(step
    sum)), the torch ops it replaced."""
    p, q, g, edges = _case(torch.bfloat16, "windowed", "ell")
    tile = default_tile(p.shape[0])
    step = windowed.windowed_edge_conv_sum(p, q, edges.nbr, edges.degree,
                                           HALO, tile, "step")
    want = (g.to(torch.float32) * step.to(torch.float32)).to(torch.bfloat16)
    got = windowed.windowed_edge_conv_sum(p, q, edges.nbr, edges.degree,
                                          HALO, tile, "step", g=g)
    assert _same(got, want)
    with pytest.raises(ValueError):
        windowed.windowed_edge_conv_sum(p, q, edges.nbr, edges.degree, HALO,
                                        tile, "relu", g=g)
    with pytest.raises(ValueError):
        windowed.windowed_edge_conv_sum(p, q, edges.nbr, edges.degree, HALO,
                                        tile, "step",
                                        mean_degree=edges.degree)


def _loss_and_grads(model, graph):
    loss, _ = gc.inpainting_loss(model(graph), graph.color, graph.mask,
                                 gc.vertex_mask(graph), True)
    loss.backward()
    return loss.detach(), [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpointed_blocks_rerun_the_folded_mean(monkeypatch, dtype):
    """A model whose blocks are all checkpointed: each folded filter call
    runs twice (the forward, then its rerun in the backward), and the loss
    and every gradient equal those of the parent's composition."""
    graph = build_hierarchical_graph([synthetic_scene(**SCENE)])

    def model():
        return define_G(**CFG, dtype=dtype, remat_io_blocks=True,
                        checkpoint_bottleneck=True,
                        generator=torch.Generator().manual_seed(0))

    calls = [0]
    m = model()
    for mod in m.modules():
        if isinstance(mod, EdgeConvFilter):
            mod.register_forward_pre_hook(
                lambda *_: calls.__setitem__(0, calls[0] + 1))
    before = _counts()
    got = _loss_and_grads(m, graph)
    folded = edge_conv_aggregate.folded - before[0]
    tail = edge_conv_aggregate.tail - before[1]
    n_filters = 1 + 2 + CFG["n_blocks"] + 2 + 1
    assert calls[0] == 2 * n_filters == folded + tail
    assert folded > 0 and folded % 2 == 0
    monkeypatch.setattr(stinet, "edge_conv_aggregate", reference_aggregate)
    want = _loss_and_grads(model(), graph)
    assert _same(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert _same(a, b)


class _OneModelRank:
    """A mesh's model all-reduce over one rank: the identity."""

    @staticmethod
    def model_all_reduce_(t):
        return t


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tensor_parallel_filter_bitwise_the_torch_tail(monkeypatch, dtype):
    """A TensorParallelEdgeConv holding the first half of the hidden
    channels aggregates through the folded mean; its output and the
    gradients of its input and slices equal the parent's composition."""
    rng = np.random.default_rng(2)
    v, c = 256, 8
    edges = _edge_set(rng, v, 8, "ell")
    x = _rows(rng, v, c, torch.float32)
    gup = _rows(rng, v, 16, dtype)

    def run():
        filt = EdgeConvFilter(c, 16, trans_inv=True, dtype=dtype)
        with torch.no_grad():
            for t in filt.parameters():
                t.copy_(torch.from_numpy(
                    np.random.default_rng(3).normal(size=t.shape)
                    .astype(np.float32)))
        for key, dim in tensor_parallel._SLICED:
            tensor_parallel._keep(filt.get_parameter(key), dim, 0, 16, None)
        filt.__class__ = tensor_parallel.TensorParallelEdgeConv
        filt.mesh = _OneModelRank()
        xg = x.clone().requires_grad_()
        out = filt(xg, edges)
        out.backward(gup)
        return [out.detach(), xg.grad] + [t.grad for t in filt.parameters()]

    before = _counts()
    got = run()
    assert _counts() == (before[0] + 1, before[1])
    monkeypatch.setattr(tensor_parallel, "edge_conv_aggregate",
                        reference_aggregate)
    want = run()
    for a, b in zip(got, want):
        assert _same(a, b)


# --- on the card ----------------------------------------------------------


@pytest.fixture
def dev():
    """The card, under torch's deterministic algorithms: a spill's
    segment sum and the COO mean's gathers add by atomics otherwise, and
    two runs of one sum may differ in the last bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    try:
        _cuda.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield torch.device("cuda", torch.cuda.current_device())
    torch.use_deterministic_algorithms(was)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_card_aggregate_bitwise_the_torch_tail(dev, case):
    """On the card: the folded kernels (K1's or K3a's/K3b's epilogue, the
    mean's backward pass, dp by the step sum) against the slot sum's
    kernel followed by the torch tail, output, dp and dq bit for bit."""
    dtype, dispatch, kind = case
    p, q, gup, edges = _case(dtype, dispatch, kind, device=dev, seed=4)
    counts = (ell.ell_edge_conv_sum_kernel.launches,
              ell.mean_scale_kernel.launches)
    got = _run(edge_conv_aggregate, p, q, edges, gup)
    want = _run(reference_aggregate, p, q, edges, gup)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert _same(a, b), ("out", "dp", "dq")[i]
    if kind == "ell":
        assert ell.mean_scale_kernel.launches == counts[1] + 1
        assert ell.ell_edge_conv_sum_kernel.launches == counts[0] + 2 * (
            dispatch == "ell")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [4, 20, 128, 130, 512])
def test_card_mean_kernels_bitwise_the_tail(dev, dtype, h):
    """K1's mean epilogue and `mean_scale_kernel` at widths of every layout
    class (element loads at H*es % 16 != 0), on aligned rows and on rows
    one element past 16 bytes, against the tail on the card; degrees from
    0 to past 2^16, which round in bf16; NaN and infinities among q."""
    rng = np.random.default_rng(h)
    v, d = 1001, 9
    p = _rows(rng, v, h, dtype, dev)
    q = _rows(rng, v, h, dtype, dev)
    q[rng.integers(0, v, 4), rng.integers(0, h, 4)] = float("nan")
    q[rng.integers(0, v, 4), rng.integers(0, h, 4)] = float("inf")
    nbr = torch.from_numpy(rng.integers(0, v, (v, d)).astype(np.int32)).to(
        dev)
    deg = torch.from_numpy(rng.integers(0, d + 1, v).astype(np.float32)).to(
        dev)
    mean = torch.from_numpy(np.concatenate([
        [0, 1, 2, 3, 255, 256, 257, 1023, 65537],
        rng.integers(0, 400, v - 9)]).astype(np.float32)).to(dev)
    want = ell.mean_scale_plain(ell.ell_edge_conv_sum_kernel(p, q, nbr, deg),
                                mean)
    got = ell.ell_edge_conv_sum_kernel(p, q, nbr, deg, mean)
    g = _rows(rng, v, h, dtype, dev)
    shifted = torch.empty(v * h + 1, dtype=dtype, device=dev)[1:].view(v, h)
    shifted.copy_(g)
    torch.cuda.synchronize()
    assert _same(got, want)
    for rows in (g, shifted):
        assert _same(ell.mean_scale_kernel(rows, mean),
                     ell.mean_scale_plain(rows, mean))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_card_windowed_epilogues_bitwise(dev, dtype):
    """K3a (bf16) and K3b (f32) with the mean, and K3a's step sum with g,
    against the unscaled kernels followed by the torch ops they replace."""
    rng = np.random.default_rng(5)
    v, d, h = 1024, 8, WIDTHS[dtype]
    edges = _edge_set(rng, v, d, "ell", HALO, dev)
    p, q, g = (_rows(rng, v, h, dtype, dev) for _ in range(3))
    tile = default_tile(v)
    mean = edges.degree * 37.0   # past 256: bf16 rounds the divisor
    if dtype == torch.float32:
        plain = windowed.windowed_edge_conv_sum_f32_kernel(
            p, q, edges.nbr, edges.degree, HALO, tile)
        got = windowed.windowed_edge_conv_sum_f32_kernel(
            p, q, edges.nbr, edges.degree, HALO, tile, mean)
        torch.cuda.synchronize()
        assert _same(got, ell.mean_scale_plain(plain, mean))
        return
    args = (p, q, edges.nbr, edges.degree, HALO, tile)
    relu = windowed.windowed_edge_conv_sum_kernel(*args, "relu")
    step = windowed.windowed_edge_conv_sum_kernel(*args, "step")
    got_mean = windowed.windowed_edge_conv_sum_kernel(*args, "relu", mean)
    got_dp = windowed.windowed_edge_conv_sum_kernel(*args, "step", g=g)
    shifted = torch.empty(v * h + 1, dtype=dtype, device=dev)[1:].view(v, h)
    shifted.copy_(g)
    got_dp_shifted = windowed.windowed_edge_conv_sum_kernel(*args, "step",
                                                            g=shifted)
    torch.cuda.synchronize()
    assert _same(got_mean, ell.mean_scale_plain(relu, mean))
    want_dp = (g.to(torch.float32) * step.to(torch.float32)).to(dtype)
    assert _same(got_dp, want_dp) and _same(got_dp_shifted, want_dp)


@pytest.mark.cuda
def test_card_checkpointed_bf16_model_bitwise_the_torch_tail(dev,
                                                             monkeypatch):
    """The bf16 model with every block checkpointed, built windowed, on the
    card: loss and gradients of the folded path equal the parent's
    composition's."""
    graph = build_hierarchical_graph([synthetic_scene(**dict(
        SCENE, num_vertices=4096))], windowed=True).to(dev)

    def model():
        return define_G(**dict(CFG, ngf=64), dtype="bfloat16",
                        remat_io_blocks=True, checkpoint_bottleneck=True,
                        generator=torch.Generator().manual_seed(0)).to(dev)

    before = windowed.windowed_edge_conv_sum_kernel.launches
    got = _loss_and_grads(model(), graph)
    assert windowed.windowed_edge_conv_sum_kernel.launches > before
    monkeypatch.setattr(stinet, "edge_conv_aggregate", reference_aggregate)
    want = _loss_and_grads(model(), graph)
    assert _same(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert _same(a, b)
