"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they need an NVIDIA GPU and nvcc, and skip elsewhere (the
CPU suite holds the plain versions against the JAX package in
tests/test_torch_ops.py and tests/test_torch_model.py). Run on a card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from stinet_tpu_torch.graph.build import build_hierarchical_graph
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.ops import _cuda, ell, norms
from stinet_tpu_torch.utils.synthetic import synthetic_scene

pytestmark = pytest.mark.cuda


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


def test_instance_norm_kernel_refuses_batched_graphs(dev):
    x = torch.zeros(16, 4, device=dev)
    with pytest.raises(NotImplementedError):
        norms.masked_instance_norm(x, torch.zeros(16, dtype=torch.int32,
                                                  device=dev), 2, 16)


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
