"""Graph-domain quality metrics over padded graphs, always in f32.

PyTorch counterpart of `stinet_tpu/metrics/graph_metrics.py` (parity
targets: the reference's utils/metrics/graph_metrics.py):

  psnr                 -10 log10(mean(((x - y) / data_range)^2) + 1e-8)
  graph total variation  sum_e |x[src_e] - x[dst_e]| / (N * C)
  graph Laplace variance var over vertices of the graph Laplacian of luma

Every function takes a valid mask or count, so pad rows and edges are left
out.
"""
import torch

from stinet_tpu_torch.graph.hierarchy import EdgeSet
from stinet_tpu_torch.ops.segment import segment_sum

_EPS = 1e-8


def length_mask(n, size, device):
    """[size] f32 mask: 1.0 for rows < n, 0.0 for pad rows."""
    return (torch.arange(size, device=device)
            < torch.as_tensor(n, device=device)).to(torch.float32)


def psnr(x, y, valid_mask, data_range=2.0):
    """PSNR over the valid rows. x, y: [V_pad, C]; valid_mask: [V_pad]."""
    w = valid_mask[:, None]
    n = torch.clamp(w.sum() * x.shape[1], min=1.0)
    mse = (((x - y) / data_range) ** 2 * w).sum() / n
    return -10.0 * torch.log10(mse + _EPS)


def masked_psnr(x, y, valid_mask, region_mask, data_range=2.0):
    """PSNR restricted to the inpainting region (the reference's
    psnr_mask_only)."""
    return psnr(x, y, valid_mask * region_mask, data_range)


def l1(x, y, valid_mask):
    w = valid_mask[:, None]
    n = torch.clamp(w.sum() * x.shape[1], min=1.0)
    return ((x - y).abs() * w).sum() / n


def mse(x, y, valid_mask):
    w = valid_mask[:, None]
    n = torch.clamp(w.sum() * x.shape[1], min=1.0)
    return ((x - y) ** 2 * w).sum() / n


def _grayscale(x):
    return 0.299 * x[:, 0:1] + 0.587 * x[:, 1:2] + 0.114 * x[:, 2:3]


def _laplace_variance(lap, num_vertices):
    vmask = length_mask(num_vertices, lap.shape[0], lap.device)[:, None]
    n = torch.clamp(vmask.sum(), min=1.0)
    mean = (lap * vmask).sum() / n
    return (((lap - mean) ** 2) * vmask).sum() / n


def graph_tv_and_lap_var(x, edges: EdgeSet, num_vertices):
    """(total variation, Laplace variance), both in f32, from one pass over
    the neighbours: the ELL slots (and the COO spill) where the edge set
    has ELL tables, the COO edge list otherwise."""
    xf = x.to(torch.float32)
    gray = _grayscale(xf)
    n_v = torch.clamp(torch.as_tensor(num_vertices, device=x.device)
                      .to(torch.float32), min=1.0)
    if edges.nbr is None:
        emask = length_mask(edges.num_edges, edges.src.shape[0], x.device)
        xs, xd = xf.index_select(0, edges.src), xf.index_select(0, edges.dst)
        tv = ((xs - xd).abs() * emask[:, None]).sum() / (n_v * x.shape[1])
        s = segment_sum(gray.index_select(0, edges.src), edges.dst,
                        gray.shape[0])
    else:
        deg_i = edges.ell_degree.to(torch.int32)
        tv_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        s = torch.zeros(gray.shape, dtype=torch.float32, device=x.device)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        for d in range(edges.nbr.shape[1]):
            xn = xf.index_select(0, edges.nbr[:, d])
            valid = (d < deg_i)[:, None]
            tv_sum = tv_sum + torch.where(valid, (xn - xf).abs(), zero).sum()
            s = s + torch.where(valid, _grayscale(xn), zero)
        if edges.spill_src is not None:
            # pad spill entries are trash self-edges: a TV term of exactly
            # 0, and a Laplacian term on the trash row, which vmask drops
            xs = xf.index_select(0, edges.spill_src)
            xd = xf.index_select(0, edges.spill_dst)
            tv_sum = tv_sum + (xs - xd).abs().sum()
            s = s + segment_sum(_grayscale(xs), edges.spill_dst,
                                gray.shape[0])
        tv = tv_sum / (n_v * x.shape[1])
    lap = s - edges.degree[:, None].to(torch.float32) * gray
    return tv, _laplace_variance(lap, num_vertices)
