"""The served path's kernels as `torch.library` custom ops, for torch.export.

`torch.export` traces with fake tensors and cannot trace a ctypes launch,
so while a forward is being exported (`torch.compiler.is_exporting()`),
the autograd Functions that hold the kernels of the served path call these
ops instead of their wrappers:

  stinet::ell_edge_conv_sum           K1's forward (ops/ell.py)
  stinet::windowed_edge_conv_sum      K3a, relu mode (ops/windowed.py)
  stinet::windowed_edge_conv_sum_f32  K3b (ops/windowed.py)
  stinet::masked_instance_norm        K2, one graph or G (ops/norms.py)

Each op runs its kernel on a CUDA tensor and its plain version on a CPU
tensor, through the same dispatch as the eager path, and has a fake
(shape) function. An exported program holds the ops by name, so the
process that loads it imports this module first (utils/model_io.py:
load_serving does). Eager calls never go through the dispatcher: `predict`
keeps its host cost a call.
"""
import torch

from stinet_tpu_torch.ops import ell, norms, windowed


@torch.library.custom_op("stinet::ell_edge_conv_sum", mutates_args=())
def ell_edge_conv_sum(p: torch.Tensor, q: torch.Tensor, nbr: torch.Tensor,
                      deg: torch.Tensor) -> torch.Tensor:
    if p.is_cuda:
        return ell.ell_edge_conv_sum_kernel(p, q, nbr, deg)
    return ell.ell_edge_conv_sum_plain(p, q, nbr, deg)


@ell_edge_conv_sum.register_fake
def _(p, q, nbr, deg):
    return torch.empty_like(p)


@torch.library.custom_op("stinet::windowed_edge_conv_sum", mutates_args=())
def windowed_edge_conv_sum(p: torch.Tensor, q: torch.Tensor,
                           nbr: torch.Tensor, deg: torch.Tensor, halo: int,
                           tile: int) -> torch.Tensor:
    return windowed.windowed_edge_conv_sum(p, q, nbr, deg, halo, tile,
                                           "relu")


@windowed_edge_conv_sum.register_fake
def _(p, q, nbr, deg, halo, tile):
    return torch.empty_like(p, dtype=torch.bfloat16)


@torch.library.custom_op("stinet::windowed_edge_conv_sum_f32",
                         mutates_args=())
def windowed_edge_conv_sum_f32(p: torch.Tensor, q: torch.Tensor,
                               nbr: torch.Tensor, deg: torch.Tensor,
                               halo: int, tile: int) -> torch.Tensor:
    return windowed.windowed_edge_conv_sum_f32(p, q, nbr, deg, halo, tile)


@windowed_edge_conv_sum_f32.register_fake
def _(p, q, nbr, deg, halo, tile):
    return torch.empty_like(p)


@torch.library.custom_op("stinet::masked_instance_norm", mutates_args=())
def masked_instance_norm(x: torch.Tensor, graph_id: torch.Tensor,
                         num_graphs: int, num_valid: torch.Tensor,
                         eps: float) -> torch.Tensor:
    if x.is_cuda:
        return norms.masked_instance_norm_kernel(
            x, num_valid, eps, graph_id if num_graphs > 1 else None,
            num_graphs)
    return norms.masked_instance_norm_plain(x, graph_id, num_graphs,
                                            num_valid, eps)


@masked_instance_norm.register_fake
def _(x, graph_id, num_graphs, num_valid, eps):
    return torch.empty_like(x)
