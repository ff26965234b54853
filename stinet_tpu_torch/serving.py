"""Serving a trained mesh-inpainting generator, one scene per request.

PyTorch counterpart of `SceneInpainter.predict` / `warmup` in
`stinet_tpu/serving.py`. A request builds the scene's padded hierarchy on
the host (geometric bucket padding, so scene sizes land on a short ladder
of shapes), moves it to the device in ONE copy, runs the generator and
returns the valid level-0 rows.

Host to device: only the leaves the inference forward reads are copied,
in one copy (`PackedPlacer`, which the trainer's placement shares).

Matmul precision: the forward runs its f32 matmuls in full f32, with TF32
off (`full_f32_matmuls`), since TF32 would move the numbers away from the
JAX f32 model's. The process's own settings are restored after each
forward.

Batched and streamed serving, meshes, export and the running-max table
widths of the JAX server come in later slices.
"""
import contextlib
import copy
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from stinet_tpu_torch.graph.build import RawHierarchy, build_hierarchical_graph
from stinet_tpu_torch.graph.hierarchy import (
    EdgeSet, HierarchicalGraph, map_tensors, tensor_leaves)


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises for a CUDA device when no card is
    visible, so nothing quietly runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def full_f32_matmuls():
    """Inside the block, f32 matmuls run in full f32 (TF32 off); after it
    the process's settings are as they were."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _inference_edges(e: EdgeSet) -> EdgeSet:
    ell = e.nbr is not None
    return dataclasses.replace(
        e, rev_dst=None, out_degree=None,   # backward only
        src=None if ell else e.src, dst=None if ell else e.dst)


def inference_graph(graph: HierarchicalGraph) -> HierarchicalGraph:
    """`graph` without the leaves the inference forward never reads: the
    target colors, mask and labels, the backward-only reverse tables, and
    the COO lists of edge sets that have ELL tables."""
    levels = tuple(dataclasses.replace(
        lv, edges=_inference_edges(lv.edges),
        dilated={d: _inference_edges(e) for d, e in lv.dilated.items()})
        for lv in graph.levels)
    return dataclasses.replace(graph, color=None, mask=None, labels=None,
                               levels=levels)


class PackedPlacer:
    """Moves a host graph to `device` in ONE host-to-device copy: every
    leaf (int32 or float32) is packed into a pinned int32 buffer, copied
    with `non_blocking=True`, and sliced back into typed views on the
    device. The pinned buffer is reused across calls; an event recorded
    after each copy guards it from being refilled while a copy still reads
    it. On a CPU device the graph is moved leaf by leaf."""

    def __init__(self, device: torch.device):
        self.device = device
        self._pinned = None        # reusable pinned host buffer (int32)
        self._copy_done = None     # event after the last copy out of it

    def __call__(self, graph: HierarchicalGraph) -> HierarchicalGraph:
        if self.device.type != "cuda":
            return graph.to(self.device)
        leaves = tensor_leaves(graph)
        for t in leaves:
            if t.dtype not in (torch.int32, torch.float32):
                raise TypeError(f"graph leaf of dtype {t.dtype}: the packed "
                                "copy takes int32 and float32 leaves")
        total = sum(t.numel() for t in leaves)
        if self._pinned is None or self._pinned.numel() < total:
            self._pinned = torch.empty(total, dtype=torch.int32,
                                       pin_memory=True)
        elif self._copy_done is not None:
            self._copy_done.synchronize()
        off = 0
        for t in leaves:
            n = t.numel()
            self._pinned[off:off + n].copy_(
                t.reshape(-1).view(torch.int32))
            off += n
        flat = self._pinned[:total].to(self.device, non_blocking=True)
        self._copy_done = torch.cuda.Event()
        self._copy_done.record()

        offset = [0]

        def unpack(t):
            n = t.numel()
            view = flat[offset[0]:offset[0] + n].view(t.dtype).view(t.shape)
            offset[0] += n
            return view

        return map_tensors(graph, unpack)


class SceneInpainter:
    """Serve `model(graph)` over preprocessed scene hierarchies.

    model: a port generator (models/factory.define_G); state_dict: its
    weights (reference key layout). impl=None runs the CUDA kernels on a
    CUDA device; impl="plain" runs the plain torch versions there. The
    server keeps its own copy of `model`; the caller's is left as it is.
    """

    def __init__(self, model: torch.nn.Module, state_dict, *,
                 device="cuda", impl: Optional[str] = None):
        self.device = resolve_device(device)
        self.impl = impl
        model = copy.deepcopy(model)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self._placer = PackedPlacer(self.device)

    def build(self, scene: RawHierarchy) -> HierarchicalGraph:
        """The scene's padded hierarchy, on the host, padded to the
        geometric bucket ladder (as the JAX server pads)."""
        return build_hierarchical_graph([scene], geometric=True)

    def place(self, graph: HierarchicalGraph) -> HierarchicalGraph:
        """Move the leaves of a host graph that the forward reads to the
        device, in one host-to-device copy."""
        return self._placer(inference_graph(graph))

    @torch.inference_mode()
    def forward(self, graph: HierarchicalGraph) -> torch.Tensor:
        """The generator on a graph already on the device."""
        with full_f32_matmuls():
            return self.model(graph, impl=self.impl)

    def predict(self, scene: RawHierarchy) -> np.ndarray:
        """Inpaint one scene; returns [num_vertices, output_nc] colors for
        the valid level-0 vertices."""
        out = self.forward(self.place(self.build(scene)))
        return out[:scene.num_vertices[0]].cpu().numpy()

    def warmup(self, scenes: Sequence[RawHierarchy]) -> None:
        """Serve each representative scene once, so the kernels are built
        and loaded and the allocator has its buffers before live traffic."""
        for s in scenes:
            self.predict(s)
