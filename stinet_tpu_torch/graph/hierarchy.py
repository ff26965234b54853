"""HierarchicalGraph: the padded multi-level graph the model runs over.

PyTorch counterpart of `stinet_tpu/graph/hierarchy.py`. The layout is the
same static-shape, padded one:

  * vertices of level l live in rows [0, num_vertices[l]) of a [V_pad_l, C]
    buffer; row V_pad-1 is the "trash" vertex that pad edges and pad trace
    entries point at;
  * edges are COO int32 pairs sorted by destination and padded with
    (trash, trash) self-edges, plus the ELL tables of ops/ell.py;
  * traces map a fine vertex to its coarse representative; children tables
    are the inverse map used by gather-only pooling;
  * `graph_id` assigns every vertex to its scene (pad rows = num_graphs).

Every array is a torch tensor. `num_vertices` and `num_edges` are 0-d int32
tensors, so a forward reads them on the device without a host round trip;
`halo` and `num_graphs` are Python ints.

A stacked batch (graph/build.py `stack_graphs`) is one graph whose every
tensor carries a leading scene axis [B, ...]; `scene_of` takes scene i out
of it, and `tree_structure` stands in for JAX's treedef when graphs are
checked for a shared layout.
"""
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def map_tensors(obj, fn):
    """Rebuild `obj` (a graph dataclass, tuple or dict of them) with `fn`
    applied to every tensor leaf (a torch tensor, or a numpy array of a
    host-side layout such as graph/partition.py's). None and Python
    scalars pass through."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(map_tensors(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: map_tensors(v, fn) for k, v in obj.items()}
    return obj


def tensor_leaves(obj):
    """Tensor leaves of `obj` in the order `map_tensors` visits them."""
    out = []
    map_tensors(obj, lambda t: out.append(t) or t)
    return out


TENSOR = "<tensor>"   # a tensor leaf in `tree_structure`


def tree_structure(obj):
    """A hashable description of `obj` with every tensor leaf replaced by
    TENSOR: dataclass types and fields, tuple lengths, dict keys, where the
    None leaves are, and the static ints (`halo`, `num_graphs`). Two graphs
    with equal structures hold their tensors at the same places, as two
    pytrees with one JAX treedef do; their shapes may still differ."""
    if isinstance(obj, torch.Tensor):
        return TENSOR
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                tuple((f.name, tree_structure(getattr(obj, f.name)))
                      for f in dataclasses.fields(obj)))
    if isinstance(obj, tuple):
        return tuple(tree_structure(o) for o in obj)
    if isinstance(obj, dict):
        return ("dict", tuple(sorted((k, tree_structure(v))
                                     for k, v in obj.items())))
    return obj


def scene_of(stacked, i: int):
    """Scene i of a stacked graph: every tensor indexed at i of its leading
    scene axis (views, no copy)."""
    return map_tensors(stacked, lambda t: t[i])


@dataclasses.dataclass
class EdgeSet:
    src: torch.Tensor          # [E_pad] int32, sender ids, sorted by dst
    dst: torch.Tensor          # [E_pad] int32, receiver ids (sorted)
    num_edges: torch.Tensor    # 0-d int32, count of valid (non-pad) edges
    degree: torch.Tensor       # [V_pad] float32, valid in-degree per vertex
    # ELL tables (ops/ell.py); None when the builder chose pure COO. Edges
    # beyond the slot cap spill to the small COO list spill_src/spill_dst.
    nbr: Optional[torch.Tensor] = None         # [V_pad, D] int32
    rev_dst: Optional[torch.Tensor] = None     # [V_pad, D_out] int32
    out_degree: Optional[torch.Tensor] = None  # [V_pad] f32
    ell_degree: Optional[torch.Tensor] = None  # [V_pad] f32
    spill_src: Optional[torch.Tensor] = None   # [S_pad] int32
    spill_dst: Optional[torch.Tensor] = None   # [S_pad] int32
    halo: Optional[int] = None  # band bound of windowed builds


@dataclasses.dataclass
class GraphLevel:
    edges: EdgeSet
    num_vertices: torch.Tensor   # 0-d int32, valid vertex count
    graph_id: torch.Tensor       # [V_pad] int32; pad rows = num_graphs
    # dilated edge sets of the bottleneck, keyed by dilation distance
    dilated: Dict[int, EdgeSet] = dataclasses.field(default_factory=dict)

    @property
    def num_padded_vertices(self) -> int:
        return self.graph_id.shape[0]


@dataclasses.dataclass
class HierarchicalGraph:
    x: torch.Tensor                     # [V0_pad, C] input features
    color: torch.Tensor                 # [V0_pad, 3] ground-truth colors
    mask: torch.Tensor                  # [V0_pad, 1] inpainting mask
    levels: Tuple[GraphLevel, ...]      # level 0 (finest) .. L-1
    traces: Tuple[torch.Tensor, ...]    # traces[l]: [V_pad_l] -> level l+1
    num_graphs: int = 1
    labels: Optional[torch.Tensor] = None   # [V0_pad] int32
    # children[l]: [V_pad_{l+1}, C] int32 (None: a cluster was too large,
    # pooling at that level takes the segment ops)
    children: Tuple = ()
    child_counts: Tuple = ()            # counts[l]: [V_pad_{l+1}] f32

    def to(self, device) -> "HierarchicalGraph":
        return map_tensors(self, lambda t: t.to(device))
