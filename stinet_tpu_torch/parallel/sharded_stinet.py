"""The full STINet forward under graph-partition (halo) parallelism.

PyTorch counterpart of `stinet_tpu/parallel/sharded_stinet.py`. It runs
the whole flagship forward over the partitioned layout of
`graph/partition.py`, each partition on its own rows:

  * dense projections (P/Q, Lin2, shortcut, head): local matmuls on each
    partition's [vp, C] rows;
  * EdgeConv aggregation: the pipelined ring halo exchange (parallel/
    halo.py), then the SAME `edge_conv_aggregate` as the single-device
    model (ops/message_passing.py) over the extended sender space: K1 on a
    CUDA tensor, with q of Vp + S*W rows (more than p's);
  * pooling and unpooling: local by construction (ownership propagated down
    the hierarchy at build time), with the children-table ops of ops/ell.py;
  * instance norm: masked sums added over the mesh (parallel/
    sharded_block.py), not K2.

The forward walks the model's own modules (models/stinet.py), so one state
dict serves both paths. It keeps JAX's refusals: instance norm only, no
label embedding, EdgeConv filters, pooling "mean" or "max".

`make_sharded_train_step` trains through it: autograd runs back through
the mesh's collectives (parallel/mesh.py) and the halo gathers (a
scatter-add into the previous buffer), and K1's dp and dq run on the halo
layout, dq over q's Vp + S*W rows (ops/ell.py).
"""
from typing import List

import numpy as np
import torch

from stinet_tpu_torch.graph.hierarchy import map_tensors
from stinet_tpu_torch.graph.partition import PartitionedGraph, shard
from stinet_tpu_torch.models.stinet import (
    EdgeConvFilter, GraphNormLayer, SurfaceTextureInpaintingNet, _dense)
from stinet_tpu_torch.ops.ell import ell_pool_max, ell_pool_mean, ell_unpool
from stinet_tpu_torch.parallel.sharded_block import (
    sharded_instance_norm, sharded_resnet_block)
from stinet_tpu_torch.serving import full_f32_matmuls


def check_partitionable(model: SurfaceTextureInpaintingNet) -> None:
    """Raise unless the partitioned forward covers `model`'s config (JAX's
    refusals, sharded_stinet.py:180-190)."""
    norms = {m.norm_type for m in model.modules()
             if isinstance(m, GraphNormLayer)}
    if norms != {"instance"}:
        raise ValueError(f"the partitioned forward supports instance norm "
                         f"only, got {sorted(norms)}")
    if model.use_label_embedding:
        raise NotImplementedError(
            "the partitioned forward does not thread the label embedding "
            "(encoder block 0 is widened by num_embedding)")
    if model.pooling_type not in ("mean", "max"):
        raise ValueError(f"unknown pooling type {model.pooling_type!r}")
    for name, m in model.named_modules():
        if name.endswith("first_filter") and not isinstance(m,
                                                            EdgeConvFilter):
            raise ValueError(f"the partitioned forward supports EdgeConv "
                             f"filters only, got {type(m).__name__} at "
                             f"{name}")


def make_sharded_stinet(mesh, model: SurfaceTextureInpaintingNet,
                        impl=None):
    """apply(graphs) -> one [vp0, output_nc] tensor for each partition of
    `graphs` (`place_partitioned`'s list), in the compute dtype. Raises for
    a model the partitioned forward does not cover."""
    check_partitionable(model)
    pool = ell_pool_mean if model.pooling_type == "mean" else ell_pool_max

    def block(b, xs, levels, edges):
        return sharded_resnet_block(b, xs, edges,
                                    [lv.vmask for lv in levels], mesh, impl)

    def apply(graphs: List[PartitionedGraph]) -> List[torch.Tensor]:
        L = model.n_levels
        lv = [[g.levels[i] for g in graphs] for i in range(L + 1)]
        outs = [g.x for g in graphs]
        for b in model.input_blocks:
            outs = block(b, outs, lv[0], [l.edges for l in lv[0]])

        for i, b in enumerate(model.encoder_blocks):
            outs = [pool(o, g.traces[i], g.children[i], g.child_counts[i])
                    for o, g in zip(outs, graphs)]
            outs = block(b, outs, lv[i + 1], [l.edges for l in lv[i + 1]])

        for d, b in zip(model.dilations, model.bottleneck_blocks):
            outs = block(b, outs, lv[L], [l.dilated[d] if d > 1 else l.edges
                                          for l in lv[L]])

        for i, b in enumerate(model.decoder_blocks):
            f = L - i - 1
            outs = [ell_unpool(o, g.traces[f], g.children[f],
                               g.child_counts[f])
                    for o, g in zip(outs, graphs)]
            outs = block(b, outs, lv[f], [l.edges for l in lv[f]])

        for b in model.output_blocks:
            outs = block(b, outs, lv[0], [l.edges for l in lv[0]])

        outs = [_dense(model.final_linear1, o, model.dtype) for o in outs]
        normed = sharded_instance_norm(
            [o.to(torch.promote_types(o.dtype, torch.float32))
             for o in outs],
            [l.vmask for l in lv[0]], mesh, eps=model.final_norm1.eps)
        outs = [torch.nn.functional.elu(n.to(o.dtype))
                for n, o in zip(normed, outs)]
        return [torch.tanh(_dense(model.final_linear2, o, model.dtype))
                for o in outs]

    return apply


def place_partitioned(mesh, pg: PartitionedGraph, placer
                      ) -> List[PartitionedGraph]:
    """The partitions this process holds (`mesh.parts`), each its shard of
    every leaf as a torch tensor on `mesh.device`, moved by `placer`
    (serving.PackedPlacer: one host-to-device copy). The in-process mesh
    copies each leaf whole and cuts views; a process mesh copies its
    rank's shard only."""
    if mesh.processes:
        (p,) = mesh.parts
        host = map_tensors(shard(pg, p, pg.n_parts), np.ascontiguousarray)
    else:
        host = pg
    placed = placer(map_tensors(host, torch.from_numpy))
    if mesh.processes:
        return [placed]
    return [shard(placed, p, pg.n_parts) for p in mesh.parts]


def make_sharded_train_step(mesh, model: SurfaceTextureInpaintingNet,
                            optimizer, use_mask_weighted=True, impl=None):
    """(train_step, loss_fn): the full train step on the partitioned
    layout, the counterpart of JAX's (sharded_stinet.py:213-236).

    loss_fn(graphs) -> (loss, share): the masked-composite L1
    (trainers/graph_common.py:inpainting_loss_terms) over the valid level-0
    rows of all partitions, its count summed over the mesh. `loss` is the
    global value; `share` is this process's sum over the global count, so
    that its backward, summed over the ranks, is the loss's gradient (on
    the in-process mesh `share` is `loss`).
    train_step(graphs, lr) -> loss: `share` backpropagated, the parameters'
    gradients summed over the ranks of a process mesh (they are
    replicated), one optimizer step at `lr`. f32 matmuls run in full f32,
    as in the single-device step. Raises as `make_sharded_stinet` for a
    model the partitioned forward does not cover."""
    from stinet_tpu_torch.trainers.graph_common import (
        inpainting_loss_terms, set_lr)
    apply = make_sharded_stinet(mesh, model, impl)

    def loss_fn(graphs: List[PartitionedGraph]):
        terms = [inpainting_loss_terms(o, g.color, g.mask, g.levels[0].vmask,
                                       use_mask_weighted)[:2]
                 for o, g in zip(apply(graphs), graphs)]
        n = torch.clamp(mesh.sum([n.detach() for _, n in terms])[0], min=1.0)
        wsum = sum(w for w, _ in terms)
        share = wsum / n
        if not mesh.processes:
            return share, share
        return mesh.sum([wsum.detach()])[0] / n, share

    def train_step(graphs: List[PartitionedGraph], lr):
        model.train()
        with full_f32_matmuls():
            optimizer.zero_grad(set_to_none=True)
            loss, share = loss_fn(graphs)
            share.backward()
            if mesh.processes:
                mesh.all_reduce_grads(list(model.parameters()))
            set_lr(optimizer, lr)
            optimizer.step()
        return loss.detach()

    return train_step, loss_fn
