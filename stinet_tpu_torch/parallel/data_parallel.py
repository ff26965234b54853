"""Sharded training step over a process mesh: dp, tp and their product.

PyTorch counterpart of `stinet_tpu/parallel/data_parallel.py`. JAX jits
one GSPMD step over a device mesh; a torch process drives one card, so
the port's mesh is the torch.distributed process group
(parallel/mesh.py:ProcessMesh), and the step is the stacked step of
trainers/graph_common.py with that mesh: each data rank runs the scenes of
its slice of a stacked batch, the gradients are summed over the data ranks
in one all_reduce, and every rank takes the same optimizer step. With a
model axis above 1 the wide EdgeConv filters are split over the model
ranks first (parallel/tensor_parallel.py).
"""
from stinet_tpu_torch.parallel.mesh import shard_graph
from stinet_tpu_torch.parallel.tensor_parallel import shard_model
from stinet_tpu_torch.trainers.graph_common import (
    make_stacked_inpainting_steps, place_stacked, replicate_to_mesh)


def make_sharded_train_step(model, optimizer, mesh, use_mask_weighted=False,
                            impl=None):
    """(train_step, place_state, place_graph, jit_step), the port's
    counterparts of JAX's:

      train_step(graph, lr) -> metrics: the stacked step
          (`make_stacked_inpainting_steps` with `mesh`) on this rank's
          slice of a stacked batch;
      place_state(): data rank 0's parameters, buffers and optimizer
          state on every data rank (`replicate_to_mesh`);
      place_graph(stacked) -> this rank's slice of a GLOBAL stacked batch
          on the mesh's device: `graph_sharding`'s rule (leaves whose dim
          0 the data rank count divides are split, the rest replicated);
      jit_step() -> train_step (eager torch has no program to compile).

    With a model axis above 1 the model is sharded first, in place
    (`shard_model`: rank 0's whole weights, then this model rank's slice
    of each wide EdgeConv filter, the optimizer's parameters kept);
    `tensor_parallel.whole` gives its whole state dict back. `mesh` None
    runs the step in one process, on the model's device."""
    if mesh is not None:
        shard_model(model, mesh, optimizer)
    train_step, _ = make_stacked_inpainting_steps(
        model, optimizer, use_mask_weighted, impl=impl, mesh=mesh)
    device = next(model.parameters()).device

    def place_state():
        replicate_to_mesh(mesh, model, optimizer)

    def place_graph(stacked):
        if mesh is not None:
            stacked = shard_graph(stacked, mesh.rank, mesh.n_parts)
        return place_stacked(mesh, stacked, device)

    def jit_step():
        return train_step

    return train_step, place_state, place_graph, jit_step
