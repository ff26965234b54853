"""Tensor parallelism over the model axis of a process mesh.

JAX's `make_sharded_train_step` over a mesh with a model axis above 1
lets GSPMD split every 2-D kernel `param_sharding` selects (an output at
least 128 wide that the model axis divides) and choose the collectives.
The port is held to JAX's results, not to its layout: a torch process
drives one card, and the split here is Megatron's MLP split around the
edge aggregation of each EdgeConv filter whose first linear that rule
splits (hidden width 2H at least 128 and divisible by the model axis T):

  * model rank m keeps rows [m 2H/T, (m+1) 2H/T) of `nn.0`'s weight and
    bias, so its P and Q are the same slice of the hidden channels;
  * the aggregation (K1 forward, and dp and dq in the backward), the
    mean's divide and the spill tail run on [V, 2H/T] with no
    communication, because each sums per channel;
  * the rank keeps the same columns of `nn.2`'s weight, and one
    all_reduce over the model ranks sums the partial products, to which
    `nn.2`'s bias, kept whole, is added;
  * the filter's input takes the sum of the model ranks' gradients in the
    backward (Megatron's f and g pair).

Everything else (K2, pooling, the other linears) runs on whole tensors,
replicated on the model ranks, which compute it alike and so keep the
replicated parameters bitwise equal (on a card under torch's
deterministic algorithms: the spill's `index_add_` is atomic otherwise,
and two ranks may sum it in other orders); the data ranks sum every
gradient
(`ProcessMesh.all_reduce_grads` over the data group), a sharded one over
the ranks that hold the same slice. `whole` gives back whole tensors (a
checkpoint's state dict, gradients) on every rank; collectives on the
card are `all_reduce` and `broadcast` only, as gloo takes them there.
"""
import torch
import torch.nn.functional as F

from stinet_tpu_torch.models.stinet import EdgeConvFilter
from stinet_tpu_torch.ops.message_passing import edge_conv_aggregate
from stinet_tpu_torch.parallel.mesh import param_sharding


class _ToModelRanks(torch.autograd.Function):
    """The identity; its backward sums the gradient over the model ranks
    (each rank's slice of hidden channels gave a part of it)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_all_reduce_(g.contiguous().clone()), None


class _FromModelRanks(torch.autograd.Function):
    """The sum of the model ranks' partials; its backward the identity
    (every rank uses the whole sum alike)."""

    @staticmethod
    def forward(ctx, partial, mesh):
        return mesh.model_all_reduce_(partial.detach().contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class TensorParallelEdgeConv(EdgeConvFilter):
    """An EdgeConvFilter that holds its model rank's slice of the hidden
    channels, `hidden` = (start, stop) of 2H (module docstring); made by
    `shard_model`, on a process mesh `mesh` with a model axis."""

    def forward(self, x, edges, impl=None):
        p, q = self.projections(_ToModelRanks.apply(x, self.mesh))
        agg = edge_conv_aggregate(p, q, edges, impl=impl)
        dt = self.dtype or agg.dtype
        partial = F.linear(agg.to(dt), self.nn[2].weight.to(dt))
        return (_FromModelRanks.apply(partial, self.mesh)
                + self.nn[2].bias.to(dt))


# each sliced tensor of a TensorParallelEdgeConv: its key and split dim
_SLICED = (("nn.0.weight", 0), ("nn.0.bias", 0), ("nn.2.weight", 1))


def _keep(param, dim, start, stop, optimizer):
    """Cut `param` (in place: the same Parameter object) and any optimizer
    state of its shape to [start, stop) along `dim`."""
    state = optimizer.state.get(param, {}) if optimizer is not None else {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor) and v.shape == param.shape:
            state[k] = v.narrow(dim, start, stop - start).clone()
    param.data = param.data.narrow(dim, start, stop - start).clone()


def shard_model(model, mesh, optimizer=None):
    """Turn, in place, every EdgeConvFilter of `model` whose first linear
    `param_sharding` splits over `mesh.model_parallel` into a
    TensorParallelEdgeConv holding this model rank's slice. The whole
    parameters and buffers are rank 0's first (one broadcast over every
    rank each). Parameters keep their objects, so an optimizer built on
    `model.parameters()` still holds them; its state for them is sliced
    alike. Returns the names of the sharded filters. Nothing is sharded at
    a model axis of 1."""
    tp = getattr(mesh, "model_parallel", 1)
    if tp == 1:
        return []
    dist, m = mesh._dist, mesh.model_rank
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, 0)
    names = []
    for name, mod in model.named_modules():
        if type(mod) is not EdgeConvFilter or param_sharding(
                {"w": mod.nn[0].weight}, tp)["w"] != ("model", None):
            continue
        width = mod.nn[0].weight.shape[0] // tp
        start, stop = m * width, (m + 1) * width
        for key, dim in _SLICED:
            _keep(mod.get_parameter(key), dim, start, stop, optimizer)
        mod.__class__ = TensorParallelEdgeConv
        mod.mesh, mod.hidden = mesh, (start, stop)
        names.append(name)
    return names


def whole(model, tensors):
    """`tensors` keyed like `model`'s state dict (its state dict, or the
    parameters' gradients), with every slice of a TensorParallelEdgeConv
    made whole on every rank: placed in zeros of the whole shape and
    summed over the model ranks (exact: the other ranks add zeros)."""
    out = dict(tensors)
    for name, mod in model.named_modules():
        if not isinstance(mod, TensorParallelEdgeConv):
            continue
        start, stop = mod.hidden
        for key, dim in _SLICED:
            key = f"{name}.{key}" if name else key
            part = out.get(key)
            if part is None:
                continue
            shape = list(part.shape)
            shape[dim] = shape[dim] * mod.mesh.model_parallel
            full = torch.zeros(shape, dtype=part.dtype, device=part.device)
            full.narrow(dim, start, stop - start).copy_(part)
            out[key] = mod.mesh.model_all_reduce_(full)
    return out
