"""Meshes of partitions for graph-partition serving.

PyTorch counterpart of `stinet_tpu/parallel/mesh.py:make_mesh`. A mesh
holds `n_parts` partitions of a graph; a process holds the partitions
`parts` of them, on one `device`. The partitioned code (parallel/halo.py,
sharded_block.py, sharded_stinet.py) runs the same per-partition steps on
either mesh, on lists with one entry per partition this process holds, and
uses two collectives:

  ring_shift(bufs)  partition i's buffer goes to partition i+1 (mod
                    n_parts), so partition i receives i-1's;
  sum(partials)     every partition gets the sum of all partitions'
                    partials.

Two meshes:

  * `InProcessMesh`: every partition in this process, on one device. The
    ring shift rotates the list; the sum adds the partials in partition
    order. JAX's tests run its mesh as 8 virtual CPU devices of one
    process; this is the port's counterpart, and the only way one card
    runs more than one partition (NCCL takes one rank a device).
  * `ProcessMesh`: the default `torch.distributed` process group, one
    partition a rank (partition = rank; on cards, each rank sets its own
    current device first). The ring shift is `batch_isend_irecv` to rank+1 and
    from rank-1; the sum is `all_reduce`. With two ranks the sum adds two
    numbers, which is exact in either order, so it gives the in-process
    mesh's bits.

Both meshes are differentiable, so the partitioned forward trains
(parallel/sharded_stinet.py:make_sharded_train_step). On the in-process
mesh autograd runs through the list rotation and the additions. On the
process mesh each collective is a `torch.autograd.Function` whose backward
is its transpose: the ring shift's sends the gradient to rank-1, the sum's
all-reduces the gradient (each rank's use of the total adds a share), the
gather's keeps the rank's rows (the gathered rows are used alike on every
rank). The process mesh is also the data mesh of data-parallel training
(`all_reduce_`, `broadcast_`, `all_reduce_grads`), where a rank holds its
slice of a stacked batch.

A process mesh may carry a model axis (`model_parallel`), as JAX's
(data, model) mesh does: the group's ranks form a grid of n_parts data
ranks by model_parallel model ranks, rank r at data index r //
model_parallel and model index r % model_parallel (JAX's reshape of its
device list). The partition and data collectives above run among the
ranks of one model index (`data_group`); the ranks of one data index
(`model_group`) split the wide layers' hidden channels
(parallel/tensor_parallel.py) and sum across them with
`model_all_reduce_`.

`graph_sharding` and `param_sharding` are JAX's layout rules as functions
(parallel/mesh.py:36-63 there): which leaves of a batch a rank slices, and
which weights a model axis splits.
"""
from typing import List, Optional

import torch

from stinet_tpu_torch.graph.hierarchy import map_tensors
from stinet_tpu_torch.serving import resolve_device


class InProcessMesh:
    """n_parts partitions, all in this process, on `device`."""
    processes = False

    def __init__(self, n_parts: int, device):
        if n_parts < 1:
            raise ValueError(f"a mesh needs at least 1 partition, got "
                             f"{n_parts}")
        self.n_parts = n_parts
        self.device = resolve_device(device)
        self.parts = list(range(n_parts))

    def ring_shift(self, bufs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [bufs[-1]] + list(bufs[:-1])

    def sum(self, partials: List[torch.Tensor]) -> List[torch.Tensor]:
        total = partials[0]
        for t in partials[1:]:
            total = total + t
        return [total] * len(partials)

    def gather(self, outs: List[torch.Tensor]) -> torch.Tensor:
        """Every partition's rows, concatenated in partition order."""
        return torch.cat(outs)


class _RingShift(torch.autograd.Function):
    """Rank r's buffer to rank r+1, rank r-1's back; the backward sends the
    gradient the other way round."""

    @staticmethod
    def forward(ctx, buf, mesh):
        ctx.mesh = mesh
        return mesh._shift(buf, +1)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._shift(g, -1), None


class _Sum(torch.autograd.Function):
    """The sum of every rank's partial on every rank; its backward sums the
    ranks' gradients, each rank's use of the total being one share."""

    @staticmethod
    def forward(ctx, partial, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(partial.detach().clone().contiguous())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone().contiguous()), None


class _Gather(torch.autograd.Function):
    """Every rank's rows (equal shapes), in rank order; the backward keeps
    this rank's rows of the gradient."""

    @staticmethod
    def forward(ctx, out, mesh):
        ctx.mesh, ctx.rows = mesh, out.shape[0]
        out = out.detach().contiguous()
        parts = [torch.empty_like(out) for _ in range(mesh.n_parts)]
        mesh._dist.all_gather(parts, out, group=mesh.data_group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        r = ctx.mesh.rank * ctx.rows
        return g[r:r + ctx.rows], None


class ProcessMesh:
    """One partition a data rank of the initialised default
    `torch.distributed` process group, on `device`; with `model_parallel`
    above 1 a grid of data and model ranks (module docstring). `rank` and
    `n_parts` are the data index and the data ranks; `model_rank` the
    model index. Every rank builds every subgroup, in one order."""
    processes = True

    def __init__(self, device, model_parallel: int = 1):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs an initialised "
                               "torch.distributed process group")
        world = dist.get_world_size()
        if model_parallel < 1 or world % model_parallel:
            raise ValueError(f"{world} ranks do not divide into a model "
                             f"axis of {model_parallel}")
        self._dist = dist
        self.model_parallel = model_parallel
        self.n_parts = world // model_parallel
        self.rank, self.model_rank = divmod(dist.get_rank(), model_parallel)
        self.device = resolve_device(device)
        self.parts = [self.rank]
        self.data_group = self.model_group = None    # None: every rank
        if model_parallel > 1:
            for d in range(self.n_parts):
                group = dist.new_group([self._global(d, m)
                                        for m in range(model_parallel)])
                if d == self.rank:
                    self.model_group = group
            for m in range(model_parallel):
                group = dist.new_group([self._global(d, m)
                                        for d in range(self.n_parts)])
                if m == self.model_rank:
                    self.data_group = group

    def _global(self, data_rank, model_rank=None):
        """The group rank at `data_rank` and `model_rank` (this rank's)."""
        if model_rank is None:
            model_rank = self.model_rank
        return data_rank * self.model_parallel + model_rank

    def _shift(self, buf, step):
        """buf to rank + step, rank - step's received (no autograd)."""
        dist = self._dist
        buf = buf.detach().contiguous()
        recv = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf,
                          self._global((self.rank + step) % self.n_parts)),
               dist.P2POp(dist.irecv, recv,
                          self._global((self.rank - step) % self.n_parts))]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    def ring_shift(self, bufs: List[torch.Tensor]) -> List[torch.Tensor]:
        (buf,) = bufs
        if self.n_parts == 1:
            return [buf]
        return [_RingShift.apply(buf, self)]

    def sum(self, partials: List[torch.Tensor]) -> List[torch.Tensor]:
        (total,) = partials
        return [_Sum.apply(total, self)]

    def gather(self, outs: List[torch.Tensor]) -> torch.Tensor:
        """Every partition's rows (equal shapes), concatenated in rank
        order, on every rank."""
        (out,) = outs
        return _Gather.apply(out, self)

    def all_gather_object(self, obj) -> list:
        """Every rank's `obj`, in rank order, on every rank."""
        out = [None] * self.n_parts
        self._dist.all_gather_object(out, obj, group=self.data_group)
        return out

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the ranks, in place (contiguous t); returns t.
        Under gloo a card's tensor is taken too (gloo's all_reduce and
        broadcast take CUDA tensors)."""
        if self.n_parts > 1:
            self._dist.all_reduce(t, group=self.data_group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Data rank `src`'s t on every data rank, in place; returns t."""
        if self.n_parts > 1:
            self._dist.broadcast(t, self._global(src),
                                 group=self.data_group)
        return t

    def model_all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the model ranks of this data index, in place
        (contiguous t); returns t."""
        if self.model_parallel > 1:
            self._dist.all_reduce(t, group=self.model_group)
        return t

    def all_reduce_grads(self, params) -> None:
        """Every parameter's gradient summed over the ranks, in one
        all_reduce of one flat buffer (a parameter without a gradient adds
        zeros, and keeps none where no rank has one)."""
        params = [p for p in params if p.requires_grad]
        if self.n_parts <= 1 or not params:
            return
        ref = next((p.grad for p in params if p.grad is not None), None)
        dtype = ref.dtype if ref is not None else params[0].dtype
        flat = torch.cat(
            [(p.grad if p.grad is not None else torch.zeros_like(p)
              ).reshape(-1).to(dtype) for p in params]
            + [torch.tensor([float(p.grad is not None) for p in params],
                            dtype=dtype, device=params[0].device)])
        self.all_reduce_(flat)
        has = flat[-len(params):].tolist()
        i = 0
        for p, h in zip(params, has):
            n = p.numel()
            if h > 0:
                p.grad = flat[i:i + n].view_as(p).to(p.dtype).clone()
            i += n


def _split(t, n_data: int) -> bool:
    """JAX's data-axis rule: dim 0 of the leaf divides over the ranks."""
    return t.ndim >= 1 and t.shape[0] % n_data == 0 \
        and t.shape[0] >= n_data


def graph_sharding(graph, n_data: int):
    """JAX's data-axis layout rule (parallel/mesh.py:graph_sharding) for
    a batch of `n_data` ranks: a leaf whose dim 0 `n_data` divides (and is
    at least `n_data`) is split on dim 0, ("data",); every other leaf is
    replicated, (). Returns the tree of specs, the graph's shape."""
    return map_tensors(graph, lambda t: ("data",) if _split(t, n_data)
                       else ())


def shard_graph(graph, rank: int, n_data: int):
    """Rank `rank`'s part of `graph` under `graph_sharding`: its contiguous
    dim-0 block of every split leaf, every replicated leaf whole."""
    def piece(t):
        if not _split(t, n_data):
            return t
        b = t.shape[0] // n_data
        return t[rank * b:(rank + 1) * b]
    return map_tensors(graph, piece)


def param_sharding(params, n_model: int, min_dim: int = 128):
    """JAX's tensor-parallel layout rule (parallel/mesh.py:param_sharding)
    on torch's layout, {name: spec}: a 2-D weight ([out, in], a Linear's)
    whose output dim `n_model` divides and is at least `min_dim` wide
    splits its output dim, ("model", None); everything else is replicated,
    (). JAX's kernels are [in, out], hence its P(None, "model"). Pure data
    parallelism (n_model 1) replicates everything."""
    def spec(t):
        if (n_model > 1 and t.dim() == 2 and t.shape[0] % n_model == 0
                and t.shape[0] >= min_dim):
            return ("model", None)
        return ()
    return {k: spec(v) for k, v in params.items()}


def make_mesh(n_parts: Optional[int] = None, device="cuda",
              processes: bool = False, model_parallel: int = 1):
    """A mesh of partitions on `device`: with `processes`, the
    `ProcessMesh` of the initialised torch.distributed process group with
    a model axis of `model_parallel` (n_parts, if given, must be its data
    ranks: the group's size over model_parallel); else the
    `InProcessMesh` of n_parts partitions (default 1), which has no model
    axis (its partitions share one card)."""
    if processes:
        mesh = ProcessMesh(device, model_parallel)
        if n_parts is not None and n_parts != mesh.n_parts:
            raise ValueError(f"{n_parts} partitions asked of a process "
                             f"group of {mesh.n_parts} data ranks")
        return mesh
    if model_parallel != 1:
        raise ValueError("a model axis needs a process mesh "
                         "(processes=True): one rank a model index")
    return InProcessMesh(1 if n_parts is None else n_parts, device)
