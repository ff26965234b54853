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

Not ported: JAX's `graph_sharding` and `param_sharding`, GSPMD layouts of
data-parallel training; they come with the training half (ROADMAP.md).
"""
from typing import List, Optional

import torch

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


class ProcessMesh:
    """One partition a rank of the initialised default `torch.distributed`
    process group, on `device`."""
    processes = True

    def __init__(self, device):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs an initialised "
                               "torch.distributed process group")
        self._dist = dist
        self.n_parts = dist.get_world_size()
        self.rank = dist.get_rank()
        self.device = resolve_device(device)
        self.parts = [self.rank]

    def ring_shift(self, bufs: List[torch.Tensor]) -> List[torch.Tensor]:
        (buf,) = bufs
        if self.n_parts == 1:
            return [buf]
        dist = self._dist
        buf = buf.contiguous()
        recv = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf, (self.rank + 1) % self.n_parts),
               dist.P2POp(dist.irecv, recv, (self.rank - 1) % self.n_parts)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [recv]

    def sum(self, partials: List[torch.Tensor]) -> List[torch.Tensor]:
        (total,) = partials
        total = total.clone()
        self._dist.all_reduce(total)
        return [total]

    def gather(self, outs: List[torch.Tensor]) -> torch.Tensor:
        """Every partition's rows (equal shapes), concatenated in rank
        order, on every rank."""
        (out,) = outs
        out = out.contiguous()
        parts = [torch.empty_like(out) for _ in range(self.n_parts)]
        self._dist.all_gather(parts, out)
        return torch.cat(parts)

    def all_gather_object(self, obj) -> list:
        """Every rank's `obj`, in rank order, on every rank."""
        out = [None] * self.n_parts
        self._dist.all_gather_object(out, obj)
        return out


def make_mesh(n_parts: Optional[int] = None, device="cuda",
              processes: bool = False):
    """A mesh of partitions on `device`: with `processes`, the
    `ProcessMesh` of the initialised torch.distributed process group
    (n_parts, if given, must be its size); else the `InProcessMesh` of
    n_parts partitions (default 1)."""
    if processes:
        mesh = ProcessMesh(device)
        if n_parts is not None and n_parts != mesh.n_parts:
            raise ValueError(f"{n_parts} partitions asked of a process "
                             f"group of {mesh.n_parts}")
        return mesh
    return InProcessMesh(1 if n_parts is None else n_parts, device)
