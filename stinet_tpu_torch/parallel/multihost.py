"""Multi-process training over `torch.distributed`.

PyTorch counterpart of `stinet_tpu/parallel/multihost.py`. A torch process
drives one card, so a run across cards is a process group, one rank a
card, started by `torchrun` (`python -m torch.distributed.run
--nproc_per_node N -m stinet_tpu_torch.train -c cfg.json`). This module is
the trainers' entry to that group:

  * `initialize`: idempotent `init_process_group`; without arguments only
    under torchrun's environment, so `train.py` calls it unconditionally;
  * `process_index`, `process_count`, `is_primary`: rank 0 writes the
    checkpoints and TensorBoard logs, every rank computes;
  * `local_scene_shard`: a rank's round-robin share of a scene list;
  * `merge_widths_across_hosts`, `sum_array_across_hosts`,
    `mean_scalar_metrics`, `sync_hosts`: the collectives of the trainers'
    host side (stacked signatures, full-scene confusion matrices, epoch
    logs, the barriers at the save points).

Every collective here runs on CPU tensors under gloo and on the rank's
card under NCCL (NCCL takes no CPU tensor). Outside a group of more than
one rank every helper is the identity, so the trainers call them
unconditionally. `make_global_mesh` is JAX's: the group's
`parallel/mesh.py:ProcessMesh`, with a model axis.
"""
import logging
import os
import zlib

import numpy as np
import torch

_log = logging.getLogger(__name__)

# torchrun's environment: present on every rank it starts
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")

_initialized = False


def _dist():
    import torch.distributed as dist
    return dist


def _in_group() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def initialize(init_method=None, world_size=None, rank=None, backend=None,
               local_rank=None) -> bool:
    """Set up the default process group once; returns whether this call
    did. With explicit arguments it always does (`init_method` defaults to
    "env://"). Without them it does only under torchrun's environment
    (RANK, WORLD_SIZE and MASTER_ADDR set): a plain single-process run is
    left as it is. The backend is NCCL where a card is present and gloo
    otherwise, unless `backend` names one. Under NCCL the rank's card
    (`local_rank`, else LOCAL_RANK, else 0) becomes the current device
    before the first collective."""
    global _initialized
    if _initialized or _in_group():
        return False
    explicit = (init_method is not None or world_size is not None
                or rank is not None)
    if not explicit and not all(os.environ.get(k) for k in _TORCHRUN_ENV):
        return False
    dist = _dist()
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank)
    _initialized = True
    _log.info("torch.distributed initialised: rank %d of %d, backend %s",
              dist.get_rank(), dist.get_world_size(), backend)
    return True


def process_index() -> int:
    return _dist().get_rank() if _in_group() else 0


def process_count() -> int:
    return _dist().get_world_size() if _in_group() else 1


def is_primary() -> bool:
    """True on the rank that writes checkpoints, TensorBoard logs and run
    directories (rank 0). Always True in one process."""
    return process_index() == 0


def describe() -> str:
    """This process's place in words: its rank, the group's size and
    backend, or that it is one process without a group."""
    if not _in_group():
        return "one process"
    dist = _dist()
    return (f"rank {dist.get_rank()} of {dist.get_world_size()}, backend "
            f"{dist.get_backend()}")


def collective_device() -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under NCCL, the CPU under gloo."""
    if _dist().get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def local_scene_shard(items, index=None, count=None):
    """A rank's deterministic share of a scene list: rank i of n takes
    items[i::n] (shares differ by at most one). The identity in one
    process. Every rank passes the same ordering (shard after the seeded
    shuffle)."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    if count <= 1:
        return list(items)
    return list(items)[index::count]


def host_local_block(arr) -> np.ndarray:
    """This rank's rows of a batch as a host array. A torch tensor holds
    only its rank's rows (the data-parallel steps take a rank's slice of
    the batch, `trainers/graph_common.py:place_stacked`), so this is the
    copy to the host; JAX's version assembles the rows a host addressed."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def _same_everywhere(obj, what):
    """Raise unless every rank passes an equal `obj` (all_gather_object)."""
    objs = [None] * process_count()
    _dist().all_gather_object(objs, obj)
    if any(o != objs[0] for o in objs):
        raise RuntimeError(f"{what} differ across ranks; this rank "
                           f"({process_index()}): {obj}")


def merge_widths_across_hosts(widths):
    """Max-merge stacked table-width dicts (graph/build.py:table_widths'
    format) across ranks, so every rank pads to one signature. Raises
    when the key sets differ (other dilation sets or ELL layouts). The
    identity in one process. A collective: every rank calls it, in the same
    order."""
    if process_count() <= 1:
        return dict(widths)
    keys = sorted(widths, key=lambda k: (
        k[0], -1 if k[1] is None else int(k[1]), str(k[2])))
    _same_everywhere(keys, "stacked width keys")
    vals = [None] * process_count()
    _dist().all_gather_object(vals, [int(widths[k]) for k in keys])
    return {k: int(v) for k, v in zip(keys, np.max(np.asarray(vals), 0))}


def sum_array_across_hosts(arr) -> np.ndarray:
    """Elementwise float64 sum of a same-shape array across ranks (the
    identity in one process): exact for integer-valued arrays below 2^53,
    such as confusion matrices. A collective: call it on every rank, a rank
    with nothing to add passing zeros, never behind a data-dependent gate."""
    if process_count() <= 1:
        return np.asarray(arr)
    t = torch.as_tensor(np.asarray(arr, np.float64)).to(collective_device())
    _dist().all_reduce(t)
    return t.cpu().numpy()


def mean_scalar_metrics(log, weight=1.0):
    """Every float of an epoch log averaged across ranks with this rank's
    `weight`, so the monitor's decisions (best checkpoint, early stop,
    plateau) agree on every rank. Ints and bools pass through. The key
    sets must be equal on every rank, else RuntimeError (a missing metric
    would split the monitor's decisions and hang the save barriers). The
    identity in one process."""
    if process_count() <= 1:
        return log
    keys = sorted(k for k, v in log.items()
                  if isinstance(v, (float, np.floating))
                  and not isinstance(v, bool))
    sig = [len(keys), zlib.crc32("\x00".join(keys).encode())]
    objs = [None] * process_count()
    _dist().all_gather_object(objs, sig)
    if any(o != objs[0] for o in objs):
        raise RuntimeError(
            "mean_scalar_metrics: the ranks' metric key sets differ (this "
            f"rank: {keys}). Epoch logs must have the same keys on every "
            "rank.")
    if not keys:
        return log
    w = float(weight)
    t = torch.tensor([float(log[k]) * w for k in keys] + [w],
                     dtype=torch.float64, device=collective_device())
    _dist().all_reduce(t)
    vals = t.cpu().numpy()
    total = max(float(vals[-1]), 1e-12)
    out = dict(log)
    for k, v in zip(keys, vals[:-1] / total):
        out[k] = float(v)
    return out


def make_global_mesh(model_parallel=1, device="cuda"):
    """The mesh over every rank of the group (every rank calls it with the
    same arguments): `ProcessMesh` on `device`, a grid of data ranks by
    `model_parallel` model ranks (JAX's (data, model) mesh)."""
    from stinet_tpu_torch.parallel.mesh import ProcessMesh
    return ProcessMesh(device, model_parallel)


def sync_hosts(name="barrier"):
    """A barrier across ranks (nothing in one process), at the save points,
    so no rank runs ahead into the next epoch while rank 0 writes."""
    if process_count() <= 1:
        return
    _log.debug("barrier %s", name)
    _dist().barrier()
