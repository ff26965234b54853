"""The port's multi-process helpers (stinet_tpu_torch/parallel/
multihost.py, the layout rules of parallel/mesh.py and the trainers'
gating in trainers/base.py), on the CPU.

- In one process: `local_scene_shard` equals JAX's at explicit index and
  count for 1-4 ranks, every helper is the identity JAX's is,
  `initialize` sets up a group only with arguments or under torchrun's
  environment, and `graph_sharding` / `param_sharding` give JAX's specs
  (param_sharding on torch's [out, in] layout, JAX's transposed).
- Under 2 gloo ranks (torch.multiprocessing.spawn on a free localhost
  port, one intra-op thread a rank): table widths max-merge and different
  key sets raise on every rank; `sum_array_across_hosts` stays exact on
  integers above 2^40; `mean_scalar_metrics` is weighted, passes ints
  through and raises on different key sets; only rank 0 writes
  checkpoints, and both ranks pass the save barriers (JAX's
  tests/test_multihost.py:123).

`run_gloo` is the spawn helper the other gloo tests import.
"""
import logging
import os
import socket
import tempfile
import time

import numpy as np
import pytest
import torch

from stinet_tpu_torch.parallel import mesh as port_mesh
from stinet_tpu_torch.parallel import multihost

SPAWN_TIMEOUT = 300


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo_entry(rank, fn, world, port, out_dir, args):
    """One rank: one intra-op thread, the gloo group through
    `multihost.initialize`, fn(rank, world, *args) saved to
    out_dir/rank{rank}.pt."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ["STINET_DISABLE_GIT_TAG"] = "1"
    multihost.initialize(f"tcp://localhost:{port}", world, rank, "gloo")
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_gloo(fn, world, *args):
    """fn(rank, world, *args) on `world` spawned gloo ranks (fn and args
    picklable, fn at module level); returns their results in rank order.
    Fails after SPAWN_TIMEOUT seconds, the ranks killed."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.spawn(
            _gloo_entry, args=(fn, world, free_port(), tmp, args),
            nprocs=world, join=False)
        deadline = time.monotonic() + SPAWN_TIMEOUT
        try:
            while not ctx.join(timeout=2):
                assert time.monotonic() < deadline, "gloo ranks timed out"
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


@pytest.fixture(autouse=True)
def _reset_initialized():
    multihost._initialized = False
    yield
    multihost._initialized = False


# --- one process --------------------------------------------------------------

@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_local_scene_shard_matches_jax(count):
    from stinet_tpu.parallel import multihost as jax_multihost
    items = [f"scene{i:04d}" for i in range(11)]
    shards = [multihost.local_scene_shard(items, index=i, count=count)
              for i in range(count)]
    for i, got in enumerate(shards):
        assert got == jax_multihost.local_scene_shard(items, index=i,
                                                      count=count)
    assert sorted(s for sh in shards for s in sh) == sorted(items)
    assert multihost.local_scene_shard(items) == items


def test_single_process_helpers_are_the_identity():
    assert multihost.process_index() == 0
    assert multihost.process_count() == 1
    assert multihost.is_primary()
    widths = {(0, None, "ell"): 5, (1, 2, "ell"): 3}
    assert multihost.merge_widths_across_hosts(widths) == widths
    arr = np.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(multihost.sum_array_across_hosts(arr), arr)
    log = {"epoch": 3, "loss": 0.5, "name": "scene0000_00", "flag": True}
    assert multihost.mean_scalar_metrics(log) == log
    multihost.sync_hosts("test")
    np.testing.assert_array_equal(
        multihost.host_local_block(torch.arange(4)), np.arange(4))


def test_initialize_needs_arguments_or_torchrun(monkeypatch):
    import torch.distributed as dist
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    called = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: called.append((a, kw)))
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    assert multihost.initialize() is False
    assert called == []
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize() is False    # MASTER_ADDR missing
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert multihost.initialize() is True
    assert called[0][0] == ("gloo",)     # no card here: gloo
    assert called[0][1]["init_method"] == "env://"
    assert multihost.initialize() is False       # idempotent
    multihost._initialized = False
    assert multihost.initialize("tcp://localhost:1", 1, 0,
                                backend="gloo") is True
    assert called[1][1] == {"init_method": "tcp://localhost:1",
                            "world_size": 1, "rank": 0}


def test_graph_sharding_matches_jax():
    from stinet_tpu.parallel import mesh as jax_mesh
    shapes = {"x": (16, 3), "vec": (3,), "scalar": (), "even": (8,),
              "tall": (24, 2, 2), "short": (4, 5)}
    tree = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    want = jax_mesh.graph_sharding(tree, jax_mesh.make_mesh(8))
    got = port_mesh.graph_sharding(
        {k: torch.zeros(s) for k, s in shapes.items()}, 8)
    for k in shapes:
        assert tuple(want[k].spec) == got[k], k
    # the rank's part: split leaves cut, replicated ones whole
    x = {k: torch.arange(int(np.prod(s))).reshape(s) for k, s in
         shapes.items()}
    part = port_mesh.shard_graph(x, 3, 8)
    assert torch.equal(part["x"], x["x"][6:8])
    assert torch.equal(part["vec"], x["vec"])
    assert torch.equal(part["even"], x["even"][3:4])


def test_param_sharding_matches_jax():
    from stinet_tpu.parallel import mesh as jax_mesh
    shapes = {"wide": (64, 256), "narrow": (64, 2), "bias": (256,),
              "odd": (64, 130), "tall": (256, 64)}
    jmesh = jax_mesh.make_mesh(8, model_parallel=2)
    want = jax_mesh.param_sharding(
        {k: np.zeros(s, np.float32) for k, s in shapes.items()}, jmesh)
    got = port_mesh.param_sharding(
        {k: torch.zeros(s[::-1]) for k, s in shapes.items()}, 2)
    for k in shapes:
        assert got[k] == tuple(want[k].spec)[::-1], k
    assert got["wide"] == ("model", None)
    assert all(v == () for v in port_mesh.param_sharding(
        {k: torch.zeros(s[::-1]) for k, s in shapes.items()}, 1).values())


# --- 2 gloo ranks ---------------------------------------------------------------

def _raises(fn, *args):
    try:
        fn(*args)
    except RuntimeError as e:
        return str(e)
    return None


def _helpers_rank(rank, world, tmp):
    out = {}
    widths = {(0, None, "ell"): 5 + rank, (1, 2, "ell"): 3 - rank,
              (0, None, "rev"): 4}
    out["merged"] = multihost.merge_widths_across_hosts(widths)
    if rank == 1:
        widths[(1, 4, "ell")] = 2
    out["merge_mismatch"] = _raises(multihost.merge_widths_across_hosts,
                                    widths)
    big = np.asarray([[2.0 ** 40 + 3 + rank, 2.0 ** 41 + 1],
                      [7.0 * rank, 2.0 ** 47 - 1]])
    out["sum"] = multihost.sum_array_across_hosts(big)
    log = {"epoch": 3, "loss": 1.0 + 3.0 * rank, "psnr": 20.0,
           "flag": True}
    out["mean"] = multihost.mean_scalar_metrics(log, weight=1.0 + 2 * rank)
    if rank == 1:
        log["extra"] = 0.5
    out["mean_mismatch"] = _raises(multihost.mean_scalar_metrics, log)
    out["index"] = (multihost.process_index(), multihost.process_count(),
                    multihost.is_primary())

    from stinet_tpu_torch.trainers.base import BaseTrainer
    saves = []

    class Config:
        resume = None
        dry_run = False
        save_dir = os.path.join(tmp, f"models{rank}")
        log_dir = os.path.join(tmp, f"log{rank}")

        def __getitem__(self, k):
            return {"trainer": {"epochs": 2, "save_period": 1,
                                "monitor": "min val_loss",
                                "tensorboard": True}}[k]

        def get_logger(self, *a, **kw):
            return logging.getLogger("test_torch_multihost")

    class Trainer(BaseTrainer):
        def _train_epoch(self, epoch):
            return {"val_loss": 1.0 / epoch + rank}

        def _eval(self, mode):
            pass

        def _save_checkpoint(self, epoch):
            saves.append(("ckpt", epoch))

        def _save_best(self, epoch):
            saves.append(("best", epoch))

    trainer = Trainer(Config())
    out["writer"] = trainer.writer.writer is not None
    trainer.train()
    out["saves"] = saves
    out["best"] = trainer.mnt_best
    return out


def test_helpers_under_two_gloo_ranks(tmp_path):
    results = run_gloo(_helpers_rank, 2, str(tmp_path))
    for rank, r in enumerate(results):
        assert r["index"] == (rank, 2, rank == 0)
        assert r["merged"] == {(0, None, "ell"): 6, (1, 2, "ell"): 3,
                               (0, None, "rev"): 4}
        assert "differ across ranks" in r["merge_mismatch"]
        want = np.asarray([[2.0 ** 41 + 7, 2.0 ** 42 + 2],
                           [7.0, 2.0 ** 48 - 2]])
        assert r["sum"].dtype == np.float64
        np.testing.assert_array_equal(r["sum"], want)    # exact
        assert r["mean"]["loss"] == (1.0 * 1 + 4.0 * 3) / 4
        assert r["mean"]["psnr"] == 20.0
        assert r["mean"]["epoch"] == 3 and r["mean"]["flag"] is True
        assert "key sets differ" in r["mean_mismatch"]
        # the monitor reads the averaged val_loss: 1/epoch + 0.5
        assert r["best"] == 0.5 + 0.5
    # only rank 0 writes: checkpoints each epoch, best each epoch
    assert results[0]["saves"] == [("ckpt", 1), ("best", 1), ("ckpt", 2),
                                   ("best", 2)]
    assert results[1]["saves"] == []
    assert results[0]["writer"] and not results[1]["writer"]
