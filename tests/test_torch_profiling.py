"""The port's profiling (stinet_tpu_torch/utils/profiling.py) against the
JAX package's, on the CPU: `EpochProfiler` traces the steps JAX's
schedule selects, `SyncedTimer` gives JAX's results under the same clock,
and the 2D trainer with `trainer.profile` writes its traces where JAX's
would (`<log_dir>/profile`), closing an open window at the end of
`train()`. Exact: step sets and the timer's means are equal."""
import copy
import json
import pathlib
import time

import jax.numpy as jnp
import pytest
import torch

from stinet_tpu.utils import profiling as jax_profiling
from stinet_tpu_torch.core.config import ConfigParser
from stinet_tpu_torch.trainers.inpainting2d import Inpainting2DTrainer
from stinet_tpu_torch.utils import profiling
from test_train_e2e import make_2d_config


def traced_steps(log_dir):
    """{trace file: sorted step numbers of its ProfilerStep#k events}."""
    out = {}
    for f in sorted(pathlib.Path(log_dir).glob("*.pt.trace.json")):
        events = json.loads(f.read_text())["traceEvents"]
        out[f.name] = sorted({int(e["name"].split("#")[1]) for e in events
                              if e.get("name", "").startswith(
                                  "ProfilerStep#")})
    return out


# (skip_first, wait, warmup, active, repeat), steps: the default schedule
# past its last cycle, without warmup or wait, without end, and a window
# left open at the last step
SCHEDULES = [((1, 2, 1, 3, 4), 30), ((0, 0, 0, 2, 3), 8),
             ((2, 1, 0, 1, 0), 9), ((1, 2, 1, 3, 2), 12)]


@pytest.mark.parametrize("schedule,steps", SCHEDULES,
                         ids=[str(s) for s, _ in SCHEDULES])
def test_profiler_records_the_steps_jax_traces(tmp_path, schedule, steps):
    """Each step's work is one op in its own profiler step: the steps the
    trace files name are those JAX's `_should_trace` selects, one file a
    cycle (the last written by close())."""
    skip, wait, warmup, active, repeat = schedule
    kw = dict(skip_first=skip, wait=wait, warmup=warmup, active=active,
              repeat=repeat)
    want = [k for k in range(steps) if jax_profiling.EpochProfiler(
        tmp_path / "jax", **kw)._should_trace(k)]
    prof = profiling.EpochProfiler(tmp_path / "port", **kw)
    x = torch.zeros(4)
    for k in range(steps):
        prof.step()
        x.add_(k)
    prof.close()
    files = traced_steps(tmp_path / "port")
    assert sorted(k for ks in files.values() for k in ks) == want
    cycle = wait + warmup + active
    assert len(files) == len({(k - skip) // cycle for k in want})


def test_disabled_profiler_writes_nothing(tmp_path):
    prof = profiling.EpochProfiler(tmp_path, enabled=False)
    for _ in range(10):
        prof.step()
    prof.close()
    assert not list(tmp_path.iterdir())


def test_synced_timer_matches_jax(monkeypatch):
    """Both timers under one fake clock: sections named, the first
    `warmup` runs of each dropped, mean seconds; a CPU tensor's sync is
    nothing (JAX's reads the value back)."""
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(time, "perf_counter",
                        lambda: float(next(ticks)) * 0.25)
    results = []
    for mod, value in ((jax_profiling, jnp.ones(3)),
                       (profiling, (torch.ones(3), {"b": torch.zeros(1)}))):
        timer = mod.SyncedTimer(warmup=2)
        for i in range(5):
            with timer.section("forward", sync_value=value):
                pass
            for _ in range(i):
                with timer.section("backward"):
                    time.perf_counter()
        results.append(timer.results())
    assert results[0] == results[1]
    assert set(results[1]) == {"forward", "backward"}


def test_trainer_profile_writes_a_trace(tmp_path, monkeypatch):
    """A tiny 2D trainer (graph branch) with `trainer.profile`: 3 epochs of
    2 steps, so the default schedule traces steps 4 and 5 and the run ends
    inside the window, which `train()` closes into a trace under
    <log_dir>/profile. A dry run builds no profiler, as in JAX."""
    monkeypatch.setenv("STINET_DISABLE_GIT_TAG", "1")
    cfg = make_2d_config(tmp_path)
    cfg["trainer"].update(profile=True, epochs=3, do_validation=False,
                          monitor="off")
    cfg["data_loader"]["args"]["max_items"] = 6
    dry = Inpainting2DTrainer(ConfigParser(copy.deepcopy(cfg),
                                           dry_run=True), device="cpu")
    assert dry.profiler is None
    config = ConfigParser(copy.deepcopy(cfg))
    trainer = Inpainting2DTrainer(config, device="cpu")
    assert len(trainer.data_loader.train_loader) == 2
    trainer.train()
    assert [t["steps"] for t in trainer.epoch_timings] == [2, 2, 2]
    files = traced_steps(config.log_dir / "profile")
    assert list(files.values()) == [[4, 5]]
