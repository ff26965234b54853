"""Profiling and timing of the trainers, the counterpart of
`stinet_tpu/utils/profiling.py` (the reference's observability, SURVEY.md
§5): `EpochProfiler` traces selected train steps with the reference's
skip/wait/warmup/active schedule through `torch.profiler`, as the
reference's 2D trainer did (inpainting2d_trainer.py:319-325), and writes
TensorBoard traces; `SyncedTimer` times named sections with a device
synchronisation and drops warmup runs (the reference's utils/util.py:
58-86); `device_memory_stats` reads the caching allocator's counters."""
import time
from contextlib import contextmanager

import numpy as np
import torch

from stinet_tpu_torch.graph.hierarchy import tensor_leaves


class EpochProfiler:
    """Trace the steps the schedule selects: after `skip_first` steps,
    cycles of `wait` steps untraced, `warmup` steps untraced, then
    `active` steps traced, `repeat` cycles (0: without end), counted by
    `step()` calls. Call `step()` at the top of every train step, before
    its work, and `close()` after the last.

    The work after the k-th call (k from 0) is traced where JAX's
    `_should_trace(k)` holds: `torch.profiler.schedule` with the same
    arguments gives RECORD there, because the first call starts the
    profiler at its step 0 and every later call advances it by one. The
    profiler starts in the last warmup step (CUPTI's warmup, which JAX's
    tracer does not have) and writes a cycle's trace at the call that
    ends its active window, where JAX stops its trace; `close()` writes a
    window that is still open. Each trace is a
    `<host>_<pid>.<ms>.pt.trace.json` file under `log_dir`
    (`torch.profiler.tensorboard_trace_handler`), its steps marked
    `ProfilerStep#k`. CPU activity is traced, and CUDA activity where
    there is a card."""

    def __init__(self, log_dir, skip_first=1, wait=2, warmup=1, active=3,
                 repeat=4, enabled=True):
        self.log_dir = str(log_dir)
        self.schedule = (skip_first, wait, warmup, active, repeat)
        self.enabled = enabled
        self._step = 0
        self._prof = None

    def step(self):
        """Once a train step, before its work."""
        if not self.enabled:
            return
        if self._prof is None:
            skip, wait, warmup, active, repeat = self.schedule
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=activities,
                schedule=torch.profiler.schedule(
                    skip_first=skip, wait=wait, warmup=warmup,
                    active=active, repeat=repeat),
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    self.log_dir))
            self._prof.start()
        else:
            self._prof.step()
        self._step += 1

    def close(self):
        """Stop the profiler, writing the trace of an open window."""
        if self._prof is not None:
            self._prof.stop()
            self._prof = None


class SyncedTimer:
    """Named sections timed on the host clock, each ended by a device
    synchronisation; the first `warmup` runs of each name are dropped."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._times = {}
        self._counts = {}

    @contextmanager
    def section(self, name, sync_value=None):
        """Time the body as section `name`; with `sync_value` (a tensor, or
        a tuple, dict or graph of them) wait for the card that holds its
        first tensor before the clock stops (nothing for a CPU tensor)."""
        t0 = time.perf_counter()
        yield
        if sync_value is not None:
            first = tensor_leaves(sync_value)[0]
            if first.device.type == "cuda":
                torch.cuda.synchronize(first.device)
        dt = time.perf_counter() - t0
        c = self._counts.get(name, 0)
        self._counts[name] = c + 1
        if c >= self.warmup:
            self._times.setdefault(name, []).append(dt)

    def results(self):
        """{name: mean seconds of its runs after the warmup}."""
        return {k: float(np.mean(v)) for k, v in self._times.items()}


def device_memory_stats(device: torch.device):
    """{"mem_allocated", "mem_reserved"}: bytes the caching allocator has
    handed out and holds on `device`; 0 on a CPU device."""
    if device.type != "cuda":
        return {"mem_allocated": 0, "mem_reserved": 0}
    return {"mem_allocated": torch.cuda.memory_allocated(device),
            "mem_reserved": torch.cuda.memory_reserved(device)}
