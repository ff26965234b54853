"""Profiling and timing of the trainers, the counterpart of
`stinet_tpu/utils/profiling.py` (the reference's observability, SURVEY.md
§5): `EpochProfiler` traces selected train steps with the reference's
skip/wait/warmup/active schedule through `torch.profiler`, as the
reference's 2D trainer did (inpainting2d_trainer.py:319-325), and writes
TensorBoard traces; `SyncedTimer` times named sections with a device
synchronisation and drops warmup runs (the reference's utils/util.py:
58-86); `device_memory_stats` reads the caching allocator's counters.

`span` marks a stretch of the program's own work (a loader's read, a
build stage, a step's forward) on whatever thread runs it: its wall and
thread-CPU time go into a bounded ring of records that `span_records`
copies out, and while a torch profiler records, the span is also a
`record_function` range in its trace."""
import collections
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

# the newest records are kept: at a few dozen spans a step, this many
# hold hundreds of steps in a few MB
SPAN_RECORDS_MAX = 1 << 16


class SpanRecord(NamedTuple):
    """One finished span: `thread` is `threading.get_ident()` of the thread
    that ran it, `start_ns`/`end_ns` read `time.perf_counter_ns()`,
    `cpu_ns` is the thread's CPU time inside it (`time.thread_time_ns()`),
    `parent` the name of the span it ran in, and `batch` the scene names
    of the batch it worked on (None where the code has none)."""
    name: str
    thread: int
    start_ns: int
    end_ns: int
    cpu_ns: int
    parent: Optional[str]
    batch: Optional[Tuple[str, ...]]


_records = collections.deque(maxlen=SPAN_RECORDS_MAX)
# thread ident -> the names of the thread's open spans, innermost last
# (each thread touches its own entry only)
_open = {}


class _Span:
    __slots__ = ("name", "batch", "parent", "_range", "_thread", "_t0",
                 "_c0")

    def __init__(self, name, batch, parent):
        self.name, self.batch, self.parent = name, batch, parent
        self._range = None

    def __enter__(self):
        thread = self._thread = threading.get_ident()
        names = _open.get(thread)
        if names is None:
            names = _open[thread] = []
        if self.parent is None and names:
            self.parent = names[-1]
        names.append(self.name)
        if torch.autograd.profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        # the wall clock's reads hold the CPU clock's between them, so
        # the CPU time is never above the wall
        self._t0 = time.perf_counter_ns()
        self._c0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        c1 = time.thread_time_ns()
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        names = _open[self._thread]
        names.pop()
        if not names:
            del _open[self._thread]
        batch = None if self.batch is None else tuple(self.batch)
        # tuple.__new__ skips the named tuple's Python-level constructor;
        # deque.append is atomic, so the threads need no lock
        _records.append(tuple.__new__(SpanRecord, (
            self.name, self._thread, self._t0, t1, c1 - self._c0,
            self.parent, batch)))
        return False


def span(name: str, batch=None, parent: Optional[str] = None):
    """A context manager that records the work inside it as one
    `SpanRecord` (an exception inside it is recorded, then raised on).
    `batch`: the scene names it works on (settable on the object the
    `with` gives, for a span that learns them inside); `parent`: the
    enclosing span's name, for work handed to another thread (by default
    the innermost span open on this thread)."""
    return _Span(name, batch, parent)


def span_records():
    """A list copy of the kept records, oldest first (by end)."""
    while True:
        try:
            return list(_records)
        except RuntimeError:    # another thread appended during the copy
            continue


def _all_threads_config():
    """The profiler option that records `record_function` ranges on every
    thread (the loader's, its pool's), where this torch has it; else
    None, and only the thread that started the profiler and the autograd
    engine's are recorded."""
    try:
        return torch.profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


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
    there is a card, on every thread where torch can record them
    (`_all_threads_config`), so the loader's and the build's spans show
    beside the step's."""

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
            extra = {}
            config = _all_threads_config()
            if config is not None:
                extra["experimental_config"] = config
            self._prof = torch.profiler.profile(
                activities=activities, **extra,
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
        # imported here: `graph/build.py` imports this module
        from stinet_tpu_torch.graph.hierarchy import tensor_leaves
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
