"""Spans, op ranges and the reduction of a profiler trace to numbers.

`OpRanges` wraps the program's op entry points at run time (the program is
not edited): each call runs inside a `record_function` range named for the
op, and its inputs are kept so that the op's bytes and operations can be
counted once the call is over (`benchlib/counts.py`). The kernels that a
range launches, on whatever thread, are linked to it by the profiler's
correlation ids, so a range's device time is that of the op's kernels.

`Session` is one profiler window; `Summary` adds windows up: device busy
seconds (the union of every kernel, copy and set on the card), the host
window, kernel launches, device time by kernel name and by range, and the
longest idle gaps of the card, each named by the harness span that the
host was in.
"""
import bisect
import collections
import importlib
import time
from typing import Dict, List

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from benchlib import counts, peaks

SPAN_PREFIX = "bench."

# (range, module, attribute): the op entry points the model calls through
# a module attribute, so that a wrapper put there sees every call
# (the windowed autograd Function calls K3a, relu and step, and K3c
# through the attributes of `ops.windowed`)
OP_ENTRIES = (
    ("op.k1", "stinet_tpu_torch.ops.message_passing", "ell_edge_conv_sum"),
    ("op.k1.grad", "stinet_tpu_torch.ops.ell", "ell_edge_conv_grads"),
    ("op.k2", "stinet_tpu_torch.models.stinet", "masked_instance_norm"),
    ("op.k3", "stinet_tpu_torch.ops.windowed", "windowed_edge_conv_sum"),
    ("op.k3.dq", "stinet_tpu_torch.ops.windowed", "windowed_dq"),
)


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _inputs(name, args, kwargs):
    """What counting a call needs, taken at the call without touching the
    device: widths and dtypes, and the call's tables (views that hold the
    call's data until the caller releases its batch)."""
    if name == "op.k1":
        p, _q, nbr, deg = args[:4]
        return (p.shape[1], p.element_size(), _dtype_name(p), nbr, deg)
    if name == "op.k1.grad":
        p, _q, nbr, deg, rev_dst, out_degree = args[:6]
        needs = kwargs.get("needs", args[8] if len(args) > 8
                           else (True, True))
        return (p.shape[1], p.element_size(), _dtype_name(p), nbr, deg,
                rev_dst, out_degree, tuple(needs))
    if name == "op.k3":
        p, _q, nbr, deg = args[:4]
        return (p.shape[1], nbr, deg)
    if name == "op.k3.dq":
        q, _g, _p, rev_dst, deg_out = args[:5]
        return (q.shape[1], rev_dst, deg_out)
    x, _gid, _ng, num_valid = args[:4]
    return (x.shape[0], x.shape[1], num_valid)


def _need(name, kept):
    """(bytes, operations, flops peak) of one call."""
    if name == "op.k1":
        h, es, dt, nbr, deg = kept
        b, o = counts.k1_need(h, es, nbr, deg)
        return b, o, peaks.flops_per_s(dt)
    if name == "op.k1.grad":
        h, es, dt, nbr, deg, rev_dst, out_degree, needs = kept
        b = o = 0
        if needs[0]:
            b1, o1 = counts.k1_dp_need(h, es, nbr, deg)
            b, o = b + b1, o + o1
        if needs[1]:
            b2, o2 = counts.k1_dq_need(h, es, rev_dst, out_degree)
            b, o = b + b2, o + o2
        return b, o, peaks.flops_per_s(dt)
    if name == "op.k3":        # the windowed kernels compute in bf16
        b, o = counts.k3_need(*kept)
        return b, o, peaks.flops_per_s("bfloat16")
    if name == "op.k3.dq":
        h, rev_dst, deg_out = kept
        b, o = counts.k1_dq_need(h, 2, rev_dst, deg_out)
        return b, o, peaks.flops_per_s("bfloat16")
    v, c, num_valid = kept
    b, o = counts.k2_need(v, c, int(num_valid))
    return b, o, peaks.flops_per_s("float32")


class OpRanges:
    """Inside the `with` block each op entry of OP_ENTRIES runs in a
    range of its name, and each call's inputs are kept until `bounds()`
    counts them (call it while the inputs still hold the call's data)."""

    def __init__(self):
        self.calls: List[tuple] = []
        self._saved = []

    def __enter__(self):
        for name, mod_name, attr in OP_ENTRIES:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            with record_function(name):
                out = fn(*args, **kwargs)
            self.calls.append((name, _inputs(name, args, kwargs)))
            return out
        return wrapped

    def bounds(self) -> Dict[str, float]:
        """{range: least seconds} summed over the calls kept, which are
        then dropped."""
        out = collections.Counter()
        for name, kept in self.calls:
            b, o, peak = _need(name, kept)
            out[name] += counts.least_seconds(b, o, peak)
        self.calls.clear()
        return dict(out)


def span(name: str):
    """A harness span (a profiler range), named under SPAN_PREFIX."""
    return record_function(SPAN_PREFIX + name)


LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def _range_device_s(ranges, launches, kernels):
    """{range name: device seconds of the kernels whose launch call (the
    runtime event with the kernel's correlation id) started inside a range
    of that name on the same host thread}. The op ranges do not nest in
    one another. A kernel launched from the autograd engine's thread is
    found so too, where the profiler links it to the backward node."""
    by_thread = collections.defaultdict(list)
    for r in ranges:
        by_thread[r.thread].append((r.time_range.start, r.time_range.end,
                                    r.name))
    starts = {}
    for t, rs in by_thread.items():
        rs.sort()
        starts[t] = [a for a, _, _ in rs]
    launch_of = {e.id: e for e in launches}
    out = collections.Counter()
    for k in kernels:
        call = launch_of.get(k.id)
        if call is None or call.thread not in starts:
            continue
        rs = by_thread[call.thread]
        i = bisect.bisect_right(starts[call.thread],
                                call.time_range.start) - 1
        if i >= 0 and rs[i][0] <= call.time_range.start <= rs[i][1]:
            out[rs[i][2]] += (k.time_range.end - k.time_range.start) / 1e6
    return out


def _is_kernel(evt) -> bool:
    kind = getattr(evt, "activity_type", None)
    if kind:
        return "kernel" in str(kind).lower()
    return not evt.name.lower().startswith(("memcpy", "memset"))


class Summary:
    """What one or more profiler windows read, added up."""

    def __init__(self):
        self.busy_s = 0.0
        self.window_s = 0.0
        self.launches = 0
        self.ops = collections.Counter()       # kernel name -> device s
        self.ranges = collections.Counter()    # range name -> device s
        self.gaps = []                         # (seconds, host span)

    def add(self, prof, window_s: float):
        events = prof.events()
        device, spans, ranges, launches = [], [], [], []
        for e in events:
            if e.device_type == DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False) or \
                        e.name.startswith((SPAN_PREFIX, "op.")):
                    continue
                device.append(e)
            elif e.name.startswith(SPAN_PREFIX):
                spans.append(e)
            elif e.name.startswith("op.") and not e.is_async:
                ranges.append(e)
            elif e.name in LAUNCHES:
                launches.append(e)
        intervals = sorted((e.time_range.start, e.time_range.end)
                           for e in device)
        merged = []
        for a, b in intervals:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s += sum(b - a for a, b in merged) / 1e6
        self.window_s += window_s
        kernels = [e for e in device if _is_kernel(e)]
        self.launches += len(kernels)
        for e in kernels:
            self.ops[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        self.ranges.update(_range_device_s(ranges, launches, kernels))
        gaps = sorted(((b0 - a1, a1, b0) for (_a0, a1), (b0, _b1)
                       in zip(merged, merged[1:])), reverse=True)[:64]
        spans.sort(key=lambda e: e.time_range.end - e.time_range.start)
        for length, a1, b0 in gaps:
            mid = (a1 + b0) / 2
            # the innermost harness span that holds the gap's middle
            label = next((s.name for s in spans
                          if s.time_range.start <= mid <= s.time_range.end),
                         "outside any span")
            self.gaps.append((length / 1e6, label))
        self.gaps.sort(reverse=True)
        del self.gaps[64:]

    def breakdown(self) -> dict:
        return {"device_ops": [[n, s] for n, s in self.ops.most_common(10)],
                "idle_gaps": [[label, s] for s, label in self.gaps[:10]]}


class Session:
    """One profiler window over the `with` block; its events are read into
    `summary` when the block ends. With `device_only` it records the
    card's activity alone (enough for the busy time)."""

    def __init__(self, summary: Summary, device_only: bool = False):
        self.summary, self.device_only = summary, device_only

    def __enter__(self):
        self.cuda = torch.cuda.is_available()
        if self.cuda:
            torch.cuda.synchronize()
        # device_only: the card's activity and the runtime's calls, no
        # host ops, so that a long window costs the host little
        host = [] if self.device_only and self.cuda else [ProfilerActivity.CPU]
        self.prof = profile(activities=host
                            + ([ProfilerActivity.CUDA] if self.cuda else []))
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.summary.add(self.prof, window)
        return False
