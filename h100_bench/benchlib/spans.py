"""The program's own spans (`stinet_tpu_torch/utils/profiling.py:span`:
the loader's reads, transforms and build stages, the placer's packing,
the loop's wait for a batch, the step's forward, backward, optimizer and
sync), read over the unprofiled window of a `--trace 1` run, so that they
compare with `train.wait_ms` and `train.step_ms` from the same window.

The window runs from the end of the set-up's last `step.sync` to the end
of the window's last `step.sync`: among the caller's `step.sync` records,
those at positions -(steps + items) - 1 and -items - 1, since the traced
epoch's `items` steps follow the window's `steps`. A record belongs to
the window when it started inside it. Each function returns None where
there is nothing to read: facts without `steps` or a traced epoch, a
program without spans, or a ring that no longer holds the window."""


def _all_records():
    try:
        from stinet_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "span_records", None)
    return None if read is None else read()


def window(facts):
    """(every record, (start ns, end ns) of the window), or None."""
    steps, summary = facts.get("steps"), facts.get("trace")
    items = getattr(summary, "items", 0)
    if not steps or not items:
        return None
    records = _all_records()
    if not records:
        return None
    syncs = [r for r in records if r.name == "step.sync"]
    caller = syncs[-1].thread if syncs else None
    syncs = [r for r in syncs if r.thread == caller]
    if len(syncs) < steps + items + 1:
        return None
    return records, (syncs[-(steps + items) - 1].end_ns,
                     syncs[-items - 1].end_ns)


def in_window(facts, name):
    """The records named `name` that started inside the window, or None
    where the window cannot be read."""
    found = window(facts)
    if found is None:
        return None
    records, (a, b) = found
    return [r for r in records if r.name == name and a <= r.start_ns <= b]


def _wall_ns(r):
    return r.end_ns - r.start_ns


def mean_ms(facts, name):
    """Mean wall ms of the window's spans named `name`."""
    rs = in_window(facts, name)
    if not rs:
        return None
    return sum(map(_wall_ns, rs)) / len(rs) / 1e6


def concurrency(facts, inner, outer):
    """The summed wall of the window's `inner` spans over that of its
    `outer` spans: how many `inner` ran at once inside an `outer`."""
    a, b = in_window(facts, inner), in_window(facts, outer)
    if not a or not b:
        return None
    den = sum(map(_wall_ns, b))
    return sum(map(_wall_ns, a)) / den if den > 0 else None


def offcpu_pct(facts, names):
    """100 x the wall its thread spent off the CPU over the wall, summed
    over the window's spans of `names`."""
    wall = off = 0
    for name in names:
        for r in in_window(facts, name) or ():
            wall += _wall_ns(r)
            off += _wall_ns(r) - r.cpu_ns
    return 100.0 * off / wall if wall > 0 else None


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def covered_pct(facts, name, by):
    """100 x the share of the window's `name` spans' wall during which
    another thread was inside a span of `by` (the union of their
    intervals, from the whole ring: a build begun before the window may
    cover a wait inside it)."""
    found = window(facts)
    waits = in_window(facts, name)
    if found is None or not waits:
        return None
    records = found[0]
    total = sum(map(_wall_ns, waits))
    if total <= 0:
        return None
    covered = 0
    for w in waits:
        busy = _union((r.start_ns, r.end_ns) for r in records
                      if r.name in by and r.thread != w.thread
                      and r.start_ns < w.end_ns and r.end_ns > w.start_ns)
        covered += sum(min(b, w.end_ns) - max(a, w.start_ns)
                       for a, b in busy)
    return 100.0 * covered / total
