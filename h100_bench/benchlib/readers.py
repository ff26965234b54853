"""Arithmetic the per-layer metric readers share. Each reader returns None
where its run has nothing to read, and the harness then leaves the metric
out; a share of a roofline or of a peak is never made up as 0."""
import statistics

from benchlib import peaks


def mean(values):
    return statistics.fmean(values) if values else None


def idle_pct(facts):
    s = facts.get("trace")
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def launches_per_item(facts):
    s = facts.get("trace")
    if s is None or not getattr(s, "items", 0) or s.launches <= 0:
        return None
    return s.launches / s.items


def roofline_pct(facts, ranges):
    """100 x the least time of the calls' work over the device time of the
    kernels launched inside their ranges."""
    s, bounds = facts.get("trace"), facts.get("bounds")
    if s is None or not bounds:
        return None
    device = sum(s.ranges.get(r, 0.0) for r in ranges)
    least = sum(bounds.get(r, 0.0) for r in ranges)
    if device <= 0 or least <= 0:
        return None
    return 100.0 * least / device


def mfu_pct(facts):
    """100 x the model's useful FLOPs in the window over the window's time
    at the card's peak for the configuration's precision."""
    if facts.get("trace") is None or not facts.get("flops") \
            or facts.get("window_s", 0) <= 0:
        return None
    peak = peaks.flops_per_s(facts["dtype"])
    return 100.0 * facts["flops"] / (facts["window_s"] * peak)
