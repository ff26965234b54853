"""Mean wall ms of a batch's levels, traces, children tables and features
(`build.levels` spans), over the unprofiled window."""
from benchlib import spans


def read(facts):
    return spans.mean_ms(facts, "build.levels")
