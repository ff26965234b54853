"""Mean wall ms of a batch's edge-set tables on the build's thread pool
(`build.tables` spans), over the unprofiled window."""
from benchlib import spans


def read(facts):
    return spans.mean_ms(facts, "build.tables")
