"""Edge sets that build at once: the summed wall of the window's
`build.edge_set` spans over that of its `build.tables` spans (the build
pool's useful width)."""
from benchlib import spans


def read(facts):
    return spans.concurrency(facts, "build.edge_set", "build.tables")
