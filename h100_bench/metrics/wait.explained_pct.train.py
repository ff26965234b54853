"""Share of the loop's wait for its batch (`loop.wait` spans) during which
another thread was inside a `load.batch` or `place.pack` span, over the
unprofiled window: how much of the card's idle wait the loader's and the
placer's spans account for."""
from benchlib import spans


def read(facts):
    return spans.covered_pct(facts, "loop.wait", ("load.batch", "place.pack"))
