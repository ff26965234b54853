"""Mean wall ms of packing a batch into pinned memory on the placing thread
(`place.pack` spans), over the unprofiled window."""
from benchlib import spans


def read(facts):
    return spans.mean_ms(facts, "place.pack")
