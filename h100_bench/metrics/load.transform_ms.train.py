"""Mean wall ms of a scene's transforms on the loader's thread
(`load.transform` spans), over the unprofiled window."""
from benchlib import spans


def read(facts):
    return spans.mean_ms(facts, "load.transform")
