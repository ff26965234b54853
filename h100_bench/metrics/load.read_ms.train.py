"""Mean wall ms of a scene's npz read, decompression and casts on the loader's
thread (`load.read` spans), over the unprofiled window."""
from benchlib import spans


def read(facts):
    return spans.mean_ms(facts, "load.read")
