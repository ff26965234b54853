"""Mean wall ms of a batch's windowed layout (band check, RCM order and
relabel; `build.order` spans), over the unprofiled window."""
from benchlib import spans


def read(facts):
    return spans.mean_ms(facts, "build.order")
