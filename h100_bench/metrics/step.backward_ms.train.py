"""Mean wall ms of a step's backward call on the caller (`step.backward`
spans), over the unprofiled window."""
from benchlib import spans


def read(facts):
    return spans.mean_ms(facts, "step.backward")
