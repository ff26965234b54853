"""Mean wall ms of a step's forward and loss on the caller (`step.forward`
spans), over the unprofiled window."""
from benchlib import spans


def read(facts):
    return spans.mean_ms(facts, "step.forward")
