"""Mean wall ms of a step's learning-rate set and optimizer step
(`step.optimizer` spans), over the unprofiled window."""
from benchlib import spans


def read(facts):
    return spans.mean_ms(facts, "step.optimizer")
