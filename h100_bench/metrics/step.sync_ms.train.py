"""Mean wall ms of the host's wait for the card at a step's end (`step.sync`
spans), over the unprofiled window."""
from benchlib import spans


def read(facts):
    return spans.mean_ms(facts, "step.sync")
