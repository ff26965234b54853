"""Mean host ms of the step call, which ends in the host sync of its metrics."""
from benchlib import readers


def read(facts):
    return readers.mean(facts.get("step_ms"))
