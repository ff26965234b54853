"""Mean host ms a step waited for its batch (next() on iter_placed)."""
from benchlib import readers


def read(facts):
    return readers.mean(facts.get("wait_ms"))
