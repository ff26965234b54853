"""Kernel launches a step in the traced steps."""
from benchlib import readers


def read(facts):
    return readers.launches_per_item(facts)
