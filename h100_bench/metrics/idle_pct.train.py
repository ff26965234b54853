"""Share of the traced steps' windows in which no operation ran on the card."""
from benchlib import readers


def read(facts):
    return readers.idle_pct(facts)
