"""K2's share of its roofline in the traced steps (its forward calls)."""
from benchlib import readers


def read(facts):
    return readers.roofline_pct(facts, ("op.k2",))
