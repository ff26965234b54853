"""K1's share of its roofline in the traced steps: forward, dp and dq together."""
from benchlib import readers


def read(facts):
    return readers.roofline_pct(facts, ("op.k1", "op.k1.grad"))
