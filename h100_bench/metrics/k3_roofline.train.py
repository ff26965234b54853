"""K3's share of its roofline in the traced steps: the windowed slot sums (relu and step) and the windowed dq together."""
from benchlib import readers


def read(facts):
    return readers.roofline_pct(facts, ("op.k3", "op.k3.dq"))
