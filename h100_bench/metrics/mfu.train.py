"""The steps' useful FLOPs (three forwards a step) over the window's time at the card's bf16 peak."""
from benchlib import readers


def read(facts):
    return readers.mfu_pct(facts)
