"""Share of the caller's wall in a step's forward and optimizer spans that
its thread spent off the CPU (waiting for the interpreter lock or a core
beside the build), over the unprofiled window. The backward runs on the
autograd engine's thread and is left out."""
from benchlib import spans


def read(facts):
    return spans.offcpu_pct(facts, ("step.forward", "step.optimizer"))
