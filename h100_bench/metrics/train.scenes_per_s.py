"""Optimizer steps (batch 1) over the unprofiled window's time, loader and
build included: the rate a training user waits on, by the host's clock."""


def read(facts):
    if not facts.get("steps") or facts.get("window_s", 0) <= 0:
        return None
    return facts["steps"] / facts["window_s"]
