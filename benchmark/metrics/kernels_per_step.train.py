"""Kernel records per training step in the traced sub-window (copies and
fills left out)."""


def read(facts):
    tr = facts.get("trace")
    if tr is None or facts.get("peak") is None:
        return None
    return len(tr.kernels) / tr.calls
