"""Device ms per traced training step of the trunk's train-mode BatchNorm
kernels (kernel records whose name holds `omni3d_bn_`): the busy time of
their records in the traced sub-window over its steps. None off the card,
and where no such kernel ran (a program without them)."""
from benchmark.yardstick.busy import busy_us

PREFIX = "omni3d_bn_"


def read(facts):
    tr = facts.get("trace")
    if tr is None or facts.get("peak") is None or not tr.calls:
        return None
    spans = [(s, e) for n, s, e in tr.kernels if PREFIX in n]
    return busy_us(spans) / 1e3 / tr.calls if spans else None
