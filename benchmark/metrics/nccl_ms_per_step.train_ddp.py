"""Device ms per traced training step of the exchange's kernels (kernel
records whose name holds `nccl`, the profiler's `nccl:` annotation ranges
left out): the busy time of their records in the traced sub-window over
its steps, the wait for the slowest rank included. None off the card and
where no such kernel ran."""
from benchmark.yardstick.busy import busy_us


def read(facts):
    tr = facts.get("trace")
    if tr is None or facts.get("peak") is None or not tr.calls:
        return None
    spans = [(s, e) for n, s, e in tr.kernels
             if "nccl" in n.lower() and not n.startswith("nccl:")]
    return busy_us(spans) / 1e3 / tr.calls if spans else None
