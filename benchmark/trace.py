"""The traced sub-window of a `--trace 1` run: torch.profiler over a fixed
number of calls of the timed path, the benchmark's own spans around each
call into the program (`span`), and what the per-layer metrics read from
it: kernel records, busy time, the window's length, the top device
operations and the longest idle gaps by what the host was doing."""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .yardstick.busy import busy_us, is_kernel, merged

SPAN_PREFIX = "bench."


def span(name: str):
    """A named span of the benchmark's own around a call into the program;
    a profiler range when a profiler runs, nothing otherwise."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclass
class Trace:
    calls: int
    kernels: list            # (name, start us, end us)
    cpu: list                # (name, start us, end us, is a benchmark span)
    window_us: float = field(init=False)
    busy_us: float = field(init=False)

    def __post_init__(self):
        spans = [(s, e) for _, s, e, own in self.cpu if own]
        starts = [s for s, _ in spans] + [s for _, s, _ in self.kernels]
        ends = [e for _, e in spans] + [e for _, _, e in self.kernels]
        self.window_us = (max(ends) - min(starts)) if starts else 0.0
        self.busy_us = busy_us([(s, e) for _, s, e in self.kernels])

    def kernel_ms_per_call(self, part: str) -> tuple[float, int]:
        """(device ms per call, launches per call) of kernels whose name holds `part`."""
        ks = [(s, e) for n, s, e in self.kernels if part in n]
        return sum(e - s for s, e in ks) / 1e3 / self.calls, len(ks) / self.calls

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, s, e in self.kernels:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k[:160], v / 1e6] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest gaps between kernels inside the window, each named by
        the benchmark span and the innermost host operation running at its
        middle."""
        iv = merged([(s, e) for _, s, e in self.kernels])
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(iv, iv[1:]) if b[0] > a[1]]
        out = []
        for length, s, e in sorted(gaps, reverse=True)[:n]:
            mid = (s + e) / 2
            own = [c for c in self.cpu if c[3] and c[1] <= mid <= c[2]]
            ops = [c for c in self.cpu if not c[3] and c[1] <= mid <= c[2]]
            name = max(own, key=lambda c: c[1])[0] if own else "outside the spans"
            if ops:
                name += " / " + max(ops, key=lambda c: c[1])[0]
            out.append([name[:160], length / 1e6])
        return out


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def profile(fn, calls: int) -> Trace:
    """Run fn(i) for i < calls under torch.profiler (CPU and CUDA), ended by
    a synchronise."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _sync()
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(calls):
            fn(i)
        _sync()
    kernels, cpu = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the spans' device-side ranges are annotations, not kernels
            if (is_kernel(e.name) and not e.name.startswith(SPAN_PREFIX)
                    and not getattr(e, "is_user_annotation", False)):
                kernels.append((e.name, s, t))
        elif not e.name.startswith("ProfilerStep"):
            cpu.append((e.name, s, t, e.name.startswith(SPAN_PREFIX)))
    return Trace(calls, kernels, cpu)
