"""Device busy time, frozen from omni3d_tpu_torch/utils/benchtime.py
`device_busy_ms` and the kernel filter of `device_profile` (commit
5a24e3a): the union of kernel intervals, copies and fills left out."""
from __future__ import annotations


def is_kernel(name: str) -> bool:
    """A profiler device record that counts as a kernel (not a copy or a
    fill)."""
    return bool(name) and not name.startswith(("Memcpy", "Memset"))


def merged(spans):
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(spans) -> float:
    """Length of the union of [start, end) intervals (the spans' unit)."""
    return sum(e - s for s, e in merged(spans))
