"""Spans of the port on the profiler's clock, off unless a profiler records.

`span(name)` is a host span: while a `torch.profiler` records it is
`torch.profiler.record_function("omni3d." + name, <call index>)`, so it sits
on the profiler's clock beside the kernel records, in the same
`prof.events()` and chrome trace, and the spans of one call (one
`inference_step`, one training step: `set_call`) share an index. With no
profiler it is one shared null context and records nothing.

`stage(name, device)` is a `span` that, on a CUDA device, also brackets its
work on the current stream with two marker kernels (`csrc/stage_mark.cu`):
empty one-thread kernels that the profiler lists as `omni3d_stage_mark<2 i>`
(the start) and `omni3d_stage_mark<2 i + 1>` (the end) for `STAGES[i]`.
They are launched inside the capture of a CUDA graph whether or not a
profiler records, since graphs are captured at set-up (each replay then
runs them), and eagerly only while a profiler records. On the CPU a stage
is its host span alone.

A stage's device time is read from the profiler's own kernel records
(`stage_device_ms`): the busy time of the kernels between its two markers.
That leaves out the device's idle time while the host falls behind, and
the gaps that the profiler's CUDA tracing opens between a replayed graph's
kernels, both of which timing events around the stage would count. Nothing
is read on the host and nothing synchronises.

Which metric or documented use reads each span: PERF.md, section 3.
"""
from __future__ import annotations

import bisect
import contextlib
import ctypes
import re

import torch

PREFIX = "omni3d."
STAGES = ("inference.trunk", "inference.proposals", "inference.box", "inference.cube",
          "step.forward", "step.trunk", "step.rpn_head", "step.anchor_labelling",
          "step.proposals", "step.roi_sampling", "step.pooler", "step.box", "step.cube",
          "step.backward", "step.optimizer", "trunk.dense_concat",
          "step.rank_means")      # at most 32: csrc/stage_mark.cu kMarks
MARK = re.compile(r"omni3d_stage_mark(?:<|ILi)(\d+)")   # demangled or mangled
_INDEX = {name: i for i, name in enumerate(STAGES)}
_NULL = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled
_call = "0"
_lib = None


def set_call(index: int):
    """The index the spans carry from here: the caller's call count."""
    global _call
    _call = str(index)


def _span(name: str):
    return torch.profiler.record_function(PREFIX + name, _call)


def span(name: str):
    """A host span named "omni3d." + name while a profiler records, else a
    null context."""
    return _span(name) if _profiling() else _NULL


def _mark(mark_id: int, device: torch.device):
    """Launch marker kernel `mark_id` on `device`'s current stream."""
    global _lib
    if _lib is None:
        from .cuda_build import library
        lib = library()
        lib.stage_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.stage_mark.restype = ctypes.c_int
        _lib = lib
    with torch.cuda.device(device):
        err = _lib.stage_mark(mark_id, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stage_mark launch failed: CUDA error {err}")


class _Stage:
    """A span whose work on the device lies between two marker kernels."""

    def __init__(self, name: str, device: torch.device, profiling: bool):
        self.mark, self.device = 2 * _INDEX[name], device
        self.span = _span(name) if profiling else _NULL

    def __enter__(self):
        self.span.__enter__()
        _mark(self.mark, self.device)
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            _mark(self.mark + 1, self.device)
        return self.span.__exit__(*exc)


def stage(name: str, device: torch.device):
    """A span that also marks its bounds on `device` when that is a CUDA
    device: always inside a graph's capture, eager only while a profiler
    records. `name` is one of STAGES."""
    profiling = _profiling()
    if device.type == "cuda" and (profiling or torch.cuda.is_current_stream_capturing()):
        return _Stage(name, device, profiling)
    return _span(name) if profiling else _NULL


def stage_device_ms(kernels) -> dict:
    """{stage name: [device ms of each of its intervals, in order]} from a
    profiler's kernel records `kernels`, (name, start us, end us) on one
    stream: for each start marker and the next end marker of its stage, the
    busy time (union of intervals) of the other kernels between them. A
    start with no end in the records is left out."""
    marks, work = [], []
    for name, s, e in kernels:
        m = MARK.search(name)
        if m:
            marks.append((s, e, int(m.group(1))))
        else:
            work.append((s, e))
    busy = []                         # the union of the work, as disjoint sorted intervals
    for s, e in sorted(work):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    starts = [s for s, _ in busy]
    opened, out = {}, {}
    for s, e, mark_id in sorted(marks):
        i, is_end = divmod(mark_id, 2)
        if not is_end:
            opened[i] = e
        elif i in opened and i < len(STAGES):
            t0, t1 = opened.pop(i), s
            k = max(bisect.bisect_right(starts, t0) - 1, 0)
            us = 0.0
            while k < len(busy) and busy[k][0] < t1:
                us += max(0.0, min(busy[k][1], t1) - max(busy[k][0], t0))
                k += 1
            out.setdefault(STAGES[i], []).append(us / 1e3)
    return out
