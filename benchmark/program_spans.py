"""What the readers of the program's own spans share: the host spans and
the stages of `omni3d_tpu_torch.utils.trace` ("omni3d." names). A stage's
bounds on the device are two marker kernels in the traced sub-window's
kernel records, `omni3d_stage_mark<2 i>` and `<2 i + 1>` for the program's
`STAGES[i]`; its device ms are the busy time of the other kernels between
them. The benchmark does this arithmetic itself, as `yardstick/` keeps
its own busy time, so a change to the program cannot move it; it takes only
the stage names from the program. Each reader returns None off the card,
and where the program has no such span or stage (a program without
`utils.trace` has neither)."""
from __future__ import annotations

import bisect
import re

from .yardstick.busy import merged

PREFIX = "omni3d."
MARK = re.compile(r"omni3d_stage_mark(?:<|ILi)(\d+)")   # demangled or mangled


def host_ms_per_call(facts: dict, name: str):
    """Host ms per traced call inside the program's span `name`: the summed
    length of its records in the traced sub-window, on the profiler's
    clock, over the sub-window's calls."""
    tr = facts.get("trace")
    if tr is None or facts.get("peak") is None or not tr.calls:
        return None
    spans = [e - s for n, s, e, own in tr.cpu if not own and n == PREFIX + name]
    return sum(spans) / 1e3 / tr.calls if spans else None


def program_stages() -> tuple:
    """The program's `utils.trace.STAGES`, or () where it has none."""
    try:
        from omni3d_tpu_torch.utils.trace import STAGES
    except ImportError:
        return ()
    return STAGES


def stage_ms(kernels: list, index: int) -> list:
    """Device ms of each interval of stage `index` in the kernel records
    (name, start us, end us): from its start marker's end to its end
    marker's start, the union of the other kernels' intervals."""
    marks = sorted((s, e, int(m.group(1))) for n, s, e in kernels if (m := MARK.search(n)))
    work = merged([(s, e) for n, s, e in kernels if not MARK.search(n)])
    starts = [s for s, _ in work]
    out, t0 = [], None
    for s, e, mark in marks:
        if mark == 2 * index:
            t0 = e
        elif mark == 2 * index + 1 and t0 is not None:
            k = max(bisect.bisect_right(starts, t0) - 1, 0)
            us = 0.0
            while k < len(work) and work[k][0] < s:
                us += max(0.0, min(work[k][1], s) - max(work[k][0], t0))
                k += 1
            out.append(us / 1e3)
            t0 = None
    return out


def device_ms_per_call(facts: dict, *names: str):
    """The sum over the stages `names` of each one's mean device ms per
    interval in the traced sub-window (one interval per replay or step);
    None where a stage has no interval there."""
    tr = facts.get("trace")
    stages = program_stages()
    if tr is None or facts.get("peak") is None:
        return None
    ms = 0.0
    for name in names:
        got = stage_ms(tr.kernels, stages.index(name)) if name in stages else []
        if not got:
            return None
        ms += sum(got) / len(got)
    return ms
