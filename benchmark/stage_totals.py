"""What the readers of stages with many intervals a step share, in ms per
traced call summed over all of a stage's intervals in the traced
sub-window (`program_spans.device_ms_per_call` averages one interval a
call instead): the busy time of the kernels inside them, or the time they
span on the device, idle gaps included."""
from __future__ import annotations

from .program_spans import MARK, program_stages, stage_ms


def _trace(facts: dict, name: str):
    tr = facts.get("trace")
    if tr is None or facts.get("peak") is None or not tr.calls or name not in program_stages():
        return None
    return tr


def stage_total_ms(facts: dict, name: str):
    """The summed device ms of every interval of the program's stage `name`
    per traced call; None off the card, and where the program has no such
    stage or it ran no interval."""
    tr = _trace(facts, name)
    got = stage_ms(tr.kernels, program_stages().index(name)) if tr else []
    return sum(got) / tr.calls if got else None


def stage_span_ms(facts: dict, name: str):
    """The summed ms from each interval's start marker's end to its end
    marker's start, per traced call: what the stage holds the device's
    stream for, waits for the host or for another rank included. None as
    `stage_total_ms`."""
    tr = _trace(facts, name)
    if tr is None:
        return None
    index = program_stages().index(name)
    marks = sorted((s, e, int(m.group(1))) for n, s, e in tr.kernels if (m := MARK.search(n)))
    us, t0, spans = 0.0, None, 0
    for s, e, mark in marks:
        if mark == 2 * index:
            t0 = e
        elif mark == 2 * index + 1 and t0 is not None:
            us, t0, spans = us + s - t0, None, spans + 1
    return us / 1e3 / tr.calls if spans else None
