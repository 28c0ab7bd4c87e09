"""The readers of the program's own spans: host ms per traced call from a
synthetic trace, a stage's device ms from the busy time between its marker
kernels, and None off the card, with no interval of a stage, or where the
program has no spans."""
from __future__ import annotations

import sys

import pytest

from benchmark import harness, program_spans
from benchmark.trace import Trace

CARD = {"bfloat16": 1.0}
HOST = ("graph_prep_ms.offline", "graph_prep_ms.live")
DEVICE = {"trunk_graph_ms.offline": ["inference.trunk"], "trunk_graph_ms.live": ["inference.trunk"],
          "proposals_graph_ms.live": ["inference.proposals"],
          "box_graph_ms.live": ["inference.box"], "cube_graph_ms.live": ["inference.cube"],
          "forward_device_ms.train": ["step.forward"],
          "backward_device_ms.train": ["step.backward"],
          "labelling_device_ms.train": ["step.anchor_labelling", "step.roi_sampling"]}
STAGES = ("inference.trunk", "inference.proposals", "inference.box", "inference.cube",
          "step.forward", "step.anchor_labelling", "step.roi_sampling", "step.backward")


def _trace() -> Trace:
    """Two calls: prepare spans of 300 and 200 us, another span of the
    program's and one of the benchmark's beside them."""
    cpu = [("bench.inference_step", 0.0, 1000.0, True),
           ("omni3d.inference_step.prepare", 10.0, 310.0, False),
           ("omni3d.inference_step.replay", 310.0, 400.0, False),
           ("bench.inference_step", 1000.0, 2000.0, True),
           ("omni3d.inference_step.prepare", 1010.0, 1210.0, False),
           ("aten::copy_", 1100.0, 1150.0, False)]
    return Trace(2, [("gemm", 320.0, 900.0)], cpu)


def _mark(i: int, t: float):
    return (f"void omni3d_stage_mark<{i}>()", t, t + 1.0)


def _stage_trace(names, calls=2) -> Trace:
    """`calls` calls; in each, stage k of `names` (in the program's STAGES)
    holds two kernels of (k + 1) * 50 us with a 50 us gap between them and
    idle time around them, and a kernel runs outside every stage."""
    kernels, t = [], 0.0
    for _ in range(calls):
        kernels.append(("outside", t, t + 500.0))
        t += 600.0
        for k, name in enumerate(names):
            i = STAGES.index(name)
            kernels.append(_mark(2 * i, t))
            t += 20.0                                    # idle after the start marker
            for _ in range(2):
                kernels.append(("gemm", t, t + (k + 1) * 50.0))
                t += (k + 1) * 50.0 + 50.0               # a gap of 50 us
            kernels.append(_mark(2 * i + 1, t))
            t += 30.0
    return Trace(calls, kernels, [("bench.step", 0.0, t, True)])


@pytest.mark.parametrize("metric", HOST)
def test_host_span_readers(metric):
    read = harness.reader(metric)
    assert read({"trace": _trace(), "peak": CARD}) == pytest.approx(0.25)
    assert read({"trace": _trace(), "peak": None}) is None
    assert read({"trace": Trace(2, [], [("bench.inference_step", 0.0, 9.0, True)]),
                 "peak": CARD}) is None


@pytest.mark.parametrize("metric", sorted(DEVICE))
def test_device_stage_readers(metric, monkeypatch):
    read = harness.reader(metric)
    names = DEVICE[metric]
    monkeypatch.setattr(program_spans, "program_stages", lambda: STAGES)
    want = sum((k + 1) * 0.1 for k in range(len(names)))
    assert read({"trace": _stage_trace(names), "peak": CARD}) == pytest.approx(want)
    assert read({"trace": _stage_trace(names), "peak": None}) is None
    other = next(n for n in STAGES if n not in names)
    assert read({"trace": _stage_trace([other]), "peak": CARD}) is None
    # a start marker whose end is not in the records reads nothing
    cut = _stage_trace(names, calls=1)
    end = _mark(2 * STAGES.index(names[-1]) + 1, 0.0)[0]
    cut.kernels[:] = [k for k in cut.kernels if k[0] != end]
    assert read({"trace": cut, "peak": CARD}) is None


def test_stage_ms_leaves_out_idle_time_and_other_stages():
    """Nested stages: the outer one counts the inner one's kernels, not
    its markers; idle time between kernels counts in neither; the mangled
    marker name reads as the demangled one."""
    kernels = [_mark(0, 0.0), ("a", 10.0, 40.0), ("_Z17omni3d_stage_markILi2EEvv", 50.0, 51.0),
               ("b", 60.0, 90.0), ("c", 80.0, 100.0), _mark(3, 120.0), _mark(1, 130.0),
               ("after", 200.0, 300.0)]
    assert program_spans.stage_ms(kernels, 0) == pytest.approx([0.03 + 0.04])
    assert program_spans.stage_ms(kernels, 1) == pytest.approx([0.04])
    assert program_spans.stage_ms(kernels, 2) == []


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "omni3d_tpu_torch.utils.trace", None)
    assert program_spans.program_stages() == ()
    trace = _stage_trace(DEVICE["trunk_graph_ms.live"])
    assert harness.reader("trunk_graph_ms.live")({"trace": trace, "peak": CARD}) is None
