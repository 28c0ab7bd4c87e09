"""The port's spans (`utils.trace`) on the CPU at the narrow test widths:
off unless a profiler records, named and ordered as PERF.md's inventory
says, nested under the training step's forward, leaving every output,
parameter and graph key as it was; the stages' marker kernels (launches
stood in for) and their reading from kernel records; and
`engine.loop._StepProfile`'s summary."""
import contextlib
import json
import types

import pytest
import torch

from omni3d_tpu_torch.engine import loop
from omni3d_tpu_torch.models import rcnn3d
from omni3d_tpu_torch.tools.synthetic import condition_pose_bias_, synthetic_trainer
from omni3d_tpu_torch.utils import trace
from torch_port_helpers import small_cfgs

IMG = 64
TRAIN_IMG = 160   # `synthetic.train_batch` draws boxes up to 132 px
CPU = [torch.profiler.ProfilerActivity.CPU]
_, CFG = small_cfgs(**{"MODEL.RPN.PRE_NMS_TOPK_TEST": 64, "MODEL.RPN.POST_NMS_TOPK_TEST": 64,
                       "TPU.NMS_CANDIDATES": 128, "TEST.DETECTIONS_PER_IMAGE": 10,
                       "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 32,
                       "MODEL.RPN.BATCH_SIZE_PER_IMAGE": 32,
                       "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 64, "MODEL.RPN.POST_NMS_TOPK_TRAIN": 32})
INFERENCE = ["inference.trunk", "inference.proposals", "inference.box", "inference.cube"]
FORWARD = ["step.trunk", "step.rpn_head", "step.anchor_labelling", "step.proposals",
           "step.roi_sampling", "step.pooler", "step.box", "step.cube"]


@pytest.fixture
def marks(monkeypatch):
    """The marker kernels launched, by id, in place of the launches."""
    launched = []
    monkeypatch.setattr(trace, "_mark", lambda mark_id, device: launched.append(mark_id))
    return launched


@pytest.fixture(scope="module")
def model():
    m = rcnn3d.build_model(CFG, device="cpu", seed=0)
    condition_pose_bias_(m)
    return m


def _inputs(seed=0):
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn(1, IMG, IMG, 3, generator=gen)
    K = torch.tensor([[[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]]])
    return images, K, torch.ones(1)


def _oracle():
    return (torch.tensor([[[4.0, 4.0, 40.0, 40.0], [10.0, 2.0, 60.0, 50.0]]]),
            torch.tensor([[1, 3]], dtype=torch.int32), torch.tensor([[True, False]]))


def _spans(prof) -> list:
    """(name without the prefix, start, end) of the port's span records,
    by start."""
    out = [(e.name[len(trace.PREFIX):], e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith(trace.PREFIX)
           and e.device_type == torch.autograd.DeviceType.CPU]
    return sorted(out, key=lambda s: s[1])


def _trainer():
    return synthetic_trainer(CFG, torch.float32, 1, "cpu", img=TRAIN_IMG)


@pytest.fixture(scope="module")
def trainer():
    return _trainer()


def test_no_profiler_enters_no_record_function_and_records_no_event(model, trainer, marks,
                                                                   monkeypatch):
    """With no profiler neither eager inference nor a training step enters
    a `record_function`, and a stage on a CUDA device launches no marker
    outside a capture; under a profiler the same inference enters one per
    stage (on the CPU, with no marker), and a stage on a CUDA device
    launches its two markers."""
    entered = []
    real = torch.profiler.record_function

    def counting(name, args=None):
        entered.append(name)
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    rcnn3d.inference(model, *_inputs(), **rcnn3d.inference_kwargs(CFG))
    _, _, step, batch = trainer
    step(batch, torch.Generator().manual_seed(0))
    with trace.stage("inference.trunk", torch.device("cuda")):
        pass
    assert entered == [] and marks == []
    with torch.profiler.profile(activities=CPU):
        rcnn3d.inference(model, *_inputs(), **rcnn3d.inference_kwargs(CFG))
        assert entered == [trace.PREFIX + n for n in INFERENCE] and marks == []
        with trace.stage("step.backward", torch.device("cuda")):
            pass
    i = trace.STAGES.index("step.backward")
    assert marks == [2 * i, 2 * i + 1]


def test_inference_stages_in_order(model):
    """Eager inference emits the four stages in order; the oracle path
    trunk and cube only; every stage has its markers' ids (`STAGES`)."""
    kw = rcnn3d.inference_kwargs(CFG)
    with torch.profiler.profile(activities=CPU) as prof:
        rcnn3d.inference(model, *_inputs(), **kw)
    assert [n for n, _, _ in _spans(prof)] == INFERENCE
    with torch.profiler.profile(activities=CPU) as prof:
        rcnn3d.inference(model, *_inputs(), oracle=_oracle(), sampling_ratio=0)
    assert [n for n, _, _ in _spans(prof)] == ["inference.trunk", "inference.cube"]
    assert set(INFERENCE + FORWARD) <= set(trace.STAGES)


def test_the_dense_concat_and_rank_means_stages_have_markers():
    """The stages inside DenseNet's train-mode trunk and around the step's
    own collectives have marker ids, within csrc/stage_mark.cu's 32."""
    assert {"trunk.dense_concat", "step.rank_means"} <= set(trace.STAGES)
    assert len(trace.STAGES) == len(set(trace.STAGES)) <= 32


def test_training_step_spans_in_order_and_nested(trainer):
    """One step emits forward, its eight stages inside it in order, then
    backward, the skip decision and the optimizer."""
    _, _, step, batch = trainer
    with torch.profiler.profile(activities=CPU) as prof:
        step(batch, torch.Generator().manual_seed(0))
    spans = _spans(prof)
    assert [n for n, _, _ in spans] == (["step.forward"] + FORWARD
                                        + ["step.backward", "step.skip_decision",
                                           "step.optimizer"])
    _, f0, f1 = spans[0]
    assert all(f0 <= s and e <= f1 for n, s, e in spans[1:9])
    assert spans[9][1] >= f1


def test_profiling_changes_no_output_parameter_or_graph_key(model):
    """Inference outputs and graph keys, and the logs and parameters after
    a step, are bit-equal with the profiler on and off."""
    kw = rcnn3d.inference_kwargs(CFG)
    args = _inputs(1)
    off = rcnn3d.inference(model, *args, **kw)
    key_off = rcnn3d.graph_key(model, *args, **kw)
    with torch.profiler.profile(activities=CPU):
        on = rcnn3d.inference(model, *args, **kw)
        key_on = rcnn3d.graph_key(model, *args, **kw)
    assert key_on == key_off
    for k, v in off.items():
        assert torch.equal(on[k], v), k
    logs = []
    params = []
    for profiled in (False, True):
        m, _, step, batch = _trainer()
        with torch.profiler.profile(activities=CPU) if profiled else contextlib.nullcontext():
            logs.append(step(batch, torch.Generator().manual_seed(3)))
        params.append([p.detach().clone() for p in m.parameters()])
    for k, v in logs[0].items():
        assert torch.equal(torch.as_tensor(logs[1][k]), torch.as_tensor(v)), k
    assert all(torch.equal(a, b) for a, b in zip(*params))


def _kernel(name, start, end, cuda=True, note=False):
    """A stand-in for a profiler event."""
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, device_type=kind, is_user_annotation=note,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def _mark_name(mark_id):
    return f"void omni3d_stage_mark<{mark_id}>()"


def test_graph_stages_readings(marks, monkeypatch):
    """Stages inside a graph's capture launch their markers with no
    profiler; each replay's kernel records then give every stage's busy
    time between its markers, the idle time and the other stages' kernels
    left out, in replay order."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    cuda = torch.device("cuda")
    for name in ("inference.trunk", "inference.cube"):
        with trace.stage(name, cuda):
            pass
    trunk, cube = trace.STAGES.index("inference.trunk"), trace.STAGES.index("inference.cube")
    assert marks == [2 * trunk, 2 * trunk + 1, 2 * cube, 2 * cube + 1]
    records = []
    for r, t in enumerate((0.0, 1000.0)):     # two replays; the trunk's kernel grows
        records += [(_mark_name(2 * trunk), t, t + 1), ("conv", t + 10, t + 110 + r * 100),
                    ("conv", t + 300, t + 350), (_mark_name(2 * trunk + 1), t + 400, t + 401),
                    ("clone", t + 405, t + 410), (_mark_name(2 * cube), t + 420, t + 421),
                    ("gemm", t + 430, t + 450), (_mark_name(2 * cube + 1), t + 460, t + 461)]
    got = trace.stage_device_ms(records)
    assert got == {"inference.trunk": pytest.approx([0.15, 0.25]),
                   "inference.cube": pytest.approx([0.02, 0.02])}
    assert trace.stage_device_ms(records[:-1])["inference.cube"] == pytest.approx([0.02])


def test_step_profile_summary(tmp_path):
    """`_StepProfile` around two calls of a tiny step writes the trace and
    the summary: its keys, the window from the trace's own events, the
    spans' host ms; on a card the busy share is busy over that window, and
    a stage's device ms the busy time between its markers, which are not
    counted as kernels."""
    prof = loop._StepProfile(str(tmp_path), torch.device("cpu"), 0)
    for _ in range(2):
        with trace.span("train.step"):
            torch.ones(64).mul_(2.0)
    summary = prof.stop(2)
    assert json.loads((tmp_path / "summary.json").read_text()) == summary
    assert (tmp_path / "trace.json").is_file()
    assert set(summary) == {"device", "steps", "window_ms_per_step", "device_busy_ms_per_step",
                            "device_busy_share", "kernels_per_step", "span_host_ms",
                            "stage_device_ms"}
    times = [(e.time_range.start, e.time_range.end) for e in prof.prof.events()]
    window = (max(t for _, t in times) - min(s for s, _ in times)) / 1e3
    assert summary["window_ms_per_step"] == pytest.approx(window / 2)
    assert summary["device_busy_share"] is None and summary["stage_device_ms"] == {}
    step = summary["span_host_ms"]["train.step"]
    assert list(summary["span_host_ms"]) == ["train.step"] and step["calls"] == 2
    assert step["ms_per_call"] == pytest.approx(step["ms_per_step"])
    assert 0 < step["ms_per_call"] <= window / 2

    fwd = 2 * trace.STAGES.index("step.forward")
    events = [_kernel("omni3d.step.forward", 0.0, 4000.0, cuda=False, note=True),
              _kernel("omni3d.step.forward", 500.0, 3500.0, note=True),   # its device range
              _kernel(_mark_name(fwd), 900.0, 901.0), _kernel("gemm", 1000.0, 2000.0),
              _kernel("Memcpy HtoD", 2000.0, 3000.0), _kernel(_mark_name(fwd + 1), 3100.0, 3101.0)]
    card = loop.step_profile_summary(events, 2, "card")
    assert card["window_ms_per_step"] == 2.0 and card["device_busy_share"] == 0.25
    assert card["kernels_per_step"] == 0.5
    assert card["span_host_ms"] == {"step.forward": {"calls": 1, "ms_per_call": 4.0,
                                                     "ms_per_step": 2.0}}
    assert card["stage_device_ms"] == {"step.forward": {"calls": 1, "ms_per_call": 1.0,
                                                        "ms_per_step": 0.5}}
