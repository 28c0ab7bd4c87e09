"""The training cells beside dla34.train_b32: `densenet121.train_b32`
(DenseNet-121-FPN on one card, traffic `train`) and `dla34.train_ddp4`
(DLA-34-FPN data-parallel over four cards, traffic `train_ddp`).

On the CPU at a tiny width in float32: the DenseNet cell reads correct
with every compared number 0 (the port and the reference agree to the
bit); the data-parallel generator with two gloo ranks reads correct with
`rank_param_gap` 0, while the faults `no_exchange` (DDP's gradient
reduction left out) and `no_bn_mean` (the BN running statistics' mean left
out) leave the ranks' state apart, and the fp8 control reads above the
program, each not correct. The readers of the new stages sum every
interval of a step: the busy time inside, or the time spanned.

On the card (`cuda`), at the cells' own sizes on three seeds: the control
and each planted fault come out `correct: false` under the committed
limits. The verdict reads the set-up's compared steps, which the
generators drive before the window, and `rank_param_gap` after it, so the
window repeats an episode of one pass over the pool (4 steps) instead of
104 steps (~8 minutes a seed of fp8 reference steps on DenseNet-121)."""
from __future__ import annotations

import os

import pytest
import torch

from benchmark import harness, stage_totals
from benchmark.tests import tiny
from benchmark.trace import Trace

SEED = 2 ** 31 + 29
SEEDS = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]
DENSENET = "densenet121.train_b32"
DDP = "dla34.train_ddp4"


def _tiny_float32(name: str, **spec) -> tuple:
    bench, base, config = tiny.cell(name)
    config["cfg"]["TPU"]["COMPUTE_DTYPE"] = "float32"
    return bench, dict(base, **spec), config


def test_densenet_cell_matches_the_reference_in_float32(monkeypatch):
    from omni3d_tpu_torch.utils import trace
    entered, real = [], trace.stage
    monkeypatch.setattr(trace, "stage", lambda name, device: entered.append(name)
                        or real(name, device))
    bench, spec, config = _tiny_float32(DENSENET)
    out = harness.run_cell(DENSENET, SEED, 0.0, False, device="cpu", bench=bench, spec=spec,
                           config=config)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values()), out["checks"]
    steps = spec["check_steps"] + spec["episode_steps"]
    assert entered.count("trunk.dense_concat") == 58 * steps


@pytest.fixture
def two_threads():
    """Two intra-op threads in each rank (the spawned rank takes rank 0's
    count): two ranks of the machine's default count each oversubscribe
    the cores several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("substitute", [None, "no_exchange", "no_bn_mean", "control"])
def test_two_gloo_ranks(substitute, two_threads):
    bench, spec, config = _tiny_float32(DDP, ranks=2)
    out = harness.run_cell(DDP, SEED, 0.0, False, device="cpu", bench=bench, spec=spec,
                           config=config, substitute=substitute)
    checks = {k: c["value"] for k, c in out["checks"].items()}
    assert out["attempted"] == spec["episode_steps"] and out["failed"] == 0
    if substitute is None:
        assert out["correct"] is True and checks["rank_param_gap"] == 0, checks
        assert checks["loss_gap"] < 1e-6 and checks["grad_gap"] < 1e-6, checks
    else:
        assert out["correct"] is False, checks
        if substitute != "control":
            assert checks["rank_param_gap"] > 0, checks
        if substitute == "no_bn_mean":   # the step's own numbers are left as they were
            assert checks["loss_gap"] < 1e-6 and checks["grad_gap"] < 1e-6, checks


def _marks(index: int, spans: list) -> list:
    """Marker kernels of stage `index` around each (start us, end us), a
    30 us kernel inside each, 10 us after its start."""
    out = []
    for t0, t1 in spans:
        out += [(f"void omni3d_stage_mark<{2 * index}>()", t0 - 1.0, t0),
                ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", t0 + 10.0, t0 + 40.0),
                (f"void omni3d_stage_mark<{2 * index + 1}>()", t1, t1 + 1.0)]
    return out


def test_stage_readers_sum_every_interval_of_a_step(monkeypatch):
    """Two traced steps, each with intervals of 100 and 60 us of stage 1:
    `dense_concat_ms.train` reads the busy time inside them (2 x 30 us a
    step), `rank_means_ms.train_ddp` the time they span (160 us a step),
    `nccl_ms_per_step.train_ddp` the busy time of the nccl kernels; each
    None off the card or where the program has no such stage."""
    names = ("step.forward", "trunk.dense_concat")
    monkeypatch.setattr(stage_totals, "program_stages", lambda: names)
    spans = [(0.0, 100.0), (200.0, 260.0), (1000.0, 1100.0), (1200.0, 1260.0)]
    facts = {"trace": Trace(2, _marks(1, spans), []), "peak": {"bfloat16": 1.0}}
    assert harness.reader("dense_concat_ms.train")(facts) == pytest.approx(0.06)
    assert harness.reader("nccl_ms_per_step.train_ddp")(facts) == pytest.approx(0.06)
    assert stage_totals.stage_span_ms(facts, "trunk.dense_concat") == pytest.approx(0.16)
    assert harness.reader("rank_means_ms.train_ddp")(facts) is None    # not a stage here
    monkeypatch.setattr(stage_totals, "program_stages", lambda: ("a", "step.rank_means"))
    assert harness.reader("rank_means_ms.train_ddp")(facts) == pytest.approx(0.16)
    for read in map(harness.reader, ("dense_concat_ms.train", "rank_means_ms.train_ddp",
                                     "nccl_ms_per_step.train_ddp")):
        assert read(dict(facts, peak=None)) is None


CARD_CASES = [(DENSENET, sub) for sub in ("control", "half_batch", "frozen_head")]
CARD_CASES += [(DDP, sub) for sub in ("control", "no_exchange", "half_batch", "frozen_head",
                                      "no_bn_mean")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,substitute", CARD_CASES)
def test_substitute_is_not_correct_on_the_card(name, substitute):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells' own sizes")
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == name)
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{name} needs {chips} cards")
    spec = harness.load_json(os.path.join(harness.HERE, "workloads", name + ".json"))
    spec["episode_steps"] = spec["pool_batches"]
    for seed in SEEDS:
        out = harness.run_cell(name, seed, 0.0, False, spec=spec, substitute=substitute)
        assert out["correct"] is False, (seed, out["checks"])
