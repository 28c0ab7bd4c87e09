"""The comparison fails what it must: the lower-precision control (the
reference with fp8-rounded products in the program's place) and the
planted faults come out not correct. Inference: the first image's boxes
moved where they are returned (`moved_boxes`), half of its detections
dropped there (`dropped_dets`), the per-class NMS suppressing nothing
(`no_det_nms`). Training: half of each batch left out (`half_batch`), the
cube head's update left out (`frozen_head`).

On the CPU at a tiny width each reads well above the program's own reading
on at least one number, or above a limit that the configuration states
(the NMS threshold); on the card (`cuda`), at the cells' own sizes on
three seeds, each comes out `correct: false` under the committed limits."""
from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

INFERENCE_FAULTS = ["moved_boxes", "dropped_dets", "no_det_nms"]
CASES = [(cell, sub) for cell in ("dla34.offline_b8", "resnet34.live_b1")
         for sub in ["control", *INFERENCE_FAULTS]]
CASES += [("dla34.train_b32", sub) for sub in ("control", "half_batch", "frozen_head")]
SEEDS = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]


def _numbers(name, substitute, seed=2 ** 31 + 17, rpn_nms=None):
    """The compared numbers of a tiny run whose window is one call, so
    both sides judge the same frames."""
    bench, spec, config = tiny.cell(name)
    if rpn_nms is not None:
        config["cfg"]["MODEL"]["RPN"]["NMS_THRESH"] = rpn_nms
    out = harness.run_cell(name, seed, 0.0, False, device="cpu", bench=bench, spec=spec,
                           config=config, substitute=substitute)
    stated = {k for k, lim in spec["limits"].items() if isinstance(lim, str)}
    return ({k: c["value"] for k, c in out["checks"].items()},
            any(out["checks"][k]["value"] > out["checks"][k]["limit"] for k in stated))


@pytest.mark.parametrize("name,substitute", CASES)
def test_substitute_reads_above_the_program(name, substitute):
    # the tiny DLA cell's 40 proposals seldom overlap enough for the
    # per-class NMS to suppress a detection; without the RPN's NMS they do
    rpn_nms = 1.0 if (name, substitute) == ("dla34.offline_b8", "no_det_nms") else None
    (sound, _), (bad, over) = (_numbers(name, None, rpn_nms=rpn_nms),
                               _numbers(name, substitute, rpn_nms=rpn_nms))
    assert over or any(bad[k] >= 3 * sound[k] and bad[k] > 0 for k in sound), (sound, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("name,substitute", CASES)
def test_substitute_is_not_correct_on_the_card(name, substitute):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells' own sizes")
    for seed in SEEDS:
        out = harness.run_cell(name, seed, 2.0, False, substitute=substitute)
        assert out["correct"] is False, (seed, out["checks"])
