"""Evaluation through the port's entry points on the CPU: `engine.loop.do_test`
against the JAX package's `do_test`, evaluation every TEST.EVAL_PERIOD
iterations of training leaving the run bit-equal to an unbroken one, the
training model's modes after an evaluation, and `--eval-only` refusing to
leave the card unless asked.

do_test tolerances (same weights, f32, one 64 x 96 test split at
TPU.EVAL_BATCH_SIZE 2): the same number of predictions and categories,
scores within 1e-4, 2D boxes within 1e-3 px, and AP dicts within 1e-6 (the
inference slice's own tolerances, tests/test_torch_inference.py)."""
import os

import numpy as np
import pytest
import torch

from omni3d_tpu.config.cfg import StaticCfg
from omni3d_tpu.data import datasets as jds
from omni3d_tpu.engine import loop as jloop
from omni3d_tpu_torch.data import datasets as tds
from omni3d_tpu_torch.engine import loop as tloop
from omni3d_tpu_torch.models.layers import BatchNorm2d
from omni3d_tpu_torch.models.rcnn3d import build_model
from omni3d_tpu_torch.tools import train_net
from omni3d_tpu_torch.tools.synthetic import write_omni3d_dataset, write_omni3d_stats
from omni3d_tpu_torch.utils import events as tevents
from omni3d_tpu_torch.utils.checkpoint import state_dict_from_flax
from test_torch_loop import CATS, _argv, write_loop_dataset
from test_torch_train import TINY
from torch_port_helpers import pooled_shape, random_variables, small_cfgs

# test-time settings at the narrow widths: few proposals and detections
EVAL = {"MODEL.RPN.PRE_NMS_TOPK_TEST": 64, "MODEL.RPN.POST_NMS_TOPK_TEST": 64,
        "TEST.DETECTIONS_PER_IMAGE": 10, "TPU.NMS_CANDIDATES": 128,
        "INPUT.MIN_SIZE_TEST": 64, "INPUT.MAX_SIZE_TEST": 200, "TPU.EVAL_BATCH_SIZE": 2}


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard_two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tevents, "_make_tb_writer", lambda output_dir: None)
        yield
    torch.set_num_threads(threads)


def test_do_test_matches_jax(tmp_path):
    data_root = str(tmp_path / "data")
    write_omni3d_stats(data_root)
    write_omni3d_dataset(data_root, "SUNRGBD_test", 5, 64, 96, "ppm", seed=8, dataset_id=1,
                         objects=(2, 5), categories=CATS)
    over = {**TINY, **EVAL, "DATASETS.TEST": ("SUNRGBD_test",),
            "DATASETS.CATEGORY_NAMES": list(CATS), "MODEL.ROI_HEADS.SCORE_THRESH_TEST": 0.05}
    jcfg, tcfg = small_cfgs(**over)
    root = os.path.join(data_root, "Omni3D")
    for lib, cfg in ((jds, jcfg), (tds, tcfg)):
        fs = lib.get_filter_settings_from_cfg(cfg)
        lib.simple_register("SUNRGBD_test", fs, datasets_root_path=root)
        lib.register_and_store_model_metadata(str(tmp_path / lib.__name__), fs,
                                              os.path.join(root, "stats.json"))
    jm = jloop.build_eval_model(StaticCfg(jcfg))
    variables = random_variables(jm, (64, 96), seed=6)
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables["params"], variables["batch_stats"],
                                               pooled_shape(tcfg)), strict=True)

    want = jloop.do_test(jcfg, jm, variables, output_dir=None)
    got = tloop.do_test(tcfg, model, output_dir=str(tmp_path / "out"))
    files = tmp_path / "out" / "inference" / "iter_final"
    assert (files / "omni3d_results.json").exists()
    preds = tloop.Omni3DEvaluationHelper.load_predictions(
        files / "SUNRGBD_test" / "instances_predictions.pkl")
    jpreds = jloop.run_inference_dataset(
        jcfg, jm, variables, "SUNRGBD_test",
        jds.metadata("omni3d_model")["thing_dataset_id_to_contiguous_id"])
    assert len(preds) == len(jpreds) > 10
    for p, q in zip(preds, jpreds):
        assert (p["image_id"], p["category_id"], p["id"]) == (q["image_id"], q["category_id"],
                                                               q["id"])
        np.testing.assert_allclose(p["score"], q["score"], atol=1e-4)
        np.testing.assert_allclose(p["bbox"], q["bbox"], atol=1e-3)
    assert got["SUNRGBD_test"]["inference"]["images"] == 5
    batches = got["SUNRGBD_test"]["inference"]["batches"]
    assert [b[2] for b in batches] == [2, 2, 1] and len({tuple(b[:2]) for b in batches}) == 1
    for k, w in want["SUNRGBD_test"].items():
        if k.startswith(("AP", "AR")):
            assert abs(got["SUNRGBD_test"][k] - w) <= 1e-6, k
    for k, w in want["summary"].items():
        g = got["summary"][k]
        assert (np.isnan(w) and np.isnan(g)) or abs(g - w) <= 1e-6, k


@pytest.fixture(scope="module")
def eval_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_loop"))
    write_loop_dataset(root)
    write_omni3d_dataset(root, "SUNRGBD_test", 2, 48, 64, "ppm", seed=5, dataset_id=1,
                         objects=(1, 4), categories=CATS)
    return root


def _eval_opts(period):
    return {"DATASETS.TEST": "('SUNRGBD_test',)", "TEST.EVAL_PERIOD": str(period),
            **{k: str(v) for k, v in EVAL.items()}, "INPUT.MIN_SIZE_TEST": "48"}


def test_evaluation_during_training_leaves_the_run_unchanged(eval_root, tmp_path):
    """2 steps, an evaluation, 2 steps, an evaluation: bit-equal to 4
    straight steps (parameters, BN statistics, optimizer, step state, logs);
    both evaluations wrote their files."""
    straight = train_net.main(_argv(eval_root, tmp_path / "a", 4, **_eval_opts(0)))
    evaluated = train_net.main(_argv(eval_root, tmp_path / "b", 4, **_eval_opts(2)))
    for it in (1, 3):
        assert (tmp_path / "b" / "inference" / f"iter_{it}" / "omni3d_results.json").exists()
    assert not (tmp_path / "a" / "inference").exists()
    for k, v in straight.model.state_dict().items():
        assert torch.equal(evaluated.model.state_dict()[k], v), k
    for a, b in zip(straight.optimizer.state_dict()["state"].values(),
                    evaluated.optimizer.state_dict()["state"].values()):
        assert torch.equal(a["momentum_buffer"], b["momentum_buffer"])
    assert straight.step.state["step"] == evaluated.step.state["step"] == 4
    assert torch.equal(straight.step.state["recent_loss"], evaluated.step.state["recent_loss"])
    assert straight.shapes == evaluated.shapes
    assert all(m.training for m in evaluated.model.modules())


@pytest.mark.parametrize("use_bn", [True, False])
def test_eval_mode_restores_every_module_mode(use_bn):
    """With MODEL.USE_BN False the training model keeps BN in eval mode
    (frozen statistics); an evaluation must not un-freeze it."""
    _, tcfg = small_cfgs(**{"MODEL.USE_BN": use_bn})
    model = build_model(tcfg, device="cpu", seed=0, train=True)
    before = [m.training for m in model.modules()]
    bn = [m.training for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert all(bn) == use_bn and any(bn) == use_bn
    with tloop.eval_mode(model):
        assert not any(m.training for m in model.modules())
    assert [m.training for m in model.modules()] == before


def test_eval_only_targets_the_card_unless_asked(eval_root, tmp_path):
    argv = [a for a in _argv(eval_root, tmp_path, 1, "--eval-only", **_eval_opts(0))
            if a not in ("--device", "cpu")]
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train_net.main(argv)
