"""The port's training CLI in a subprocess, on the CPU: 4 steps, then
--resume to 5, and --eval-only of a checkpoint (`python -m
omni3d_tpu_torch.tools.train_net`, the command a user runs). As on the
card's machine, `tensorboard` does not import (a stub package that raises
ImportError comes first on the path; here importing it would import
TensorFlow, ~14 s), and torch runs two threads (the tier-1 command runs six
test processes on the machine's cores)."""
import json
import os
import subprocess
import sys

from test_torch_loop import CATS, ROOT, _argv, _metrics, write_loop_dataset


def _env(tmp_path):
    stub = tmp_path / "stub" / "tensorboard"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("raise ImportError('no tensorboard')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(tmp_path / "stub"), OMP_NUM_THREADS="2")
    return env


def test_cli_trains_and_resumes_in_a_subprocess(tmp_path):
    data_root = str(tmp_path / "data")
    write_loop_dataset(data_root)
    env = _env(tmp_path)
    cmd = [sys.executable, "-m", "omni3d_tpu_torch.tools.train_net"]
    first = subprocess.run(cmd + _argv(data_root, tmp_path, 4),
                           cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stderr[-3000:]
    assert "[train] finished" in first.stdout
    second = subprocess.run(cmd + _argv(data_root, tmp_path, 5, "--resume"),
                            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert second.returncode == 0, second.stderr[-3000:]
    assert "at iteration 4" in second.stdout and "iter: 4/5" in second.stdout
    assert [r["iteration"] for r in _metrics(tmp_path)] == [0, 3, 4]
    assert not (tmp_path / "tb").exists()


def test_cli_eval_only_in_a_subprocess(tmp_path):
    """--eval-only --weights <a checkpoint of the port> on a SUN RGB-D- and
    a KITTI-named test split: AP tables printed, predictions and results
    written under inference/iter_final."""
    from omni3d_tpu_torch.config import get_default_cfg
    from omni3d_tpu_torch.models.rcnn3d import build_model
    from omni3d_tpu_torch.tools.synthetic import write_omni3d_dataset
    from omni3d_tpu_torch.utils.checkpoint import save_checkpoint
    from test_torch_eval_loop import EVAL
    from test_torch_loop import OPTS

    data_root = str(tmp_path / "data")
    write_loop_dataset(data_root)
    for name, fmt, seed in (("SUNRGBD_test", "ppm", 5), ("KITTI_test", "png", 6)):
        write_omni3d_dataset(data_root, name, 2, 48, 64, fmt, seed=seed, dataset_id=1,
                             objects=(1, 4), categories=CATS)
    cfg = get_default_cfg()
    cfg.merge_from_list([x for k, v in OPTS.items() for x in (k, v)])
    ckpt = str(tmp_path / "weights.ckpt")
    save_checkpoint(ckpt, {"model": build_model(cfg, device="cpu", seed=1, train=True)
                           .state_dict()}, {"iteration": 7})
    opts = {"DATASETS.TEST": "('SUNRGBD_test', 'KITTI_test')",
            **{k: str(v) for k, v in EVAL.items()}, "INPUT.MIN_SIZE_TEST": "48"}
    out = tmp_path / "out"
    run = subprocess.run([sys.executable, "-m", "omni3d_tpu_torch.tools.train_net"]
                         + _argv(data_root, out, 1, "--eval-only", "--weights", ckpt, **opts),
                         cwd=ROOT, env=_env(tmp_path), capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "(iteration 7)" in run.stdout and "Performance on Omni3D" in run.stdout
    files = out / "inference" / "iter_final"
    with open(files / "omni3d_results.json") as f:
        results = json.load(f)
    assert set(results) == {"SUNRGBD_test", "KITTI_test"}
    for name in results:
        assert (files / name / "instances_predictions.pkl").exists()
        assert 0 <= results[name]["AP3D"] <= 100
    assert not (out / "model_final.ckpt").exists()
