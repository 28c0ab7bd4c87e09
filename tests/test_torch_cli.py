"""The port's training CLI in a subprocess, on the CPU: 4 steps, then
--resume to 5 (`python -m omni3d_tpu_torch.tools.train_net`, the command a
user runs). As on the card's machine, `tensorboard` does not import (a stub
package that raises ImportError comes first on the path; here importing it
would import TensorFlow, ~14 s), and torch runs two threads (the tier-1
command runs six test processes on the machine's cores)."""
import os
import subprocess
import sys

from test_torch_loop import ROOT, _argv, _metrics, write_loop_dataset


def test_cli_trains_and_resumes_in_a_subprocess(tmp_path):
    data_root = str(tmp_path / "data")
    write_loop_dataset(data_root)
    stub = tmp_path / "stub" / "tensorboard"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("raise ImportError('no tensorboard')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(tmp_path / "stub"), OMP_NUM_THREADS="2")
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
