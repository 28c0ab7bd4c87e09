"""The result line: its keys, the cell's metrics, the checks last; the
command refuses without a card and outside a checkout of the program."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name,trace", [("dla34.offline_b8", False), ("dla34.offline_b8", True),
                                        ("resnet34.live_b1", False), ("dla34.train_b32", False)])
def test_result_keys(name, trace):
    bench, spec, config = tiny.cell(name)
    out = harness.run_cell(name, 2 ** 31 + 7, 0.2, trace, device="cpu", bench=bench, spec=spec,
                           config=config)
    want = KEYS[:4] + (["breakdown"] if trace else []) + KEYS[4:]
    assert list(out) == want
    assert list(out["checks"]) == list(spec["limits"])
    assert out["attempted"] > 0 and out["failed"] == 0
    _, _, e2e, _ = harness.find_cell(bench, name)
    if not trace:   # the CPU has no device trace, so no per-layer reading
        assert set(out["metrics"]) == {m["name"] for m in e2e}
    else:
        assert out["metrics"] == {} and set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(out["device"])
    json.dumps(out)


def _command(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dla34.offline_b8",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


def test_refuses_without_a_card():
    got = _command(harness.ROOT)
    assert got.returncode != 0 and got.stdout == ""
    assert "cuda" in got.stderr.lower()


def test_refuses_with_only_its_own_files(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _command(tmp_path)
    assert got.returncode != 0 and got.stdout == ""
