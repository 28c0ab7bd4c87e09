"""The port's training entry point on the CPU: checkpoints (round trip, the
periodic file set, the JAX package's files refused), resume bit-equal to an
unbroken run, the retry protocol restarting from model_recent and the
metrics.json keys. The CLI in a subprocess is tests/test_torch_cli.py; two
loop iterations against the JAX package are tests/test_torch_loop_jax.py.
The runs here write no TensorBoard events (creating the writer imports
TensorFlow where it is installed, ~14 s) and use two torch threads (the
tier-1 command runs six test processes on the machine's cores)."""
import json
import os
import pathlib
import pickle

import numpy as np
import pytest
import torch

from omni3d_tpu_torch.engine import loop as tloop
from omni3d_tpu_torch.tools import train_net
from omni3d_tpu_torch.tools.synthetic import write_omni3d_dataset, write_omni3d_stats
from omni3d_tpu_torch.utils import checkpoint as tckpt
from omni3d_tpu_torch.utils import events as tevents
from test_torch_train import TINY

ROOT = pathlib.Path(__file__).resolve().parents[1]
CATS = ("car", "chair", "lamp", "sofa", "table")
TRAIN = ("SUNRGBD_train", "KITTI_train")
OPTS = {
    "DATASETS.TRAIN": str(TRAIN), "DATASETS.TEST": "()",
    "DATASETS.CATEGORY_NAMES": str(list(CATS)),
    "MODEL.ROI_HEADS.NUM_CLASSES": "5", "MODEL.FPN.OUT_CHANNELS": "32",
    "MODEL.ROI_BOX_HEAD.FC_DIM": "64", "MODEL.ROI_CUBE_HEAD.FC_DIM": "64",
    **{k: str(v) for k, v in TINY.items()},
    "INPUT.MIN_SIZE_TRAIN": "(48, 64)", "INPUT.MAX_SIZE_TRAIN": "200",
    "SOLVER.IMS_PER_BATCH": "2", "SOLVER.CHECKPOINT_PERIOD": "2",
    "TPU.COMPUTE_DTYPE": "float32", "TPU.TRAIN_SIZE_BUCKETS": "4",
    "DATALOADER.NUM_WORKERS": "0", "SEED": "3", "VIS_PERIOD": "0",
}


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard_two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tevents, "_make_tb_writer", lambda output_dir: None)
        yield
    torch.set_num_threads(threads)


def write_loop_dataset(root):
    """A SUN RGB-D-like split (PPM) and a KITTI-like one (PNG) at tiny
    sizes, 5 categories."""
    write_omni3d_dataset(root, "SUNRGBD_train", 6, 48, 64, "ppm", seed=1, dataset_id=1,
                         objects=(1, 4), categories=CATS)
    write_omni3d_dataset(root, "KITTI_train", 4, 30, 100, "png", seed=2, dataset_id=2,
                         objects=(1, 4), categories=CATS)
    write_omni3d_stats(root)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loop_omni3d"))
    write_loop_dataset(root)
    return root


def _argv(root, out, steps, *extra, **opts):
    kv = {**OPTS, "OUTPUT_DIR": str(out), **opts}
    return (["--config-file", str(ROOT / "configs" / "cubercnn_DLA34_FPN.yaml"),
             "--datasets-root", os.path.join(root, "Omni3D"), "--max-steps", str(steps),
             "--device", "cpu", *extra] + [x for k, v in kv.items() for x in (k, v)])


def _metrics(out):
    with open(os.path.join(out, "metrics.json")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def unbroken(data_root, tmp_path_factory):
    out = tmp_path_factory.mktemp("unbroken")
    return out, train_net.main(_argv(data_root, out, 4))


# ------------------------------ checkpoints ------------------------------

def test_periodic_checkpointer_file_set(tmp_path):
    saved = []
    cp = tckpt.PeriodicCheckpointer(str(tmp_path), period=2, max_iter=5)
    for it in range(5):
        cp.step(it, lambda it=it: saved.append(it) or {"it": torch.tensor(it)},
                {"iteration": it})
        names = sorted(os.listdir(tmp_path))
        assert names == (["model_final.ckpt", "model_recent.ckpt"] if it == 4 else
                         ["model_recent.ckpt"] if it >= 1 else [])
    assert saved == [1, 3, 4]
    state, extra = tckpt.load_checkpoint(str(tmp_path / "model_recent.ckpt"))
    assert extra == {"iteration": 3} and int(state["it"]) == 3
    assert tckpt.resume_or_load(str(tmp_path))[1] == {"iteration": 3}
    assert tckpt.resume_or_load(str(tmp_path / "none")) is None
    with open(tmp_path / "jax.ckpt", "wb") as f:   # the JAX package's format: a plain pickle
        pickle.dump({"tree": {"a": np.ones(2)}, "extra": {}}, f)
    with pytest.raises(ValueError, match="state_dict_from_flax"):
        tckpt.load_checkpoint(str(tmp_path / "jax.ckpt"))


def test_checkpoint_round_trip_and_metrics(unbroken):
    out, run = unbroken
    assert sorted(p for p in os.listdir(out) if p.endswith(".ckpt")) == [
        "model_final.ckpt", "model_recent.ckpt"]
    state, extra = tckpt.load_checkpoint(str(out / "model_final.ckpt"))
    assert extra == {"iteration": 3}
    for k, v in run.model.state_dict().items():
        assert torch.equal(state["model"][k], v), k
    assert state["step"]["step"] == 4 and state["step"]["skipped"] == run.step.state["skipped"]
    assert torch.equal(state["step"]["recent_loss"], run.step.state["recent_loss"])
    assert state["scheduler"]["last_epoch"] == run.scheduler.last_epoch
    opt = run.optimizer.state_dict()
    assert state["optimizer"]["param_groups"] == opt["param_groups"]
    for i, s in opt["state"].items():
        assert torch.equal(state["optimizer"]["state"][i]["momentum_buffer"], s["momentum_buffer"])
    _, recent = tckpt.load_checkpoint(str(out / "model_recent.ckpt"))
    assert recent == {"iteration": 3}

    lines = _metrics(out)
    assert [r["iteration"] for r in lines] == [0, 3]
    keys = {"iteration", "total_loss", "lr", "finite", "time/data_ms", "time/step_ms",
            "roi/num_fg", "rpn/num_pos_anchors", "rpn/num_neg_anchors", "rpn/cls", "rpn/loc",
            "BoxHead/loss_cls", "BoxHead/loss_box_reg", "Cube/loss_dims", "Cube/loss_xy",
            "Cube/loss_z", "Cube/loss_pose", "Cube/loss_joint", "Cube/uncert"}
    for r in lines:
        assert keys <= set(r), keys - set(r)
        assert all(np.isfinite(v) for v in r.values())
    with open(out / "category_meta.json") as f:
        assert json.load(f)["thing_classes"] == sorted(CATS)
    assert len(run.shapes) == 4 and len(set(run.shapes)) > 1


def test_resume_is_bit_equal_to_an_unbroken_run(data_root, unbroken, tmp_path):
    """2 steps, then --resume to 4 from model_recent (iteration 1): the same
    parameters, BN statistics, optimizer state and logs as 4 straight steps."""
    out, run = unbroken
    train_net.main(_argv(data_root, tmp_path, 2))
    os.remove(tmp_path / "model_final.ckpt")
    resumed = train_net.main(_argv(data_root, tmp_path, 4, "--resume"))
    assert resumed.start_iter == 2 and resumed.iterations == [2, 3]
    assert resumed.shapes == run.shapes[2:]
    for k, v in run.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    for a, b in zip(run.optimizer.state_dict()["state"].values(),
                    resumed.optimizer.state_dict()["state"].values()):
        assert torch.equal(a["momentum_buffer"], b["momentum_buffer"])
    assert run.step.state["step"] == resumed.step.state["step"] == 4
    assert torch.equal(run.step.state["recent_loss"], resumed.step.state["recent_loss"])
    want, got = _metrics(out)[-1], _metrics(tmp_path)[-1]
    for k, v in want.items():
        if not k.startswith("time/"):
            assert got[k] == v, k


def test_retry_restarts_from_model_recent(data_root, tmp_path, monkeypatch, capsys):
    """A NaN image at iteration 2 of the first attempt spends the exploded
    budget (1 of 4 >= MODEL.STABILIZE); the second attempt resumes from
    model_recent (iteration 1) and finishes."""
    calls = {"n": 0}
    real = tloop.batch_to_device

    def poisoned(batch, *a, **k):
        out = real(batch, *a, **k)
        calls["n"] += 1
        if calls["n"] == 3:
            out["images"][0, 0, 0, 0] = float("nan")
        return out
    monkeypatch.setattr(tloop, "batch_to_device", poisoned)
    run = train_net.main(_argv(data_root, tmp_path, 4))
    log = capsys.readouterr().out
    assert "restarting from checkpoint" in log and "attempt 1 failed" in log
    assert "resumed from" in log and run.start_iter == 2 and run.iterations == [2, 3]
    assert run.step.state["skipped"] == 0 and calls["n"] == 6
    assert tckpt.load_checkpoint(str(tmp_path / "model_final.ckpt"))[1] == {"iteration": 3}
