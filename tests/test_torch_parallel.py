"""The port's multi-process helpers (`omni3d_tpu_torch.parallel`) on the
CPU: without a process group every helper answers for one process and
touches no collective; in 2 and 3 gloo processes `gather_objects` returns
every rank's list in rank order on every rank and `mean_across_ranks`
averages; TPU.MESH_DATA is held to the world size; and a process group of
one, joined through `--dist-init HOST:PORT`, trains bit for bit as no group
does (the DDP wrapper and the collectives change no value at world size 1).
The processes are spawned by tests/torch_ddp_workers.py."""
import json
import os

import pytest
import torch

import torch_ddp_workers as workers
from omni3d_tpu_torch.config import get_default_cfg
from omni3d_tpu_torch.parallel import dist as dist_lib
from omni3d_tpu_torch.tools import train_net
from omni3d_tpu_torch.utils import checkpoint as tckpt
from omni3d_tpu_torch.utils import events as tevents
from test_torch_loop import OPTS, _argv, _metrics, write_loop_dataset


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard_two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tevents, "_make_tb_writer", lambda output_dir: None)
        yield
    torch.set_num_threads(threads)


def test_without_a_process_group_every_helper_answers_for_one_process():
    assert not dist_lib.process_group_active()
    assert (dist_lib.process_index(), dist_lib.process_count()) == (0, 1)
    objs = [{"a": 1}, 2]
    got = dist_lib.gather_objects(objs)
    assert got == objs and got is not objs
    ts = [torch.ones(2), torch.zeros(())]
    assert all(a is b for a, b in zip(dist_lib.mean_across_ranks(ts), ts))
    dist_lib.barrier()
    cfg = get_default_cfg()
    assert cfg.TPU.MESH_DATA == -1 and dist_lib.check_world(cfg) == 1
    cfg.TPU.MESH_DATA = 1
    assert dist_lib.check_world(cfg) == 1
    cfg.TPU.MESH_DATA = 2
    with pytest.raises(ValueError, match="TPU.MESH_DATA=2 .* has 1"):
        dist_lib.check_world(cfg)


@pytest.mark.parametrize("world", [2, 3])
def test_gather_objects_and_means_across_processes(tmp_path, world):
    workers.spawn(workers.gather_worker, world, tmp_path, str(tmp_path))
    want = [{"rank": r, "i": i} for r in range(world) for i in range(r + 1)]
    for rank in range(world):
        res = torch.load(tmp_path / f"rank{rank}.pt")
        assert res["gather"] == want
        assert (res["index"], res["count"], res["world"]) == (rank, world, world)
        assert float(res["means"][0]) == sum(range(world)) / world
        assert torch.equal(res["means"][1],
                           torch.full((2, 3), sum(r * r for r in range(world)) / world))
        assert f"TPU.MESH_DATA={world + 1}" in res["refused"] and f"has {world}" in res["refused"]


def test_a_process_group_of_one_trains_as_no_group(tmp_path):
    """Two steps through `train_net` at world size 1 (gloo, joined through
    --dist-init 127.0.0.1:<port>, so the step runs under DDP) against the
    same two steps without a process group: metrics.json and the final
    checkpoint bit-equal."""
    root = str(tmp_path / "data")
    write_loop_dataset(root)
    plain = train_net.main(_argv(root, tmp_path / "plain", 2))
    argv = _argv(root, tmp_path / "ddp", 2, "--dist-init", f"127.0.0.1:{dist_lib.free_port()}",
                 "--num-processes", "1", "--process-id", "0")
    workers.run_alone(workers.train_net_worker, argv)
    assert plain.iterations == [0, 1]
    want, got = _metrics(tmp_path / "plain"), _metrics(tmp_path / "ddp")
    assert [r["iteration"] for r in got] == [0, 1]
    for w, g in zip(want, got):
        assert {k: v for k, v in w.items() if not k.startswith("time/")} == {
            k: v for k, v in g.items() if not k.startswith("time/")}
    a, _ = tckpt.load_checkpoint(str(tmp_path / "plain" / "model_final.ckpt"))
    b, _ = tckpt.load_checkpoint(str(tmp_path / "ddp" / "model_final.ckpt"))
    assert list(a["model"]) == list(b["model"])   # no "module." prefix
    for k, v in a["model"].items():
        assert torch.equal(b["model"][k], v), k
    for i, s in a["optimizer"]["state"].items():
        assert torch.equal(b["optimizer"]["state"][i]["momentum_buffer"], s["momentum_buffer"])
    assert not os.path.exists(tmp_path / "ddp" / "tb")


def test_profile_ddp_trains_two_gloo_ranks_in_step(tmp_path):
    """`tools.profile_ddp` on the CPU at world size 2 (narrow widths): the
    ranks train on their own batches and end with bit-equal parameters; the
    result names its world size, times and gradient bytes."""
    from omni3d_tpu_torch.tools import profile_ddp
    out = tmp_path / "ddp.json"
    summary = profile_ddp.main([
        "--device", "cpu", "--world", "2", "--bs", "1", "--img", "256", "--warmup", "1",
        "--steps", "1", "--profiled", "1", "--dtype", "float32", "--out", str(out),
        *[x for k, v in OPTS.items() if k.startswith("MODEL.") for x in (k, v)],
        "TPU.COMPUTE_DTYPE", "float32"])
    (run,) = summary["runs"]
    assert run["world"] == 2 and run["params_bit_equal_across_ranks"] and run["skipped"] == 0
    assert len(run["ms"]) == 1 and run["img_per_s"] > 0 and run["grad_mb_per_step"] > 0
    assert len(run["ms_per_step_by_rank"]) == len(run["all_reduce_ms_by_rank"]) == 2
    assert run["all_reduce_ms"] > 0 and run["all_reduce_bus_gb_per_s"] > 0
    with open(out) as f:
        assert json.load(f) == summary
