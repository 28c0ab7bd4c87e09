"""Multi-process runs of the port for tests/test_torch_parallel.py and
tests/test_torch_ddp.py, on the CPU.

`spawn` starts `world` processes with the spawn method; each joins a gloo
process group through a file store under the test's temporary directory
(so parallel test workers never race for a port), runs one of the worker
functions below and leaves the group. This module imports only torch and
the port: a spawned child imports it, and never the JAX package.
"""
from __future__ import annotations

import os
import time
import warnings

import torch

from omni3d_tpu_torch.config import get_default_cfg
from omni3d_tpu_torch.parallel import dist as dist_lib

TIMEOUT_S = 300


def spawn(fn, world: int, tmp_path, *args, timeout: float = TIMEOUT_S) -> None:
    """Run fn(rank, world, *args) in `world` spawned processes of one gloo
    process group; raises unless every one exits with 0 within `timeout`
    seconds (a stuck rank is killed)."""
    store = "file://" + os.path.join(str(tmp_path), f"store-{time.monotonic_ns()}")
    dist_lib.run_spawned(_entry, [(fn, rank, world, store, args) for rank in range(world)],
                         timeout)


def run_alone(fn, *args, timeout: float = TIMEOUT_S) -> None:
    """Run fn(*args) in one spawned process outside any process group."""
    dist_lib.run_spawned(_alone, [(fn, args)], timeout)


def _entry(fn, rank, world, init, args):
    torch.set_num_threads(2)
    dist_lib.init_distributed(init, world, rank, "cpu")
    try:
        fn(rank, world, *args)
    finally:
        torch.distributed.destroy_process_group()


def _alone(fn, args):
    torch.set_num_threads(2)
    fn(*args)


def cfg_from_opts(opts: list):
    """The port's default config with `KEY VALUE` overrides (strings)."""
    cfg = get_default_cfg()
    cfg.merge_from_list(list(opts))
    return cfg


def no_tensorboard():
    from omni3d_tpu_torch.utils import events
    events._make_tb_writer = lambda output_dir: None


# ------------------------------ workers ------------------------------

def gather_worker(rank, world, out_dir):
    """gather_objects of a rank-dependent list, mean_across_ranks of two
    tensors, the rank and world size, and check_world."""
    got = dist_lib.gather_objects([{"rank": rank, "i": i} for i in range(rank + 1)])
    means = dist_lib.mean_across_ranks([torch.tensor(float(rank)),
                                        torch.full((2, 3), float(rank * rank))])
    cfg = get_default_cfg()
    cfg.TPU.MESH_DATA = world + 1
    try:
        dist_lib.check_world(cfg)
        refused = None
    except ValueError as e:
        refused = str(e)
    cfg.TPU.MESH_DATA = world
    torch.save({"gather": got, "means": means, "index": dist_lib.process_index(),
                "count": dist_lib.process_count(), "refused": refused,
                "world": dist_lib.check_world(cfg)}, os.path.join(out_dir, f"rank{rank}.pt"))


def train_net_worker(argv):
    """`tools.train_net.main(argv)` without TensorBoard."""
    from omni3d_tpu_torch.tools import train_net
    no_tensorboard()
    train_net.main(argv)


def _trainer(opts, state_dict):
    from omni3d_tpu_torch.engine.train import make_train_step
    from omni3d_tpu_torch.models.rcnn3d import build_model
    from omni3d_tpu_torch.solver.build import build_lr_schedule, build_optimizer
    cfg = cfg_from_opts(opts)
    model = build_model(cfg, device="cpu", seed=0, train=True)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    opt = build_optimizer(cfg, model)
    sched = build_lr_schedule(cfg, opt)
    return model, opt, sched, make_train_step(cfg, model, opt, sched)


def _snapshot(model, opt, step, logs):
    return {"logs": {k: float(v) for k, v in logs.items()},
            "model": {k: v.clone() for k, v in model.state_dict().items()},
            "optimizer": {i: {k: v.clone() for k, v in s.items()}
                          for i, s in opt.state_dict()["state"].items()},
            "skipped": step.state["skipped"], "step": step.state["step"]}


def step_worker(rank, world, out_dir, opts, state_dict, batch, noises, start_step):
    """One train step on this rank's slice of the global `batch` with the
    injected sampling noise noises[rank], from update `start_step` of the
    LR schedule; beside its snapshot, the names of the stages the step
    entered, in order."""
    from omni3d_tpu_torch.utils import trace
    model, opt, sched, step = _trainer(opts, state_dict)
    with warnings.catch_warnings():   # the schedule advanced without updates
        warnings.simplefilter("ignore", UserWarning)
        for _ in range(start_step):
            sched.step()
    step.state["step"] = start_step
    b = batch["images"].shape[0] // world
    entered, real = [], trace.stage
    trace.stage = lambda name, device: entered.append(name) or real(name, device)
    try:
        logs = step({k: v[rank * b:(rank + 1) * b] for k, v in batch.items()},
                    noise=noises[rank])
    finally:
        trace.stage = real
    torch.save(dict(_snapshot(model, opt, step, logs), stages=entered),
               os.path.join(out_dir, f"rank{rank}.pt"))


def nan_worker(rank, world, out_dir, opts, batch):
    """A finite step, then a step whose image is NaN on the last rank only."""
    model, opt, sched, step = _trainer(opts, None)
    b = batch["images"].shape[0] // world
    local = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
    first = step(local, torch.Generator().manual_seed(0))
    before = _snapshot(model, opt, step, first)
    if rank == world - 1:
        local = dict(local, images=local["images"].clone())
        local["images"][0, 0, 0, 0] = float("nan")
    after = _snapshot(model, opt, step, step(local, torch.Generator().manual_seed(1)))
    torch.save({"before": before, "after": after}, os.path.join(out_dir, f"rank{rank}.pt"))


def train_worker(rank, world, out_dir, opts, records, priors, state_dict, noises, runs):
    """`engine.loop.do_train` on this rank's loader of `records` from
    `state_dict`, with the sampling noise noises[step][rank] injected;
    `runs` is a list of (max_steps, resume). Rank 0 writes metrics.json and
    the checkpoints; each rank saves its final state dict."""
    from omni3d_tpu_torch.engine import loop, train
    no_tensorboard()
    loop.step_generator = lambda seed, step: step
    train.sampling_noise = (lambda step, B, n_anchors, n_candidates, device, img_offset=0:
                            noises[step][img_offset // B])
    for max_steps, resume in runs:
        ok, run = loop.do_train(cfg_from_opts(opts), out_dir, resume=resume, max_steps=max_steps,
                                records=records, priors=priors, seed=3, device="cpu",
                                init_variables_fn=lambda m: m.load_state_dict(state_dict,
                                                                             strict=True))
        assert ok and run.iterations == list(range(run.start_iter, max_steps))
    torch.save({k: v.clone() for k, v in run.model.state_dict().items()},
               os.path.join(out_dir, f"rank{rank}.pt"))
