"""The training loop (port of `omni3d_tpu.engine.loop`: `do_train` and
`train_with_retries`; the reference's tools/train_net.py do_train:117-316 and
retry loop main:431-467).

One attempt builds the train-mode model on the device, writes the priors
into its buffers, resumes from `model_recent` or applies the initial
weights, and runs `engine.train.make_train_step` over the train loader's
batches: uint8 images go to the device and are normalised there
(`data.mapper.batch_to_device`). The step's sampling noise comes from a
generator seeded by (seed, step count), as the JAX package folds the step
into a fixed key, and the loader replays its draws up to the resumed
iteration, so a resumed run repeats an unbroken one (bit for bit on the
CPU). Every LOG_PERIOD iterations the logs come to the host, go to
metrics.json and the log line, and the stabilizer's exploded-iteration
budget is checked; when it is spent the attempt fails and
`train_with_retries` restarts from `model_recent`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import torch

from ..data.build import build_detection_train_loader
from ..data.mapper import batch_to_device
from ..models.rcnn3d import build_model
from ..solver.build import build_lr_schedule, build_optimizer
from ..utils import checkpoint as ckpt
from ..utils.events import EventStorage
from ..utils.priors import load_priors_
from .train import make_train_step

LOG_PERIOD = 20    # host<->device sync cadence of the logs (loss fetch + retry check)
MAX_TRAINING_ATTEMPTS = 10
PROFILE_STEPS = (10, 15)   # iterations after the start traced with --profile-dir


@dataclasses.dataclass
class TrainRun:
    """What one attempt leaves: the model, optimizer, LR schedule and train
    step (with `step.state`), and per iteration the host time blocked on
    the loader, the host time of the step (to its one synchronising read,
    the skip decision) and the padded batch shape."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: object
    step: object
    start_iter: int
    iterations: list = dataclasses.field(default_factory=list)
    data_ms: list = dataclasses.field(default_factory=list)
    step_ms: list = dataclasses.field(default_factory=list)
    shapes: list = dataclasses.field(default_factory=list)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's sampling noise, from (seed, step
    count) alone (the JAX package: fold_in(PRNGKey(seed + 100), step))."""
    return torch.Generator().manual_seed(((seed + 100) << 32) + step)


def train_state(run: TrainRun) -> dict:
    """The checkpointed state: model (priors included), optimizer, LR
    schedule and the train step's state."""
    return {"model": run.model.state_dict(), "optimizer": run.optimizer.state_dict(),
            "scheduler": run.scheduler.state_dict(), "step": dict(run.step.state)}


def load_train_state(run: TrainRun, state: dict) -> None:
    run.model.load_state_dict(state["model"])
    run.optimizer.load_state_dict(state["optimizer"])
    run.scheduler.load_state_dict(state["scheduler"])
    saved = state["step"]
    run.step.state["step"] = int(saved["step"])
    run.step.state["skipped"] = int(saved["skipped"])
    run.step.state["recent_loss"].copy_(saved["recent_loss"])


def device_busy_ms(events) -> float:
    """Union of [start, end) intervals of profiler events, ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3   # us -> ms


class _StepProfile:
    """torch.profiler over PROFILE_STEPS: writes <dir>/trace.json (chrome
    trace) and <dir>/summary.json (wall and device-busy ms per step, busy
    share, kernels per step, the device's name). The profiler's host cost
    (~5000 ops per step) lengthens the wall time it divides by, so the busy
    share it reports is a lower bound."""

    def __init__(self, profile_dir: str, device: torch.device, n_done: int):
        self.n0 = n_done          # iterations done before the trace starts
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(device)
        self.dir, self.device = profile_dir, device
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, n_done: int) -> dict:
        steps = n_done - self.n0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = (time.perf_counter() - self.t0) * 1e3
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(self.dir, "trace.json"))
        kernels = [e for e in self.prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.name
                   and not e.name.startswith(("Memcpy", "Memset"))]
        busy = device_busy_ms(kernels)
        summary = {
            "device": (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                       else "cpu"),
            "steps": steps, "wall_ms_per_step": wall / steps,
            "device_busy_ms_per_step": busy / steps,
            "device_busy_share": busy / wall if self.device.type == "cuda" else None,
            "kernels_per_step": len(kernels) / steps,
        }
        with open(os.path.join(self.dir, "summary.json"), "w") as f:
            json.dump(summary, f)
        print(f"[train] profile of {steps} steps -> {self.dir}: {json.dumps(summary)}")
        return summary


def do_train(cfg, output_dir: str, resume: bool = False, max_steps: int | None = None,
             records=None, priors=None, seed: int = 0,
             profile_dir: str | None = None, init_variables_fn=None, device="cuda"):
    """One training attempt; returns (success, TrainRun).

    success=False signals the retry protocol to restart from the last
    checkpoint (reference do_train returning False, train_net.py:258-285).

    priors: `utils.priors.priors_to_params` arrays for the prior buffers.
    init_variables_fn: model -> None, loading initial weights in place when
      NOT resuming (MODEL.WEIGHTS_PRETRAIN, MODEL.WEIGHTS or ImageNet).
    Evaluation during training (the JAX package's eval_fn) and the
    training visualisation wait for ROADMAP items 11 and 12: with
    TEST.EVAL_PERIOD or VIS_PERIOD set, one line says so.
    """
    device = torch.device(device)
    model = build_model(cfg, device=device, seed=seed, train=True)
    if priors is not None:
        load_priors_(model, priors)
    optimizer = build_optimizer(cfg, model)
    scheduler = build_lr_schedule(cfg, optimizer)
    run = TrainRun(model, optimizer, scheduler, make_train_step(cfg, model, optimizer, scheduler),
                   start_iter=0)
    loaded = ckpt.resume_or_load(output_dir, map_location=device) if resume else None
    if loaded is not None:
        state, extra = loaded
        load_train_state(run, state)
        run.start_iter = int(extra.get("iteration", 0)) + 1
        print(f"[train] resumed from {os.path.join(output_dir, 'model_recent.ckpt')} "
              f"at iteration {run.start_iter}")
    elif init_variables_fn is not None:
        init_variables_fn(model)
    start_iter, step = run.start_iter, run.step

    if cfg.VIS_PERIOD > 0:
        print(f"[train] VIS_PERIOD={cfg.VIS_PERIOD}: training visualisation waits for "
              "ROADMAP item 12; no images are written")
    if cfg.DATASETS.TEST and cfg.TEST.EVAL_PERIOD > 0:
        print(f"[train] TEST.EVAL_PERIOD={cfg.TEST.EVAL_PERIOD}: evaluation waits for "
              "ROADMAP item 11; none runs during training")

    loader = build_detection_train_loader(cfg, records=records, seed=seed,
                                          skip_batches=start_iter)
    max_iter = max_steps or cfg.SOLVER.MAX_ITER
    period = cfg.SOLVER.CHECKPOINT_PERIOD
    checkpointer = ckpt.PeriodicCheckpointer(output_dir, period, max_iter)
    storage = EventStorage(output_dir, start_iter=start_iter)
    skipped0 = step.state["skipped"]
    profile = None
    try:
        for iteration in range(start_iter, max_iter):
            if profile_dir and iteration == start_iter + PROFILE_STEPS[0]:
                profile = _StepProfile(profile_dir, device, len(run.iterations))
            if profile is not None and iteration == start_iter + PROFILE_STEPS[1]:
                profile.stop(len(run.iterations))
                profile = None
            t0 = time.perf_counter()
            host_batch = next(loader)
            t1 = time.perf_counter()
            batch = batch_to_device(host_batch, device, cfg.MODEL.PIXEL_MEAN,
                                    cfg.MODEL.PIXEL_STD)
            logs = step(batch, step_generator(seed, step.state["step"]))
            run.iterations.append(iteration)
            run.data_ms.append((t1 - t0) * 1e3)
            run.step_ms.append((time.perf_counter() - t1) * 1e3)
            run.shapes.append(tuple(host_batch["images"].shape[1:3]))

            last = iteration == max_iter - 1
            if iteration % LOG_PERIOD == 0 or last:
                host_logs = {k: float(v.detach() if torch.is_tensor(v) else v)   # device sync
                             for k, v in logs.items()}
                for k, v in host_logs.items():
                    storage.put_scalar(k, v)
                storage.put_scalar("time/data_ms", run.data_ms[-1])
                storage.put_scalar("time/step_ms", run.step_ms[-1])
                print("[train] " + storage.log_line(max_iter, lr=host_logs["lr"]))
                storage.write()

                # exploded-iteration budget -> restart from checkpoint
                # (reference train_net.py:253-285: cumulative per attempt, armed
                # after half a checkpoint period)
                exploded = step.state["skipped"] - skipped0
                done = iteration - start_iter + 1
                if done > period // 2 and exploded / done >= cfg.MODEL.STABILIZE > 0:
                    print(f"[train] unstable: {exploded}/{done} exploded "
                          f"iterations; restarting from checkpoint")
                    return False, run
            storage.step()
            checkpointer.step(iteration, lambda: train_state(run), {"iteration": iteration})
    finally:
        if profile is not None:
            profile.stop(len(run.iterations))
        storage.close()
        loader.close()
    return True, run


def train_with_retries(cfg, output_dir, **kwargs):
    """Retry-on-divergence wrapper (reference main:431-467): a failed
    attempt restarts from `model_recent`."""
    resume = kwargs.pop("resume", False)
    for attempt in range(MAX_TRAINING_ATTEMPTS):
        ok, run = do_train(cfg, output_dir, resume=(attempt > 0) or resume, **kwargs)
        if ok:
            return run
        print(f"[train] attempt {attempt + 1} failed; retrying")
    raise RuntimeError("Training diverged in all attempts")
