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
CPU). Each iteration's logs stay on the device; every LOG_PERIOD iterations
they come to the host in one copy, go to metrics.json (the latest values)
and the log line (medians over the last 20 iterations), and the
stabilizer's exploded-iteration budget is checked; when it is spent the
attempt fails and `train_with_retries` restarts from `model_recent`. Every
TEST.EVAL_PERIOD iterations `eval_fn` evaluates the training model in eval
mode, and its modes come back unchanged. Every VIS_PERIOD iterations rank 0
runs the training model in eval mode on the batch's first image and writes
GT-vs-prediction panels (`visualize_training`) under <output_dir>/vis/.
The inference graphs that either captures on the card are dropped when it
returns, so the training step never runs beside their memory pool.

Under a process group (one process per GPU, `parallel.init_distributed`)
each rank loads IMS_PER_BATCH / world images per step and the step runs
data-parallel (`engine.train.make_train_step`); rank 0 alone writes the
checkpoints (of the unwrapped model, so checkpoints of one and of N
processes are interchangeable), metrics.json, the log line and the profile.

Evaluation (port of the JAX package's `run_inference_dataset` and
`do_test`; the reference's do_test, tools/train_net.py:56-114): inference
over each DATASETS.TEST split on the model's device, TPU.EVAL_BATCH_SIZE
images per batch, then the Omni3D AP2D / AP3D tables with IoU3D on the same
device, files under <OUTPUT_DIR>/inference/iter_<N>/, and every 50th image
of a split that is on disk drawn with its confident detections
(<dataset>/vis/). Under a process group
each rank runs inference on its shard of each split, every rank gathers
all predictions and evaluates them, and rank 0 writes the files and prints.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..data import datasets as data_lib
from ..data.build import build_detection_test_loader, build_detection_train_loader
from ..data.mapper import batch_to_device
from ..evaluation.error_stats import (compute_error_stats, error_log_string,
                                     visualize_from_predictions)
from ..evaluation.omni3d_eval import Omni3DEvaluationHelper, instances_to_predictions
from ..models.rcnn3d import build_model, inference_kwargs, inference_step
from ..parallel import dist as dist_lib
from ..solver.build import build_lr_schedule, build_optimizer
from ..utils import checkpoint as ckpt
from ..utils import trace
from ..utils.benchtime import device_busy_ms, kernel_events
from ..utils.events import EventStorage
from ..utils.priors import load_priors_
from ..vis.logperf import print_per_category_table
from ..vis.vis import visualize_training_sample
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


class _StepProfile:
    """torch.profiler over PROFILE_STEPS: writes <dir>/trace.json (chrome
    trace: the port's spans, `utils.trace`, beside the kernels) and
    <dir>/summary.json: the device's name, the steps, the trace's window
    per step (first to last event on the profiler's clock), device-busy ms
    per step and the busy share over that window, kernels per step, and
    from the same events each span's host ms (`span_host_ms`) and each
    stage's device ms (`stage_device_ms`: the busy time between its marker
    kernels), each with its calls, per call and per step. The profiler's
    host cost (~5000 ops a step) widens the window, so the busy share is a
    lower bound."""

    def __init__(self, profile_dir: str, device: torch.device, n_done: int):
        self.n0 = n_done          # iterations done before the trace starts
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(device)
        self.dir, self.device = profile_dir, device
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def stop(self, n_done: int) -> dict:
        steps = n_done - self.n0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(self.dir, "trace.json"))
        card = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else None
        summary = step_profile_summary(self.prof.events(), steps, card)
        with open(os.path.join(self.dir, "summary.json"), "w") as f:
            json.dump(summary, f)
        print(f"[train] profile of {steps} steps -> {self.dir}: {json.dumps(summary)}")
        return summary


def step_profile_summary(events, steps: int, card: str | None) -> dict:
    """`_StepProfile`'s summary of a trace's events over `steps` steps on
    the card named `card` (None: the CPU, no busy share)."""
    times = [(e.time_range.start, e.time_range.end) for e in events]
    window = (max(t for _, t in times) - min(s for s, _ in times)) / 1e3 if times else 0.0
    kernels = kernel_events(events)
    busy = device_busy_ms(kernels)
    host = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(trace.PREFIX):
            host.setdefault(e.name[len(trace.PREFIX):], []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    device = trace.stage_device_ms((e.name, e.time_range.start, e.time_range.end)
                                   for e in kernel_events(events, markers=True))

    def per(ms: dict) -> dict:
        return {k: {"calls": len(v), "ms_per_call": sum(v) / len(v), "ms_per_step": sum(v) / steps}
                for k, v in ms.items()}

    return {
        "device": card or "cpu",
        "steps": steps, "window_ms_per_step": window / steps,
        "device_busy_ms_per_step": busy / steps,
        "device_busy_share": busy / window if card and window else None,
        "kernels_per_step": len(kernels) / steps,
        "span_host_ms": per(host), "stage_device_ms": per(device),
    }


def thing_classes(cfg) -> list:
    """The model's category names, or their indices where no metadata is
    registered."""
    try:
        return data_lib.metadata("omni3d_model")["thing_classes"]
    except KeyError:
        return [str(i) for i in range(cfg.MODEL.ROI_HEADS.NUM_CLASSES)]


def build_eval_model(cfg, device="cuda", seed: int | None = None):
    """The eval-mode inference model of `cfg` on `device` (TPU.COMPUTE_DTYPE;
    seeded random weights with `seed`, else load a state dict), as the JAX
    package's `build_eval_model`."""
    return build_model(cfg, device=device, seed=seed, train=False)


def visualize_training(cfg, model, batch, storage) -> dict:
    """GT-vs-prediction panels of the first image of the device `batch`
    (reference meta_arch/rcnn3d.py:70-72,114-245): an eval-mode
    `inference_step` of the training model (its modes come back unchanged;
    on the card a graph per padded shape that casts the float32 master
    weights per call and so sees every optimizer step), then
    `vis.visualize_training_sample`; written as `gt_vs_pred_2d` and
    `gt_vs_pred_3d` through `storage.put_image`. Returns the panels."""
    with eval_mode(model):
        out = inference_step(model, batch["images"][0:1], batch["Ks"][0:1],
                             batch["ratios"][0:1], hw=batch["hw"][0:1], **inference_kwargs(cfg))
    det = {k: v[0] for k, v in _to_host(out).items()}
    det["boxes"] = out["boxes"][0].float().cpu().numpy()
    host = {k: v[0:1].detach().float().cpu().numpy() for k, v in batch.items()
            if torch.is_tensor(v)}
    panels = visualize_training_sample(host, det, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD,
                                       thing_classes(cfg))
    storage.put_image("gt_vs_pred_2d", panels["2d"])
    storage.put_image("gt_vs_pred_3d", panels["3d"])
    return panels


# the outputs of `inference_step` that become predictions
_PREDICTION_KEYS = ("boxes_orig", "classes", "scores", "valid", "center_cam", "dims", "pose",
                    "corners", "center_2D")


def _to_host(out: dict) -> dict:
    """One batch's prediction outputs as float32 numpy arrays, through one
    synchronising copy (class indices and the valid mask are exact in
    float32, which the JAX package also converts them to)."""
    B, K = out["valid"].shape
    parts = [out[k].float().reshape(B, K, -1) for k in _PREDICTION_KEYS]
    host = torch.cat(parts, -1).cpu().numpy()
    res, i = {}, 0
    for k, p in zip(_PREDICTION_KEYS, parts):
        res[k] = host[..., i:i + p.shape[-1]].reshape(tuple(out[k].shape))
        i += p.shape[-1]
    return res


def run_inference_dataset(cfg, model, dataset_name, id_map):
    """Inference over one test dataset on the model's device -> (predictions,
    timing) (reference inference_on_dataset, omni3d_evaluation.py:522-641).

    Batches of TPU.EVAL_BATCH_SIZE images from `build_detection_test_loader`
    go to the device as uint8, are normalised there and run through
    `models.rcnn3d.inference_step` (on the card one CUDA graph per padded
    shape, the test loader pads the tail batch to the full batch); the
    outputs come back in one copy per batch.
    Under a process group the loader takes this rank's shard (every
    world-th image), and every rank gets all predictions in rank order
    (`parallel.gather_objects`), numbered 1..n in that order.
    timing (this rank's): images, data_s (host time waiting for the
    loader), compute_s (to the copy's end) and per batch [H, W, images,
    data ms, compute ms].
    """
    device = next(model.parameters()).device
    loader, n_total = build_detection_test_loader(
        cfg, dataset_name, batch_size=cfg.TPU.EVAL_BATCH_SIZE,
        process_index=dist_lib.process_index(), process_count=dist_lib.process_count())
    contig_to_dataset = {v: k for k, v in id_map.items()}
    kw = inference_kwargs(cfg)
    predictions, batches = [], []
    next_id = 1
    t_data = t_compute = 0.0
    done = 0
    start = t_last_log = t0 = time.perf_counter()
    for host_batch, records in loader:
        t1 = time.perf_counter()
        batch = batch_to_device(host_batch, device, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
        out = _to_host(inference_step(model, batch["images"], batch["Ks"], batch["ratios"],
                                      hw=batch["hw"], **kw))
        t2 = time.perf_counter()
        t_data += t1 - t0
        t_compute += t2 - t1
        batches.append([*host_batch["images"].shape[1:3], len(records),
                        (t1 - t0) * 1e3, (t2 - t1) * 1e3])
        for b, rec in enumerate(records):
            det = {k: v[b] for k, v in out.items()}
            preds = instances_to_predictions(det, rec["image_id"], contig_to_dataset, next_id)
            next_id += len(preds)
            predictions.extend(preds)
        done += len(records)
        now = time.perf_counter()
        # progress + ETA every 5 s (reference inference_on_dataset,
        # omni3d_evaluation.py:596-631), per image since the loader batches
        if now - t_last_log > 5.0 and done < n_total:
            per_img = (now - start) / done
            eta = int(per_img * (n_total - done))
            print(f"[eval] {dataset_name}: {done}/{n_total} images  "
                  f"data {t_data / done:.4f} s/img  compute {t_compute / done:.4f} s/img  "
                  f"total {per_img:.4f} s/img  ETA {eta // 60}m{eta % 60:02d}s")
            t_last_log = now
        t0 = time.perf_counter()
    predictions = dist_lib.gather_objects(predictions)
    for i, p in enumerate(predictions):   # the ranks' id counters overlap after the gather
        p["id"] = i + 1
    return predictions, dict(images=done, data_s=t_data, compute_s=t_compute, batches=batches)


def do_test(cfg, model, output_dir=None, iteration="final", datasets_root=None):
    """Evaluate `model` (in eval mode) on every cfg.DATASETS.TEST dataset
    (reference do_test, tools/train_net.py:56-114); IoU3D runs on the
    model's device.

    Predictions and results land under <output_dir>/inference/iter_<N>/
    (<dataset>/instances_predictions.pkl and omni3d_results.json). After
    each dataset the per-instance error stats (xy/z/whl/ry vs the matched
    GT) are printed, and every 50th image drawn with its confident
    detections goes to <dataset>/vis/ (`visualize_from_predictions`; image
    paths relative to `datasets_root`, by default the directory the
    dataset's records were read from). Returns {dataset: AP dict with its
    "error_stats" and its "inference" timing, "summary": summarize_all()}.

    Under a process group every rank evaluates the gathered predictions
    (the same AP dicts on every rank); rank 0 alone writes the files, prints
    and computes the error stats (the JAX package's do_test).
    """
    main = dist_lib.process_index() == 0
    device = next(model.parameters()).device
    filter_settings = data_lib.get_filter_settings_from_cfg(cfg)
    id_map = data_lib.metadata("omni3d_model")["thing_dataset_id_to_contiguous_id"]
    inference_dir = (os.path.join(output_dir, "inference", f"iter_{iteration}")
                     if output_dir else None)
    helper = Omni3DEvaluationHelper(list(cfg.DATASETS.TEST), filter_settings, inference_dir,
                                    device=device)
    n_cats = max(len(id_map), 1)
    names = thing_classes(cfg)
    results = {}
    start = time.perf_counter()
    for name in cfg.DATASETS.TEST:
        preds, timing = run_inference_dataset(cfg, model, name, id_map)
        gt_api = data_lib.Omni3D([data_lib.metadata(name)["json_file"]], dict(filter_settings))
        helper.add_predictions(name, preds, gt_api)
        if main:
            path = helper.save_predictions(name)
            if path:
                print(f"[eval] saved predictions -> {path}")
        t0 = time.perf_counter()
        results[name] = helper.evaluate(name)
        timing.update(evaluate_s=time.perf_counter() - t0,
                      ap_ready_s=time.perf_counter() - start)
        if main:
            print(f"[eval] {name}: " + "  ".join(
                f"{k}={v:.2f}" for k, v in results[name].items() if k in ("AP2D", "AP3D")))
            # per-dataset 3D error stats (reference train_net.py:102-107 ->
            # vis.visualize_from_instances)
            anns = [dict(a) for a in gt_api.dataset.get("annotations", [])]
            for a in anns:  # raw Omni3D jsons carry the pose as R_cam
                a.setdefault("pose", a.get("R_cam"))
            Ks = {img["id"]: img["K"] for img in gt_api.dataset.get("images", []) if "K" in img}
            stats = compute_error_stats(preds, anns, score_thresh=float(np.sqrt(1.0 / n_cats)),
                                        Ks=Ks)
            print("[eval] " + error_log_string(name, stats, iteration))
            results[name]["error_stats"] = stats
            if inference_dir is not None:
                root = (datasets_root if datasets_root is not None
                        else data_lib.metadata(name).get("image_root", ""))
                n_vis = visualize_from_predictions(preds, gt_api,
                                                   os.path.join(inference_dir, name), names,
                                                   datasets_root=root)
                if n_vis:
                    print(f"[eval] wrote {n_vis} vis samples -> "
                          f"{os.path.join(inference_dir, name, 'vis')}")
        results[name]["inference"] = timing
    results["summary"] = helper.summarize_all()
    if inference_dir is not None and main:
        helper.save_results()
    if results["summary"] and main:
        print_per_category_table(results["summary"])
        print("[eval] " + "  ".join(f"{k}={v:.2f}" for k, v in results["summary"].items()
                                    if k.endswith(("AP2D", "AP3D"))))
    return results


@contextlib.contextmanager
def eval_mode(model):
    """`model` in eval mode inside the block; afterwards every module's
    training flag is set back as it was, so BN that `CubeRCNN.train` keeps
    in eval mode (MODEL.USE_BN=False) stays so."""
    modes = [(m, m.training) for m in model.modules()]
    model.eval()
    try:
        yield model
    finally:
        for m, mode in modes:
            m.training = mode


class LogWindow:
    """The logs of the iterations since the last log line. `add` keeps each
    iteration's tensors stacked into one vector on the device (no sync) and
    its host values (lr, finite) as they are; `flush` copies every kept
    vector to the host in one copy and returns one {name: float} per
    iteration, oldest first."""

    def __init__(self):
        self._rows = []

    def add(self, logs: dict) -> None:
        keys = [k for k, v in logs.items() if torch.is_tensor(v)]
        self._rows.append((keys, torch.stack([logs[k].detach().float() for k in keys]),
                           {k: float(v) for k, v in logs.items() if not torch.is_tensor(v)}))

    def flush(self) -> list:
        if not self._rows:
            return []
        values = torch.stack([vec for _, vec, _ in self._rows]).cpu().tolist()
        out = [dict(zip(keys, vals), **host) for (keys, _, host), vals in zip(self._rows, values)]
        self._rows.clear()
        return out


def do_train(cfg, output_dir: str, resume: bool = False, max_steps: int | None = None,
             records=None, priors=None, seed: int = 0,
             profile_dir: str | None = None, init_variables_fn=None, device="cuda",
             eval_fn=None):
    """One training attempt; returns (success, TrainRun).

    success=False signals the retry protocol to restart from the last
    checkpoint (reference do_train returning False, train_net.py:258-285).

    priors: `utils.priors.priors_to_params` arrays for the prior buffers.
    init_variables_fn: model -> None, loading initial weights in place when
      NOT resuming (MODEL.WEIGHTS_PRETRAIN, MODEL.WEIGHTS or ImageNet).
    eval_fn: (model, iteration) -> None, called after every TEST.EVAL_PERIOD
      iterations with the training model in eval mode (`eval_mode`).
    With VIS_PERIOD > 0, rank 0 writes `visualize_training`'s panels after
    every VIS_PERIOD-th iteration (not iteration 0); a failure there is
    printed and training goes on.
    Under a process group every rank calls this with its own device; the
    ranks load the same initial weights or checkpoint.
    """
    rank, world = dist_lib.process_index(), dist_lib.process_count()
    if cfg.SOLVER.IMS_PER_BATCH % world:
        raise ValueError(f"SOLVER.IMS_PER_BATCH={cfg.SOLVER.IMS_PER_BATCH} is not divisible "
                         f"by the {world} processes")
    main = rank == 0
    device = torch.device(device)
    model = build_model(cfg, device=device, seed=seed, train=True)
    if priors is not None:
        load_priors_(model, priors)
    optimizer = build_optimizer(cfg, model)
    scheduler = build_lr_schedule(cfg, optimizer)
    run = TrainRun(model, optimizer, scheduler, make_train_step(cfg, model, optimizer, scheduler),
                   start_iter=0)
    dist_lib.barrier()   # a restart never reads a checkpoint that rank 0 is still writing
    loaded = ckpt.resume_or_load(output_dir, map_location=device) if resume else None
    if loaded is not None:
        state, extra = loaded
        load_train_state(run, state)
        run.start_iter = int(extra.get("iteration", 0)) + 1
        if main:
            print(f"[train] resumed from {os.path.join(output_dir, 'model_recent.ckpt')} "
                  f"at iteration {run.start_iter}")
    elif init_variables_fn is not None:
        init_variables_fn(model)
    start_iter, step = run.start_iter, run.step

    loader = build_detection_train_loader(cfg, records=records, seed=seed,
                                          skip_batches=start_iter, process_index=rank,
                                          process_count=world)
    max_iter = max_steps or cfg.SOLVER.MAX_ITER
    period = cfg.SOLVER.CHECKPOINT_PERIOD
    checkpointer = ckpt.PeriodicCheckpointer(output_dir, period, max_iter)
    storage = EventStorage(output_dir if main else None, start_iter=start_iter)
    window = LogWindow()
    skipped0 = step.state["skipped"]
    profile = None
    try:
        for iteration in range(start_iter, max_iter):
            if profile_dir and main and iteration == start_iter + PROFILE_STEPS[0]:
                profile = _StepProfile(profile_dir, device, len(run.iterations))
            if profile is not None and iteration == start_iter + PROFILE_STEPS[1]:
                profile.stop(len(run.iterations))
                profile = None
            trace.set_call(iteration)
            t0 = time.perf_counter()
            with trace.span("train.data"):
                host_batch = next(loader)
            t1 = time.perf_counter()
            with trace.span("train.to_device"):
                batch = batch_to_device(host_batch, device, cfg.MODEL.PIXEL_MEAN,
                                        cfg.MODEL.PIXEL_STD)
            with trace.span("train.step"):
                window.add(step(batch, step_generator(seed, step.state["step"])))
            run.iterations.append(iteration)
            run.data_ms.append((t1 - t0) * 1e3)
            run.step_ms.append((time.perf_counter() - t1) * 1e3)
            run.shapes.append(tuple(host_batch["images"].shape[1:3]))

            last = iteration == max_iter - 1
            if iteration % LOG_PERIOD == 0 or last:
                with trace.span("train.logs"):
                    rows = window.flush()   # device sync
                    if main:
                        for row in rows:
                            for k, v in row.items():
                                storage.put_scalar(k, v)
                        storage.put_scalar("time/data_ms", run.data_ms[-1])
                        storage.put_scalar("time/step_ms", run.step_ms[-1])
                        print("[train] " + storage.log_line(max_iter, lr=rows[-1]["lr"]))
                        storage.write()

                # exploded-iteration budget -> restart from checkpoint
                # (reference train_net.py:253-285: cumulative per attempt, armed
                # after half a checkpoint period)
                exploded = step.state["skipped"] - skipped0
                done = iteration - start_iter + 1
                if done > period // 2 and exploded / done >= cfg.MODEL.STABILIZE > 0:
                    if main:
                        print(f"[train] unstable: {exploded}/{done} exploded "
                              f"iterations; restarting from checkpoint")
                    return False, run
            storage.step()
            if main and cfg.VIS_PERIOD > 0 and iteration > 0 and iteration % cfg.VIS_PERIOD == 0:
                try:
                    visualize_training(cfg, model, batch, storage)
                except Exception as e:  # vis must never kill a training run
                    print(f"[train] visualization failed: {e!r}")
                finally:
                    model.inference_graphs = None   # their pool would stay beside the step's
            if main:
                checkpointer.step(iteration, lambda: train_state(run), {"iteration": iteration})
            if (eval_fn is not None and cfg.TEST.EVAL_PERIOD > 0
                    and (iteration + 1) % cfg.TEST.EVAL_PERIOD == 0):
                try:
                    with eval_mode(model):
                        eval_fn(model, iteration)
                finally:
                    model.inference_graphs = None
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
        if dist_lib.process_index() == 0:
            print(f"[train] attempt {attempt + 1} failed; retrying")
    raise RuntimeError("Training diverged in all attempts")
