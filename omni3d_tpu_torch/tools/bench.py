"""DLA34-FPN Cube R-CNN 512 px inference throughput on a CUDA card (the
port's counterpart of the repo's root `bench.py`).

    python -m omni3d_tpu_torch.tools.bench [--rounds 5] [--iters 30] [--out FILE] [--device cpu]

Model: configs/cubercnn_DLA34_FPN.yaml at full width (50 classes, FPN 256,
FC 1024) in its TPU.COMPUTE_DTYPE (bfloat16), seeded random weights with the
6D pose bias at the identity, as chip_smoke.py phase 3 builds it.

Inputs: `bench.py`'s. One `np.random.default_rng(0)` draws
`integers(0, 255, (bs, 512, 512, 3), int32)` for bs 1, 8 and 32 in that
order; `rcnn3d.preprocess` normalises them; Ks = [[500, 0, 256], [0, 500,
256], [0, 0, 1]]; ratios 1.

Settings: `**inference_kwargs(cfg)`, the configs' settings (adaptive
sampling, TPU.ROI_SAMPLING_RATIO 0). This departs from `bench.py`, which
calls `inference_impl` with its defaults (sampling_ratio=2).

Timing (`utils.benchtime`): the timed call is `rcnn3d.inference_step`, the
counterpart of `bench.py`'s compiled calls: one CUDA graph per batch size,
replayed. Eager `rcnn3d.inference` is timed beside it, in turns. Per batch
size the first `inference_step` call is timed apart (its eager warm-up, where
cuDNN picks its algorithms, and the capture), then 2 warm-up calls of each;
then --rounds rounds of --iters back-to-back calls of each call and batch
size, all in turns, on the host clock ended by one synchronise. Per batch
size and call (the eager figures under `eager_` names) it reports the
median / min / max ms per batch and img/s, one profiled round (device busy
ms per call and its share of the median ms; kernels per call; the
hand-written kernels' launches per call from the kernel records, which a
replay makes without running their wrappers), the wrappers' own launches
per call (0 for a replay), `mfu`; then the model FLOPs per image, the
first call's captures and wrapper launches (`graph`: its eager warm-up and
its capture each launch what an eager call does), the peak memory, and
the mean valid proposals and detections per image (random weights set the
NMS depth and the detection count, so the work done is shown). The
record's `graphs` holds the run's captures and replays
(`rcnn3d.inference_step`'s counters), the model's recaptures and the
graphs' pool bytes.

Output: one line per batch size, then as the last line `bench.py`'s JSON
keys `metric`, `value` (the best graphed img/s) and `unit`, with the card
and its power limit. `bench.py`'s `vs_baseline` is not carried: it divides by an
A100 estimate that was never measured. --out writes the full record with
the git commit. Runs on the card unless --device cpu (no device numbers
there: those fields are null).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from ..models import rcnn3d
from ..utils import benchtime as bt

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "configs", "cubercnn_DLA34_FPN.yaml")
BATCH_SIZES = (1, 8, 32)
IMG = 512
WARMUP = 2


def config(path: str = CONFIG):
    from ..config import get_default_cfg
    cfg = get_default_cfg()
    cfg.merge_from_file(path)
    return cfg


def inputs(cfg, batch_sizes, image: int, device):
    """{bs: (raw int32 draw, preprocessed images, Ks, ratios)}, drawn as
    `bench.py` draws them, batch size after batch size from one seed."""
    rng = np.random.default_rng(0)
    K = torch.tensor([[500.0, 0, image / 2], [0, 500.0, image / 2], [0, 0, 1]], device=device)
    out = {}
    for bs in batch_sizes:
        raw = rng.integers(0, 255, (bs, image, image, 3), dtype=np.int32)
        images = rcnn3d.preprocess(torch.from_numpy(raw).to(device), cfg.MODEL.PIXEL_MEAN,
                                   cfg.MODEL.PIXEL_STD)
        out[bs] = (raw, images, K.expand(bs, 3, 3).contiguous(), torch.ones(bs, device=device))
    return out


def random_model(cfg, device):
    """The bench's model: seeded random weights, pose bias at the identity."""
    from .synthetic import condition_pose_bias_
    model = rcnn3d.build_model(cfg, device=device, seed=0)
    condition_pose_bias_(model)
    return model


def git_commit():
    """The checkout's commit, or None outside a git checkout."""
    got = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=ROOT,
                         capture_output=True, text=True)
    return got.stdout.strip() or None


def launches_per_call(before: dict, after: dict, n: int) -> dict:
    """The wrappers' launches per call between two
    `rcnn3d.kernel_launch_counts()`."""
    return {k: (after[k] - before[k]) / n for k in after}


class Counted:
    """`fn` timed by `benchtime.timed_calls(fn, iters)`, adding up the
    kernels' wrapper launches and the calls it made."""

    def __init__(self, fn, iters: int):
        self.fn, self.iters, self.calls = fn, iters, 0
        self.launches = dict.fromkeys(rcnn3d.kernel_launch_counts(), 0)

    def __call__(self) -> float:
        before = rcnn3d.kernel_launch_counts()
        ms = bt.timed_calls(self.fn, self.iters)
        for k, n in rcnn3d.kernel_launch_counts().items():
            self.launches[k] += n - before[k]
        self.calls += self.iters
        return ms

    def per_call(self) -> dict:
        return {k: n / self.calls for k, n in self.launches.items()}


def peak_mem_gib(device):
    return torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda" else None


def reset_peak_mem(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def summary_line(metric: str, value: float, record: dict) -> dict:
    return {"metric": metric, "value": value, "unit": "images/sec/chip",
            "card": record["card"], "power_limit": record["power_limit"]}


def write_record(path: str, record: dict):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dict(record, git_commit=git_commit()), f, indent=1)


def run(cfg, batch_sizes=BATCH_SIZES, image: int = IMG, rounds: int = 5, iters: int = 30,
        device="cuda", model=None):
    """Time `rcnn3d.inference_step` (graphed) and `rcnn3d.inference`
    (eager) at each batch size (module docstring); prints one line per batch
    size and the summary line last. Returns (record, {bs: ((raw, images, Ks,
    ratios), outputs of the last graphed call)}). `model` defaults to
    `random_model(cfg, device)`."""
    device = bt.cuda_device(device)
    model = random_model(cfg, device) if model is None else model
    kw = rcnn3d.inference_kwargs(cfg)
    data = inputs(cfg, batch_sizes, image, device)
    graphed = {bs: (lambda d=d: rcnn3d.inference_step(model, d[1], d[2], d[3], **kw))
               for bs, d in data.items()}
    eager = {bs: (lambda d=d: rcnn3d.inference(model, d[1], d[2], d[3], **kw))
             for bs, d in data.items()}
    rows, graph = {}, {}
    graph_counts = graph_counters()
    for bs in batch_sizes:
        reset_peak_mem(device)
        before, captures = rcnn3d.kernel_launch_counts(), rcnn3d.inference_step.captures
        first = bt.timed_calls(graphed[bs], 1)     # eager warm-up + capture
        graph[bs] = None if device.type != "cuda" else {
            "captures": rcnn3d.inference_step.captures - captures,
            "wrapper_launches": launches_per_call(before, rcnn3d.kernel_launch_counts(), 1)}
        bt.timed_calls(graphed[bs], WARMUP)
        bt.timed_calls(eager[bs], WARMUP)
        rows[bs] = {"bs": bs, "first_call_ms": first, "peak_mem_gib": peak_mem_gib(device)}
    timed = {}
    for bs in batch_sizes:
        timed[("graphed", bs)] = Counted(graphed[bs], iters)
        timed[("eager", bs)] = Counted(eager[bs], iters)
    times = bt.in_turns(timed, rounds)
    last = {}
    for bs in batch_sizes:
        row = rows[bs]
        counts, out = bt.model_flops(model, eager[bs])   # a replay runs no Python to count
        for mode, fn in (("graphed", graphed[bs]), ("eager", eager[bs])):
            t = times[(mode, bs)]
            profile = bt.device_profile(fn, iters, device)
            prefix = "" if mode == "graphed" else "eager_"
            row.update({
                prefix + "ms_per_batch": t, prefix + "img_per_s": bs * 1e3 / t["median_ms"],
                prefix + "img_per_s_range": [bs * 1e3 / t["max_ms"], bs * 1e3 / t["min_ms"]],
                prefix + "profile": profile,
                prefix + "device_busy_share": bt.busy_share(profile, t["median_ms"]),
                prefix + "mfu": bt.mfu(counts.model, t["median_ms"], model.dtype, device),
                prefix + "wrapper_launches_per_call": timed[(mode, bs)].per_call()})
        row.update(
            model_gflop_per_image=counts.model / bs / 1e9,
            all_gflop_per_image=counts.all / bs / 1e9,
            proposals_per_image=float(out["proposal_valid"].sum()) / bs,
            detections_per_image=float(out["valid"].sum()) / bs, graph=graph[bs])
        last[bs] = (data[bs], graphed[bs]())
    best = max(batch_sizes, key=lambda bs: rows[bs]["img_per_s"])
    dtype = str(model.dtype).replace("torch.", "")
    graphs = model.inference_graphs
    record = {"dtype": dtype, "image": image, "rounds": rounds, "iters": iters,
              "device": str(device), **bt.card_fields(device), "inference_kwargs": kw,
              "graphs": None if graphs is None else {
                  **{k: n - graph_counts[k] for k, n in graph_counters().items()},
                  "recaptures": graphs.recaptures, "pool_bytes": graphs.pool_bytes()},
              "batch_sizes": [rows[bs] for bs in batch_sizes]}
    for bs in batch_sizes:
        r = rows[bs]
        print(f"# bs={bs}: graphed {_line(r, '')}; eager {_line(r, 'eager_')}; first call "
              f"{r['first_call_ms']:.1f} ms; {r['model_gflop_per_image']:.1f} GFLOP/img; "
              f"{r['proposals_per_image']:.0f} proposals, {r['detections_per_image']:.1f} "
              f"detections per image", flush=True)
    record["summary"] = summary_line(
        f"DLA34-FPN {image}px inference throughput (bs={best}, {dtype}, 1 GPU, CUDA graph)",
        rows[best]["img_per_s"], record)
    print(json.dumps(record["summary"]), flush=True)
    return record, last


def graph_counters() -> dict:
    """This process's `rcnn3d.inference_step` captures and replays."""
    return {"captures": rcnn3d.inference_step.captures,
            "replays": rcnn3d.inference_step.replays}


def _line(r, prefix):
    t, p = r[prefix + "ms_per_batch"], r[prefix + "profile"]
    busy = ("busy not measured" if r[prefix + "device_busy_share"] is None
            else f"{100 * r[prefix + 'device_busy_share']:.0f}% busy, "
                 f"{p['kernels_per_call']:.0f} kernels/call")
    return (f"{t['median_ms']:.2f} ms/batch ({t['min_ms']:.2f}-{t['max_ms']:.2f}), "
            f"{r[prefix + 'img_per_s']:.1f} img/s, {busy}, mfu {bt.fmt(r[prefix + 'mfu'])}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    record, _ = run(config(), rounds=args.rounds, iters=args.iters, device=args.device)
    record["config"] = os.path.relpath(CONFIG, ROOT)
    if args.out:
        write_record(args.out, record)


if __name__ == "__main__":
    main()
