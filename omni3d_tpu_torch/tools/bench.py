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

Timing (`utils.benchtime`): per batch size the first call timed apart (cuDNN
picks its algorithms per shape), then 2 warm-up calls; then --rounds rounds
of --iters back-to-back calls per batch size, the batch sizes in turns, on
the host clock ended by one synchronise. Per batch size it reports the
median / min / max ms per batch and img/s, the first call's ms, one
profiled round (device busy ms per call, and its share of the median ms;
kernels per call; the ROIAlign kernels' launches per call), the ROIAlign
and NMS kernels' launches per call by their wrappers' counts, the model
FLOPs per image and `mfu`, the peak memory,
and the mean valid proposals and detections per image (random weights set
the NMS depth and the detection count, so the work done is shown).

Output: one line per batch size, then as the last line `bench.py`'s JSON
keys `metric`, `value` (the best img/s) and `unit`, with the card and its
power limit. `bench.py`'s `vs_baseline` is not carried: it divides by an
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


def launch_counts():
    """The kernels' launch counts: ROIAlign forward, backward, then the NMS
    words and greedy kernels."""
    from ..ops import nms_cuda
    from ..ops.roi_align_cuda import multilevel_roi_align
    return (multilevel_roi_align.launches, multilevel_roi_align.bwd_launches,
            nms_cuda.suppression_words.launches, nms_cuda.greedy_keep.launches)


def nms_launches(before, after, n: int) -> dict:
    """The NMS kernels' launches per call between two `launch_counts()`."""
    return {"suppression_words": (after[2] - before[2]) / n,
            "greedy_keep": (after[3] - before[3]) / n}


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
    """Time `rcnn3d.inference` at each batch size (module docstring); prints
    one line per batch size and the summary line last. Returns (record,
    {bs: ((raw, images, Ks, ratios), outputs of the last call)}). `model`
    defaults to `random_model(cfg, device)`."""
    device = bt.cuda_device(device)
    model = random_model(cfg, device) if model is None else model
    kw = rcnn3d.inference_kwargs(cfg)
    data = inputs(cfg, batch_sizes, image, device)
    calls = {bs: (lambda d=d: rcnn3d.inference(model, d[1], d[2], d[3], **kw))
             for bs, d in data.items()}
    rows = {}
    for bs in batch_sizes:
        reset_peak_mem(device)
        first = bt.timed_calls(calls[bs], 1)
        bt.timed_calls(calls[bs], WARMUP)
        rows[bs] = {"bs": bs, "first_call_ms": first, "peak_mem_gib": peak_mem_gib(device)}
    before = launch_counts()
    times = bt.in_turns({bs: (lambda f=calls[bs]: bt.timed_calls(f, iters))
                         for bs in batch_sizes}, rounds)
    after = launch_counts()
    n_calls = rounds * iters
    last = {}
    for bs in batch_sizes:
        row, t = rows[bs], times[bs]
        counts, out = bt.model_flops(model, calls[bs])
        profile = bt.device_profile(calls[bs], iters, device)
        row.update(
            ms_per_batch=t, img_per_s=bs * 1e3 / t["median_ms"],
            img_per_s_range=[bs * 1e3 / t["max_ms"], bs * 1e3 / t["min_ms"]],
            profile=profile, device_busy_share=bt.busy_share(profile, t["median_ms"]),
            model_gflop_per_image=counts.model / bs / 1e9,
            all_gflop_per_image=counts.all / bs / 1e9,
            mfu=bt.mfu(counts.model, t["median_ms"], model.dtype, device),
            proposals_per_image=float(out["proposal_valid"].sum()) / bs,
            detections_per_image=float(out["valid"].sum()) / bs)
        last[bs] = (data[bs], calls[bs]())
    kernel_launches = {"forward": (after[0] - before[0]) / (n_calls * len(batch_sizes)),
                       "backward": (after[1] - before[1]) / (n_calls * len(batch_sizes))}
    best = max(batch_sizes, key=lambda bs: rows[bs]["img_per_s"])
    dtype = str(model.dtype).replace("torch.", "")
    record = {"dtype": dtype, "image": image, "rounds": rounds, "iters": iters,
              "device": str(device), **bt.card_fields(device), "inference_kwargs": kw,
              "kernel_launches_per_call": kernel_launches,
              "nms_launches_per_call": nms_launches(before, after, n_calls * len(batch_sizes)),
              "batch_sizes": [rows[bs] for bs in batch_sizes]}
    for bs in batch_sizes:
        r = rows[bs]
        busy = ("not measured" if r["device_busy_share"] is None
                else f"{100 * r['device_busy_share']:.0f}% busy, "
                     f"{r['profile']['kernels_per_call']:.0f} kernels/call")
        print(f"# bs={bs}: {r['ms_per_batch']['median_ms']:.2f} ms/batch "
              f"({r['ms_per_batch']['min_ms']:.2f}-{r['ms_per_batch']['max_ms']:.2f}), "
              f"{r['img_per_s']:.1f} img/s; first call {r['first_call_ms']:.1f} ms; {busy}; "
              f"{r['model_gflop_per_image']:.1f} GFLOP/img, mfu {bt.fmt(r['mfu'])}; "
              f"{r['proposals_per_image']:.0f} proposals, {r['detections_per_image']:.1f} "
              f"detections per image", flush=True)
    record["summary"] = summary_line(
        f"DLA34-FPN {image}px inference throughput (bs={best}, {dtype}, 1 GPU)",
        rows[best]["img_per_s"], record)
    print(json.dumps(record["summary"]), flush=True)
    return record, last


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
