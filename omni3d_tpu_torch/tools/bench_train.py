"""Training-step throughput on a CUDA card (the port's counterpart of the
JAX package's tools/bench_train.py).

    python -m omni3d_tpu_torch.tools.bench_train [--bs 8] [--dtype bfloat16]
        [--rounds 5] [--iters 10] [--out FILE] [--device cpu]

The full step (forward, every loss, backward, the stabilizer's check, SGD)
of configs/cubercnn_DLA34_FPN.yaml at full width and 512 px, from
`tools.synthetic.synthetic_trainer`: seeded random weights and the batch that
mirrors the JAX bench's (`tools/bench_train.py:34-57`), bf16 at bs 8 by
default as there. After 2 warm-up steps and one step under the FLOP counter,
--rounds rounds of --iters steps on the host clock ended by one synchronise,
then one profiled round. It reports the median / min / max ms per step and
img/s, `total_loss` at every step (all finite, or it raises), the model
FLOPs per step (the convolutions and linear layers, forward and backward:
`utils.benchtime.model_flops`) and `mfu`, the peak memory, and the ROIAlign
kernels' launches per step (1 forward + 1 backward) and the NMS kernels'
(1 + 1, the RPN's). Its last line is
`bench.py`'s JSON keys (`metric`, `value` in img/s, `unit`) with the card and
its power limit; --out writes the full record with the git commit.
"""
from __future__ import annotations

import argparse
import json
import math
import os

import torch

from ..models import rcnn3d
from ..utils import benchtime as bt
from . import bench

WARMUP = 2


def run(cfg, bs: int = 8, dtype=torch.bfloat16, rounds: int = 5, iters: int = 10,
        device="cuda", image: int = bench.IMG):
    """Time `synthetic_trainer`'s step (module docstring); prints a summary
    line last. Returns the record; its `first_step_losses` are the first
    warm-up step's logs."""
    from .synthetic import synthetic_trainer
    device = bt.cuda_device(device)
    model, _, step, batch = synthetic_trainer(cfg, dtype, bs, device, img=image)
    gen = torch.Generator().manual_seed(0)
    totals = []

    def one_step():
        logs = step(batch, gen)
        totals.append(logs["total_loss"])
        return logs

    bench.reset_peak_mem(device)
    first = {k: float(v.detach() if torch.is_tensor(v) else v) for k, v in one_step().items()}
    bt.timed_calls(one_step, WARMUP - 1)
    counts, _ = bt.model_flops(model, one_step)
    before = rcnn3d.kernel_launch_counts()
    t = bt.in_turns({"step": lambda: bt.timed_calls(one_step, iters)}, rounds)["step"]
    after = rcnn3d.kernel_launch_counts()
    profile = bt.device_profile(one_step, iters, device)
    losses = [float(v) for v in totals]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"a training step's total_loss is not finite: {losses}")
    if step.state["skipped"]:
        raise RuntimeError(f"the stabilizer skipped {step.state['skipped']} steps")
    per_step = bench.launches_per_call(before, after, rounds * iters)
    name = str(dtype).replace("torch.", "")
    record = {
        "dtype": name, "bs": bs, "image": image, "rounds": rounds, "iters": iters,
        "device": str(device), **bt.card_fields(device),
        "ms_per_step": t, "img_per_s": bs * 1e3 / t["median_ms"],
        "img_per_s_range": [bs * 1e3 / t["max_ms"], bs * 1e3 / t["min_ms"]],
        "model_gflop_per_step": counts.model / 1e9,
        "model_gflop_forward": counts.forward / 1e9,
        "model_gflop_backward": counts.backward / 1e9,
        "all_gflop_per_step": counts.all / 1e9,
        "mfu": bt.mfu(counts.model, t["median_ms"], dtype, device),
        "peak_mem_gib": bench.peak_mem_gib(device),
        "kernel_launches_per_step": {"forward": per_step["roi_align_fwd"],
                                     "backward": per_step["roi_align_bwd"]},
        "nms_launches_per_step": {k: per_step[k] for k in ("suppression_words", "greedy_keep")},
        "profile": profile, "device_busy_share": bt.busy_share(profile, t["median_ms"]),
        "total_loss": losses, "first_step_losses": first,
    }
    print(f"# train step bs={bs} {name}: {t['median_ms']:.2f} ms/step "
          f"({t['min_ms']:.2f}-{t['max_ms']:.2f}), {record['img_per_s']:.1f} img/s; "
          f"{record['model_gflop_per_step']:.0f} GFLOP/step, mfu {bt.fmt(record['mfu'])}; "
          f"busy {bt.fmt(record['device_busy_share'])}; "
          f"peak {bt.fmt(record['peak_mem_gib'])} GiB; last loss {losses[-1]:.3f}", flush=True)
    record["summary"] = bench.summary_line(
        f"DLA34-FPN {image}px training throughput (bs={bs}, {name}, 1 GPU)",
        record["img_per_s"], record)
    print(json.dumps(record["summary"]), flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    record = run(bench.config(), args.bs, getattr(torch, args.dtype), args.rounds, args.iters,
                 args.device)
    record["config"] = os.path.relpath(bench.CONFIG, bench.ROOT)
    if args.out:
        bench.write_record(args.out, record)


if __name__ == "__main__":
    main()
