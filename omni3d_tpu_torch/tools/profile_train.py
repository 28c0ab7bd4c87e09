"""Where the time of a training step goes, on a CUDA card.

    python -m omni3d_tpu_torch.tools.profile_train --dtype bfloat16 --bs 32
    python -m omni3d_tpu_torch.tools.profile_train --dtype float32 --bs 8
    python -m omni3d_tpu_torch.tools.profile_train --config-file configs/cubercnn_ResNet34_FPN.yaml

The full-width model of --config-file (configs/cubercnn_DLA34_FPN.yaml by
default) at 512 px on synthetic batches, seeded random weights, float32 runs with TF32 off. After
two warm-up steps it reports:
  * wall ms per step (host clock ending in a synchronise), median of --steps;
  * stages: each stage of `compute_losses` (the engine's functions and the
    model's modules, through forward hooks), the whole forward, the
    optimizer step (through its step hooks) and the backward (the step less
    the forward and the optimizer step: also the gradient checks and the
    skip decision), timed on the host clock with a synchronise on both
    sides (this serialises them, so their sum exceeds the wall time of a
    step);
  * from `torch.profiler` over --steps steps: device busy ms per step (the
    union of kernel intervals), kernels launched per step, and the kernels
    with the most device time, the ROIAlign kernels among them.
It prints one JSON object as its last line and writes it to --out.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    from ..config import get_default_cfg
    from ..engine import train as train_mod
    from ..utils.benchtime import device_profile
    from .synthetic import synthetic_trainer

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--bs", type=int, default=32)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--config-file", default=os.path.join(ROOT, "configs",
                                                           "cubercnn_DLA34_FPN.yaml"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)

    cfg = get_default_cfg()
    cfg.merge_from_file(args.config_file)
    model, opt, step, batch = synthetic_trainer(cfg, getattr(torch, args.dtype), args.bs,
                                                device)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        step(batch, gen)
    torch.cuda.synchronize()

    wall = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    # stages: synchronised host clock around each stage
    stages: dict[str, list[float]] = {}
    starts: dict[str, float] = {}

    def begin(name):
        torch.cuda.synchronize()
        starts[name] = time.perf_counter()

    def end(name):
        torch.cuda.synchronize()
        stages.setdefault(name, []).append((time.perf_counter() - starts[name]) * 1e3)

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            begin(name)
            out = fn(*a, **k)
            end(name)
            return out
        return wrapper

    patched = {n: getattr(train_mod, n) for n in (
        "compute_losses", "label_and_sample_anchors", "rpn_losses", "select_proposals",
        "label_and_sample_proposals", "multilevel_roi_align", "fast_rcnn_losses",
        "decode_cube", "cube_losses")}
    names = {"compute_losses": "forward, all losses"}
    hooks = []
    for name, mod in {"features (trunk + FPN)": model.backbone,
                      "RPN head": model.proposal_generator["rpn_head"],
                      "box head": model.roi_heads.box_head,
                      "cube head": model.roi_heads.cube_head}.items():
        hooks.append(mod.register_forward_pre_hook(lambda *_, n=name: begin(n)))
        hooks.append(mod.register_forward_hook(lambda *_, n=name: end(n)))
    hooks.append(opt.register_step_pre_hook(lambda *_: begin("optimizer step")))
    hooks.append(opt.register_step_post_hook(lambda *_: end("optimizer step")))
    for n, fn in patched.items():
        setattr(train_mod, n, timed(names.get(n, n), fn))
    timed_step = timed("step", step)
    try:
        for _ in range(args.steps):
            timed_step(batch, gen)
    finally:
        for n, fn in patched.items():
            setattr(train_mod, n, fn)
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    if len(stages["optimizer step"]) != args.steps:
        raise SystemExit(f"the stabilizer skipped a timed step: {step.state}")
    stages["backward (step - forward - optimizer)"] = [
        s - f - o for s, f, o in zip(stages.pop("step"), stages["forward, all losses"],
                                     stages["optimizer step"])]

    prof = device_profile(lambda: step(batch, gen), args.steps, torch.device("cuda"), top=15)
    busy = prof["device_busy_ms_per_call"]

    card = torch.cuda.get_device_name(0)
    res = {
        "card": card, "config": os.path.basename(args.config_file), "dtype": args.dtype, "bs": args.bs, "steps": args.steps,
        "wall_ms_per_step": statistics.median(wall), "wall_ms": wall,
        "img_per_s": args.bs * 1e3 / statistics.median(wall),
        "stages_ms": {k: statistics.median(v) for k, v in stages.items()},
        "device_busy_ms_per_step": busy,
        "device_busy_share": busy / statistics.median(wall),
        "kernels_per_step": prof["kernels_per_call"],
        "roi_align_kernels_ms_per_step": prof["roi_align_ms_per_call"],
        "top_kernels_ms_per_step": prof["top_kernels_ms_per_call"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    for k, v in res["stages_ms"].items():
        print(f"  {k:28s} {v:8.2f} ms")
    print(f"  wall {res['wall_ms_per_step']:.1f} ms/step, device busy {busy:.1f} ms "
          f"({100 * res['device_busy_share']:.0f}%), {res['kernels_per_step']:.0f} kernels/step")
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
