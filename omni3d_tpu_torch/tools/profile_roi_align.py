"""Device time of the multilevel ROIAlign kernels, on a CUDA card.

    python -m omni3d_tpu_torch.tools.profile_roi_align [--calls 20] [--out FILE]

The inputs are chip_smoke.py's, made from its seeds: a 512 px pyramid with
C = 256, and its box sets (`utils.benchtime.make_boxes`). Three groups of cases:
  * the forward kernel at chip_smoke phase 2's shapes: B = 2 with N = 1000
    and 100 boxes, both routings, sampling_ratio 0 and 2, float32 and
    bfloat16;
  * the forward kernel at the inference main path's batches: B = 1 and 8
    with N = 1000 (box pooler) and 100 (cube pooler) boxes per image,
    canonical routing, adaptive sampling, float32 and bfloat16;
  * both kernels at the bf16 training batch: B = 32, N = 640, canonical
    routing, adaptive sampling.
Each case makes 3 warm-up calls of the kernel's wrapper. Then it reports the
mean device time of the ROIAlign kernels per call over --calls calls, from
torch.profiler's kernel intervals. The host time between launches, which
dominates the wrapper's CUDA-event time at the inference shapes, is left
out. The script imports the kernels as `omni3d_tpu_torch`, so it can time
another checkout's kernels on the same inputs: put that checkout (one
that has `utils/benchtime.py`) first on PYTHONPATH and run this file as a
script. It prints one JSON object as its
last line and writes it to --out.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from omni3d_tpu_torch.models.rcnn3d import FEATURE_STRIDES
from omni3d_tpu_torch.utils.benchtime import card, device_profile, make_boxes

IMG, CHANNELS = 512, 256          # chip_smoke's pyramid: 512 px, C = 256
POOLER_BOXES = (1000, 100)        # per image: box pooler, cube pooler
TRAIN_ROIS = 512 + 128            # per image at the training batch


def device_ms(fn, calls: int) -> tuple[float, float]:
    """(device ms of the ROIAlign kernels per call, their launches per call)."""
    for _ in range(3):
        fn()
    prof = device_profile(fn, calls, torch.device("cuda"))
    return (sum(prof["roi_align_ms_per_call"].values()),
            sum(prof["roi_align_launches_per_call"].values()))


def main(argv=None):
    from omni3d_tpu_torch.ops import roi_align_cuda as rac
    from omni3d_tpu_torch.ops.roi_align import route_levels

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_roi_align needs a CUDA device")
    device = torch.device("cuda", 0)
    img, strides, C = IMG, FEATURE_STRIDES, CHANNELS
    rows = []

    gen = torch.Generator().manual_seed(0)   # chip_smoke phase 2's inputs
    feats32 = [torch.randn(2, img // s, img // s, C, generator=gen).to(device) for s in strides]
    for n in POOLER_BOXES:
        boxes = make_boxes(n, gen, device, img)
        for routing in ("canonical", "fit"):
            levels = route_levels(boxes, strides, 2, routing)
            for dtype in (torch.float32, torch.bfloat16):
                feats = [f.to(dtype) for f in feats32]
                for S in (0, 2):
                    ms, launches = device_ms(
                        lambda: rac._forward_kernel(feats, boxes, levels, strides, 7, S),
                        args.calls)
                    rows.append(dict(kernel="forward", B=2, N=n, routing=routing,
                                     dtype=str(dtype)[6:], S=S, device_ms=ms,
                                     launches_per_call=launches))

    gen = torch.Generator().manual_seed(3)   # the inference main path's batches
    for bs in (1, 8):
        feats32 = [torch.randn(bs, img // s, img // s, C, generator=gen).to(device)
                   for s in strides]
        for n in POOLER_BOXES:
            boxes = torch.cat([make_boxes(n, gen, device, img) for _ in range((bs + 1) // 2)])[:bs]
            levels = route_levels(boxes, strides, 2, "canonical")
            for dtype in (torch.float32, torch.bfloat16):
                feats = [f.to(dtype) for f in feats32]
                ms, launches = device_ms(
                    lambda: rac._forward_kernel(feats, boxes, levels, strides, 7, 0), args.calls)
                rows.append(dict(kernel="forward", B=bs, N=n, routing="canonical",
                                 dtype=str(dtype)[6:], S=0, device_ms=ms,
                                 launches_per_call=launches))

    bs, n = 32, TRAIN_ROIS                # chip_smoke phase 4's training batch
    gen = torch.Generator().manual_seed(2)
    feats = [torch.randn(bs, img // s, img // s, C, generator=gen).to(device, torch.bfloat16)
             for s in strides]
    shapes = [tuple(f.shape[1:3]) for f in feats]
    boxes = torch.cat([make_boxes(n, gen, device, img) for _ in range(bs // 2)], 0)
    levels = route_levels(boxes, strides, 2, "canonical")
    g = torch.randn((bs, n, 7, 7, C), generator=gen).to(device, torch.bfloat16)
    for kernel, fn in (
            ("forward", lambda: rac._forward_kernel(feats, boxes, levels, strides, 7, 0)),
            ("backward", lambda: rac._backward_kernel(g, boxes, levels, shapes, strides, 7, 0,
                                                      torch.bfloat16))):
        ms, launches = device_ms(fn, args.calls)
        rows.append(dict(kernel=kernel, B=bs, N=n, routing="canonical", dtype="bfloat16", S=0,
                         device_ms=ms, launches_per_call=launches))

    for r in rows:
        print(f"  {r['kernel']:8s} B={r['B']:2d} N={r['N']:4d} {r['routing']:9s} "
              f"{r['dtype']:8s} S={r['S']}  {r['device_ms']:.4f} ms  "
              f"({r['launches_per_call']:.0f} launch per call)")
    res = {"card": card(), "package": os.path.dirname(os.path.dirname(rac.__file__)),
           "calls": args.calls, "cases": rows}
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
