"""Device time of the multilevel ROIAlign kernels, on a CUDA card.

    python -m omni3d_tpu_torch.tools.profile_roi_align [--calls 20] [--out FILE]

The inputs are chip_smoke.py's, made from its seeds: a 512 px pyramid with
C = 256, and its box sets. Three groups of cases:
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
another checkout's kernels on the same inputs: put that checkout first on
PYTHONPATH and run this file as a script. It prints one JSON object as its
last line and writes it to --out.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_ms(fn, calls: int) -> tuple[float, float]:
    """(device ms of the ROIAlign kernels per call, their launches per call)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and "roi_align" in e.name]
    return sum(spans) / 1e3 / calls, len(spans) / calls


def main(argv=None):
    from omni3d_tpu_torch.ops import roi_align_cuda as rac
    from omni3d_tpu_torch.ops.roi_align import route_levels

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_roi_align needs a CUDA device")
    cs = _chip_smoke()
    device = torch.device("cuda", 0)
    img, strides, C = cs.IMG, cs.STRIDES, cs.CHANNELS
    rows = []

    gen = torch.Generator().manual_seed(0)   # chip_smoke phase 2's inputs
    feats32 = [torch.randn(2, img // s, img // s, C, generator=gen).to(device) for s in strides]
    for n in cs.POOLER_BOXES:
        boxes = cs.make_boxes(n, gen, device)
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
        for n in cs.POOLER_BOXES:
            boxes = torch.cat([cs.make_boxes(n, gen, device) for _ in range((bs + 1) // 2)])[:bs]
            levels = route_levels(boxes, strides, 2, "canonical")
            for dtype in (torch.float32, torch.bfloat16):
                feats = [f.to(dtype) for f in feats32]
                ms, launches = device_ms(
                    lambda: rac._forward_kernel(feats, boxes, levels, strides, 7, 0), args.calls)
                rows.append(dict(kernel="forward", B=bs, N=n, routing="canonical",
                                 dtype=str(dtype)[6:], S=0, device_ms=ms,
                                 launches_per_call=launches))

    bs, n = 32, cs.TRAIN_ROIS                # chip_smoke phase 4's training batch
    gen = torch.Generator().manual_seed(2)
    feats = [torch.randn(bs, img // s, img // s, C, generator=gen).to(device, torch.bfloat16)
             for s in strides]
    shapes = [tuple(f.shape[1:3]) for f in feats]
    boxes = torch.cat([cs.make_boxes(n, gen, device) for _ in range(bs // 2)], 0)
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
    res = {"card": cs.card_line(), "package": os.path.dirname(os.path.dirname(rac.__file__)),
           "calls": args.calls, "cases": rows}
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
