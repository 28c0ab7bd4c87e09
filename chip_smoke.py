#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases (each raises on failure):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the multilevel ROIAlign kernel from omni3d_tpu_torch/csrc;
  3. the kernel vs its plain PyTorch version at the main path's shapes
     (512 px pyramid, C = 256, B = 2, N = 1000 and 100 boxes), both
     routings, sampling_ratio 0 and 2, float32 and bfloat16, with times;
  4. full-width DLA34-FPN Cube R-CNN inference at 512 px
     (configs/cubercnn_DLA34_FPN.yaml, seeded random weights) at batch 1
     and 8, float32 with TF32 off and bfloat16: exactly two kernel launches
     per call, output contract and sanity checks, ms per batch; then one
     float32 call with the plain pooler, compared with the kernel's.
The line before the last is the kernel summary as JSON; the last line is
{"ok": true, "device": {...}}.
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
IMG = 512                        # network input, px
STRIDES = (4, 8, 16, 32, 64)
CHANNELS = 256                   # FPN width of the config
POOLER_BOXES = (1000, 100)       # per image: box pooler (RPN POST_NMS_TOPK), cube pooler (topk)
BATCHES = ((1, 20), (8, 10))     # (batch size, timed calls) of the main path
PLAIN_BS = 8                     # batch of the f32 call with the plain pooler
# f32: the kernel and the plain version sum the same terms in another order
F32_ATOL = 1e-5
# bf16: both accumulate in f32 and round once; compared in f32, the outputs
# may differ by one bf16 ULP where the f32 sums straddle a rounding boundary
BF16_MAX_MISMATCH = 1e-3   # share of elements allowed to differ at all


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=3):
    """Median device time of fn() over `iters` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_boxes(n, gen, device):
    """(2, n, 4) boxes: edge cases (outside the image, degenerate, touching
    the border, elongated past the SMAX clamp, one box for each of the five
    levels) and random boxes of log-uniform size."""
    import torch
    edge = torch.tensor([
        [-40, -30, -4, -6], [100, 100, 100, 140], [200, 220, 230, 220],
        [IMG - 9, IMG - 7, IMG, IMG], [0, 0, IMG, IMG],
        [0, 200, IMG, 208],                # 512 x 8 px -> p2, 128 cells: g = 19 > 9
        [300, 0, 306, IMG],                # 6 x 512 px
        [10, 10, 60, 60], [10, 10, 120, 120], [10, 10, 250, 250],
        [-100, -100, 500, 500], [-500, -400, 900, 1000],   # p5, p6
    ], dtype=torch.float32)
    m = n - edge.shape[0]
    size = torch.exp(torch.empty(2, m, 2).uniform_(2.0, 6.0, generator=gen))
    xy = torch.rand(2, m, 2, generator=gen) * (IMG - size)
    rand = torch.cat([xy, xy + size], -1)
    return torch.cat([edge.expand(2, -1, -1), rand], 1).to(device)


def kernel_vs_plain(device):
    import torch
    from omni3d_tpu_torch.ops.roi_align import multilevel_roi_align_plain, route_levels
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align

    gen = torch.Generator().manual_seed(0)
    feats32 = [torch.randn(2, IMG // s, IMG // s, CHANNELS, generator=gen).to(device)
               for s in STRIDES]
    main_case, worst = None, 0.0
    for n in POOLER_BOXES:
        boxes = make_boxes(n, gen, device)
        for routing in ("canonical", "fit"):
            levels = route_levels(boxes, STRIDES, 2, routing)
            if routing == "canonical" and n == POOLER_BOXES[0]:
                hist = torch.bincount(levels.flatten(), minlength=5).tolist()
                print(f"  N={n} canonical boxes per level p2..p6: {hist}")
                assert min(hist) > 0, hist
            for dtype in (torch.float32, torch.bfloat16):
                feats = [f.to(dtype) for f in feats32]
                for S in (0, 2):
                    got = multilevel_roi_align(feats, boxes, STRIDES, 7, S, routing=routing)
                    want = multilevel_roi_align_plain(feats, boxes, levels, STRIDES, 7, S)
                    torch.cuda.synchronize()
                    diff = (got.float() - want.float()).abs()
                    err = float(diff.max())
                    if dtype == torch.float32:
                        tol, frac = F32_ATOL, 0.0
                        ok = err <= tol
                    else:
                        tol = 2.0 ** (float(torch.log2(want.float().abs().max()).floor()) - 7)
                        frac = float((diff > 0).float().mean())
                        ok = err <= tol and frac <= BF16_MAX_MISMATCH
                    ms = cuda_ms(lambda: multilevel_roi_align(feats, boxes, STRIDES, 7, S,
                                                              routing=routing))
                    plain_ms = cuda_ms(lambda: multilevel_roi_align_plain(
                        feats, boxes, route_levels(boxes, STRIDES, 2, routing), STRIDES, 7, S))
                    name = str(dtype).replace("torch.", "")
                    row = dict(N=n, routing=routing, dtype=name, S=S, max_abs_err=err,
                               tol=tol, mismatch=frac, ms=ms, plain_ms=plain_ms)
                    print(f"  N={n:4d} {routing:9s} {name:8s} S={S}  max|k-p|={err:.3e} "
                          f"(tol {tol:.1e}, differing {frac:.1e})  kernel {ms:.3f} ms  "
                          f"plain {plain_ms:.3f} ms")
                    if not ok:
                        raise AssertionError(f"kernel disagrees with plain: {row}")
                    worst = max(worst, err)
                    if (n, routing, dtype, S) == (POOLER_BOXES[0], "canonical", torch.bfloat16, 0):
                        main_case = row
    return main_case, worst


def check_outputs(out, bs, topk, C):
    import torch
    shapes = {"boxes": (4,), "boxes_orig": (4,), "scores_2d": (), "scores": (),
              "classes": (), "valid": (), "scores_full": (C,), "center_cam": (3,),
              "dims": (3,), "pose": (3, 3), "corners": (8, 3), "center_2D": (2,)}
    for k, tail in shapes.items():
        assert tuple(out[k].shape) == (bs, topk) + tail, (k, tuple(out[k].shape))
        assert bool(torch.isfinite(out[k].float()).all()), k
    assert tuple(out["proposal_boxes"].shape)[:1] == (bs,)
    pose = out["pose"]
    eye = torch.eye(3, device=pose.device).expand_as(pose)
    assert float((pose @ pose.transpose(-1, -2) - eye).abs().max()) < 1e-4
    assert bool((out["scores"] <= out["scores_2d"].sqrt() + 1e-6).all())
    assert bool(out["valid"].any()), "no detection passed the score threshold"


def main_path(device):
    import torch
    import numpy as np
    from omni3d_tpu_torch.config import get_default_cfg
    from omni3d_tpu_torch.models import rcnn3d
    from omni3d_tpu_torch.ops.roi_align import multilevel_roi_align_plain, route_levels
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align

    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "cubercnn_DLA34_FPN.yaml"))
    kw = rcnn3d.inference_kwargs(cfg)
    C = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    print(f"  config cubercnn_DLA34_FPN.yaml: {C} classes, FPN {cfg.MODEL.FPN.OUT_CHANNELS}, "
          f"FC {cfg.MODEL.ROI_BOX_HEAD.FC_DIM}; inference_kwargs {kw}")

    def inputs(bs):
        raw = np.random.default_rng(0).integers(0, 255, (bs, IMG, IMG, 3), dtype=np.uint8)
        images = rcnn3d.preprocess(torch.from_numpy(raw).to(device),
                                   cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
        K = torch.tensor([[512.0, 0, IMG / 2], [0, 512.0, IMG / 2], [0, 0, 1]], device=device)
        return images, K.expand(bs, 3, 3).contiguous(), torch.ones(bs, device=device)

    timings, models = [], {}
    multilevel_roi_align.launches = 0          # counts of the main path's run only
    for dtype in (torch.float32, torch.bfloat16):
        model = rcnn3d.build_model(cfg, device=device, dtype=dtype, seed=0)
        models[dtype] = model
        for bs, iters in BATCHES:
            images, Ks, ratio = inputs(bs)
            for _ in range(2):                  # warm-up (cuDNN plans, allocator)
                rcnn3d.inference(model, images, Ks, ratio, **kw)
            torch.cuda.synchronize()
            ms = []
            for _ in range(iters):
                before = multilevel_roi_align.launches
                t0 = time.perf_counter()
                out = rcnn3d.inference(model, images, Ks, ratio, **kw)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                assert multilevel_roi_align.launches - before == 2, \
                    multilevel_roi_align.launches - before
            check_outputs(out, bs, kw["topk"], C)
            med = statistics.median(ms)
            name = str(dtype).replace("torch.", "")
            timings.append(dict(dtype=name, bs=bs, ms_per_batch=med, img_per_s=bs * 1e3 / med,
                                valid=int(out["valid"].sum()),
                                proposals=int(out["proposal_valid"].sum())))
            print(f"  {name:8s} bs={bs}: {med:.2f} ms/batch (median of {iters}), "
                  f"{bs * 1e3 / med:.1f} img/s; {int(out['valid'].sum())} detections, "
                  f"{int(out['proposal_valid'].sum())} valid proposals")
    launches = multilevel_roi_align.launches
    print(f"  kernel launches in the main path's run: {launches}")
    assert launches == 2 * 2 * sum(2 + iters for _, iters in BATCHES), launches

    # the same f32 call with the plain pooler on the card
    def recorded(pool):
        seen = []

        def spy(*args, **kwargs):
            out = pool(*args, **kwargs)
            seen.append(out)
            return out
        return spy, seen

    def plain_pool(features, boxes, strides, out_size, sampling_ratio, min_level=2,
                   routing="canonical"):
        return multilevel_roi_align_plain(features, boxes,
                                          route_levels(boxes, strides, min_level, routing),
                                          strides, out_size, sampling_ratio)

    images, Ks, ratio = inputs(PLAIN_BS)
    outs = {}
    for label, pool in (("kernel", multilevel_roi_align), ("plain", plain_pool)):
        spy, seen = recorded(pool)
        rcnn3d.multilevel_roi_align = spy
        try:
            outs[label] = (rcnn3d.inference(models[torch.float32], images, Ks, ratio, **kw), seen)
        finally:
            rcnn3d.multilevel_roi_align = multilevel_roi_align
    (ko, kseen), (po, pseen) = outs["kernel"], outs["plain"]
    pooled_err = float((kseen[0] - pseen[0]).abs().max())
    print(f"  f32 bs={PLAIN_BS} box-pooler features, kernel vs plain pooler: max|diff| {pooled_err:.3e}")
    assert pooled_err <= F32_ATOL, pooled_err
    same = bool(torch.equal(ko["valid"], po["valid"]) and torch.equal(ko["classes"], po["classes"]))
    if same:
        errs = {k: float((ko[k].float() - po[k].float()).abs().max())
                for k in ("boxes", "scores", "center_cam", "dims", "pose")}
        print(f"  final outputs, kernel vs plain pooler (valid masks agree): {errs}")
        assert errs["scores"] <= 1e-4 and errs["boxes"] <= 1e-2, errs
    else:
        n = int((ko["valid"] != po["valid"]).sum() + (ko["classes"] != po["classes"]).sum())
        print(f"  final outputs: valid/classes differ in {n} detections (f32 ties flip)")
    return timings, launches


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(ROOT, "omni3d_tpu_torch")):
        raise SystemExit("chip_smoke.py runs from a checkout of the repo (omni3d_tpu_torch/ missing)")
    sys.path.insert(0, ROOT)
    # f32 comparisons need full f32: cuDNN convolutions default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; TF32 off (cuDNN and matmul)")

    from omni3d_tpu_torch.ops import roi_align_cuda
    print("[1/3] build")
    path, secs, log = roi_align_cuda.build()
    print(f"  {os.path.relpath(path, ROOT)} built in {secs:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    print("[2/3] kernel vs plain PyTorch version")
    main_case, worst = kernel_vs_plain(device)

    print("[3/3] main path: DLA34-FPN inference at 512 px")
    timings, launches = main_path(device)

    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "omni3d_tpu")]
    assert not bad, bad
    print("inference: " + json.dumps(timings))
    print(card)
    print(json.dumps({"kernels": [{
        "name": "multilevel_roi_align_fwd", "route": "cuda",
        "source": "omni3d_tpu_torch/csrc/roi_align_fwd.cu",
        "replaces": "omni3d_tpu/ops/roi_align_pallas.py:658",
        "also_replaces": "omni3d_tpu/ops/roi_align_pallas.py:469",
        "launches": launches, "max_abs_err": worst,
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "timed_case": f"N={POOLER_BOXES[0]} per image x B=2, canonical, bfloat16, "
                      "sampling_ratio 0",
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
