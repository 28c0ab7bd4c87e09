#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on an NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases (each raises on failure):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     build both multilevel ROIAlign kernels (forward and backward) from
     omni3d_tpu_torch/csrc, one nvcc per source started together;
  2. the forward kernel vs its plain PyTorch version at the inference
     path's shapes (512 px pyramid, C = 256, B = 2, N = 1000 and 100 boxes),
     both routings, sampling_ratio 0 and 2, float32 and bfloat16, with times;
  3. inference main path: full-width DLA34-FPN Cube R-CNN inference at
     512 px (configs/cubercnn_DLA34_FPN.yaml, seeded random weights) at
     batch 1 and 8, float32 with TF32 off and bfloat16, the 6D pose bias at
     the identity (`condition_pose_bias_`, as the training path does at
     random weights): exactly two forward and no backward launches per
     call, output contract and sanity checks, ms per batch; then one float32
     call with the plain pooler (pooled features within phase 2's tolerance
     times max(1, largest pooled magnitude), scores within 1e-4, boxes
     within 1e-2 px);
  4. the backward kernel vs the plain backward at the training path's
     shapes (B = 2, N = 640 per image), both routings, sampling_ratio 0 and
     2, float32 and bfloat16, the transpose identity, with times (the
     kernel as its wrapper: torch.empty outputs, launch); both kernels held
     against their plain versions and timed at the bf16 training batch
     (B = 32, N = 640), and two backward calls there held bit-equal;
  5. training main path: full-width DLA34-FPN training steps at 512 px on
     synthetic batches (float32 TF32 off at batch 8, bfloat16 at batch 32):
     exactly one forward and one backward launch per step, finite losses,
     parameters and BN statistics moving, ms/step, img/s, peak memory; a
     NaN batch the stabilizer skips; one float32 step with the plain pooler
     (forward and backward) against the kernels' step;
  6. the training entry point: a synthetic Omni3D-format dataset written
     from a seed (48 PPM images at SUN RGB-D's 530 x 730, 16 PNG images at
     KITTI's 375 x 1242, the 50 categories, 1-20 objects each), then
     `tools.train_net` on configs/cubercnn_DLA34_FPN.yaml at full width in
     bfloat16 (the 25 training scales, 8 shape buckets, batch 8, 4 loader
     workers, a checkpoint every 8 iterations) for 24 iterations and again
     with --resume to 32: finite losses, the checkpoint files and
     metrics.json, the resume at iteration 24, the priors buffers equal to
     compute_priors of the dataset, one forward and one backward launch per
     step, one batch normalised on the card bit-equal to the numpy collate;
     the distinct shapes, ms/step (the first step at each shape apart), ms
     blocked on the loader, img/s, the device busy share (torch.profiler,
     steps 10-14) and the peak memory;
  7. evaluation: two synthetic test splits written from a seed (32 PPM
     images at SUN RGB-D's 530 x 730, 8 PNG images at KITTI's 375 x 1242),
     then `tools.train_net --eval-only` with phase 6's model_final.ckpt at
     TPU.EVAL_BATCH_SIZE 1 and 8 (bfloat16, full width): the result files,
     every AP value a percentage or the protocol's -1 / NaN, two forward
     and no backward launches per inference batch; the forward kernel's
     output at each distinct (padded pyramid, box count) of each run held
     against the plain pooler on the same recorded inputs; a GT echo through
     `Omni3DEvaluationHelper` with IoU3D on the card at AP2D = AP3D = 100 on
     both splits; the card's IoU3D within 1e-5 of the CPU's on the
     evaluation bench's (detection, GT) pairs; `tools.bench_eval` (2D and 3D
     evaluate + accumulate s/img, IoU3D ms, matcher us); ms per image by
     split and batch size (data and compute apart, the first batch at each
     padded shape apart), the padded shapes and the peak memory;
  8. data parallelism: (a) `tools.train_net` in a child process over NCCL at
     world size 1 (--dist-init 127.0.0.1:<port>) on phase 6's dataset, bf16
     batch 8, 8 iterations: finite losses, one forward and one backward
     launch per step, model_final.ckpt loading into build_model; one f32
     step from the same weights, batch and noise with and without DDP
     (losses rel 1e-4, gradients 1e-3 of each tensor's largest); bf16 batch 8
     ms/step without, with and again without DDP, the NCCL device ms per
     step (torch.profiler) and the gradient MB all-reduced per step; (b) two
     ranks sharing the card over gloo, one f32 step each on half of a seeded
     global batch of 8, against a hand-computed DDP step (the halves'
     gradients averaged, one optimizer step): parameters within 1e-3 of the
     largest update per tensor and bit-equal across the ranks, BN statistics
     the mean of the halves', losses rel 1e-4; each rank's first pooler call
     held against the plain forward and backward (the backward on the
     recorded gradient scaled by a power of two to unit size); (c) `--eval-only` with
     phase 6's checkpoint at world size 2 (gloo, both ranks on the card) on
     SUNRGBD_test at batch 1: per image the gathered predictions equal phase
     7's (scores and boxes within 1e-5), the AP dicts equal, ms per image per
     rank. 8b's and 8c's times are two processes sharing one card;
  9. the other backbones at full width (50 classes, FPN 256, FC 1024, 512
     px, seeded random weights, f32 with TF32 off): (a) ResNet34-FPN
     (configs/cubercnn_ResNet34_FPN.yaml) as phases 3 and 5-7 drive DLA-34:
     inference in f32 and bf16 at batch 1 and 8 (two forward launches per
     call, the f32 box pooler through the kernel vs the plain pooler as in
     phase 3), the bf16
     batch-32 training step (median of 5 after 2 warm-ups, one forward and
     one backward launch per step, both kernels held against their plain
     versions on the first step's pooler call as in 8b, peak memory, and
     again with
     TPU.REMAT_BACKBONE), `tools.train_net` for 8 bf16 batch-8 iterations
     on phase 6's dataset and `--eval-only` with its model_final.ckpt on
     phase 7's SUNRGBD_test at batch 8 (finite losses, the result files, an
     AP dict), beside phase 3's and 5's DLA-34 bf16 numbers from this card;
     (b) ResNet-18/50/101, DenseNet-121, MNASNet-1.0, ShuffleNetV2-x1.0 and
     the nine other DLA variants: one bf16 batch-8 inference (two forward
     launches, `check_outputs`) and one bf16 batch-8 training step (one
     forward and one backward launch, finite losses) each, with build and
     warm-up seconds, ms and peak memory; inference models with the pose
     bias as in phase 3. It prints the `backbones:` JSON line.
The line before the last is the kernel summary as JSON; the last line is
{"ok": true, "device": {...}}.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
TRAIN_ROIS = 512 + 128           # per image: sampled box RoIs + foreground cube RoIs
TRAIN_SETTINGS = (("float32", 8), ("bfloat16", 32))   # (compute dtype, batch)
WARMUP_STEPS, TIMED_STEPS = 2, 5
ENTRY_RESUME_TO = 32             # phase 6: tools.profile_entry's STEPS (24), then resumed to 32
# phase 7's test splits: name -> (images, height, width, format, focal), SUN
# RGB-D's and KITTI's image sizes and focal lengths (MIN_SIZE_TEST 512 pads
# them to 512 x 705 and 512 x 1696 before the loader's buckets)
EVAL_SPLITS = {"SUNRGBD_test": (32, 530, 730, "ppm", 529.5),
               "KITTI_test": (8, 375, 1242, "png", 721.5)}
EVAL_BATCH_SIZES = (1, 8)
DDP_STEPS = 8                    # phase 8a: train_net iterations over NCCL at world size 1
PHASE8_TIMEOUT_S = 600           # each group of phase 8's child processes
DDP_TIMED_STEPS = 10             # phase 8a: bf16 steps per timing window
PROFILED_DDP_STEPS = 3
TWO_RANK_BS = 8                  # phase 8b: the global batch, half on each rank
# phase 8b steps at BASE_LR (no warm-up factor), so each update stands well
# above the float32 rounding of the weights it moves
TWO_RANK_OPTS = ("TPU.COMPUTE_DTYPE", "float32", "SOLVER.WARMUP_FACTOR", "1.0")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 peak rate
F32_OPS_PER_S = 67e12            # float32 outside the tensor cores


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


def bound(bytes_moved, ops):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the float32 operations over its peak rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pool_work(boxes, levels, shapes, strides, sampling_ratio, C):
    """What this run's data needs of one pooling and of its transpose:
    (distinct pyramid cells with a nonzero tap weight, forward operations,
    backward operations). Operations are float32, 2 per fused multiply-add,
    the fewer of two counts: one FMA per channel for each tap of nonzero
    weight (the sample weight folds into the four tap weights, which all C
    channels share), or the banded form's FMAs per channel over the boxes'
    per-axis bands (`ops.roi_align.axis_bands`): forward count_y x nnz(Ax) +
    P x nnz(Ay), backward P x nnz(Ax) + nnz(Ay) x count_x."""
    import torch
    from omni3d_tpu_torch.ops.roi_align import _chunk_taps, axis_bands
    B = boxes.shape[0]
    P = 7
    touched = torch.zeros(sum(B * h * w for h, w in shapes), dtype=torch.bool,
                          device=boxes.device)
    taps_live = 0
    for _, _, taps, wy, wx in _chunk_taps(boxes, levels, shapes, strides, P,
                                          sampling_ratio, C):
        live = (wy[:, :, None] * wx[:, None, :]) != 0
        for idx, w in taps:
            nz = live & (w != 0)
            taps_live += int(nz.sum())
            touched[idx[nz]] = True
    lv = levels.reshape(-1).long()
    hs = torch.tensor([h for h, _ in shapes], device=boxes.device)[lv]
    ws = torch.tensor([w for _, w in shapes], device=boxes.device)[lv]
    scale = torch.tensor([1.0 / s for s in strides], dtype=torch.float32,
                         device=boxes.device)[lv]
    b = boxes.reshape(-1, 4) * scale[:, None] - 0.5
    _, ny, ay = axis_bands(b[:, 1], b[:, 3] - b[:, 1], hs, P, sampling_ratio)
    _, nx, ax = axis_bands(b[:, 0], b[:, 2] - b[:, 0], ws, P, sampling_ratio)
    nnz_y, nnz_x = (ay != 0).sum((1, 2)), (ax != 0).sum((1, 2))
    live = (ny > 0) & (nx > 0)
    fwd = int(((ny * nnz_x + P * nnz_y) * live).sum())
    bwd = int(((P * nnz_x + nnz_y * nx) * live).sum())
    return int(touched.sum()), min(taps_live, fwd) * C * 2, min(taps_live, bwd) * C * 2


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
                    err, tol, frac, ok = fwd_agreement(got, want)
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
                        cells, ops, _ = pool_work(boxes, levels,
                                                  [f.shape[1:3] for f in feats], STRIDES, S,
                                                  CHANNELS)
                        moved = (cells * CHANNELS * 2 + boxes.numel() * 4 + levels.numel() * 4
                                 + want.numel() * 2)
                        row["bound_ms"], row["bound_by"] = bound(moved, ops)
    return main_case, worst


def fwd_agreement(got, want):
    """(max |k - p|, tolerance, share of elements differing, ok) of a forward
    kernel output against the plain one: f32 within F32_ATOL; bf16 within
    one output ULP at the largest magnitude, on at most BF16_MAX_MISMATCH of
    the elements."""
    import torch
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if want.dtype == torch.float32:
        return err, F32_ATOL, 0.0, err <= F32_ATOL
    tol = 2.0 ** (float(torch.log2(want.float().abs().max()).floor()) - 7)
    frac = float((diff > 0).float().mean())
    return err, tol, frac, err <= tol and frac <= BF16_MAX_MISMATCH


def bwd_agreement(got, want, what):
    """(max |k - p|, f32 tolerance) of the backward kernel's per-level
    gradients against the plain ones; raises where an element is off by more
    than 1e-5 of the largest gradient + 1e-6, plus one ULP of the element in
    bf16 (both round the f32 sums once)."""
    import torch
    scale = max(float(w.float().abs().max()) for w in want)
    tol32 = 1e-5 * scale + 1e-6
    err = 0.0
    for k, w in zip(got, want):
        diff = (k.float() - w.float()).abs()
        tol = tol32 + (bf16_ulp(w.float()) if w.dtype == torch.bfloat16 else 0.0)
        if not bool((diff <= tol).all()):
            raise AssertionError(f"backward kernel disagrees with plain: {what} "
                                 f"max {float(diff.max())}")
        err = max(err, float(diff.max()))
    return err, tol32


def bf16_ulp(x):
    """One bfloat16 ULP at the magnitude of each element of x (float32)."""
    import torch
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp(min=1e-30))) - 7)


def bwd_vs_plain(device):
    """The backward kernel (through the autograd Function) vs the plain
    backward at the training path's shapes, and the transpose identity."""
    import torch
    from omni3d_tpu_torch.ops import roi_align_cuda as rac
    from omni3d_tpu_torch.ops.roi_align import multilevel_roi_align_plain_bwd, route_levels

    gen = torch.Generator().manual_seed(1)
    feats32 = [torch.randn(2, IMG // s, IMG // s, CHANNELS, generator=gen).to(device)
               for s in STRIDES]
    shapes = [f.shape[1:3] for f in feats32]
    boxes = make_boxes(TRAIN_ROIS, gen, device)
    g32 = torch.randn((2, TRAIN_ROIS, 7, 7, CHANNELS), generator=gen).to(device)
    worst = 0.0
    for routing in ("canonical", "fit"):
        levels = route_levels(boxes, STRIDES, 2, routing)
        for dtype in (torch.float32, torch.bfloat16):
            g = g32.to(dtype)
            for S in (0, 2):
                feats = [f.to(dtype, copy=True).requires_grad_(True) for f in feats32]
                before = rac.multilevel_roi_align.bwd_launches
                out = rac.multilevel_roi_align(feats, boxes, STRIDES, 7, S, routing=routing)
                out.backward(g)
                torch.cuda.synchronize()
                assert rac.multilevel_roi_align.bwd_launches == before + 1
                want = multilevel_roi_align_plain_bwd(g, boxes, levels, shapes, STRIDES, 7, S,
                                                      dtype)
                err, tol32 = bwd_agreement([f.grad for f in feats], want,
                                           f"{routing} {dtype} S={S}")
                ms = cuda_ms(lambda: rac._backward_kernel(g, boxes, levels, shapes, STRIDES, 7,
                                                          S, dtype))
                plain_ms = cuda_ms(lambda: multilevel_roi_align_plain_bwd(
                    g, boxes, levels, shapes, STRIDES, 7, S, dtype))
                line = (f"  N={TRAIN_ROIS} {routing:9s} {str(dtype)[6:]:8s} S={S}  "
                        f"max|k-p|={err:.3e} (f32 tol {tol32:.1e})  kernel {ms:.3f} ms  "
                        f"plain {plain_ms:.3f} ms")
                if dtype == torch.float32:
                    lhs = float((g.double() * out.detach().double()).sum())
                    rhs = float(sum((f.grad.double() * f.detach().double()).sum() for f in feats))
                    if abs(lhs - rhs) > 1e-5 * abs(lhs):
                        raise AssertionError(f"transpose identity: {lhs} vs {rhs}")
                    line += f"  <g,fwd f>-<bwd g,f> rel {abs(lhs - rhs) / abs(lhs):.1e}"
                print(line)
                worst = max(worst, err)
    return worst


def time_kernels_at_train_shape(device, bs=32):
    """Both kernels and both plain versions at the bf16 training batch: B =
    bs images, N = 640 RoIs each, canonical routing, adaptive sampling, C =
    256 bf16; each kernel's output held against its plain version's with the
    tolerances of phases 2 and 4, and two backward calls held bit-equal;
    CUDA events. The backward is timed as its wrapper (_backward_kernel:
    torch.empty outputs, launch)."""
    import torch
    from omni3d_tpu_torch.ops import roi_align_cuda as rac
    from omni3d_tpu_torch.ops.roi_align import (multilevel_roi_align_plain,
                                                multilevel_roi_align_plain_bwd, route_levels)

    gen = torch.Generator().manual_seed(2)
    feats = [torch.randn(bs, IMG // s, IMG // s, CHANNELS, generator=gen).to(device,
                                                                            torch.bfloat16)
             for s in STRIDES]
    shapes = [tuple(f.shape[1:3]) for f in feats]
    boxes = torch.cat([make_boxes(TRAIN_ROIS, gen, device) for _ in range(bs // 2)], 0)
    levels = route_levels(boxes, STRIDES, 2, "canonical")
    g = torch.randn((bs, TRAIN_ROIS, 7, 7, CHANNELS), generator=gen).to(device, torch.bfloat16)
    bwd = lambda: rac._backward_kernel(g, boxes, levels, shapes, STRIDES, 7, 0, torch.bfloat16)
    plain_bwd = lambda: multilevel_roi_align_plain_bwd(g, boxes, levels, shapes, STRIDES, 7, 0,
                                                       torch.bfloat16)
    fwd = lambda: rac._forward_kernel(feats, boxes, levels, STRIDES, 7, 0)
    plain_fwd = lambda: multilevel_roi_align_plain(feats, boxes, levels, STRIDES, 7, 0)
    first = bwd()
    bwd_err, bwd_tol = bwd_agreement(first, plain_bwd(), f"bf16 B={bs} x N={TRAIN_ROIS}")
    if not all(torch.equal(a, b) for a, b in zip(first, bwd())):
        raise AssertionError("two backward calls on the same inputs differ")
    del first
    fwd_err, fwd_tol, fwd_frac, ok = fwd_agreement(fwd(), plain_fwd())
    if not ok:
        raise AssertionError(f"forward kernel disagrees with plain at bf16 B={bs} x "
                             f"N={TRAIN_ROIS}: max {fwd_err} (tol {fwd_tol}), differing {fwd_frac}")
    torch.cuda.synchronize()
    res = {"bwd_max_abs_err": bwd_err, "fwd_max_abs_err": fwd_err,
           "bwd_ms": cuda_ms(bwd), "fwd_ms": cuda_ms(fwd),
           "bwd_plain_ms": cuda_ms(plain_bwd, iters=3, warmup=1),
           "fwd_plain_ms": cuda_ms(plain_fwd, iters=3, warmup=1)}
    cells, fwd_ops, bwd_ops = pool_work(boxes, levels, shapes, STRIDES, 0, CHANNELS)
    pyramid = sum(bs * h * w for h, w in shapes) * CHANNELS * 2
    small = boxes.numel() * 4 + levels.numel() * 4
    # backward: g read once, every level's bf16 gradient written once
    res["bwd_bound_ms"], res["bwd_bound_by"] = bound(g.numel() * 2 + pyramid + small, bwd_ops)
    # forward: the touched cells read once, the pooled RoIs written once
    res["fwd_bound_ms"], res["fwd_bound_by"] = bound(cells * CHANNELS * 2 + small
                                                     + g.numel() * 2, fwd_ops)
    res.update(boxes=bs * TRAIN_ROIS, touched_cells=cells, fwd_ops=fwd_ops, bwd_ops=bwd_ops)
    print(f"  bf16 B={bs} x N={TRAIN_ROIS}: backward bit-equal over two calls, max|k-p|={bwd_err:.3e} (f32 tol "
          f"{bwd_tol:.1e} + 1 ULP), kernel {res['bwd_ms']:.3f} ms (bound "
          f"{res['bwd_bound_ms']:.4f} ms by {res['bwd_bound_by']}), plain "
          f"{res['bwd_plain_ms']:.3f} ms; forward max|k-p|={fwd_err:.3e} (tol {fwd_tol:.1e}, "
          f"differing {fwd_frac:.1e}), kernel {res['fwd_ms']:.3f} ms (bound "
          f"{res['fwd_bound_ms']:.4f} ms by {res['fwd_bound_by']}), plain "
          f"{res['fwd_plain_ms']:.3f} ms")
    return res


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


def _config(name, *opts):
    """The port's config of configs/<name> with `KEY VALUE` overrides."""
    from omni3d_tpu_torch.config import get_default_cfg
    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", name))
    cfg.merge_from_list(list(opts))
    return cfg


def main_path(device, config="cubercnn_DLA34_FPN.yaml"):
    """Full-width inference of `config` at 512 px: f32 and bf16 at BATCHES,
    two forward launches per call, then one f32 call with the kernel and
    one with the plain pooler. The pooled features are held to phase 2's
    tolerance times max(1, largest pooled magnitude) (f32 sums err in
    proportion to their size, and some trunks' random-weight maps are far
    from unit scale); scores and boxes to fixed tolerances. The 6D pose bias
    starts at the identity (`condition_pose_bias_`: a detection clipped to
    zero height pools zero features, and the zero bias then decodes to an
    all-zero pose). Returns (timings, launches, kernel-vs-plain errors)."""
    import torch
    import numpy as np
    from omni3d_tpu_torch.models import rcnn3d
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
    from omni3d_tpu_torch.tools.synthetic import condition_pose_bias_

    cfg = _config(config)
    kw = rcnn3d.inference_kwargs(cfg)
    C = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    print(f"  config {config}: {C} classes, FPN {cfg.MODEL.FPN.OUT_CHANNELS}, "
          f"FC {cfg.MODEL.ROI_BOX_HEAD.FC_DIM}; inference_kwargs {kw}")

    def inputs(bs):
        raw = np.random.default_rng(0).integers(0, 255, (bs, IMG, IMG, 3), dtype=np.uint8)
        images = rcnn3d.preprocess(torch.from_numpy(raw).to(device),
                                   cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
        K = torch.tensor([[512.0, 0, IMG / 2], [0, 512.0, IMG / 2], [0, 0, 1]], device=device)
        return images, K.expand(bs, 3, 3).contiguous(), torch.ones(bs, device=device)

    timings, models = [], {}
    multilevel_roi_align.launches = 0          # counts of the main path's run only
    multilevel_roi_align.bwd_launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        model = rcnn3d.build_model(cfg, device=device, dtype=dtype, seed=0)
        condition_pose_bias_(model)
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
    print(f"  kernel launches in the main path's run: {launches} forward, "
          f"{multilevel_roi_align.bwd_launches} backward")
    assert launches == 2 * 2 * sum(2 + iters for _, iters in BATCHES), launches
    assert multilevel_roi_align.bwd_launches == 0

    # the same f32 call with the plain pooler on the card
    def recorded(pool):
        seen = []

        def spy(*args, **kwargs):
            out = pool(*args, **kwargs)
            seen.append(out)
            return out
        return spy, seen

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
    pooled_max = float(pseen[0].abs().max())
    scale = max(1.0, pooled_max)
    print(f"  f32 bs={PLAIN_BS} box-pooler features, kernel vs plain pooler: max|diff| "
          f"{pooled_err:.3e} (tol {F32_ATOL * scale:.1e}; largest |pooled| {pooled_max:.3e})")
    assert pooled_err <= F32_ATOL * scale, pooled_err
    errs = {}
    same = bool(torch.equal(ko["valid"], po["valid"]) and torch.equal(ko["classes"], po["classes"]))
    if same:
        errs = {k: float((ko[k].float() - po[k].float()).abs().max())
                for k in ("boxes", "scores", "center_cam", "dims", "pose")}
        print(f"  final outputs, kernel vs plain pooler (valid masks agree): {errs}")
        assert errs["scores"] <= 1e-4 and errs["boxes"] <= 1e-2, errs
    else:
        n = int((ko["valid"] != po["valid"]).sum() + (ko["classes"] != po["classes"]).sum())
        print(f"  final outputs: valid/classes differ in {n} detections (f32 ties flip)")
    return timings, launches, dict(pooled_max_abs_err=pooled_err, pooled_max_abs=pooled_max,
                                   tol=F32_ATOL * scale, final_outputs=errs)


def plain_pool(features, boxes, strides, out_size, sampling_ratio, min_level=2,
               routing="canonical"):
    """`multilevel_roi_align` with the plain PyTorch forward and backward
    (an autograd Function), for the step compared with the kernels' step."""
    import torch
    from omni3d_tpu_torch.ops.roi_align import (multilevel_roi_align_plain,
                                                multilevel_roi_align_plain_bwd, route_levels)

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, bx, lv, *feats):
            ctx.save_for_backward(bx, lv)
            ctx.meta = ([f.shape[1:3] for f in feats], feats[0].dtype)
            return multilevel_roi_align_plain(feats, bx, lv, strides, out_size, sampling_ratio)

        @staticmethod
        def backward(ctx, g):
            bx, lv = ctx.saved_tensors
            shapes, dtype = ctx.meta
            return (None, None) + tuple(multilevel_roi_align_plain_bwd(
                g, bx, lv, shapes, strides, out_size, sampling_ratio, dtype))

    levels = route_levels(boxes, strides, min_level, routing)
    return Plain.apply(boxes, levels, *features)


def train_path(device):
    """Training steps of the full-width model, the stabilizer skip, and the
    kernels' step against the plain pooler's."""
    import torch
    from omni3d_tpu_torch.config import get_default_cfg
    from omni3d_tpu_torch.engine import train as train_mod
    from omni3d_tpu_torch.models.layers import BatchNorm2d
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
    from omni3d_tpu_torch.tools.synthetic import GT_SLOTS, synthetic_trainer

    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "cubercnn_DLA34_FPN.yaml"))
    rh = cfg.MODEL.ROI_HEADS
    print(f"  config: {rh.NUM_CLASSES} classes, ROI batch {rh.BATCH_SIZE_PER_IMAGE}, RPN "
          f"{cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN}/{cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN}, "
          f"sampling ratio {cfg.TPU.ROI_SAMPLING_RATIO}, solver {cfg.SOLVER.TYPE} "
          f"lr {cfg.SOLVER.BASE_LR}")

    def bn_stats(model):
        return [b.clone() for m in model.modules() if isinstance(m, BatchNorm2d)
                for b in (m.running_mean, m.running_var)]

    rows, kept = [], {}
    multilevel_roi_align.launches = 0          # counts of the main path's run only
    multilevel_roi_align.bwd_launches = 0
    for dtype_name, bs in TRAIN_SETTINGS:
        dtype = getattr(torch, dtype_name)
        model, opt, step, batch = synthetic_trainer(cfg, dtype, bs, device, img=IMG)
        assert all(p.dtype == torch.float32 for p in model.parameters())
        gen = torch.Generator().manual_seed(0)
        params0 = [p.detach().clone() for p in model.parameters()]
        bn0 = bn_stats(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, logs_all = [], []
        for i in range(WARMUP_STEPS + TIMED_STEPS):
            before = (multilevel_roi_align.launches, multilevel_roi_align.bwd_launches)
            t0 = time.perf_counter()
            logs = step(batch, gen)
            torch.cuda.synchronize()
            if i >= WARMUP_STEPS:
                ms.append((time.perf_counter() - t0) * 1e3)
            after = (multilevel_roi_align.launches, multilevel_roi_align.bwd_launches)
            assert (after[0] - before[0], after[1] - before[1]) == (1, 1), (before, after)
            logs_all.append(logs)
        peak = torch.cuda.max_memory_allocated()
        for logs in logs_all:
            bad = {k: float(v) for k, v in logs.items() if not torch.isfinite(torch.as_tensor(v))}
            assert not bad, bad
        skipped = step.state["skipped"]
        moved = sum(not torch.equal(a, b) for a, b in zip(params0, model.parameters()))
        bn_moved = sum(not torch.equal(a, b) for a, b in zip(bn0, bn_stats(model)))
        assert moved > 0 and bn_moved > 0, (moved, bn_moved)
        last = logs_all[-1]
        med = statistics.median(ms)
        rows.append(dict(dtype=dtype_name, bs=bs, ms_per_step=med, img_per_s=bs * 1e3 / med,
                         ms_steps=ms, peak_mem_gib=peak / 2 ** 30,
                         total_loss=float(last["total_loss"]),
                         num_fg=float(last["roi/num_fg"]),
                         skipped=skipped, params_moved=f"{moved}/{len(params0)}",
                         bn_stats_moved=f"{bn_moved}/{len(bn0)}"))
        print(f"  {dtype_name:8s} bs={bs}: {med:.1f} ms/step (median of {TIMED_STEPS}; "
              f"{', '.join(f'{t:.1f}' for t in ms)}), {bs * 1e3 / med:.1f} img/s, peak "
              f"{peak / 2 ** 30:.2f} GiB; loss {float(last['total_loss']):.4f}, "
              f"{float(last['roi/num_fg']):.1f} fg RoIs/img; {moved}/{len(params0)} params and "
              f"{bn_moved}/{len(bn0)} BN stats moved; {skipped} steps skipped")
        if dtype == torch.float32:
            kept = dict(model=model, opt=opt, step=step, batch=batch, gen=gen)
        else:
            del model, opt, step, batch
            torch.cuda.empty_cache()
    launches = {"forward": multilevel_roi_align.launches,
                "backward": multilevel_roi_align.bwd_launches}
    print(f"  kernel launches in the main path's run: {launches}")
    n_steps = len(TRAIN_SETTINGS) * (WARMUP_STEPS + TIMED_STEPS)
    assert launches == {"forward": n_steps, "backward": n_steps}, launches

    # a NaN pixel: the stabilizer skips the step, nothing moves
    model, opt, step, batch = kept["model"], kept["opt"], kept["step"], kept["batch"]
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    osd = {i: {k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
           for i, st in opt.state_dict()["state"].items()}
    bad = dict(batch, images=batch["images"].clone())
    bad["images"][0, 0, 0, 0] = float("nan")
    logs = step(bad, kept["gen"])
    torch.cuda.synchronize()
    assert logs["finite"] == 0.0, (logs["finite"], step.state)
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())
    assert all(torch.equal(v, osd[i][k]) for i, st in opt.state_dict()["state"].items()
               for k, v in st.items() if torch.is_tensor(v))
    print("  NaN pixel: step skipped; parameters, BN statistics and optimizer state "
          "bit-equal to before")

    # the kernels' step vs the plain pooler's, from the same state and noise
    bs = batch["images"].shape[0]
    R = sum(3 * (IMG // s) ** 2 for s in STRIDES)
    noise = train_mod.sampling_noise(kept["gen"], bs, R,
                                     cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN + GT_SLOTS, device)
    results = {}
    for label, pool in (("kernel", multilevel_roi_align), ("plain", plain_pool)):
        model.load_state_dict(sd)
        model.zero_grad(set_to_none=True)
        train_mod.multilevel_roi_align = pool
        try:
            total, losses, _ = train_mod.compute_losses(model, batch, noise=noise)
            total.backward()
        finally:
            train_mod.multilevel_roi_align = multilevel_roi_align
        torch.cuda.synchronize()
        results[label] = ({k: float(v) for k, v in losses.items()},
                          {n: p.grad.clone() for n, p in model.named_parameters()
                           if p.grad is not None})
    model.load_state_dict(sd)
    (kl, kg), (pl, pg) = results["kernel"], results["plain"]
    loss_err = _loss_rel(kl, pl)
    assert set(kg) == set(pg)
    grad_err = _grad_rel(kg, pg)
    print(f"  f32 bs={bs} step, kernels vs plain pooler: losses max rel diff {loss_err:.2e} "
          f"(tol 1e-4); gradients max |diff| / max|g| {grad_err:.2e} over {len(pg)} tensors "
          f"(tol 1e-3)")
    assert loss_err <= 1e-4, (kl, pl)
    for n in pg:
        assert float((kg[n] - pg[n]).abs().max()) <= 1e-3 * float(pg[n].abs().max()) + 1e-6, n
    return rows, launches, dict(loss_rel=loss_err, grad_rel=grad_err)


def entry_point_path(device, tmp):
    """Phase 6: `tools.train_net` on the synthetic Omni3D-format dataset of
    `tools.profile_entry` (SPLITS, written from a seed under `tmp`), at full
    width in bfloat16: STEPS iterations, then --resume to ENTRY_RESUME_TO.
    Returns (summary, launches, the path of model_final.ckpt)."""
    import numpy as np
    import torch
    from omni3d_tpu_torch.data import datasets as data_lib
    from omni3d_tpu_torch.data.build import get_detection_dataset_dicts
    from omni3d_tpu_torch.data.mapper import DatasetMapper3D, batch_to_device, collate_batch
    from omni3d_tpu_torch.engine.loop import LOG_PERIOD, PROFILE_STEPS
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
    from omni3d_tpu_torch.tools import train_net
    from omni3d_tpu_torch.tools.profile_entry import (BS, SPLITS, STEPS, iteration_times,
                                                      train_argv, write_dataset)
    from omni3d_tpu_torch.utils.priors import compute_priors, priors_to_params

    torch.cuda.empty_cache()
    write_dataset(tmp)
    out_dir, prof_dir = os.path.join(tmp, "output"), os.path.join(tmp, "profile")
    multilevel_roi_align.launches = 0          # counts of the main path's run only
    multilevel_roi_align.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = train_net.main(train_argv(tmp, out_dir, STEPS, "--profile-dir", prof_dir))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    resumed = train_net.main(train_argv(tmp, out_dir, ENTRY_RESUME_TO, "--resume"))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"forward": multilevel_roi_align.launches,
                "backward": multilevel_roi_align.bwd_launches}
    peak = torch.cuda.max_memory_allocated()
    print(f"  kernel launches in the main path's run: {launches}")
    assert launches == {"forward": ENTRY_RESUME_TO, "backward": ENTRY_RESUME_TO}, launches
    assert first.iterations == list(range(STEPS))
    assert resumed.start_iter == STEPS, resumed.start_iter
    assert resumed.iterations == list(range(STEPS, ENTRY_RESUME_TO))
    for f in ("model_recent.ckpt", "model_final.ckpt", "metrics.json", "category_meta.json"):
        assert os.path.exists(os.path.join(out_dir, f)), f
    with open(os.path.join(out_dir, "metrics.json")) as f:
        logged = [json.loads(line) for line in f]
    assert [r["iteration"] for r in logged] == sorted(
        {i for i in range(ENTRY_RESUME_TO) if i % LOG_PERIOD == 0}
        | {STEPS - 1, ENTRY_RESUME_TO - 1})
    bad = [(r["iteration"], k) for r in logged for k, v in r.items() if not np.isfinite(v)]
    assert not bad, bad
    with open(os.path.join(prof_dir, "summary.json")) as f:
        profile = json.load(f)

    # the priors buffers hold compute_priors of the dataset
    cfg = resumed.model.cfg
    fs = data_lib.get_filter_settings_from_cfg(cfg)
    api = data_lib.Omni3D([os.path.join(tmp, "Omni3D", n + ".json") for n in SPLITS], fs)
    classes = data_lib.metadata("omni3d_model")["thing_classes"]
    priors = priors_to_params(compute_priors(cfg, api, classes),
                              cfg.MODEL.ROI_HEADS.NUM_CLASSES, cfg.MODEL.ROI_CUBE_HEAD.CLUSTER_BINS)
    for k, v in priors.items():   # NaN (a category with one object) equals NaN here
        np.testing.assert_array_equal(getattr(resumed.model.roi_heads, k).cpu().numpy(), v,
                                      err_msg=k)
    print(f"  priors buffers equal compute_priors of the dataset: {sorted(priors)}; "
          f"{float(priors['priors_dims_per_cat'][:, 0].mean()):.3f} m mean dims")

    # one batch: normalised on the card, bit-equal to the numpy collate
    records = get_detection_dataset_dicts(list(SPLITS))
    mapper = DatasetMapper3D(cfg, is_train=True)
    pick = records[:BS // 2] + records[-(BS // 2):]   # both splits
    samples = [mapper(r, short=640, flip=bool(i % 2)) for i, r in enumerate(pick)]
    want = collate_batch(samples, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    got = batch_to_device(collate_batch(samples, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD,
                                        normalize=False), device,
                          cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    for k, v in want.items():
        if not torch.equal(got[k].cpu(), torch.from_numpy(v)):
            raise AssertionError(f"batch {k}: card normalisation differs from the collate")
    print(f"  batch of {BS} at {tuple(want['images'].shape[1:3])}: normalised on the "
          "card, bit-equal to the numpy collate")

    res = iteration_times([first, resumed])
    profiled = first.iterations[PROFILE_STEPS[0]:PROFILE_STEPS[1]]
    res.update(
        steps=ENTRY_RESUME_TO, bs=BS, peak_mem_gib=peak / 2 ** 30,
        device_busy_share=profile["device_busy_share"], profile=profile,
        profiled_shapes=[list(first.shapes[i]) for i in profiled],
        # device ms per profiled step over the unprofiled median iteration:
        # the busy share without the profiler's host cost (two windows)
        device_busy_over_median_step=profile["device_busy_ms_per_step"] / res["ms_per_step"],
        wall_s=dict(first_run=t1 - t0, resumed_run=t2 - t1),
        skipped=[first.step.state["skipped"], resumed.step.state["skipped"]],
        last_total_loss=logged[-1]["total_loss"], launches=launches)
    print(f"  {len(res['shapes'])} distinct padded shapes: {res['shapes']}")
    print(f"  {res['ms_per_step']:.1f} ms/step (median of {res['steady_steps']}, first step at "
          "each shape apart: " + ", ".join(f"{tuple(f['shape'])} {f['ms']:.0f}"
                                          for f in res["first_step_at_each_shape"])
          + "; the resumed run's first step: " + ", ".join(
              f"{f['ms']:.0f}, {f['data_ms']:.0f} of it starting the loader"
              for f in res["first_step_of_a_resumed_run"])
          + f"), {res['ms_blocked_on_loader']:.1f} ms/step blocked on the loader (median; mean "
          f"{res['ms_blocked_on_loader_mean']:.1f}), {res['img_per_s']:.1f} img/s")
    print(f"  device busy {100 * profile['device_busy_share']:.0f}% over steps 10-14 under the "
          f"profiler ({profile['device_busy_ms_per_step']:.1f} of "
          f"{profile['wall_ms_per_step']:.1f} ms per step; "
          f"{100 * res['device_busy_over_median_step']:.0f}% of the unprofiled median step), "
          f"peak {peak / 2 ** 30:.2f} GiB; resumed at iteration {resumed.start_iter}, "
          f"{res['skipped']} steps skipped, last loss {res['last_total_loss']:.4f}")
    return res, launches, os.path.join(out_dir, "model_final.ckpt")


def _ap_ok(key, v):
    """An AP value the protocol can give: a percentage, -1 (nothing to
    evaluate in that range) or, for a per-category or Omni3D-split mean, NaN."""
    if v != v:
        return key.startswith(("Omni3D", "Concat/AP2D-", "Concat/AP3D-"))
    return v == -1.0 or 0.0 <= v <= 100.0


def evaluation_path(device, tmp, weights):
    """Phase 7: `tools.train_net --eval-only` with phase 6's model_final.ckpt
    on two synthetic test splits written from a seed under `tmp`
    (EVAL_SPLITS), at TPU.EVAL_BATCH_SIZE 1 and then 8, bfloat16 at full
    width; a GT echo through `Omni3DEvaluationHelper` with IoU3D on the
    card; the card's IoU3D against the CPU's on the evaluation bench's
    (detection, GT) pairs; and `tools.bench_eval`. Returns (summary,
    launches)."""
    import pickle

    import numpy as np
    import torch
    from omni3d_tpu_torch.data import datasets as data_lib
    from omni3d_tpu_torch.evaluation.omni3d_eval import (Omni3DEvaluationHelper, gts_from_api,
                                                         paired_iou3d)
    from omni3d_tpu_torch.models import rcnn3d
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
    from omni3d_tpu_torch.tools import bench_eval, train_net
    from omni3d_tpu_torch.tools.profile_entry import SPLITS
    from omni3d_tpu_torch.tools.synthetic import write_omni3d_dataset

    for i, (name, (n, h, w, fmt, focal)) in enumerate(EVAL_SPLITS.items()):
        write_omni3d_dataset(tmp, name, n, h, w, fmt, seed=10 + i, dataset_id=i + 1,
                             focal=focal, objects=(1, 20))
    print("  test splits: " + ", ".join(f"{k} {n} x {h}x{w} {fmt}"
                                        for k, (n, h, w, fmt, _) in EVAL_SPLITS.items()))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runs, launches, pooler_checks = {}, {"forward": 0, "backward": 0}, []
    for bs in EVAL_BATCH_SIZES:
        out_dir = os.path.join(tmp, f"eval_bs{bs}")
        argv = ["--config-file", os.path.join(ROOT, "configs", "cubercnn_DLA34_FPN.yaml"),
                "--datasets-root", os.path.join(tmp, "Omni3D"), "--device", device.type,
                "--eval-only", "--weights", weights,
                "OUTPUT_DIR", out_dir, "DATASETS.TRAIN", str(tuple(SPLITS)),
                "DATASETS.TEST", str(tuple(EVAL_SPLITS)), "TPU.COMPUTE_DTYPE", "bfloat16",
                "TPU.EVAL_BATCH_SIZE", str(bs), "SEED", "0"]
        spy, seen = first_pooler_calls()
        rcnn3d.multilevel_roi_align = spy
        multilevel_roi_align.launches = 0          # counts of the main path's run only
        multilevel_roi_align.bwd_launches = 0
        try:
            t0 = time.perf_counter()
            results = train_net.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            rcnn3d.multilevel_roi_align = multilevel_roi_align
        n_batches = sum(len(results[k]["inference"]["batches"]) for k in EVAL_SPLITS)
        run_launches = {"forward": multilevel_roi_align.launches,
                        "backward": multilevel_roi_align.bwd_launches}
        checks = pooler_vs_plain(seen, bs)
        pooler_checks += checks
        print(f"  bs {bs}: kernel launches {run_launches} over {n_batches} inference batches; "
              f"forward kernel vs plain pooler on the run's own inputs at {len(checks)} "
              f"(pyramid, boxes) shapes: max|k-p| {max(c['max_abs_err'] for c in checks):.3e}, "
              f"differing at most {max(c['mismatch'] for c in checks):.1e}")
        assert run_launches == {"forward": 2 * n_batches, "backward": 0}, run_launches
        for k in launches:
            launches[k] += run_launches[k]
        files = os.path.join(out_dir, "inference", "iter_final")
        with open(os.path.join(files, "omni3d_results.json")) as f:
            saved = json.load(f)
        assert set(saved) == set(EVAL_SPLITS), sorted(saved)
        for name, (n, *_) in EVAL_SPLITS.items():
            with open(os.path.join(files, name, "instances_predictions.pkl"), "rb") as f:
                preds = pickle.load(f)
            assert results[name]["inference"]["images"] == n
            bad = {k: v for k, v in results[name].items() if k.startswith(("AP", "AR"))
                   and not _ap_ok(k, v)}
            assert not bad, (name, bad)
            print(f"  bs {bs} {name}: {len(preds)} predictions, AP2D {results[name]['AP2D']:.3f}"
                  f" AP3D {results[name]['AP3D']:.3f}")
        bad = {k: v for k, v in results["summary"].items() if not _ap_ok(k, v)}
        assert not bad, bad
        runs[bs] = dict(wall_s=wall, splits={k: results[k]["inference"] for k in EVAL_SPLITS})
    peak = torch.cuda.max_memory_allocated()

    # GT echo: the GTs as predictions, IoU3D on the card -> AP 100
    _, fs, _ = train_net.setup(train_net.parse_args(argv))
    helper = Omni3DEvaluationHelper(list(EVAL_SPLITS), fs, None, device=device)
    for name in EVAL_SPLITS:
        api = data_lib.Omni3D([data_lib.metadata(name)["json_file"]], dict(fs))
        helper.add_predictions(name, [dict(g, score=1.0) for g in gts_from_api(api)], api)
        res = helper.evaluate(name)
        print(f"  GT echo {name}: AP2D {res['AP2D']} AP3D {res['AP3D']}")
        assert res["AP2D"] == res["AP3D"] == 100.0, res

    # the card's IoU3D vs the CPU's on the evaluation bench's pairs
    dv, gv = bench_eval.group_pairs(*bench_eval.synth())
    card, cpu = paired_iou3d(dv, gv, device), paired_iou3d(dv, gv, "cpu")
    iou_err = float(np.abs(card - cpu).max())
    print(f"  IoU3D card vs CPU on {len(dv)} (detection, GT) pairs: max |diff| {iou_err:.3e} "
          f"(tol 1e-5), {int((card == cpu).sum())} bit-equal")
    assert iou_err <= 1e-5, iou_err

    bench = bench_eval.run(device=device)
    summary = dict(
        splits={k: list(v[:3]) for k, v in EVAL_SPLITS.items()}, peak_mem_gib=peak / 2 ** 30,
        roi_align_fwd_vs_plain=pooler_checks,
        roi_align_fwd_max_abs_err=max(c["max_abs_err"] for c in pooler_checks),
        iou3d_card_vs_cpu_max_abs=iou_err, iou3d_pairs=len(dv), bench_eval=bench,
        runs={bs: _eval_times(r) for bs, r in runs.items()})
    summary["padded_shapes"] = sorted({tuple(b[:2]) for r in runs.values()
                                       for t in r["splits"].values() for b in t["batches"]})
    summary["n_padded_shapes"] = len(summary["padded_shapes"])
    for bs, r in summary["runs"].items():
        print(f"  bs {bs}: " + "; ".join(
            f"{k} {v['ms_per_img']:.1f} ms/img (compute {v['compute_ms_per_img']:.1f}, data "
            f"{v['data_ms_per_img']:.1f}; steady compute "
            f"{v['steady_compute_ms_per_img'] or float('nan'):.1f}), AP dict at "
            f"{v['ap_ready_s']:.1f} s" for k, v in r.items() if isinstance(v, dict))
            + f"; wall {r['wall_s']:.1f} s")
    print(f"  {summary['n_padded_shapes']} distinct padded shapes {summary['padded_shapes']}, "
          f"peak {peak / 2 ** 30:.2f} GiB")
    return summary, launches


def first_pooler_calls():
    """(spy, seen): a stand-in for `rcnn3d.multilevel_roi_align` that calls
    the kernel's wrapper and keeps copies of the inputs and the output of the
    first call at each (pyramid shape, boxes shape) in `seen`."""
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
    seen = {}

    def spy(features, boxes, strides, out_size, sampling_ratio=0, min_level=2,
            routing="canonical"):
        out = multilevel_roi_align(features, boxes, strides, out_size, sampling_ratio,
                                   min_level, routing)
        key = (tuple(tuple(f.shape) for f in features), tuple(boxes.shape))
        if key not in seen:
            seen[key] = dict(features=[f.detach().clone() for f in features],
                             boxes=boxes.detach().clone(), out=out.detach().clone(),
                             args=(tuple(strides), out_size, sampling_ratio, min_level, routing))
        return out
    return spy, seen


def pooler_vs_plain(seen, bs):
    """Each recorded forward-kernel output against the plain pooler on the
    same inputs, with phase 2's tolerances; raises where they disagree."""
    import torch
    from omni3d_tpu_torch.ops.roi_align import multilevel_roi_align_plain, route_levels
    rows = []
    for (shapes, box_shape), r in seen.items():
        strides, out_size, S, min_level, routing = r["args"]
        levels = route_levels(r["boxes"], strides, min_level, routing)
        want = multilevel_roi_align_plain(r["features"], r["boxes"], levels, strides,
                                          out_size, S)
        torch.cuda.synchronize()
        err, tol, frac, ok = fwd_agreement(r["out"], want)
        row = dict(bs=bs, p2=list(shapes[0][1:3]), boxes=list(box_shape),
                   dtype=str(want.dtype).replace("torch.", ""), max_abs_err=err, tol=tol,
                   mismatch=frac)
        if not ok:
            raise AssertionError(f"forward kernel disagrees with plain at an eval shape: {row}")
        rows.append(row)
    seen.clear()
    return rows


def _launch_counts():
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
    return multilevel_roi_align.launches, multilevel_roi_align.bwd_launches


def _first_pooler_call_checked(train_mod, record):
    """A stand-in for `engine.train.multilevel_roi_align` that calls the
    kernel's wrapper and keeps, of its first call, the inputs, the output
    and the gradient that reaches the output in the backward in `record`."""
    real = train_mod.multilevel_roi_align

    def spy(features, boxes, strides, out_size, sampling_ratio=0, min_level=2,
            routing="canonical"):
        out = real(features, boxes, strides, out_size, sampling_ratio, min_level, routing)
        if not record:
            record.update(features=[f.detach().clone() for f in features],
                          boxes=boxes.detach().clone(), out=out.detach().clone(),
                          args=(tuple(strides), out_size, sampling_ratio, min_level, routing))
            out.register_hook(lambda g: record.__setitem__("g", g.detach().clone()))
        return out
    return real, spy


def _pooler_call_vs_plain(record):
    """The forward kernel's recorded output and the backward kernel on the
    recorded gradient (scaled to unit size), each against its plain version
    on the same inputs, with phase 2's and phase 4's tolerances; raises where
    they disagree."""
    import torch
    from omni3d_tpu_torch.ops import roi_align_cuda as rac
    from omni3d_tpu_torch.ops.roi_align import (multilevel_roi_align_plain,
                                                multilevel_roi_align_plain_bwd, route_levels)
    strides, out_size, S, min_level, routing = record["args"]
    feats, boxes, g = record["features"], record["boxes"], record["g"]
    # The backward is linear in g: scaled by the power of two that brings its
    # largest element into [1, 2) (exact in bf16), it is phase 4's unit-scale
    # case, where the tolerance's absolute floor is small against the result.
    g_max = float(g.abs().max())
    if not g_max > 0:
        raise AssertionError(f"the step's first pooler call got no gradient: max |g| {g_max}")
    g = g * 2.0 ** -math.floor(math.log2(g_max))
    levels = route_levels(boxes, strides, min_level, routing)
    shapes = [tuple(f.shape[1:3]) for f in feats]
    err, tol, frac, ok = fwd_agreement(record["out"], multilevel_roi_align_plain(
        feats, boxes, levels, strides, out_size, S))
    if not ok:
        raise AssertionError(f"forward kernel disagrees with plain on the step's pooler call: "
                             f"max {err} (tol {tol}), differing {frac}")
    bwd_err, bwd_tol = bwd_agreement(
        rac._backward_kernel(g, boxes, levels, shapes, strides, out_size, S, feats[0].dtype),
        multilevel_roi_align_plain_bwd(g, boxes, levels, shapes, strides, out_size, S,
                                       feats[0].dtype), "the step's first pooler call")
    torch.cuda.synchronize()
    return dict(boxes=list(boxes.shape), dtype=str(g.dtype).replace("torch.", ""),
                fwd_max_abs_err=err, fwd_tol=tol, fwd_mismatch=frac, g_max_abs=g_max,
                bwd_max_abs_err=bwd_err, bwd_f32_tol=bwd_tol)


def _eval_times(run):
    """Per split of one eval run: ms per image (compute, data), the compute
    ms per image of batches at an already-seen shape (the first batch at
    each shape apart) and the seconds from do_test's start to its AP dict."""
    out, seen = {"wall_s": run["wall_s"]}, set()
    for name, t in run["splits"].items():
        steady, firsts = [], []
        for h, w, n, data_ms, compute_ms in t["batches"]:
            if (h, w) in seen:
                steady.append(compute_ms / n)
            else:
                seen.add((h, w))
                firsts.append(dict(shape=[h, w], images=n, compute_ms=compute_ms))
        n = t["images"]
        out[name] = dict(
            images=n, data_s=t["data_s"], compute_s=t["compute_s"],
            ms_per_img=(t["data_s"] + t["compute_s"]) * 1e3 / n,
            compute_ms_per_img=t["compute_s"] * 1e3 / n, data_ms_per_img=t["data_s"] * 1e3 / n,
            steady_compute_ms_per_img=statistics.median(steady) if steady else None,
            first_batch_at_each_shape=firsts, evaluate_s=t["evaluate_s"],
            ap_ready_s=t["ap_ready_s"])
    return out


def _child_setup():
    import torch
    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch


def _full_cfg(*opts):
    return _config("cubercnn_DLA34_FPN.yaml", *opts)


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed_steps(step, batch, gen, timed=TIMED_STEPS, warmup=WARMUP_STEPS):
    """Host ms of the last `timed` of `warmup` + `timed` steps, each ending
    in a synchronise."""
    ms = []
    device = batch["images"].device
    for _ in range(warmup + timed):
        t0 = time.perf_counter()
        step(batch, gen)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms[-timed:]


def _loss_rel(got, want):
    return max(abs(got[k] - v) / max(abs(v), 1e-12) for k, v in want.items())


def _grad_rel(got, want):
    """Largest |difference| / largest |gradient| over the tensors."""
    return max(float((got[n] - g).abs().max()) / (float(g.abs().max()) + 1e-12)
               for n, g in want.items())


def _world1_child(device, tmp, result_path):
    """Phase 8a, in its own process: `tools.train_net` over NCCL at world
    size 1 (--dist-init 127.0.0.1:<port>), phase 6's dataset, full width,
    bf16, batch 8, 8 iterations; then one f32 step without and with DDP from
    the same weights, batch and noise; bf16 batch 8 step times without,
    with, with and again without DDP, and a torch.profiler window over DDP
    steps."""
    torch = _child_setup()
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
    from omni3d_tpu_torch.parallel import dist as dist_lib
    from omni3d_tpu_torch.tools import train_net
    from omni3d_tpu_torch.tools.profile_entry import train_argv
    from omni3d_tpu_torch.tools.synthetic import synthetic_trainer

    device = torch.device(device)
    out_dir = os.path.join(tmp, "ddp_world1")
    argv = train_argv(tmp, out_dir, DDP_STEPS, "--dist-init",
                      f"127.0.0.1:{dist_lib.free_port()}", "--num-processes", "1",
                      "--process-id", "0")
    multilevel_roi_align.launches = 0          # counts of the main path's run only
    multilevel_roi_align.bwd_launches = 0
    t0 = time.perf_counter()
    run = train_net.main(argv)
    _sync(device)
    res = {"entry_wall_s": time.perf_counter() - t0, "iterations": run.iterations,
           "entry_step_ms": run.step_ms, "launches": {
               "forward": multilevel_roi_align.launches,
               "backward": multilevel_roi_align.bwd_launches}}
    del run

    def f32_step():
        cfg = _full_cfg("TPU.COMPUTE_DTYPE", "float32")
        model, _, step, batch = synthetic_trainer(cfg, torch.float32, PLAIN_BS, device, img=IMG)
        logs = step(batch, torch.Generator().manual_seed(0))
        _sync(device)
        return ({k: float(torch.as_tensor(v).detach()) for k, v in logs.items()},
                {n: p.grad.clone() for n, p in model.named_parameters()})

    def bf16_trainer():
        cfg = _full_cfg("TPU.COMPUTE_DTYPE", "bfloat16")
        return synthetic_trainer(cfg, torch.bfloat16, PLAIN_BS, device, img=IMG)

    plain_logs, plain_grads = f32_step()
    again_logs, again_grads = f32_step()   # the plain step's own run-to-run spread
    res["plain_vs_plain_grad_rel"] = _grad_rel(again_grads, plain_grads)
    res["plain_vs_plain_loss_rel"] = _loss_rel(again_logs, plain_logs)
    del again_grads
    _, _, step, batch = bf16_trainer()
    gen = torch.Generator().manual_seed(0)
    res["plain_ms"] = [_timed_steps(step, batch, gen, DDP_TIMED_STEPS)]
    del step, batch
    dist_lib.init_distributed(f"127.0.0.1:{dist_lib.free_port()}", 1, 0, device)
    try:
        ddp_logs, ddp_grads = f32_step()
        model, _, step, batch = bf16_trainer()
        res["ddp_ms"] = [_timed_steps(step, batch, gen, DDP_TIMED_STEPS) for _ in range(2)]
        res["grad_mb_per_step"] = sum(p.numel() * p.element_size()
                                      for p in model.parameters() if p.requires_grad) / 1e6
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILED_DDP_STEPS):
                step(batch, gen)
            _sync(device)
        events = [e for e in prof.events() if "nccl" in e.name.lower()]
        nccl = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        host = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
        res["nccl_device_ms_per_step"] = sum(e.time_range.elapsed_us() for e in nccl) / 1e3 \
            / PROFILED_DDP_STEPS
        res["nccl_device_events_per_step"] = len(nccl) / PROFILED_DDP_STEPS
        res["nccl_host_ops_per_step"] = {n: sum(e.name == n for e in host) / PROFILED_DDP_STEPS
                                         for n in sorted({e.name for e in host})}
        res["nccl_event_names"] = sorted({e.name for e in nccl})
        del model, step, batch
    finally:
        torch.distributed.destroy_process_group()
    _, _, step, batch = bf16_trainer()
    res["plain_ms"].append(_timed_steps(step, batch, gen, DDP_TIMED_STEPS))
    res["loss_rel"] = _loss_rel(ddp_logs, plain_logs)
    res["grad_rel"] = _grad_rel(ddp_grads, plain_grads)
    res["grads_ok"] = all(float((ddp_grads[n] - g).abs().max())
                          <= 1e-3 * float(g.abs().max()) + 1e-6 for n, g in plain_grads.items())
    res["bit_equal_grads"] = all(torch.equal(ddp_grads[n], g) for n, g in plain_grads.items())
    with open(result_path, "w") as f:
        json.dump(res, f)


def _two_rank_child(rank, device, store, out_dir):
    """Phase 8b, rank `rank` of two on `device` (the card) over gloo: one full-width f32
    step on this rank's half of the seeded global batch; the parameters,
    BN statistics and logs after it, the launch counts, and the first pooler
    call's inputs (features, boxes, the output's gradient) held against the
    plain pooler after the counts are read."""
    torch = _child_setup()
    from omni3d_tpu_torch.engine import train as train_mod
    from omni3d_tpu_torch.ops import roi_align_cuda as rac
    from omni3d_tpu_torch.parallel import dist as dist_lib
    from omni3d_tpu_torch.tools.synthetic import synthetic_trainer

    device = dist_lib.init_distributed(store, 2, rank, device, backend="gloo")
    try:
        model, _, step, batch = synthetic_trainer(_full_cfg(*TWO_RANK_OPTS), torch.float32,
                                                  TWO_RANK_BS, device, img=IMG)
        b = TWO_RANK_BS // 2
        local = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
        record = {}
        real, train_mod.multilevel_roi_align = _first_pooler_call_checked(train_mod, record)
        rac.multilevel_roi_align.launches = 0          # counts of the main path's run only
        rac.multilevel_roi_align.bwd_launches = 0
        try:
            t0 = time.perf_counter()
            logs = step(local, torch.Generator().manual_seed(0))
            _sync(device)
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            train_mod.multilevel_roi_align = real
        launches = {"forward": rac.multilevel_roi_align.launches,
                    "backward": rac.multilevel_roi_align.bwd_launches}
        # the kernels against the plain pooler on this rank's recorded inputs
        pooler = _pooler_call_vs_plain(record)
        torch.save({"logs": {k: float(v) for k, v in logs.items()},
                    "model": {k: v.cpu() for k, v in model.state_dict().items()},
                    "launches": launches, "ms": ms, "fwd_max_abs_err": pooler["fwd_max_abs_err"],
                    "bwd_max_abs_err": pooler["bwd_max_abs_err"], "rois": pooler["boxes"]},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _eval_child(rank, device, store, argv, result_path):
    """Phase 8c, rank `rank` of two on `device` (the card) over gloo: `tools.train_net
    --eval-only` inside the process group the child joined."""
    torch = _child_setup()
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
    from omni3d_tpu_torch.parallel import dist as dist_lib
    from omni3d_tpu_torch.tools import train_net

    dist_lib.init_distributed(store, 2, rank, device, backend="gloo")
    try:
        multilevel_roi_align.launches = 0          # counts of the main path's run only
        multilevel_roi_align.bwd_launches = 0
        t0 = time.perf_counter()
        results = train_net.main(argv)
        _sync(device)
        wall = time.perf_counter() - t0
        with open(result_path, "w") as f:
            json.dump({"wall_s": wall, "inference": results["SUNRGBD_test"]["inference"],
                       "AP": {k: v for k, v in results["SUNRGBD_test"].items()
                              if k.startswith(("AP", "AR"))},
                       "launches": {"forward": multilevel_roi_align.launches,
                                    "backward": multilevel_roi_align.bwd_launches}}, f)
    finally:
        torch.distributed.destroy_process_group()


def distributed_path(device, tmp, weights):
    """Phase 8: data parallelism. (a) `tools.train_net` over NCCL at world
    size 1 and the DDP step against the plain one; (b) two ranks sharing the
    card over gloo against a hand-computed DDP step in this process; (c)
    `--eval-only` at world size 2 (gloo, both on the card) against phase 7's
    world-size-1 predictions. Returns (summary, launches)."""
    import pickle

    import numpy as np
    import torch
    from omni3d_tpu_torch.engine.train import compute_losses
    from omni3d_tpu_torch.models.layers import BatchNorm2d
    from omni3d_tpu_torch.models.rcnn3d import build_model
    from omni3d_tpu_torch.parallel.dist import run_spawned
    from omni3d_tpu_torch.solver.build import clip_gradients
    from omni3d_tpu_torch.tools.profile_entry import SPLITS
    from omni3d_tpu_torch.tools.synthetic import synthetic_trainer
    from omni3d_tpu_torch.utils.checkpoint import load_checkpoint

    summary = {}
    # ---- 8a: world size 1 over NCCL ----
    path = os.path.join(tmp, "ddp_world1.json")
    t0 = time.perf_counter()
    run_spawned(_world1_child, [(str(device), tmp, path)], PHASE8_TIMEOUT_S)
    with open(path) as f:
        a = json.load(f)
    a["phase_wall_s"] = time.perf_counter() - t0
    out_dir = os.path.join(tmp, "ddp_world1")
    with open(os.path.join(out_dir, "metrics.json")) as f:
        logged = [json.loads(line) for line in f]
    bad = [(r["iteration"], k) for r in logged for k, v in r.items() if not np.isfinite(v)]
    assert not bad, bad
    assert a["iterations"] == list(range(DDP_STEPS)), a["iterations"]
    assert a["launches"] == {"forward": DDP_STEPS, "backward": DDP_STEPS}, a["launches"]
    state, _ = load_checkpoint(os.path.join(out_dir, "model_final.ckpt"))
    build_model(_full_cfg(), device=device).load_state_dict(state["model"], strict=True)
    assert a["loss_rel"] <= 1e-4 and a["grads_ok"], (a["loss_rel"], a["grad_rel"])
    a.update(ddp_ms_median=[statistics.median(m) for m in a["ddp_ms"]],
             plain_ms_median=[statistics.median(m) for m in a["plain_ms"]])
    print(f"  8a world size 1 over NCCL: train_net {DDP_STEPS} iterations, launches "
          f"{a['launches']}, metrics finite, model_final.ckpt loads into build_model; f32 bs "
          f"{PLAIN_BS} step with vs without DDP: losses max rel {a['loss_rel']:.2e} (tol 1e-4), "
          f"gradients max |diff|/max|g| {a['grad_rel']:.2e} (tol 1e-3), bit-equal "
          f"{a['bit_equal_grads']}; two plain steps differ by {a['plain_vs_plain_grad_rel']:.2e}")
    print(f"  8a bf16 bs {PLAIN_BS} ms/step (median of {DDP_TIMED_STEPS}, in turns): without DDP "
          f"{a['plain_ms_median'][0]:.1f}, with DDP {a['ddp_ms_median'][0]:.1f} and "
          f"{a['ddp_ms_median'][1]:.1f}, without again {a['plain_ms_median'][1]:.1f}; NCCL device "
          f"ms per step {a['nccl_device_ms_per_step']:.3f} ({a['nccl_device_events_per_step']:.1f} "
          f"kernels: {a['nccl_event_names']}; host NCCL ops per step "
          f"{a['nccl_host_ops_per_step']}); {a['grad_mb_per_step']:.1f} MB of gradients "
          "all-reduced per step")
    summary["world1_nccl"] = a

    # ---- 8b: two ranks on the one card over gloo, against a hand-computed DDP step ----
    out = os.path.join(tmp, "two_ranks")
    os.makedirs(out, exist_ok=True)
    store = "file://" + os.path.join(out, "store")
    t0 = time.perf_counter()
    run_spawned(_two_rank_child, [(r, str(device), store, out) for r in range(2)],
                PHASE8_TIMEOUT_S)
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(2)]
    for k, v in ranks[0]["model"].items():
        if not torch.equal(ranks[1]["model"][k], v):
            raise AssertionError(f"8b: the two ranks' {k} differ")
    model, opt, _, batch = synthetic_trainer(_full_cfg(*TWO_RANK_OPTS), torch.float32,
                                             TWO_RANK_BS, device, img=IMG)
    params = [p for g in opt.param_groups for p in g["params"]]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bns = [b for m in model.modules() if isinstance(m, BatchNorm2d)
           for b in (m.running_mean, m.running_var)]
    b = TWO_RANK_BS // 2
    grads, stats, logs = [], [], []
    for r in range(2):
        model.load_state_dict(before)
        model.zero_grad(set_to_none=True)
        total, losses, metrics = compute_losses(
            model, {k: v[r * b:(r + 1) * b] for k, v in batch.items()},
            torch.Generator().manual_seed(0), img_offset=r * b)
        total.backward()
        grads.append([p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                      for p in params])
        stats.append([s.clone() for s in bns])
        logs.append({"total_loss": float(total), **{k: float(v) for k, v in losses.items()},
                     **{k: float(v) for k, v in metrics.items()}})
    model.load_state_dict(before)
    for p, g0, g1 in zip(params, *grads):
        p.grad = (g0 + g1) / 2
    for s, s0, s1 in zip(bns, *stats):
        s.copy_((s0 + s1) / 2)
    clip_gradients(model.cfg, params)
    opt.step()
    want = model.state_dict()
    got = ranks[0]["model"]
    bn_keys = {k for k in want if k.endswith(("running_mean", "running_var"))}
    update_rel = bn_rel = 0.0
    for k, w in want.items():
        g = got[k].to(device)
        if k in bn_keys:
            assert torch.allclose(g, w, rtol=1e-4, atol=1e-5), k
            bn_rel = max(bn_rel, float(((g - w).abs() / w.abs().clamp(min=1e-5)).max()))
        elif w.is_floating_point():
            u_want, u_got = (w - before[k]).double(), (g - before[k]).double()
            tol = 1e-3 * float(u_want.abs().max()) + float(before[k].abs().max()) * 2.0 ** -23
            err = float((u_got - u_want).abs().max())
            assert err <= tol, k
            if float(u_want.abs().max()) > 0:
                update_rel = max(update_rel, err / float(u_want.abs().max()))
    loss_rel = max(abs(ranks[0]["logs"][k] - (l0 + l1) / 2) / max(abs(l0 + l1) / 2, 1e-12)
                   for k, l0, l1 in ((k, logs[0][k], logs[1][k]) for k in logs[0]))
    assert loss_rel <= 1e-4, loss_rel
    for r in ranks:
        assert r["launches"] == {"forward": 1, "backward": 1}, r["launches"]
    summary["two_ranks_one_card_gloo"] = dict(
        wall_s=wall, step_ms=[r["ms"] for r in ranks], loss_rel=loss_rel,
        update_rel=update_rel, bn_rel=bn_rel,
        fwd_max_abs_err=max(r["fwd_max_abs_err"] for r in ranks),
        bwd_max_abs_err=max(r["bwd_max_abs_err"] for r in ranks),
        rois_per_rank=ranks[0]["rois"], launches=[r["launches"] for r in ranks])
    print(f"  8b two ranks sharing the card over gloo, f32 bs {TWO_RANK_BS // 2} each: parameters "
          f"bit-equal across ranks and within {update_rel:.2e} of the hand-computed DDP step's "
          f"largest update per tensor (tol 1e-3), BN statistics the mean of the halves' (max rel "
          f"{bn_rel:.2e}), losses max rel {loss_rel:.2e}; per rank one "
          f"forward and one backward launch; kernels vs plain on each rank's pooler inputs "
          f"{ranks[0]['rois']}: forward max|k-p| "
          f"{summary['two_ranks_one_card_gloo']['fwd_max_abs_err']:.3e}, backward "
          f"{summary['two_ranks_one_card_gloo']['bwd_max_abs_err']:.3e}; step "
          f"{', '.join(f'{r['ms']:.0f}' for r in ranks)} ms (two processes sharing one card, "
          "first step)")
    del model, opt, batch, grads, stats, before, want, got, ranks

    # ---- 8c: --eval-only at world size 2, both ranks on the card over gloo ----
    eval_out = os.path.join(tmp, "eval_world2")
    argv = ["--config-file", os.path.join(ROOT, "configs", "cubercnn_DLA34_FPN.yaml"),
            "--datasets-root", os.path.join(tmp, "Omni3D"), "--device", str(device),
            "--eval-only", "--weights", weights, "OUTPUT_DIR", eval_out,
            "DATASETS.TRAIN", str(tuple(SPLITS)), "DATASETS.TEST", "('SUNRGBD_test',)",
            "TPU.COMPUTE_DTYPE", "bfloat16", "TPU.EVAL_BATCH_SIZE", "1", "SEED", "0"]
    store = "file://" + os.path.join(tmp, "eval_store")
    paths = [os.path.join(tmp, f"eval_rank{r}.json") for r in range(2)]
    t0 = time.perf_counter()
    run_spawned(_eval_child, [(r, str(device), store, argv, paths[r]) for r in range(2)],
                PHASE8_TIMEOUT_S)
    wall = time.perf_counter() - t0
    res = []
    for p in paths:
        with open(p) as f:
            res.append(json.load(f))

    def load(run_dir):
        files = os.path.join(run_dir, "inference", "iter_final")
        with open(os.path.join(files, "SUNRGBD_test", "instances_predictions.pkl"), "rb") as f:
            preds = pickle.load(f)
        with open(os.path.join(files, "omni3d_results.json")) as f:
            ap = {k: v for k, v in json.load(f)["SUNRGBD_test"].items()
                  if k.startswith(("AP", "AR"))}
        by_image = {}
        for p in preds:
            by_image.setdefault(p["image_id"], []).append(p)
        return by_image, ap
    got, got_ap = load(eval_out)
    want, want_ap = load(os.path.join(tmp, "eval_bs1"))
    assert got.keys() == want.keys() and want, (
        f"images with predictions: {len(got)} at world size 2, {len(want)} at world size 1; "
        f"differing {sorted(set(got) ^ set(want))}")
    worst = 0.0
    for image, ps in want.items():
        qs = got[image]
        assert len(ps) == len(qs), (image, len(ps), len(qs))
        for p, q in zip(ps, qs):
            assert p["category_id"] == q["category_id"], image
            worst = max(worst, abs(p["score"] - q["score"]),
                        float(np.abs(np.subtract(p["bbox"], q["bbox"])).max()))
    assert worst <= 1e-5, worst
    same_ap = all(got_ap[k] == v or (v != v and got_ap[k] != got_ap[k])
                  for k, v in want_ap.items()) and got_ap.keys() == want_ap.keys()
    assert same_ap, (got_ap, want_ap)
    for r in res:
        assert r["AP"] == res[0]["AP"] or all(
            r["AP"][k] == v or v != v for k, v in res[0]["AP"].items())
    n_img = sum(r["inference"]["images"] for r in res)
    launches_c = {k: sum(r["launches"][k] for r in res) for k in ("forward", "backward")}
    n_batches = sum(len(r["inference"]["batches"]) for r in res)
    assert launches_c == {"forward": 2 * n_batches, "backward": 0}, launches_c
    per_rank = [dict(images=r["inference"]["images"],
                     ms_per_img=(r["inference"]["data_s"] + r["inference"]["compute_s"]) * 1e3
                     / r["inference"]["images"],
                     compute_ms_per_img=r["inference"]["compute_s"] * 1e3
                     / r["inference"]["images"], wall_s=r["wall_s"]) for r in res]
    summary["eval_world2_one_card_gloo"] = dict(
        images=n_img, wall_s=wall, per_rank=per_rank, max_pred_diff=worst,
        ap_equal=same_ap, launches=launches_c)
    print(f"  8c --eval-only at world size 2 (gloo, two processes sharing one card): "
          f"{n_img} images, {sum(len(v) for v in got.values())} gathered predictions equal "
          f"phase 7's per image (max |diff| {worst:.1e}), AP dicts equal; per rank "
          + "; ".join(f"{r['images']} images {r['ms_per_img']:.1f} ms/img (compute "
                      f"{r['compute_ms_per_img']:.1f})" for r in per_rank)
          + f"; wall {wall:.1f} s")
    launches = {k: a["launches"][k] + launches_c[k]
                + sum(r[k] for r in summary["two_ranks_one_card_gloo"]["launches"])
                for k in ("forward", "backward")}
    return summary, launches

# phase 9: the other backbones at full width
RESNET_CONFIG = "cubercnn_ResNet34_FPN.yaml"
BACKBONE_TRAIN_BS = 32           # 9a: the synthetic bf16 training batch
BACKBONE_ENTRY_STEPS = 8         # 9a: train_net iterations, bf16 bs 8
BACKBONE_BS = 8                  # 9b: one inference batch and one training batch per model
# 9b: (label, config, KEY VALUE overrides) of every other builder and variant
OTHER_BACKBONES = (
    [(f"ResNet-{d}", RESNET_CONFIG, ("MODEL.RESNETS.DEPTH", str(d))) for d in (18, 50, 101)]
    + [("DenseNet-121", "cubercnn_densenet_FPN.yaml", ()),
       ("MNASNet-1.0", "cubercnn_mnasnet_FPN.yaml", ()),
       ("ShuffleNetV2-x1.0", "cubercnn_shufflenet_FPN.yaml", ())]
    + [(v, "cubercnn_DLA34_FPN.yaml", ("MODEL.DLA.TYPE", v))
       for v in ("dla46_c", "dla46x_c", "dla60x_c", "dla60", "dla60x", "dla102", "dla102x",
                 "dla102x2", "dla169")])


def _train_steps(cfg, device, bs, warmup, timed, check_pooler=False):
    """bf16 steps of `tools.synthetic.synthetic_trainer(cfg, ...)` at 512
    px: one forward and one backward launch per step, finite losses; with
    `check_pooler` the first warm-up step's pooler call is held against the
    plain versions right after it, and the peak memory is taken over the
    steps after that one. Returns (row, launches)."""
    import torch
    from omni3d_tpu_torch.engine import train as train_mod
    from omni3d_tpu_torch.tools.synthetic import synthetic_trainer

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model, opt, step, batch = synthetic_trainer(cfg, torch.bfloat16, bs, device, img=IMG)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    losses = []

    def checked(batch, gen):
        before = _launch_counts()
        logs = step(batch, gen)
        after = _launch_counts()
        assert (after[0] - before[0], after[1] - before[1]) == (1, 1), (before, after)
        bad = {k: float(v) for k, v in logs.items() if not torch.isfinite(torch.as_tensor(v))}
        assert not bad, bad
        losses.append(float(logs["total_loss"]))

    gen = torch.Generator().manual_seed(0)
    pooler = None
    if check_pooler:
        record = {}
        real, train_mod.multilevel_roi_align = _first_pooler_call_checked(train_mod, record)
        try:
            checked(batch, gen)
        finally:
            train_mod.multilevel_roi_align = real
        pooler = _pooler_call_vs_plain(record)
        del record
        torch.cuda.empty_cache()
        warmup -= 1
    torch.cuda.reset_peak_memory_stats()
    ms = _timed_steps(checked, batch, gen, timed, warmup)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(ms)
    row = dict(bs=bs, build_s=build_s, ms_per_step=med, ms_steps=ms, img_per_s=bs * 1e3 / med,
               peak_mem_gib=peak / 2 ** 30, losses=losses, skipped=step.state["skipped"],
               remat_backbone=bool(cfg.TPU.REMAT_BACKBONE))
    if pooler is not None:
        row["first_pooler_call_vs_plain"] = pooler
    n = len(losses)
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return row, {"forward": n, "backward": n}


def _add(total, launches):
    for k in total:
        total[k] += launches[k]


def resnet_entry_and_eval(device, tmp):
    """9a: `tools.train_net` with configs/cubercnn_ResNet34_FPN.yaml on phase
    6's dataset (bf16, bs 8, BACKBONE_ENTRY_STEPS iterations), then
    `--eval-only` with its model_final.ckpt on phase 7's SUNRGBD_test at
    TPU.EVAL_BATCH_SIZE 8. Returns (summary, launches)."""
    import numpy as np
    import torch
    from omni3d_tpu_torch.tools import train_net
    from omni3d_tpu_torch.tools.profile_entry import SPLITS, iteration_times, train_argv

    out_dir = os.path.join(tmp, "resnet34_output")
    before = _launch_counts()
    t0 = time.perf_counter()
    run = train_net.main(train_argv(tmp, out_dir, BACKBONE_ENTRY_STEPS, config=RESNET_CONFIG))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = _launch_counts()
    train_launches = {"forward": after[0] - before[0], "backward": after[1] - before[1]}
    assert train_launches == {"forward": BACKBONE_ENTRY_STEPS,
                              "backward": BACKBONE_ENTRY_STEPS}, train_launches
    assert run.iterations == list(range(BACKBONE_ENTRY_STEPS))
    assert run.model.cfg.MODEL.BACKBONE.NAME == "build_resnet_from_vision_fpn_backbone"
    for f in ("model_final.ckpt", "metrics.json", "category_meta.json"):
        assert os.path.exists(os.path.join(out_dir, f)), f
    with open(os.path.join(out_dir, "metrics.json")) as f:
        logged = [json.loads(line) for line in f]
    bad = [(r["iteration"], k) for r in logged for k, v in r.items() if not np.isfinite(v)]
    assert not bad, bad
    times = iteration_times([run])

    name = "SUNRGBD_test"
    eval_dir = os.path.join(tmp, "resnet34_eval")
    argv = ["--config-file", os.path.join(ROOT, "configs", RESNET_CONFIG),
            "--datasets-root", os.path.join(tmp, "Omni3D"), "--device", device.type,
            "--eval-only", "--weights", os.path.join(out_dir, "model_final.ckpt"),
            "OUTPUT_DIR", eval_dir, "DATASETS.TRAIN", str(tuple(SPLITS)),
            "DATASETS.TEST", str((name,)), "TPU.COMPUTE_DTYPE", "bfloat16",
            "TPU.EVAL_BATCH_SIZE", "8", "SEED", "0"]
    before = _launch_counts()
    t0 = time.perf_counter()
    results = train_net.main(argv)
    torch.cuda.synchronize()
    eval_wall = time.perf_counter() - t0
    after = _launch_counts()
    n_batches = len(results[name]["inference"]["batches"])
    eval_launches = {"forward": after[0] - before[0], "backward": after[1] - before[1]}
    assert eval_launches == {"forward": 2 * n_batches, "backward": 0}, eval_launches
    files = os.path.join(eval_dir, "inference", "iter_final")
    assert os.path.exists(os.path.join(files, "omni3d_results.json"))
    assert os.path.exists(os.path.join(files, name, "instances_predictions.pkl"))
    aps = {k: v for k, v in results[name].items() if k.startswith(("AP", "AR"))}
    bad = {k: v for k, v in aps.items() if not _ap_ok(k, v)}
    assert aps and not bad, bad
    print(f"  train_net ResNet34-FPN: {BACKBONE_ENTRY_STEPS} iterations, "
          f"{times['ms_per_step']:.1f} ms/step (median at seen shapes), "
          f"{times['img_per_s']:.1f} img/s, last loss {logged[-1]['total_loss']:.4f}, "
          f"wall {wall:.1f} s; --eval-only {name} at bs 8: {n_batches} batches, AP2D "
          f"{results[name]['AP2D']:.3f} AP3D {results[name]['AP3D']:.3f}, wall {eval_wall:.1f} s")
    print("  AP dict: " + json.dumps(aps))
    launches = {k: train_launches[k] + eval_launches[k] for k in train_launches}
    summary = dict(train=dict(steps=BACKBONE_ENTRY_STEPS, wall_s=wall,
                              last_total_loss=logged[-1]["total_loss"], **times),
                   eval=dict(split=name, batches=n_batches, wall_s=eval_wall, aps=aps,
                             inference=results[name]["inference"]))
    return summary, launches


def other_backbone(device, label, config, opts):
    """9b: one full-width model: one bf16 bs-8 inference at 512 px after a
    warm-up call (two forward launches per call, `check_outputs`; the pose
    bias at the identity as in `main_path`), then one
    bf16 bs-8 training step after a warm-up step (one forward and one
    backward launch per step, finite losses). Returns (row, launches)."""
    import numpy as np
    import torch
    from omni3d_tpu_torch.models import rcnn3d
    from omni3d_tpu_torch.tools.synthetic import condition_pose_bias_

    cfg = _config(config, *opts)
    kw = rcnn3d.inference_kwargs(cfg)
    raw = np.random.default_rng(0).integers(0, 255, (BACKBONE_BS, IMG, IMG, 3), dtype=np.uint8)
    images = rcnn3d.preprocess(torch.from_numpy(raw).to(device), cfg.MODEL.PIXEL_MEAN,
                               cfg.MODEL.PIXEL_STD)
    K = torch.tensor([[512.0, 0, IMG / 2], [0, 512.0, IMG / 2], [0, 0, 1]], device=device)
    Ks, ratio = K.expand(BACKBONE_BS, 3, 3).contiguous(), torch.ones(BACKBONE_BS, device=device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = rcnn3d.build_model(cfg, device=device, dtype=torch.bfloat16, seed=0)
    condition_pose_bias_(model)
    before = _launch_counts()
    rcnn3d.inference(model, images, Ks, ratio, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = rcnn3d.inference(model, images, Ks, ratio, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    after = _launch_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (4, 0), (before, after)
    check_outputs(out, BACKBONE_BS, kw["topk"], cfg.MODEL.ROI_HEADS.NUM_CLASSES)
    peak = torch.cuda.max_memory_allocated()
    params_m = sum(p.numel() for p in model.backbone.bottom_up.parameters()) / 1e6
    valid = int(out["valid"].sum())
    del model, out
    train, train_launches = _train_steps(cfg, device, BACKBONE_BS, 1, 1)
    row = dict(model=label, config=config, opts=list(opts), trunk_params_m=params_m,
               inference=dict(bs=BACKBONE_BS, build_and_warmup_s=build_s, ms_per_batch=ms,
                              img_per_s=BACKBONE_BS * 1e3 / ms, peak_mem_gib=peak / 2 ** 30,
                              detections=valid),
               training=train)
    print(f"  {label:18s} trunk {params_m:6.2f} M params; inference bs {BACKBONE_BS}: build + "
          f"warm-up {build_s:.1f} s, {ms:.1f} ms, {valid} detections, peak "
          f"{peak / 2 ** 30:.2f} GiB; training bs "
          f"{BACKBONE_BS}: build {train['build_s']:.1f} s, steps {train['ms_steps'][0]:.1f} ms "
          f"(after one warm-up), loss {train['losses'][-1]:.4f}, peak "
          f"{train['peak_mem_gib']:.2f} GiB")
    return row, {"forward": 4 + train_launches["forward"],
                 "backward": train_launches["backward"]}


def backbones_path(device, tmp, dla_inference, dla_training):
    """Phase 9: ResNet34-FPN as phases 3, 5, 6 and 7 drive DLA-34 (9a), and
    every other builder and DLA variant at full width (9b). Returns
    (summary, launches)."""
    launches = {"forward": 0, "backward": 0}
    print("  9a: ResNet34-FPN (configs/cubercnn_ResNet34_FPN.yaml)")
    timings, inf_launches, plain = main_path(device, RESNET_CONFIG)
    _add(launches, {"forward": inf_launches, "backward": 0})
    cfg = _config(RESNET_CONFIG)
    train, train_launches = _train_steps(cfg, device, BACKBONE_TRAIN_BS, WARMUP_STEPS,
                                         TIMED_STEPS, check_pooler=True)
    _add(launches, train_launches)
    pc = train["first_pooler_call_vs_plain"]
    print(f"  bf16 bs={BACKBONE_TRAIN_BS} steps: {train['ms_per_step']:.1f} ms/step (median of "
          f"{TIMED_STEPS}; {', '.join(f'{t:.1f}' for t in train['ms_steps'])}), "
          f"{train['img_per_s']:.1f} img/s, peak {train['peak_mem_gib']:.2f} GiB, build "
          f"{train['build_s']:.1f} s; first pooler call ({pc['boxes']} RoIs, {pc['dtype']}) vs "
          f"plain: forward max|k-p| {pc['fwd_max_abs_err']:.3e} (tol {pc['fwd_tol']:.1e}), "
          f"backward on g / 2^floor(log2 {pc['g_max_abs']:.3e}) {pc['bwd_max_abs_err']:.3e} "
          f"(f32 tol {pc['bwd_f32_tol']:.3e} + 1 ULP)")
    remat, remat_launches = _train_steps(_config(RESNET_CONFIG, "TPU.REMAT_BACKBONE", "True"),
                                         device, BACKBONE_TRAIN_BS, WARMUP_STEPS, TIMED_STEPS)
    _add(launches, remat_launches)
    print(f"  bf16 bs={BACKBONE_TRAIN_BS} with TPU.REMAT_BACKBONE: {remat['ms_per_step']:.1f} "
          f"ms/step, peak {remat['peak_mem_gib']:.2f} GiB (without: "
          f"{train['peak_mem_gib']:.2f} GiB)")
    entry, entry_launches = resnet_entry_and_eval(device, tmp)
    _add(launches, entry_launches)
    dla_bf16 = {r["bs"]: r["ms_per_batch"] for r in dla_inference if r["dtype"] == "bfloat16"}
    res_bf16 = {r["bs"]: r["ms_per_batch"] for r in timings if r["dtype"] == "bfloat16"}
    dla_step = next(r for r in dla_training if r["dtype"] == "bfloat16")
    print("  on this card, bf16: inference ms/batch DLA-34 vs ResNet-34: " + ", ".join(
        f"bs {bs} {dla_bf16[bs]:.2f} vs {res_bf16[bs]:.2f}" for bs in sorted(dla_bf16))
          + f"; training bs {dla_step['bs']} {dla_step['ms_per_step']:.1f} vs "
          f"{train['ms_per_step']:.1f} ms/step, peak {dla_step['peak_mem_gib']:.2f} vs "
          f"{train['peak_mem_gib']:.2f} GiB")

    print("  9b: every other builder and DLA variant, full width, bf16, bs "
          f"{BACKBONE_BS}, 512 px")
    rows = []
    for label, config, opts in OTHER_BACKBONES:
        row, row_launches = other_backbone(device, label, config, opts)
        rows.append(row)
        _add(launches, row_launches)
    summary = {"resnet34": dict(inference=timings, kernel_vs_plain_pooler=plain, training=train,
                                training_remat_backbone=remat, entry_point=entry["train"],
                                evaluation=entry["eval"],
                                dla34_same_card=dict(inference_bf16_ms=dla_bf16,
                                                     training_bf16=dla_step)),
               "others": rows, "launches": launches}
    return summary, launches


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
    print("[1/9] build")
    path, secs, log = roi_align_cuda.build()
    print(f"  {os.path.relpath(path, ROOT)} built in {secs:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip()[:160])

    print("[2/9] forward kernel vs plain PyTorch version")
    main_case, worst = kernel_vs_plain(device)

    print("[3/9] inference main path: DLA34-FPN inference at 512 px")
    timings, launches, _ = main_path(device)

    print("[4/9] backward kernel vs plain PyTorch version")
    worst_bwd = bwd_vs_plain(device)
    at_train = time_kernels_at_train_shape(device)

    print("[5/9] training main path: DLA34-FPN training steps at 512 px")
    train_rows, train_launches, plain_cmp = train_path(device)

    with tempfile.TemporaryDirectory() as tmp:
        print("[6/9] training entry point: tools.train_net on a synthetic Omni3D-format dataset")
        entry, entry_launches, weights = entry_point_path(device, tmp)

        print("[7/9] evaluation: tools.train_net --eval-only on synthetic test splits")
        evaluation, eval_launches = evaluation_path(device, tmp, weights)

        print("[8/9] data parallelism: DDP over NCCL at world size 1, two ranks on the card "
              "over gloo, --eval-only at world size 2")
        distributed, ddp_launches = distributed_path(device, tmp, weights)

        print("[9/9] other backbones at full width: ResNet34-FPN as phases 3 and 5-7 drive "
              "DLA-34, then every other builder and DLA variant")
        backbones, bb_launches = backbones_path(device, tmp, timings, train_rows)

    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "omni3d_tpu")]
    assert not bad, bad
    print("inference: " + json.dumps(timings))
    print("training: " + json.dumps(dict(steps=train_rows, plain_pooler_step=plain_cmp)))
    print("training entry point: " + json.dumps(entry))
    print("evaluation: " + json.dumps(evaluation))
    print("distributed: " + json.dumps(distributed))
    print("backbones: " + json.dumps(backbones))
    # phase 9's kernel-vs-plain checks on ResNet-34's own pooler inputs (its
    # random-weight maps are larger than DLA-34's, so are the absolute errors)
    bb_pooler = backbones["resnet34"]["training"]["first_pooler_call_vs_plain"]
    bb_plain = backbones["resnet34"]["kernel_vs_plain_pooler"]
    bb_fwd_err = max(bb_pooler["fwd_max_abs_err"], bb_plain["pooled_max_abs_err"])
    print(card)
    print(json.dumps({"kernels": [{
        "name": "multilevel_roi_align_fwd", "route": "cuda",
        "source": "omni3d_tpu_torch/csrc/roi_align_fwd.cu",
        "replaces": "omni3d_tpu/ops/roi_align_pallas.py:658",
        "also_replaces": "omni3d_tpu/ops/roi_align_pallas.py:469",
        "launches": (launches + train_launches["forward"] + entry_launches["forward"]
                     + eval_launches["forward"] + ddp_launches["forward"]
                     + bb_launches["forward"]),
        "launches_by_path": {"inference": launches, "training": train_launches["forward"],
                             "training_entry_point": entry_launches["forward"],
                             "evaluation": eval_launches["forward"],
                             "distributed": ddp_launches["forward"],
                             "backbones": bb_launches["forward"]},
        "max_abs_err": max(worst, at_train["fwd_max_abs_err"],
                           evaluation["roi_align_fwd_max_abs_err"],
                           distributed["two_ranks_one_card_gloo"]["fwd_max_abs_err"],
                           bb_fwd_err),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None,
        "timed_case": f"N={POOLER_BOXES[0]} per image x B=2, canonical, bfloat16, "
                      "sampling_ratio 0 (whole wrapper, routing included)",
        "train_shape": {k: at_train[k] for k in ("fwd_max_abs_err", "fwd_ms", "fwd_plain_ms",
                                                 "fwd_bound_ms", "fwd_bound_by")},
        "backbones_vs_plain": {"resnet34_f32_inference": bb_plain,
                               "resnet34_bf16_train_step": {
                                   k: bb_pooler[k] for k in ("fwd_max_abs_err", "fwd_tol",
                                                             "fwd_mismatch")}},
    }, {
        "name": "multilevel_roi_align_bwd", "route": "cuda",
        "source": "omni3d_tpu_torch/csrc/roi_align_bwd.cu",
        "replaces": "omni3d_tpu/ops/roi_align_bwd_pallas.py:61",
        "launches": (train_launches["backward"] + entry_launches["backward"]
                     + ddp_launches["backward"] + bb_launches["backward"]),
        "launches_by_path": {"training": train_launches["backward"],
                             "training_entry_point": entry_launches["backward"],
                             "evaluation": eval_launches["backward"],
                             "distributed": ddp_launches["backward"],
                             "backbones": bb_launches["backward"]},
        "max_abs_err": max(worst_bwd, at_train["bwd_max_abs_err"],
                           distributed["two_ranks_one_card_gloo"]["bwd_max_abs_err"],
                           bb_pooler["bwd_max_abs_err"]),
        "max_abs_err_train_shape": at_train["bwd_max_abs_err"],
        "ms": at_train["bwd_ms"], "plain_ms": at_train["bwd_plain_ms"],
        "bound_ms": at_train["bwd_bound_ms"], "bound_by": at_train["bwd_bound_by"],
        "library_ms": None,
        "timed_case": f"N={TRAIN_ROIS} per image x B=32, canonical, bfloat16, "
                      "sampling_ratio 0 (wrapper: torch.empty outputs, launch)",
        "bit_reproducible": True,
        "backbones_vs_plain": {"resnet34_bf16_train_step": {
            k: bb_pooler[k] for k in ("bwd_max_abs_err", "bwd_f32_tol")}},
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
