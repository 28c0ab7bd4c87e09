#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on an NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card
    python3 chip_smoke.py --gate-probe N   # only phase 5's old gate state, N times

Phases (each raises on failure):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     build the port's kernel library from omni3d_tpu_torch/csrc (both
     multilevel ROIAlign kernels, forward and backward, the two NMS
     kernels and the train-mode BatchNorm kernels), one nvcc per source
     started together;
  2. the forward kernel vs its plain PyTorch version at the inference
     path's shapes (512 px pyramid, C = 256, B = 2, N = 1000 and 100 boxes),
     both routings, sampling_ratio 0 and 2, float32 and bfloat16, with times;
  3. inference main path: full-width DLA34-FPN Cube R-CNN inference at
     512 px (configs/cubercnn_DLA34_FPN.yaml, seeded random weights) at
     batch 1 and 8, float32 with TF32 off and bfloat16, the 6D pose bias at
     the identity (`condition_pose_bias_`, as the training path does at
     random weights): exactly two forward and no backward launches per
     call and two launches of each NMS kernel (the RPN's and the per-class
     NMS), output contract and sanity checks, ms per batch; then one float32
     call with the plain pooler (pooled features within phase 2's tolerance
     times max(1, largest pooled magnitude), scores within 1e-4, boxes
     within 1e-2 px) and one with `nms_mask_plain` patched in (every output
     equal to the kernels' call);
  4. the backward kernel vs the plain backward at the training path's
     shapes (B = 2, N = 640 per image), both routings, sampling_ratio 0 and
     2, float32 and bfloat16, the transpose identity, with times (the
     kernel as its wrapper: torch.empty outputs, launch); both kernels held
     against their plain versions and timed at the bf16 training batch
     (B = 32, N = 640), and two backward calls there held bit-equal;
  5. training main path: full-width DLA34-FPN training steps at 512 px on
     synthetic batches (float32 TF32 off at batch 8, bfloat16 at batch 32):
     exactly one forward and one backward launch and one launch of each NMS
     kernel per step, each step's 39 train-mode BN calls through the BN
     kernels (39 forward and 37 backward launches, none through the plain
     formula), finite losses,
     parameters and BN statistics moving, ms/step, img/s, peak memory; a
     NaN batch the stabilizer skips; one float32 step with the plain pooler
     (forward and backward) against the kernels' step, compared with
     cuDNN's deterministic algorithms at two reproducible states: the
     seeded weights of a freshly built model, and those weights after the
     f32 run's 7 steps replayed with noise from a fixed generator. At both,
     the kernels' gradient error is at most CONTROL_MULTIPLE times that of
     the plain pooler against itself nudged by two ULPs, and the kernels
     with their backward scaled by 1.05 (a planted fault) exceed it; at the
     replayed state also losses rel 1e-4 and gradients 1e-3 of each
     tensor's largest, which the planted fault fails. Logged beside them,
     each with its worst tensor and the cube losses' L1 signs, chamfer
     argmins, ROI-head ReLU signs and uncertainty clamps that differ
     between the two steps: the kernels against themselves, and the
     comparison from the state after the timed steps;
  6. the training entry point: a synthetic Omni3D-format dataset written
     from a seed (48 PPM images at SUN RGB-D's 530 x 730, 16 PNG images at
     KITTI's 375 x 1242, the 50 categories, 1-20 objects each), then
     `tools.train_net` on configs/cubercnn_DLA34_FPN.yaml at full width in
     bfloat16 (the 25 training scales, 8 shape buckets, batch 8, 4 loader
     workers, a checkpoint every 8 iterations) for 24 iterations and again
     with --resume to 32: finite losses, the checkpoint files and
     metrics.json, the resume at iteration 24, the priors buffers equal to
     compute_priors of the dataset, one forward and one backward launch per
     step, every train-mode BN call through the BN kernels, one batch
     normalised on the card bit-equal to the numpy collate;
     the distinct shapes, ms/step (the first step at each shape apart), ms
     blocked on the loader, img/s, the device busy share (torch.profiler,
     steps 10-14) and the peak memory;
  7. evaluation: two synthetic test splits written from a seed (32 PPM
     images at SUN RGB-D's 530 x 730, 8 PNG images at KITTI's 375 x 1242),
     then `tools.train_net --eval-only` with phase 6's model_final.ckpt at
     TPU.EVAL_BATCH_SIZE 1 and 8 (bfloat16, full width): the result files,
     every AP value a percentage or the protocol's -1 / NaN, one CUDA graph
     per padded batch shape (four forward launches through the wrapper per
     capture, none per replay, no backward); the forward kernel's
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
     forward and one backward launch, finite losses) each; in every
     training step of 9a and 9b each train-mode BN call goes through the BN
     kernels and none through the plain formula; with build and
     warm-up seconds, ms and peak memory; inference models with the pose
     bias as in phase 3. It prints the `backbones:` JSON line;
 10. the demo: every JPEG fixture of tests/data/jpeg decoded bit-equal to
     its committed cv2 decode (the progressive one refused), the decode ms
     of the 640 x 480 q95 file; `tools.demo` at full width in bfloat16 with
     phase 6's model_final.ckpt on the 640 x 480 and 1242 x 375 fixtures at
     threshold 0: exactly two forward launches per image, the first pooler
     call at each shape held against the plain pooler (phase 2's
     tolerances), each image's detections against a direct
     `rcnn3d.inference` call on the same input (phase 3's tolerances), the
     _boxes / _novel / _bev PNGs read back at the input size / 512 x 512 /
     400 x 400, ms per image by stage and the inference again at each
     shape (steady state); `render_depth_map` on the card and
     on the CPU on 20 boxes at 640 x 480 (silhouettes and nearest-instance
     indices equal, depth within 1e-5 relative); `tools.train_net` for 5
     iterations on phase 6's dataset with VIS_PERIOD 2 and TEST.EVAL_PERIOD
     4 on phase 7's splits: the GT-vs-prediction panels after iterations 2
     and 4, the evaluation's sample dumps, and the dumps at score threshold
     0 where the sampled images have predictions. It prints the `demo:`
     JSON line;
 11. the measurement tools at full width (DLA34-FPN, bf16, 512 px), each
     through its `run` with the launch counts at 0: `tools.bench` at batch
     1, 8 and 32 (3 rounds x 10 calls of `inference_step` and of eager
     `inference` in turns; the bs 32 outputs of its last graphed call equal
     a direct `inference` call; the box and cube poolers
     on that batch against the plain pooler with phase 2's tolerances),
     `tools.bench_train` at bf16 batch 32 (3 rounds x 3 steps),
     `tools.profile_stages` at batch 8 (its stage chain's outputs equal
     `inference`'s) and `tools.profile_backbone` at batch 32 (its blocks in
     order give `model.features` exactly), 2 rounds each: two forward
     launches per inference call and one forward and one backward per
     training step, two launches of each NMS kernel per inference call and
     one per training step, by the wrappers' counts for eager calls and
     captures and by the profiled rounds' kernel records for eager and
     graphed calls (a replay runs no wrapper), 0 < mfu <= 1 for every
     record. It prints the `measurement:` JSON line;
 12. the NMS kernels (`csrc/nms.cu`: the suppression words, the greedy
     walk): their registers, spills and shared memory from phase 1's
     `ptxas -v` lines; then, through `tools/profile_nms.py`'s cases, the
     inputs `nms_mask` gets in bf16 inference with the bench's model and
     draws (the RPN at batch 8 and 32, (B, 5, 1000) at t = 0.7; the
     per-class NMS at batch 32, (32, 1024) class-shifted boxes at t = 0.5),
     the RPN's at the training top-k ((32, 5, 2000): `select_proposals`
     again on the bs 32 call's inputs), seeded clusters at those four shapes
     and at (2, 5000) (exact duplicates, score ties, zero-width and NaN
     boxes, padded rows) and seeded pairs whose IoU lies within 4 ULP of t
     = 0.5 and 0.7 (some nearest the midpoint of t and the next float):
     keep masks bit-equal to `nms_mask_plain` on the card, the words
     bit-equal to the CPU mirror (`ops.nms.suppression_words`) wherever the
     kernel writes them, the pairs the fast IoU test left to the division
     (each near-threshold case must have some), the launch shapes, the
     kernels', their plain versions', the whole `nms_mask`'s and the plain
     fixpoint's ms (CUDA events) and the bounds; then bf16 inference at
     batch 1 and 8 with `select_proposals` and `fast_rcnn_inference` under
     `torch.cuda.set_sync_debug_mode("error")` (no synchronising call
     inside them), and the synchronising calls of a whole inference call
     counted (mode "warn") with the kernels and with `nms_mask_plain`
     patched in, by source line. It prints the `nms:` JSON line;
 13. `rcnn3d.inference_step`, one CUDA graph per padded shape, at full
     width (phase 3's DLA34-FPN models, f32 with TF32 off and bf16, 512 px,
     batch 1, 8 and 32) against eager `inference` on the same inputs:
     every output bit-equal at the first call and at replays in the order
     1, 8, 1, 32, 8; each capture 2 forward, 0 backward and 2 + 2 NMS
     launches through the wrappers, and per replayed call the same in the
     profiler's kernel records; no synchronising call inside a replay; an
     earlier result unchanged by a later call; after `load_state_dict` of
     other seeded weights the replay equals eager, with no new capture; a
     parameter rebound to new storage recaptured and equal to eager; phase
     7's `--eval-only` predictions equal an eager run's from the same
     checkpoint at batch 1 and 8. It prints, with no pass or fail, the
     warm-up and capture ms per shape, the pool's bytes and eager vs graphed
     ms per call and busy share in turns, with the card, and the `graphs:`
     JSON line;
 14. the train-mode BatchNorm kernels (`csrc/batch_norm.cu`): their
     registers and spills from phase 1's `ptxas -v` lines; then, in a
     process of its own, `ops.batch_norm_cuda.forward` and `backward` at
     each of DLA-34's six train-mode BN shapes (bf16, batch 32, 512 x 768:
     16 channels at full size down to 512 at 1/32): equal to their mirror bit for bit, two
     calls bit-equal, and within 2e-4 of the largest value (y and dx half
     a bf16 ULP more) of the plain float32 formula in y, dx, the
     parameters' gradients and the running update; the wrappers' ms (CUDA
     events), the kernels' device ms (torch.profiler), the plain formula's
     ms and the bytes bound (once, and in two passes) per shape and summed
     over a step's 39 forward and 37 backward layers. It prints the
     `batch_norm:` JSON line.
Phases 7, 8c, 9a, 10 and 11 drive `inference_step` through the entry points
(`do_test`, `tools.demo`, `tools.bench`): there the wrappers count four
forward launches per graph captured (its eager warm-up and the capture) and
none per replay, and the bench's replayed launches come from the profiler's
kernel records. Phases 3 and 12 call `inference` eagerly.
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
# phase 5's gate: the kernels' gradient error against the plain pooler's at
# most this many times the plain pooler's own error when its output is
# nudged by two float32 ULPs, at the same state; the planted fault (the
# kernels' backward scaled by PLANTED_BWD_SCALE) must exceed it
CONTROL_MULTIPLE = 4
PLANTED_BWD_SCALE = 1.05
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


NMS_PER_INFERENCE = {"suppression_words": 2, "greedy_keep": 2}   # the RPN's and the per-class
NMS_PER_STEP = {"suppression_words": 1, "greedy_keep": 1}        # the RPN's
# a DLA-34 training step's train-mode BN: calls by path, then the kernels'
# wrappers' launches (the two trees' unused projections run under no_grad,
# so 37 of the 39 run a backward)
BN_PER_DLA34_STEP = {"fused": 39, "plain": 0, "forward": 39, "backward": 37}
# per inference call, by kernel (`benchtime.HAND_KERNELS`' names): the
# wrappers' counts of an eager call or a capture, and the kernel records of
# any call
KERNELS_PER_INFERENCE = {"roi_align_fwd": 2, "roi_align_bwd": 0, "suppression_words": 2,
                         "greedy_keep": 2}


def _nms_counts():
    """The NMS wrappers' launch counts. They count eager calls, and the warm-up
    and capture of a graph; a graph replay runs no wrapper (phase 13 reads
    replayed launches from the profiler's kernel records)."""
    from omni3d_tpu_torch.ops import nms_cuda
    return {"suppression_words": nms_cuda.suppression_words.launches,
            "greedy_keep": nms_cuda.greedy_keep.launches}


def _reset_nms_counts():
    from omni3d_tpu_torch.ops import nms_cuda
    nms_cuda.suppression_words.launches = 0
    nms_cuda.greedy_keep.launches = 0


def _count_diff(before, after):
    return {k: after[k] - before[k] for k in after}


def _graph_counts():
    """(captures, replays) of `rcnn3d.inference_step` in this process."""
    from omni3d_tpu_torch.models import rcnn3d
    return rcnn3d.inference_step.captures, rcnn3d.inference_step.replays


def _reset_graph_counts():
    from omni3d_tpu_torch.models import rcnn3d
    rcnn3d.inference_step.captures = rcnn3d.inference_step.replays = 0


def graphed_launch_check(what, launches, calls, captures, replays):
    """The ROIAlign wrappers' counts over `calls` `inference_step` calls on
    the card: a capture runs `inference` twice (its eager warm-up and the
    capture), two forward launches each; a replay runs no wrapper. Raises
    unless captures + replays == calls and the counts are 4 per capture."""
    want = {"forward": 4 * captures, "backward": 0}
    if captures + replays != calls or launches != want:
        raise AssertionError(f"{what}: {calls} inference_step calls, {captures} captures and "
                             f"{replays} replays; wrapper launches {launches}, not {want}")


def kernel_vs_plain(device):
    import torch
    from omni3d_tpu_torch.utils.benchtime import bound, make_boxes, pool_work
    from omni3d_tpu_torch.ops.roi_align import multilevel_roi_align_plain, route_levels
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align

    gen = torch.Generator().manual_seed(0)
    feats32 = [torch.randn(2, IMG // s, IMG // s, CHANNELS, generator=gen).to(device)
               for s in STRIDES]
    main_case, worst = None, 0.0
    for n in POOLER_BOXES:
        boxes = make_boxes(n, gen, device, IMG)
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
    from omni3d_tpu_torch.utils.benchtime import make_boxes

    gen = torch.Generator().manual_seed(1)
    feats32 = [torch.randn(2, IMG // s, IMG // s, CHANNELS, generator=gen).to(device)
               for s in STRIDES]
    shapes = [f.shape[1:3] for f in feats32]
    boxes = make_boxes(TRAIN_ROIS, gen, device, IMG)
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
    from omni3d_tpu_torch.utils.benchtime import bound, make_boxes, pool_work

    gen = torch.Generator().manual_seed(2)
    feats = [torch.randn(bs, IMG // s, IMG // s, CHANNELS, generator=gen).to(device,
                                                                            torch.bfloat16)
             for s in STRIDES]
    shapes = [tuple(f.shape[1:3]) for f in feats]
    boxes = torch.cat([make_boxes(TRAIN_ROIS, gen, device, IMG) for _ in range(bs // 2)], 0)
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


def main_path_inputs(cfg, bs, device):
    """Phase 3's batch: seeded uint8 images at IMG px, preprocessed; one K;
    ratios 1."""
    import numpy as np
    import torch
    from omni3d_tpu_torch.models import rcnn3d
    raw = np.random.default_rng(0).integers(0, 255, (bs, IMG, IMG, 3), dtype=np.uint8)
    images = rcnn3d.preprocess(torch.from_numpy(raw).to(device),
                               cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    K = torch.tensor([[512.0, 0, IMG / 2], [0, 512.0, IMG / 2], [0, 0, 1]], device=device)
    return images, K.expand(bs, 3, 3).contiguous(), torch.ones(bs, device=device)


def main_path(device, config="cubercnn_DLA34_FPN.yaml"):
    """Full-width inference of `config` at 512 px: f32 and bf16 at BATCHES,
    two forward launches per call, then one f32 call with the kernel and
    one with the plain pooler. The pooled features are held to phase 2's
    tolerance times max(1, largest pooled magnitude) (f32 sums err in
    proportion to their size, and some trunks' random-weight maps are far
    from unit scale); scores and boxes to fixed tolerances. The 6D pose bias
    starts at the identity (`condition_pose_bias_`: a detection clipped to
    zero height pools zero features, and the zero bias then decodes to an
    all-zero pose). Returns (timings, launches, {dtype: model}, kernel-vs-plain
    errors)."""
    import torch
    from omni3d_tpu_torch.models import rcnn3d
    from omni3d_tpu_torch.ops import nms as nms_ops
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
    from omni3d_tpu_torch.tools.synthetic import condition_pose_bias_

    cfg = _config(config)
    kw = rcnn3d.inference_kwargs(cfg)
    C = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    print(f"  config {config}: {C} classes, FPN {cfg.MODEL.FPN.OUT_CHANNELS}, "
          f"FC {cfg.MODEL.ROI_BOX_HEAD.FC_DIM}; inference_kwargs {kw}")

    timings, models = [], {}
    multilevel_roi_align.launches = 0          # counts of the main path's run only
    multilevel_roi_align.bwd_launches = 0
    _reset_nms_counts()
    for dtype in (torch.float32, torch.bfloat16):
        model = rcnn3d.build_model(cfg, device=device, dtype=dtype, seed=0)
        condition_pose_bias_(model)
        models[dtype] = model
        for bs, iters in BATCHES:
            images, Ks, ratio = main_path_inputs(cfg, bs, device)
            for _ in range(2):                  # warm-up (cuDNN plans, allocator)
                rcnn3d.inference(model, images, Ks, ratio, **kw)
            torch.cuda.synchronize()
            ms = []
            for _ in range(iters):
                before = multilevel_roi_align.launches
                nms_before = _nms_counts()
                t0 = time.perf_counter()
                out = rcnn3d.inference(model, images, Ks, ratio, **kw)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                assert multilevel_roi_align.launches - before == 2, \
                    multilevel_roi_align.launches - before
                nms_per_call = _count_diff(nms_before, _nms_counts())
                assert nms_per_call == NMS_PER_INFERENCE, nms_per_call
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
    nms_launches = _nms_counts()
    print(f"  kernel launches in the main path's run: {launches} forward, "
          f"{multilevel_roi_align.bwd_launches} backward; NMS {nms_launches}")
    n_calls = 2 * sum(2 + iters for _, iters in BATCHES)
    assert launches == 2 * n_calls, launches
    assert multilevel_roi_align.bwd_launches == 0
    assert nms_launches == {k: v * n_calls for k, v in NMS_PER_INFERENCE.items()}, nms_launches

    # the same f32 call with the plain pooler on the card
    def recorded(pool):
        seen = []

        def spy(*args, **kwargs):
            out = pool(*args, **kwargs)
            seen.append(out)
            return out
        return spy, seen

    images, Ks, ratio = main_path_inputs(cfg, PLAIN_BS, device)
    nms_mask_kernel = nms_ops.nms_mask
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

    # the same f32 call with the plain NMS fixpoint: the keep masks are
    # bit-equal, so every output must be equal too
    nms_ops.nms_mask = nms_ops.nms_mask_plain
    try:
        plain_nms = rcnn3d.inference(models[torch.float32], images, Ks, ratio, **kw)
    finally:
        nms_ops.nms_mask = nms_mask_kernel
    differ = [k for k, v in ko.items() if not torch.equal(v, plain_nms[k])]
    print(f"  f32 bs={PLAIN_BS} with nms_mask_plain patched in: outputs equal to the "
          f"kernels' call in {len(ko) - len(differ)} of {len(ko)} keys")
    assert not differ, differ
    return timings, launches, models, dict(pooled_max_abs_err=pooled_err, pooled_max_abs=pooled_max,
                                   tol=F32_ATOL * scale, final_outputs=errs,
                                   nms_launches=nms_launches, plain_nms_outputs_equal=True)


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
    _reset_nms_counts()
    bn_before = _bn_counts()
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
            nms_before, bn_step = _nms_counts(), _bn_counts()
            t0 = time.perf_counter()
            logs = step(batch, gen)
            torch.cuda.synchronize()
            if i >= WARMUP_STEPS:
                ms.append((time.perf_counter() - t0) * 1e3)
            after = (multilevel_roi_align.launches, multilevel_roi_align.bwd_launches)
            assert (after[0] - before[0], after[1] - before[1]) == (1, 1), (before, after)
            assert _count_diff(nms_before, _nms_counts()) == NMS_PER_STEP, _nms_counts()
            bn_step = _count_diff(bn_step, _bn_counts())
            assert bn_step == BN_PER_DLA34_STEP, bn_step
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
                "backward": multilevel_roi_align.bwd_launches, **_nms_counts()}
    print(f"  kernel launches in the main path's run: {launches}")
    n_steps = len(TRAIN_SETTINGS) * (WARMUP_STEPS + TIMED_STEPS)
    assert launches == {"forward": n_steps, "backward": n_steps,
                        **{k: v * n_steps for k, v in NMS_PER_STEP.items()}}, launches
    launches["bn"] = _count_diff(bn_before, _bn_counts())
    print(f"  train-mode BN in the main path's run: {launches['bn']} ({n_steps} steps, each "
          f"{BN_PER_DLA34_STEP})")
    assert launches["bn"] == {k: v * n_steps for k, v in BN_PER_DLA34_STEP.items()}

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

    # the kernels' step vs the plain pooler's, on the same inputs, at two
    # reproducible states, compared with cuDNN's deterministic algorithms so
    # that the two steps differ by the pooler alone: the seeded weights of a
    # freshly built f32 model, and those weights after the f32 run's
    # WARMUP_STEPS + TIMED_STEPS steps replayed on its synthetic batch with
    # noise from a fixed generator (the same parameters in every run). At
    # each state the control is the plain pooler against itself nudged by
    # two float32 ULPs (how far a rounding-sized change of the pooler moves
    # the gradients there): the kernels' gradient error must stay within
    # CONTROL_MULTIPLE times the control's, and a planted fault (the
    # kernels' backward scaled by PLANTED_BWD_SCALE) must fail that. At the
    # replayed state the absolute tolerances hold as well (losses 1e-4,
    # gradients 1e-3 of each tensor's largest), and reject the planted fault.
    # At the seeded weights the control itself exceeds 1e-3, so only the
    # relative gate applies there. Logged beside them: the kernels against
    # themselves, each comparison's worst tensor and cube-loss L1-sign /
    # chamfer-argmin switches, and the comparison from the state after the
    # timed steps (cuDNN's default algorithms), where the gate used to start.
    bs = batch["images"].shape[0]
    R = sum(3 * (IMG // s) ** 2 for s in STRIDES)
    n_cand = cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN + GT_SLOTS
    after_steps = _pooler_step_pair(train_mod, model, batch,
                                    train_mod.sampling_noise(kept["gen"], bs, R, n_cand, device),
                                    multilevel_roi_align, plain_pool)
    del kept, model, opt, step, batch
    torch.cuda.empty_cache()
    model, _, step, batch = synthetic_trainer(cfg, torch.float32, bs, device, img=IMG)
    comparisons = {}
    torch.backends.cudnn.deterministic = True
    try:
        gen = torch.Generator().manual_seed(0)
        noise = train_mod.sampling_noise(torch.Generator().manual_seed(0), bs, R, n_cand, device)
        comparisons.update(_gate_comparisons(train_mod, model, batch, noise, "seeded"))
        for _ in range(WARMUP_STEPS + TIMED_STEPS):
            step(batch, gen)
        checksum = float(sum(p.detach().double().abs().sum() for p in model.parameters()))
        noise = train_mod.sampling_noise(gen, bs, R, n_cand, device)
        comparisons.update(_gate_comparisons(train_mod, model, batch, noise, "gate_state"))
    finally:
        torch.backends.cudnn.deterministic = False
    comparisons["after_timed_steps_kernel_vs_plain_cudnn_default"] = after_steps
    for label, r in comparisons.items():
        print(f"  f32 bs={bs} step, {label.replace('_', ' ')}: {_cmp_line(r)}")
    for state in ("seeded", "gate_state"):
        got, ctl, fault = (comparisons[f"{state}_{k}"] for k in
                           ("kernel_vs_plain", "plain_vs_plain_nudged", "planted_fault_vs_plain"))
        print(f"  {state.replace('_', ' ')}: kernels vs plain {got['grad_rel']:.2e}, planted fault "
              f"{fault['grad_rel']:.2e}, against {CONTROL_MULTIPLE} x the two-ULP control "
              f"{ctl['grad_rel']:.2e} = {CONTROL_MULTIPLE * ctl['grad_rel']:.2e}")
        assert got["grad_rel"] <= CONTROL_MULTIPLE * ctl["grad_rel"], (state, got, ctl)
        assert fault["grad_rel"] > CONTROL_MULTIPLE * ctl["grad_rel"], (state, fault, ctl)
    gate = comparisons["gate_state_kernel_vs_plain"]
    print(f"  the gate (seeded weights after {WARMUP_STEPS + TIMED_STEPS} deterministic steps, "
          f"parameters' sum of |w| {checksum:.10e}; cuDNN deterministic; kernels vs plain "
          f"pooler): losses {gate['loss_rel']:.2e} (tol 1e-4), gradients {gate['grad_rel']:.2e} "
          "(tol 1e-3 of each tensor's largest); the planted fault over it in "
          f"{len(comparisons['gate_state_planted_fault_vs_plain']['over_tol'])} tensors")
    assert gate["loss_rel"] <= 1e-4, gate
    assert not gate["over_tol"], gate["over_tol"]
    assert comparisons["gate_state_planted_fault_vs_plain"]["over_tol"], "planted fault passed"
    del model, step, batch
    torch.cuda.empty_cache()
    loss_err, grad_err = gate["loss_rel"], gate["grad_rel"]
    return rows, launches, dict(loss_rel=loss_err, grad_rel=grad_err, gate_state_checksum=checksum,
                                comparisons=comparisons)


def _gate_comparisons(train_mod, model, batch, noise, state):
    """Phase 5's comparisons at one state: {f"{state}_{label}": the
    `_pooler_step_pair` result} for the kernels against the plain pooler,
    the kernels against themselves, the two-ULP control and the planted
    fault."""
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
    pairs = (("kernel_vs_plain", multilevel_roi_align, plain_pool),
             ("kernel_vs_kernel", multilevel_roi_align, multilevel_roi_align),
             ("plain_vs_plain_nudged", plain_pool, plain_pool_nudged),
             ("planted_fault_vs_plain", kernel_pool_bwd_scaled, plain_pool))
    return {f"{state}_{label}": _pooler_step_pair(train_mod, model, batch, noise, a, b)
            for label, a, b in pairs}


def _cmp_line(r):
    return (f"losses max rel diff {r['loss_rel']:.2e}; gradients max |diff| / max|g| "
            f"{r['grad_rel']:.2e} over {r['tensors']} tensors, worst {r['worst_tensor']}; "
            f"cube-loss switches {r['l1_sign_switches']} L1 signs, "
            f"{r['chamfer_argmin_switches']} chamfer argmins (smallest chamfer margin "
            f"{r['chamfer_min_margin']:.2e}); ROI-head ReLU switches {r['relu_switches']}, "
            f"uncertainty clamp switches {r['uncert_clamp_switches']}")


def plain_pool_nudged(features, boxes, strides, out_size, sampling_ratio, min_level=2,
                      routing="canonical"):
    """`plain_pool` with its output, and so the gradient through it, scaled
    by 1 + 2^-22: two float32 ULPs, the size of the kernels' rounding
    difference from the plain pooler, as a pooler that is right to
    rounding."""
    return plain_pool(features, boxes, strides, out_size, sampling_ratio, min_level,
                      routing) * (1.0 + 2.0 ** -22)


def kernel_pool_bwd_scaled(features, boxes, strides, out_size, sampling_ratio, min_level=2,
                           routing="canonical"):
    """The kernels' `multilevel_roi_align` with the gradient through it
    scaled by PLANTED_BWD_SCALE: a planted fault that phase 5's gate must
    reject."""
    import torch
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align

    class ScaledBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g * PLANTED_BWD_SCALE

    return ScaledBackward.apply(multilevel_roi_align(features, boxes, strides, out_size,
                                                     sampling_ratio, min_level, routing))


def _pooler_step_pair(train_mod, model, batch, noise, first, second):
    """One f32 step's losses and parameter gradients with the pooler `first`
    and with `second` (the kernels' `multilevel_roi_align`, `plain_pool` or
    `plain_pool_nudged`), from `model`'s state (restored after), on `batch`
    and `noise`. Returns the
    losses' largest relative difference, the gradients' largest
    |difference| / largest |gradient| and the tensor it is in, the tensors
    over the 1e-3 tolerance, and how many L1 signs and chamfer argmins of
    the cube losses, ReLU signs of the ROI heads' FC stacks (per call, in
    call order) and the cube head's uncertainty clamps (at 0.01) differ
    between the two steps (a term switching at a
    near-tie changes the gradient by a whole step; the smallest chamfer
    margin says how near)."""
    import torch
    from omni3d_tpu_torch.models import heads, roi_training
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    real_l1, real_chamfer = roi_training.l1_corner_loss, roi_training.chamfer_corner_loss
    real_f = heads.F
    results = {}
    for label, pool in (("first", first), ("second", second)):
        seen = []

        class RecordingF:
            """torch.nn.functional with `relu` recording its input's signs."""
            def __getattr__(self, name):
                return getattr(real_f, name)

            @staticmethod
            def relu(x, *args, **kwargs):
                seen.append(("relu", (x > 0).detach()))
                return real_f.relu(x, *args, **kwargs)

        def l1(pred, gt):
            seen.append(("l1", torch.sign(pred - gt).detach()))
            return real_l1(pred, gt)

        def chamfer(pred, gt):
            d = (pred[:, :, None, :] - gt[:, None, :, :]).abs().sum(-1).detach()
            two = torch.cat([d.topk(2, dim=1, largest=False).values,
                             d.topk(2, dim=2, largest=False).values.transpose(1, 2)], -1)
            seen.append(("chamfer", torch.cat([d.argmin(1), d.argmin(2)], -1),
                         float((two[:, 1] - two[:, 0]).min())))
            return real_chamfer(pred, gt)

        model.load_state_dict(sd)
        model.zero_grad(set_to_none=True)
        train_mod.multilevel_roi_align = pool
        roi_training.l1_corner_loss, roi_training.chamfer_corner_loss = l1, chamfer
        heads.F = RecordingF()
        hooks = [m.register_forward_hook(lambda m, i, out: seen.append(("clamp", out > 0.01)))
                 for n, m in model.named_modules() if n.endswith("bbox_3D_uncertainty")]
        try:
            total, losses, _ = train_mod.compute_losses(model, batch, noise=noise)
            total.backward()
        finally:
            for h in hooks:
                h.remove()
            train_mod.multilevel_roi_align = multilevel_roi_align
            roi_training.l1_corner_loss, roi_training.chamfer_corner_loss = real_l1, real_chamfer
            heads.F = real_f
        torch.cuda.synchronize()
        results[label] = ({k: float(v.detach()) for k, v in losses.items()},
                          {n: p.grad.clone() for n, p in model.named_parameters()
                           if p.grad is not None}, seen)
    model.load_state_dict(sd)
    model.zero_grad(set_to_none=True)
    (kl, kg, ks), (pl, pg, ps) = results["first"], results["second"]
    assert set(kg) == set(pg) and len(ks) == len(ps)
    errs = {n: float((kg[n] - pg[n]).abs().max()) / (float(pg[n].abs().max()) + 1e-12)
            for n in pg}
    worst = max(errs, key=errs.get)
    over = {n: errs[n] for n in pg
            if float((kg[n] - pg[n]).abs().max()) > 1e-3 * float(pg[n].abs().max()) + 1e-6}
    margins = [a[2] for a in ks if a[0] == "chamfer"]
    return dict(loss_rel=_loss_rel(kl, pl), grad_rel=errs[worst], worst_tensor=worst,
                tensors=len(pg), over_tol=over,
                l1_sign_switches=sum(int((a[1] != b[1]).sum()) for a, b in zip(ks, ps)
                                     if a[0] == "l1"),
                chamfer_argmin_switches=sum(int((a[1] != b[1]).sum()) for a, b in zip(ks, ps)
                                            if a[0] == "chamfer"),
                relu_switches=[int((a[1] != b[1]).sum()) for a, b in zip(ks, ps)
                               if a[0] == "relu"],
                uncert_clamp_switches=sum(int((a[1] != b[1]).sum()) for a, b in zip(ks, ps)
                                          if a[0] == "clamp"),
                chamfer_min_margin=min(margins) if margins else float("nan"))


def gate_probe(device, replays):
    """`--gate-probe N`: phase 5's old gate state, rebuilt N times. Each
    replay builds the seeded f32 model, takes the f32 run's WARMUP_STEPS +
    TIMED_STEPS steps with cuDNN's default algorithms (a slightly different
    state each time), and compares the step with the kernels against the
    plain pooler's, the kernels against themselves and the two-ULP control,
    under the default algorithms (as the old gate did) and under the
    deterministic ones. Prints a line per replay and a `gate probe:` JSON
    line; asserts nothing."""
    import torch
    from omni3d_tpu_torch.config import get_default_cfg
    from omni3d_tpu_torch.engine import train as train_mod
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
    from omni3d_tpu_torch.tools.synthetic import GT_SLOTS, synthetic_trainer

    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "cubercnn_DLA34_FPN.yaml"))
    bs = dict(TRAIN_SETTINGS)["float32"]
    R = sum(3 * (IMG // s) ** 2 for s in STRIDES)
    n_cand = cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN + GT_SLOTS
    pairs = {"default": (("kernel_vs_plain", multilevel_roi_align, plain_pool),
                         ("kernel_vs_kernel", multilevel_roi_align, multilevel_roi_align),
                         ("plain_vs_plain_nudged", plain_pool, plain_pool_nudged)),
             "deterministic": (("kernel_vs_plain", multilevel_roi_align, plain_pool),
                               ("plain_vs_plain_nudged", plain_pool, plain_pool_nudged))}
    rows = []
    for r in range(replays):
        model, _, step, batch = synthetic_trainer(cfg, torch.float32, bs, device, img=IMG)
        gen = torch.Generator().manual_seed(0)
        for _ in range(WARMUP_STEPS + TIMED_STEPS):
            step(batch, gen)
        noise = train_mod.sampling_noise(gen, bs, R, n_cand, device)
        row = dict(replay=r, checksum=float(sum(p.detach().double().abs().sum()
                                                for p in model.parameters())))
        for mode, mode_pairs in pairs.items():
            torch.backends.cudnn.deterministic = mode == "deterministic"
            try:
                for label, a, b in mode_pairs:
                    row[f"{mode}_{label}"] = _pooler_step_pair(train_mod, model, batch, noise, a, b)
            finally:
                torch.backends.cudnn.deterministic = False
        rows.append(row)
        print(f"  replay {r}: sum of |w| {row['checksum']:.10e}; " + "; ".join(
            f"{k.replace('_', ' ')} {v['grad_rel']:.2e} ({v['worst_tensor']}, "
            f"{len(v['over_tol'])} over 1e-3, ReLU switches {v['relu_switches']}, "
            f"clamp {v['uncert_clamp_switches']})"
            for k, v in row.items() if isinstance(v, dict)),
            flush=True)
        del model, step, batch
        torch.cuda.empty_cache()
    print("gate probe: " + json.dumps(rows))


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
    bn_before = _bn_counts()
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
    bn = _count_diff(bn_before, _bn_counts())
    print(f"  kernel launches in the main path's run: {launches}; train-mode BN {bn} over "
          f"{ENTRY_RESUME_TO} iterations")
    assert launches == {"forward": ENTRY_RESUME_TO, "backward": ENTRY_RESUME_TO}, launches
    assert bn["plain"] == 0 and bn["fused"] == bn["forward"] > 0 and bn["backward"] > 0, bn
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
        last_total_loss=logged[-1]["total_loss"], launches=launches, bn=bn)
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
          f"{profile['window_ms_per_step']:.1f} ms per step; "
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


def eval_argv(device, tmp, weights, bs, out_dir):
    """Phase 7's `tools.train_net --eval-only` arguments at batch `bs`."""
    from omni3d_tpu_torch.tools.profile_entry import SPLITS
    return ["--config-file", os.path.join(ROOT, "configs", "cubercnn_DLA34_FPN.yaml"),
            "--datasets-root", os.path.join(tmp, "Omni3D"), "--device", device.type,
            "--eval-only", "--weights", weights,
            "OUTPUT_DIR", out_dir, "DATASETS.TRAIN", str(tuple(SPLITS)),
            "DATASETS.TEST", str(tuple(EVAL_SPLITS)), "TPU.COMPUTE_DTYPE", "bfloat16",
            "TPU.EVAL_BATCH_SIZE", str(bs), "SEED", "0"]


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
        argv = eval_argv(device, tmp, weights, bs, out_dir)
        spy, seen = first_pooler_calls()
        rcnn3d.multilevel_roi_align = spy
        multilevel_roi_align.launches = 0          # counts of the main path's run only
        multilevel_roi_align.bwd_launches = 0
        _reset_graph_counts()
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
        captures, replays = _graph_counts()
        checks = pooler_vs_plain(seen, bs)
        pooler_checks += checks
        print(f"  bs {bs}: kernel launches {run_launches} through the wrappers over {n_batches} "
              f"inference batches ({captures} graphs captured, {replays} replays); forward "
              f"kernel vs plain pooler on the run's own inputs at {len(checks)} "
              f"(pyramid, boxes) shapes: max|k-p| {max(c['max_abs_err'] for c in checks):.3e}, "
              f"differing at most {max(c['mismatch'] for c in checks):.1e}")
        graphed_launch_check(f"--eval-only bs {bs}", run_launches, n_batches, captures, replays)
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
        runs[bs] = dict(wall_s=wall, splits={k: results[k]["inference"] for k in EVAL_SPLITS},
                        graphs=dict(captures=captures, replays=replays))
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
    first call at each (pyramid shape, boxes shape) in `seen`. Under
    `inference_step` that first call is the eager warm-up of the graph at
    that shape (the capture calls the spy again, and a replay does not call
    it): the kernel as the graph captured it, held against the plain pooler."""
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
        _reset_graph_counts()
        t0 = time.perf_counter()
        results = train_net.main(argv)
        _sync(device)
        wall = time.perf_counter() - t0
        with open(result_path, "w") as f:
            json.dump({"wall_s": wall, "inference": results["SUNRGBD_test"]["inference"],
                       "AP": {k: v for k, v in results["SUNRGBD_test"].items()
                              if k.startswith(("AP", "AR"))},
                       "launches": {"forward": multilevel_roi_align.launches,
                                    "backward": multilevel_roi_align.bwd_launches},
                       "graphs": _graph_counts()}, f)
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
    graphs_c = [sum(r["graphs"][i] for r in res) for i in (0, 1)]
    graphed_launch_check("8c --eval-only at world size 2", launches_c, n_batches, *graphs_c)
    per_rank = [dict(images=r["inference"]["images"],
                     ms_per_img=(r["inference"]["data_s"] + r["inference"]["compute_s"]) * 1e3
                     / r["inference"]["images"],
                     compute_ms_per_img=r["inference"]["compute_s"] * 1e3
                     / r["inference"]["images"], wall_s=r["wall_s"]) for r in res]
    summary["eval_world2_one_card_gloo"] = dict(
        images=n_img, wall_s=wall, per_rank=per_rank, max_pred_diff=worst,
        ap_equal=same_ap, launches=launches_c,
        graphs=dict(captures=graphs_c[0], replays=graphs_c[1]))
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
    steps after that one. Each step's train-mode BN calls all go through
    the kernels (none through the plain formula); the row keeps the last
    step's counts and the sums over the steps. Returns (row, launches)."""
    import torch
    from omni3d_tpu_torch.engine import train as train_mod
    from omni3d_tpu_torch.tools.synthetic import synthetic_trainer

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model, opt, step, batch = synthetic_trainer(cfg, torch.bfloat16, bs, device, img=IMG)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    losses = []

    bn_steps = []

    def checked(batch, gen):
        before, bn_before = _launch_counts(), _bn_counts()
        logs = step(batch, gen)
        after = _launch_counts()
        assert (after[0] - before[0], after[1] - before[1]) == (1, 1), (before, after)
        bn = _count_diff(bn_before, _bn_counts())
        assert bn["plain"] == 0 and bn["fused"] == bn["forward"] > 0 and bn["backward"] > 0, bn
        bad = {k: float(v) for k, v in logs.items() if not torch.isfinite(torch.as_tensor(v))}
        assert not bad, bad
        losses.append(float(logs["total_loss"]))
        bn_steps.append(bn)

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
               remat_backbone=bool(cfg.TPU.REMAT_BACKBONE), bn_per_step=bn_steps[-1],
               bn_total={k: sum(b[k] for b in bn_steps) for k in bn_steps[-1]})
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
    before, graphs_before = _launch_counts(), _graph_counts()
    t0 = time.perf_counter()
    results = train_net.main(argv)
    torch.cuda.synchronize()
    eval_wall = time.perf_counter() - t0
    after, graphs_after = _launch_counts(), _graph_counts()
    n_batches = len(results[name]["inference"]["batches"])
    eval_launches = {"forward": after[0] - before[0], "backward": after[1] - before[1]}
    graphed_launch_check("ResNet34-FPN --eval-only", eval_launches, n_batches,
                         *(a - b for a, b in zip(graphs_after, graphs_before)))
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
          f"{train['peak_mem_gib']:.2f} GiB; train-mode BN per step {train['bn_per_step']}")
    return row, {"forward": 4 + train_launches["forward"],
                 "backward": train_launches["backward"]}


def backbones_path(device, tmp, dla_inference, dla_training):
    """Phase 9: ResNet34-FPN as phases 3, 5, 6 and 7 drive DLA-34 (9a), and
    every other builder and DLA variant at full width (9b). Returns
    (summary, launches)."""
    launches = {"forward": 0, "backward": 0}
    print("  9a: ResNet34-FPN (configs/cubercnn_ResNet34_FPN.yaml)")
    timings, inf_launches, _, plain = main_path(device, RESNET_CONFIG)
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
          f"{train['peak_mem_gib']:.2f} GiB); train-mode BN per step "
          f"{remat['bn_per_step']} (without: {train['bn_per_step']})")
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


# phase 10: the demo, the JPEG decoder, the rasterizer and training visualisation
JPEG_DIR = os.path.join(ROOT, "tests", "data", "jpeg")
DEMO_IMAGES = ("q95_420_640x480", "q75_420_1242x375")
VIS_STEPS, VIS_PERIOD, VIS_EVAL_PERIOD = 5, 2, 4   # 10d: panels after iterations 2 and 4
RENDER_BOXES, RENDER_HW = 20, (480, 640)
DEMO_STEADY_CALLS = 5          # 10b: demo.infer again per image, after the demo


def demo_path(device, tmp, weights):
    """Phase 10: (a) every JPEG fixture decoded bit-equal to its committed
    cv2 decode; (b) `tools.demo` at full width in bfloat16 with phase 6's
    model_final.ckpt on the 640 x 480 and 1242 x 375 fixtures at threshold
    0: two forward launches per image, the first pooler call held against
    the plain pooler, each image's detections against a direct
    `rcnn3d.inference` call on the same input (phase 3's tolerances), the
    three PNGs read back at their sizes, ms per image by stage; (c)
    `render_depth_map` on the card against the CPU on 20 boxes at 640 x
    480; (d) `tools.train_net` with VIS_PERIOD and TEST.EVAL_PERIOD on phase
    6's dataset and phase 7's test splits: the panels at the expected
    iterations, the evaluation's sample dumps. Returns (summary, launches)."""
    import glob
    import shutil

    import numpy as np
    import torch
    from omni3d_tpu_torch.data import datasets as data_lib
    from omni3d_tpu_torch.data.image import read_image_bgr
    from omni3d_tpu_torch.data.jpeg import decode_jpeg
    from omni3d_tpu_torch.evaluation.error_stats import visualize_from_predictions
    from omni3d_tpu_torch.evaluation.omni3d_eval import Omni3DEvaluationHelper
    from omni3d_tpu_torch.models import rcnn3d
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
    from omni3d_tpu_torch.tools import demo, train_net
    from omni3d_tpu_torch.tools.profile_entry import SPLITS, train_argv
    from omni3d_tpu_torch.utils import geometry as G
    from omni3d_tpu_torch.utils.render import render_depth_map

    summary = {}
    t_phase = time.perf_counter()
    # (a) the decoder against the committed cv2 decodes
    fixtures = sorted(glob.glob(os.path.join(JPEG_DIR, "*.jpg")))
    decoded = 0
    for path in fixtures:
        if os.path.basename(path).startswith("progressive"):
            try:
                read_image_bgr(path)
            except ValueError as e:
                assert "progressive" in str(e), e
                continue
            raise AssertionError(f"{path}: a progressive file did not raise")
        got, want = read_image_bgr(path), read_image_bgr(path[:-4] + ".png")
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{path}: the decode differs from the committed cv2 decode")
        decoded += 1
    with open(os.path.join(JPEG_DIR, "q95_420_640x480.jpg"), "rb") as f:
        data = f.read()
    ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        decode_jpeg(data)
        ms.append((time.perf_counter() - t0) * 1e3)
    summary["jpeg"] = dict(fixtures_bit_equal=decoded, decode_ms_640x480_q95=statistics.median(ms))
    print(f"  JPEG: {decoded} fixtures bit-equal to their committed cv2 decodes, the progressive "
          f"one refused; 640x480 q95 decode {statistics.median(ms):.2f} ms (median of 10)")
    assert decoded == len(fixtures) - 1 >= 9, (decoded, len(fixtures))

    # (b) the demo at full width, bf16, phase 6's checkpoint
    folder, out_dir = os.path.join(tmp, "demo_in"), os.path.join(tmp, "demo_out")
    os.makedirs(folder, exist_ok=True)
    for name in DEMO_IMAGES:
        shutil.copy(os.path.join(JPEG_DIR, name + ".jpg"), folder)
    argv = ["--config-file", os.path.join(ROOT, "configs", "cubercnn_DLA34_FPN.yaml"),
            "--input-folder", folder, "--weights", weights, "--threshold", "0.0",
            "--output-dir", out_dir, "--device", device.type, "--display",
            "TPU.COMPUTE_DTYPE", "bfloat16", "OUTPUT_DIR", os.path.join(tmp, "output")]
    calls = []
    real_infer = demo.infer

    def infer(model, cfg, image_bgr, K):
        det = real_infer(model, cfg, image_bgr, K)
        calls.append((model, cfg, image_bgr, K, det))
        return det
    spy, seen = first_pooler_calls()
    rcnn3d.multilevel_roi_align, demo.infer = spy, infer
    multilevel_roi_align.launches = 0          # counts of the main path's run only
    multilevel_roi_align.bwd_launches = 0
    _reset_graph_counts()
    try:
        t0 = time.perf_counter()
        records = demo.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        rcnn3d.multilevel_roi_align, demo.infer = multilevel_roi_align, real_infer
    launches = {"forward": multilevel_roi_align.launches,
                "backward": multilevel_roi_align.bwd_launches}
    captures, replays = _graph_counts()
    print(f"  demo: kernel launches {launches} through the wrappers over {len(records)} images "
          f"({captures} graphs captured, {replays} replays)")
    graphed_launch_check("demo", launches, len(DEMO_IMAGES), captures, replays)
    checks = pooler_vs_plain(seen, 1)
    print(f"  demo: forward kernel vs plain pooler on the run's own inputs at {len(checks)} "
          f"(pyramid, boxes) shapes: max|k-p| {max(c['max_abs_err'] for c in checks):.3e}")
    det_errs = []
    for (model, cfg, image_bgr, K, det), rec in zip(calls, records):
        canvas, net_h, net_w = demo.network_input(cfg, image_bgr)
        images = rcnn3d.preprocess(torch.from_numpy(canvas[None]).to(device),
                                   cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
        direct = rcnn3d.inference(
            model, images, torch.from_numpy(K[None]).to(device),
            torch.tensor([image_bgr.shape[0] / net_h], device=device),
            hw=torch.tensor([[net_h, net_w]], dtype=torch.float32, device=device),
            **rcnn3d.inference_kwargs(cfg))
        direct = {k: v[0].float().cpu().numpy() for k, v in direct.items()}
        assert np.array_equal(det["valid"], direct["valid"]) and np.array_equal(
            det["classes"], direct["classes"]), rec["name"]
        errs = {k: float(np.abs(det[k] - direct[k]).max())
                for k in ("boxes", "scores", "center_cam", "dims", "pose")}
        assert errs["scores"] <= 1e-4 and errs["boxes"] <= 1e-2, (rec["name"], errs)
        assert np.isfinite(det["center_cam"][det["valid"] > 0]).all(), rec["name"]
        det_errs.append(errs)
        h, w = rec["height"], rec["width"]
        for kind, shape in (("boxes", (h, w, 3)), ("novel", (512, 512, 3)),
                            ("bev", (400, 400, 3))):
            img = read_image_bgr(rec["files"][kind])
            assert img.shape == shape, (rec["name"], kind, img.shape)
        assert rec["detections"] > 0, rec
        # the demo's inference time holds the first call at the image's
        # shape (the warm-up and the capture); `demo.infer` again at that
        # shape replays the graph: the steady state
        steady = []
        for _ in range(DEMO_STEADY_CALLS):
            t0 = time.perf_counter()
            real_infer(model, cfg, image_bgr, K)
            steady.append((time.perf_counter() - t0) * 1e3)
        rec["ms"]["inference_steady"] = statistics.median(steady)
        print(f"  demo {rec['name']} ({w}x{h}): {rec['detections']} detections drawn; "
              + ", ".join(f"{k} {v:.1f} ms" for k, v in rec["ms"].items())
              + f" (median of {DEMO_STEADY_CALLS} more calls at this shape); "
              f"vs a direct inference call: {errs}")
    del calls
    torch.cuda.empty_cache()
    summary["demo"] = dict(images=[dict(name=r["name"], hw=[r["height"], r["width"]],
                                        detections=r["detections"], ms=r["ms"])
                                   for r in records],
                           wall_s=wall, launches=launches, pooler_vs_plain=checks,
                           vs_direct_inference=det_errs)

    # (c) the rasterizer on the card against the CPU
    gen = np.random.default_rng(0)
    c = np.stack([gen.uniform(-4, 4, RENDER_BOXES), gen.uniform(-1, 1.5, RENDER_BOXES),
                  gen.uniform(3, 25, RENDER_BOXES)], 1)
    d = gen.uniform(0.5, 3.0, (RENDER_BOXES, 3))
    boxes = np.concatenate([c, d], 1).astype(np.float32)
    R = G.euler_angles_to_matrix(torch.tensor(gen.uniform(-np.pi, np.pi, (RENDER_BOXES, 3)),
                                              dtype=torch.float32)).numpy()
    H, W = RENDER_HW
    K = np.array([[500, 0, W / 2], [0, 500, H / 2], [0, 0, 1]], np.float32)
    times, outs = ([], []), []
    for j, dev in enumerate((device, torch.device("cpu"))):
        for i in range(3):
            t0 = time.perf_counter()
            out = [t.cpu() for t in render_depth_map(K, boxes, R, W, H, device=dev)]
            if i:
                times[j].append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    (cs, cd, ci), (ps, pd, pi) = outs
    fin = torch.isfinite(pd)
    depth_rel = float(((cd[fin] - pd[fin]).abs() / pd[fin]).max())
    assert torch.equal(cs, ps) and torch.equal(ci, pi), "render_depth_map: card != CPU"
    assert torch.equal(torch.isfinite(cd), fin) and depth_rel <= 1e-5, depth_rel
    card_ms, cpu_ms = statistics.median(times[0]), statistics.median(times[1])
    summary["render_depth_map"] = dict(
        boxes=RENDER_BOXES, hw=list(RENDER_HW), depth_max_rel=depth_rel,
        covered_pixels=int(fin.sum()), card_ms=card_ms, cpu_ms=cpu_ms)
    print(f"  render_depth_map, {RENDER_BOXES} boxes at {W}x{H}: silhouettes and indices equal "
          f"on the card and the CPU, depth max rel {depth_rel:.1e} (tol 1e-5); "
          f"{card_ms:.1f} ms on the card, {cpu_ms:.1f} ms on the CPU")

    # (d) train_net with the training visualisation and evaluation
    vis_out = os.path.join(tmp, "vis_run")
    argv = train_argv(tmp, vis_out, VIS_STEPS, "--weights", weights) + [
        "VIS_PERIOD", str(VIS_PERIOD), "TEST.EVAL_PERIOD", str(VIS_EVAL_PERIOD),
        "DATASETS.TEST", str(tuple(EVAL_SPLITS)), "TPU.EVAL_BATCH_SIZE", "8"]
    before, graphs_before = _launch_counts(), _graph_counts()
    t0 = time.perf_counter()
    run = train_net.main(argv)
    torch.cuda.synchronize()
    vis_wall = time.perf_counter() - t0
    after = _launch_counts()
    vis_graphs = tuple(b - a for a, b in zip(graphs_before, _graph_counts()))
    # the panels and the evaluation captured graphs of the training model,
    # and do_train dropped them after each
    if not vis_graphs[0] or run.model.inference_graphs is not None:
        raise AssertionError(f"train_net with VIS_PERIOD: {vis_graphs} captures / replays, "
                             f"graphs left on the training model: {run.model.inference_graphs}")
    panels = sorted(os.listdir(os.path.join(vis_out, "vis")))
    want = sorted(f"iter_{i + 1:07d}_gt_vs_pred_{k}.png" for i in range(1, VIS_STEPS)
                  if i % VIS_PERIOD == 0 for k in ("2d", "3d"))
    assert run.iterations == list(range(VIS_STEPS)), run.iterations
    assert panels == want, (panels, want)
    for f in panels:
        img = read_image_bgr(os.path.join(vis_out, "vis", f))
        assert img.ndim == 3 and img.shape[1] % 2 == 0, (f, img.shape)
    eval_dir = os.path.join(vis_out, "inference", f"iter_{VIS_EVAL_PERIOD - 1}")
    dumps, forced = {}, {}
    cfg = run.model.cfg
    fs = data_lib.get_filter_settings_from_cfg(cfg)
    for name in EVAL_SPLITS:
        vis_dir = os.path.join(eval_dir, name, "vis")
        dumps[name] = sorted(os.listdir(vis_dir)) if os.path.isdir(vis_dir) else []
        preds = Omni3DEvaluationHelper.load_predictions(
            os.path.join(eval_dir, name, "instances_predictions.pkl"))
        api = data_lib.Omni3D([data_lib.metadata(name)["json_file"]], dict(fs))
        n = visualize_from_predictions(preds, api, os.path.join(tmp, "forced_vis", name),
                                       [str(i) for i in range(50)], score_thresh=0.0,
                                       datasets_root=data_lib.metadata(name)["image_root"])
        sampled = [img["id"] for i, img in enumerate(api.dataset["images"]) if i % 50 == 0]
        want_n = sum(any(p["image_id"] == i for p in preds) for i in sampled)
        assert n == want_n, (name, n, want_n)
        for f in os.listdir(os.path.join(tmp, "forced_vis", name, "vis")) if n else []:
            img = read_image_bgr(os.path.join(tmp, "forced_vis", name, "vis", f))
            assert img.shape[:2] == EVAL_SPLITS[name][1:3], (name, f, img.shape)
        forced[name] = n
    summary["train_vis"] = dict(steps=VIS_STEPS, vis_period=VIS_PERIOD, panels=panels,
                                eval_period=VIS_EVAL_PERIOD, eval_dumps=dumps,
                                dumps_at_score_0=forced, wall_s=vis_wall,
                                graphs=dict(zip(("captures", "replays"), vis_graphs)),
                                launches={"forward": after[0] - before[0],
                                          "backward": after[1] - before[1]})
    print(f"  train_net {VIS_STEPS} iterations, VIS_PERIOD {VIS_PERIOD}, TEST.EVAL_PERIOD "
          f"{VIS_EVAL_PERIOD}: panels {panels}; evaluation sample dumps {dumps} (at score "
          f"threshold 0: {forced}); {vis_graphs[0]} graphs captured and {vis_graphs[1]} "
          f"replays, none left on the training model; wall {vis_wall:.1f} s")
    summary["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"  phase 10 wall {summary['phase_wall_s']:.1f} s")
    return summary, launches


# phase 11: the measurement tools on the card
BENCH_BATCHES, BENCH_ROUNDS, BENCH_ITERS = (1, 8, 32), 3, 10
BENCH_TRAIN = (32, 3, 3)           # bf16 batch, rounds, steps per round
STAGES_BS, BACKBONE_BS, PROFILE_ROUNDS, PROFILE_ITERS = 8, 32, 2, 5


def _counted(run):
    """run() with the kernels' launch counts set to 0 just before it; returns
    (its result, {"forward": n, "backward": n, "suppression_words": n,
    "greedy_keep": n} launched during it)."""
    import torch
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
    multilevel_roi_align.launches = 0
    multilevel_roi_align.bwd_launches = 0
    _reset_nms_counts()
    out = run()
    torch.cuda.synchronize()
    return out, {"forward": multilevel_roi_align.launches,
                 "backward": multilevel_roi_align.bwd_launches, **_nms_counts()}


def _check_mfu(what, mfu):
    if not 0 < mfu <= 1:
        raise AssertionError(f"{what}: mfu {mfu} outside (0, 1]")


def _equal_outputs(what, got, want):
    import torch
    bad = [k for k, v in want.items() if not torch.equal(got[k], v)]
    if bad:
        raise AssertionError(f"{what}: outputs differ from a direct inference call in {bad}")


def measurement_path(device):
    """Phase 11: `tools.bench` at bs 1 / 8 / 32, `tools.bench_train` at bf16
    bs 32, `tools.profile_stages` at bs 8 and `tools.profile_backbone` at bs
    32, all at full width through their `run` functions, each driven with
    the launch counts at 0. Binding checks: bs 32's outputs from the bench's
    last call equal a direct `inference` call; the stage chain's outputs
    equal `inference`'s; the trunk blocks run in order give `model.features`'
    outputs exactly; two forward launches per inference call and one forward
    and one backward per training step (the wrappers' counts and the
    profiled rounds' kernels); the box and cube poolers on the bench's bs 32
    batch against the plain pooler with phase 2's tolerances; 0 < mfu <= 1
    for every record. Returns (records, launches by tool, the poolers'
    largest error)."""
    import torch
    from omni3d_tpu_torch.models import rcnn3d
    from omni3d_tpu_torch.ops.roi_align import multilevel_roi_align_plain, route_levels
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
    from omni3d_tpu_torch.tools import bench, bench_train, profile_backbone, profile_stages

    cfg = bench.config()
    kw = rcnn3d.inference_kwargs(cfg)
    launches, records = {}, {}
    t0 = time.perf_counter()
    (records["bench"], last), launches["bench"] = _counted(lambda: bench.run(
        cfg, BENCH_BATCHES, rounds=BENCH_ROUNDS, iters=BENCH_ITERS, device=device))
    rec = records["bench"]
    for row in rec["batch_sizes"]:
        # eager calls launch through the wrappers; replays launch the same
        # kernels with no wrapper call, so their counts come from the
        # profiler's kernel records, and the capture's from the wrappers
        checks = {"eager wrapper launches": (row["eager_wrapper_launches_per_call"],
                                             KERNELS_PER_INFERENCE),
                  "graphed wrapper launches": (row["wrapper_launches_per_call"],
                                               dict.fromkeys(KERNELS_PER_INFERENCE, 0)),
                  "first call's wrapper launches (warm-up and capture)": (
                      row["graph"]["wrapper_launches"],
                      {k: 2 * n for k, n in KERNELS_PER_INFERENCE.items()}),
                  "first call's captures": (row["graph"]["captures"], 1),
                  "graphed kernel records": (row["profile"]["hand_kernel_launches_per_call"],
                                             KERNELS_PER_INFERENCE),
                  "eager kernel records": (row["eager_profile"]["hand_kernel_launches_per_call"],
                                           KERNELS_PER_INFERENCE)}
        for what, (got, want) in checks.items():
            if got != want:
                raise AssertionError(f"bench bs={row['bs']}: {what}: {got}, not {want}")
        _check_mfu(f"bench bs={row['bs']}", row["mfu"])
        _check_mfu(f"bench bs={row['bs']} eager", row["eager_mfu"])
    print(f"  bench: per eager call the wrappers launch {KERNELS_PER_INFERENCE}; per graphed "
          f"call none, and the kernel records hold {KERNELS_PER_INFERENCE}; graphs "
          f"{rec['graphs']}")
    model = bench.random_model(cfg, device)
    (_, images, Ks, ratios), got = last[BENCH_BATCHES[-1]]
    _equal_outputs(f"bench bs={BENCH_BATCHES[-1]}", got,
                   rcnn3d.inference(model, images, Ks, ratios, **kw))
    print(f"  bench bs={BENCH_BATCHES[-1]}: the last graphed call's outputs equal a direct "
          "inference call")

    # the poolers on the bench's largest batch, kernel vs plain
    _, s, _ = profile_stages.stage_chain(model, images, Ks, ratios, **kw)
    pooler_err = 0.0
    for what, boxes in (("box", s["prop_boxes"]), ("cube", rcnn3d.scale_proposals(
            s["dets"]["boxes"], cfg.MODEL.ROI_CUBE_HEAD.SCALE_ROI_BOXES))):
        got = multilevel_roi_align(s["flist"], boxes, STRIDES, 7, kw["sampling_ratio"])
        want = multilevel_roi_align_plain(s["flist"], boxes,
                                          route_levels(boxes, STRIDES, 2, "canonical"),
                                          STRIDES, 7, kw["sampling_ratio"])
        err, tol, frac, ok = fwd_agreement(got, want)
        print(f"  {what} pooler at bs={BENCH_BATCHES[-1]} x {boxes.shape[1]} boxes: kernel vs "
              f"plain max|diff| {err:.3e} (tol {tol:.1e}, differing {frac:.1e})")
        if not ok:
            raise AssertionError(f"{what} pooler disagrees with plain: {err} (tol {tol}), {frac}")
        pooler_err = max(pooler_err, err)
    del s, got, want

    bs, rounds, iters = BENCH_TRAIN
    records["bench_train"], launches["bench_train"] = _counted(lambda: bench_train.run(
        cfg, bs, torch.bfloat16, rounds=rounds, iters=iters, device=device))
    rec = records["bench_train"]
    if rec["kernel_launches_per_step"] != {"forward": 1.0, "backward": 1.0}:
        raise AssertionError(f"bench_train: launches per step {rec['kernel_launches_per_step']}")
    if rec["nms_launches_per_step"] != NMS_PER_STEP:
        raise AssertionError(f"bench_train: NMS launches per step {rec['nms_launches_per_step']}")
    per_step = rec["profile"]["roi_align_launches_per_call"]
    if per_step != {"roi_align_fwd": 1.0, "roi_align_bwd": 1.0}:
        raise AssertionError(f"bench_train: profiled launches per step {per_step}")
    _check_mfu("bench_train", rec["mfu"])
    if not 1.0 < rec["model_gflop_backward"] / rec["model_gflop_forward"] <= 2.0:
        raise AssertionError(f"bench_train: backward / forward FLOPs "
                             f"{rec['model_gflop_backward'] / rec['model_gflop_forward']}")

    (records["profile_stages"], out, (images, Ks, ratios)), launches["profile_stages"] = \
        _counted(lambda: profile_stages.run(cfg, STAGES_BS, rounds=PROFILE_ROUNDS,
                                            iters=PROFILE_ITERS, device=device, model=model))
    rec = records["profile_stages"]
    _equal_outputs(f"profile_stages bs={STAGES_BS} stage chain", out,
                   rcnn3d.inference(model, images, Ks, ratios, **kw))
    print(f"  profile_stages bs={STAGES_BS}: the stage chain's outputs equal inference's")
    if rec["roi_align_launches_per_call"] != {"roi_align_fwd": 2.0, "roi_align_bwd": 0.0}:
        raise AssertionError(f"profile_stages: profiled launches {rec['roi_align_launches_per_call']}")
    if rec["graphed_hand_kernel_launches_per_call"] != KERNELS_PER_INFERENCE:
        raise AssertionError(f"profile_stages: graphed call's kernel records "
                             f"{rec['graphed_hand_kernel_launches_per_call']}")
    _check_mfu("profile_stages", rec["mfu"])

    (records["profile_backbone"], env, (feats, flist)), _ = _counted(
        lambda: profile_backbone.run(cfg, BACKBONE_BS, rounds=PROFILE_ROUNDS,
                                     iters=PROFILE_ITERS, device=device, model=model))
    if not (all(torch.equal(env["feats"][k], v) for k, v in feats.items())
            and all(torch.equal(a, b) for a, b in zip(env["flist"], flist))):
        raise AssertionError("profile_backbone: the blocks in order differ from model.features")
    print(f"  profile_backbone bs={BACKBONE_BS}: the blocks in order give model.features exactly")
    for name, n in launches.items():
        if n["forward"] == 0:
            raise AssertionError(f"{name}: the forward kernel was not launched")
        if 0 in (n["suppression_words"], n["greedy_keep"]):
            raise AssertionError(f"{name}: an NMS kernel was not launched: {n}")
    print(f"  phase 11 took {time.perf_counter() - t0:.1f} s; kernel launches by tool {launches}")
    return records, launches, pooler_err


# phase 12: the NMS kernels
NMS_SYNC_BS = (1, 8)             # bf16 inference calls checked for host syncs
NMS_CPU_CHUNK = 16               # rows per chunk of the CPU mirror
IOU_OPS = 13                     # float operations per IoU test (4 max / min, 2 sub,
                                 # 2 clamp, mul, add, sub, div, the compare)


def _nms_build_facts(build_log):
    """The NMS kernels' registers, spills and shared memory from the build's
    `ptxas -v` lines (phase 1's log): {kernel: text}."""
    facts, current = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            current = next((k for k in ("nms_words_kernel", "nms_greedy_kernel") if k in name),
                           None)
            if current and "ILb0" in name:          # the t < 0 / NaN instance of the words kernel
                current += " (t < 0 or NaN)"
        elif current and ("registers" in line or "spill" in line):
            facts[current] = (facts.get(current, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return facts


def _nms_case(label, boxes, scores, thresh, valid):
    """One NMS input on the card: the keep mask of `nms_mask` (the kernels)
    against `nms_mask_plain`, the words against the CPU mirror where the
    kernel writes them, the pairs the words kernel's fast IoU test left to
    the division, the launch shapes, the times of both kernels and their
    plain versions (CUDA events, median of 10; the greedy mirror, a loop of
    N steps, 3), of `nms_mask` whole and of the plain fixpoint, and each
    kernel's bound for these inputs."""
    import torch
    from omni3d_tpu_torch.ops import nms as nms_ops
    from omni3d_tpu_torch.ops import nms_cuda
    from omni3d_tpu_torch.tools import profile_nms
    from omni3d_tpu_torch.utils.benchtime import bound

    n = scores.shape[-1]
    R = scores.numel() // n
    _, W, NP = nms_cuda.words_shape(R, n)
    got = nms_ops.nms_mask(boxes, scores, thresh, valid)
    want = nms_ops.nms_mask_plain(boxes, scores, thresh, valid)
    differ = int((got != want).sum())
    boxes_s, valid_s, order = profile_nms.sorted_rows(boxes, scores, valid)
    words = nms_cuda.suppression_words(boxes_s, valid_s, thresh)
    keep_s = nms_cuda.greedy_keep(words, valid_s)
    slow = profile_nms.slow_pairs(boxes_s, valid_s, thresh)
    torch.cuda.synchronize()
    tile_of = torch.arange(NP) // nms_cuda.TILE
    defined = torch.arange(W)[:, None] >= tile_of[None, :]     # blocks (row tile, w >= it)
    words_cpu, boxes_cpu, valid_cpu = words.cpu(), boxes_s.cpu(), valid_s.cpu()
    word_differ = 0
    for r0 in range(0, R, NMS_CPU_CHUNK):
        rows = slice(r0, r0 + NMS_CPU_CHUNK)
        mirror = nms_ops.suppression_words(boxes_cpu[rows], valid_cpu[rows], thresh)
        word_differ += int((words_cpu[rows] != mirror)[:, defined].sum())
    del words_cpu, mirror

    # the work these inputs need: pairs j > i of valid boxes, the words of
    # the blocks w >= row tile, the kept boxes' later words
    vf = valid_cpu.to(torch.int64)
    later_valid = vf.flip(-1).cumsum(-1).flip(-1) - vf             # valid j > i, per i
    pairs = int((later_valid * vf).sum())
    row = dict(case=label, shape=list(scores.shape), threshold=thresh,
               valid=int(valid_s.sum()), kept=int(got.sum()), differing_keep=differ,
               differing_words=word_differ, words_compared=R * int(defined.sum()),
               valid_pairs=pairs, slow_pairs=slow,
               slow_share=slow / pairs if pairs else 0.0,
               launch=nms_cuda.launch_shapes(R, n))
    row["words_ms"] = cuda_ms(lambda: nms_cuda.suppression_words(boxes_s, valid_s, thresh))
    row["greedy_ms"] = cuda_ms(lambda: nms_cuda.greedy_keep(words, valid_s, order))
    row["nms_mask_ms"] = cuda_ms(lambda: nms_ops.nms_mask(boxes, scores, thresh, valid))
    row["fixpoint_ms"] = cuda_ms(lambda: nms_ops.nms_mask_plain(boxes, scores, thresh, valid))
    row["words_plain_ms"] = cuda_ms(lambda: nms_ops.suppression_words(boxes_s, valid_s, thresh))
    row["greedy_plain_ms"] = cuda_ms(lambda: nms_ops.greedy_keep_from_words(words, valid_s),
                                     iters=3, warmup=1)
    torch.cuda.empty_cache()
    # bounds for these inputs: (a) reads the boxes and validity, writes the
    # words of the blocks w >= row tile, tests the pairs of valid boxes;
    # (b) reads validity, the sort order, the diagonal words and the later
    # words of the kept boxes, writes the keep mask
    per_row_words = W * (W + 1) // 2 * nms_cuda.TILE
    later = int(((W - 1 - tile_of[:n])[None, :] * keep_s.cpu()).sum())
    row["words_bound_ms"], row["words_bound_by"] = bound(
        R * n * (16 + 1) + R * per_row_words * 8, IOU_OPS * pairs)
    row["greedy_bound_ms"], row["greedy_bound_by"] = bound(
        R * n * (1 + 8 + 8 + 1) + later * 8, 0)
    print(f"  {label:22s} {tuple(scores.shape)} t={thresh}: kept {row['kept']} of "
          f"{row['valid']} valid; keep vs nms_mask_plain differing {differ}, words vs the "
          f"CPU mirror differing {word_differ} of {row['words_compared']}; slow-path pairs "
          f"{slow} of {pairs} ({row['slow_share']:.2e}); words "
          f"{row['words_ms']:.4f} ms (plain {row['words_plain_ms']:.3f}, bound "
          f"{row['words_bound_ms']:.4f} by {row['words_bound_by']}), greedy "
          f"{row['greedy_ms']:.4f} ms (plain {row['greedy_plain_ms']:.1f}, bound "
          f"{row['greedy_bound_ms']:.4f}); nms_mask {row['nms_mask_ms']:.3f} ms, the plain "
          f"fixpoint {row['fixpoint_ms']:.3f} ms; launch {row['launch']}")
    if differ or word_differ:
        raise AssertionError(f"NMS kernels disagree with the plain version: {row}")
    return row


def _sync_count(fn):
    """fn() under `torch.cuda.set_sync_debug_mode("warn")`: {the Python
    line that made it: count} of the synchronising CUDA calls it made."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = {}
    for w in caught:
        if "called a synchronizing CUDA operation" in str(w.message):
            key = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return where


def _nms_sync_checks(device):
    """bf16 inference at NMS_SYNC_BS with `select_proposals` and
    `fast_rcnn_inference` run under `set_sync_debug_mode("error")` (a
    synchronising call inside them raises), then the synchronising calls of
    one whole `inference` call counted, with the kernels and with
    `nms_mask_plain` patched in (the parent's NMS)."""
    import torch
    from omni3d_tpu_torch.models import rcnn3d
    from omni3d_tpu_torch.ops import nms as nms_ops
    from omni3d_tpu_torch.tools import bench

    cfg = bench.config()
    kw = rcnn3d.inference_kwargs(cfg)
    model = bench.random_model(cfg, device)
    data = bench.inputs(cfg, NMS_SYNC_BS, bench.IMG, device)

    def strict(fn):
        def call(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return call

    result = {}
    originals = rcnn3d.select_proposals, rcnn3d.fast_rcnn_inference
    kernel_nms = nms_ops.nms_mask
    with torch.no_grad():
        for bs in NMS_SYNC_BS:
            _, images, Ks, ratios = data[bs]
            call = lambda: rcnn3d.inference(model, images, Ks, ratios, **kw)  # noqa: E731
            call()
            torch.cuda.synchronize()
            rcnn3d.select_proposals, rcnn3d.fast_rcnn_inference = map(strict, originals)
            try:
                call()
                torch.cuda.synchronize()
            finally:
                rcnn3d.select_proposals, rcnn3d.fast_rcnn_inference = originals
            after = _sync_count(call)
            nms_ops.nms_mask = nms_ops.nms_mask_plain
            try:
                before = _sync_count(call)
            finally:
                nms_ops.nms_mask = kernel_nms
            result[f"bs{bs}"] = dict(
                select_and_class_nms_under_error_mode="no synchronising call",
                syncs_per_call_kernels=sum(after.values()), where_kernels=after,
                syncs_per_call_plain_fixpoint=sum(before.values()), where_plain_fixpoint=before)
            print(f"  bf16 bs={bs}: select_proposals and fast_rcnn_inference under "
                  f"set_sync_debug_mode('error'): no synchronising call; syncs per inference "
                  f"call {sum(after.values())} with the kernels {after}, "
                  f"{sum(before.values())} with the plain fixpoint {before}")
    del model
    torch.cuda.empty_cache()
    return result


NMS_KERNELS = {   # wrapper: (C entry point, row key, error key, device kernel)
    "suppression_words": ("nms_suppression_words", "words", "differing_words", "nms_words_kernel"),
    "greedy_keep": ("nms_greedy_keep", "greedy", "differing_keep", "nms_greedy_kernel"),
}
NMS_TIMED_CASE = "rpn test bs 32"


def nms_kernel_entry(kernel, rows, launches_by_path, build):
    """The kernel line's entry of an NMS kernel: launches in the main
    paths' runs (phases 3, 5 and 11), times and bound at the recorded RPN
    input of the bench's bs 32 batch, its build facts, and every case's
    times, launch shape (and, for the words, slow-path pairs)."""
    name, key, differ, device_kernel = NMS_KERNELS[kernel]
    main = next(r for r in rows if r["case"] == NMS_TIMED_CASE)
    return {
        "name": name, "route": "cuda", "source": "omni3d_tpu_torch/csrc/nms.cu",
        "replaces": "omni3d_tpu/ops/nms.py:55",
        "also_replaces": "omni3d_tpu/ops/nms.py:38 (_fixpoint_keep's lax.while_loop)",
        "launches": sum(launches_by_path.values()), "launches_by_path": launches_by_path,
        "max_abs_err": float(max(r[differ] for r in rows)),
        "ms": main[f"{key}_ms"], "plain_ms": main[f"{key}_plain_ms"],
        "bound_ms": main[f"{key}_bound_ms"], "bound_by": main[f"{key}_bound_by"],
        "library_ms": None,
        "timed_case": f"{NMS_TIMED_CASE}: {main['shape']} recorded in bf16 inference, "
                      f"t {main['threshold']} (the kernel alone on its inputs)",
        "build": {k: v for k, v in build.items() if k.startswith(device_kernel)},
        "cases": [{**{k: r[k] for k in ("case", "source", "shape", f"{key}_ms", f"{key}_plain_ms",
                                         f"{key}_bound_ms", f"{key}_bound_by", differ,
                                         "nms_mask_ms", "fixpoint_ms")},
                   "launch": r["launch"][device_kernel],
                   **({"slow_pairs": r["slow_pairs"], "slow_share": r["slow_share"]}
                      if kernel == "suppression_words" else {})} for r in rows],
    }


def nms_path(device, build_log):
    """Phase 12: the NMS kernels' build facts, then the kernels against
    `nms_mask_plain` and the CPU mirror at the main path's shapes on three
    sources of boxes (recorded from the bench's batches, seeded clusters,
    seeded near-threshold pairs), with times and bounds; then the host-sync
    checks."""
    from omni3d_tpu_torch.tools import profile_nms
    t0 = time.perf_counter()
    facts = _nms_build_facts(build_log)
    for kernel, text in facts.items():
        print(f"  {kernel}: {text}")
    if not any(k.startswith("nms_words_kernel") for k in facts) or \
            "nms_greedy_kernel" not in facts:
        raise AssertionError(f"phase 1's log lacks the NMS kernels' ptxas lines: {facts}")
    rows = []
    for label, source, boxes, scores, thresh, valid in profile_nms.cases(device):
        rows.append(dict(_nms_case(label, boxes, scores, thresh, valid), source=source))
        del boxes, scores, valid
    near = [r for r in rows if r["source"].endswith("near-threshold pairs")]
    if not near or not all(r["slow_pairs"] for r in near):
        raise AssertionError("a near-threshold case took no slow-path pair")
    syncs = _nms_sync_checks(device)
    print(f"  phase 12 took {time.perf_counter() - t0:.1f} s")
    return dict(build=facts, cases=rows, host_syncs=syncs)


# phase 13: inference_step, one CUDA graph per padded shape
GRAPH_BATCHES = (1, 8, 32)
GRAPH_ORDER = (1, 8, 1, 32, 8)      # replays after the captures: A, B, A, C, B
GRAPH_ALIAS_BS = 8                  # the batch of the aliasing and weight checks
GRAPH_PROFILED_CALLS = 5
GRAPH_ROUNDS, GRAPH_ITERS = 3, 5    # eager vs graphed in turns, per dtype and batch
WEIGHT_NOISE = 0.05                 # load_state_dict: each parameter x (1 + 0.05 N(0, 1))


def _predictions(out_dir, name):
    """The predictions `do_test` wrote for split `name` under `out_dir`."""
    import pickle
    with open(os.path.join(out_dir, "inference", "iter_final", name,
                           "instances_predictions.pkl"), "rb") as f:
        return pickle.load(f)


def _differs(a, b):
    import torch
    return any(not torch.equal(a[k], b[k]) for k in a)


def graph_path(device, tmp, weights, models, card):
    """Phase 13: `rcnn3d.inference_step` at full width (phase 3's DLA34-FPN
    models, f32 with TF32 off and bf16; 512 px; bs 1, 8 and 32) against
    eager `inference` on the same inputs, with the launch counts at 0 just
    before. Checks, each raising: every output bit-equal to eager at the
    first call (the eager warm-up) and at replays in the order GRAPH_ORDER
    (A, B, A over two shapes); the first call at each shape (the warm-up and
    the capture) launched 4 forward, 0 backward and 4 + 4 NMS kernels
    through the wrappers; per replayed call the profiler's kernel records
    hold 2 / 0 / 2 + 2; no synchronising call inside a replay
    (`set_sync_debug_mode("error")`); an earlier call's outputs unchanged by
    a later call at the same shape on other images; after `load_state_dict`
    of other seeded weights the replay (no new capture) equals eager with
    those weights; a parameter rebound to new storage raises the recapture
    count and the new graph equals eager; phase 7's `--eval-only`
    predictions (through `inference_step`) equal an eager run's from the
    same checkpoint at both batch sizes. Prints, with no pass or fail: the
    first call's ms per shape (eager warm-up and capture), the pool's
    bytes, and eager vs graphed ms per call and busy share in turns. Returns
    (summary, wrapper launches during the phase, the replays: their count
    and the hand-written kernels' records in the profiled ones)."""
    import torch
    from omni3d_tpu_torch.engine import loop
    from omni3d_tpu_torch.models import rcnn3d
    from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
    from omni3d_tpu_torch.tools import train_net
    from omni3d_tpu_torch.utils import benchtime as bt

    t0 = time.perf_counter()
    cfg = _config("cubercnn_DLA34_FPN.yaml")
    kw = rcnn3d.inference_kwargs(cfg)
    C = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    multilevel_roi_align.launches = 0          # counts of this path's run only
    multilevel_roi_align.bwd_launches = 0
    _reset_nms_counts()
    _reset_graph_counts()
    summary = {"card": card}
    profiled = dict(replays=0, kernel_records=dict.fromkeys(KERNELS_PER_INFERENCE, 0))

    def profile_replays(fn):
        """`device_profile` of GRAPH_PROFILED_CALLS replays of `fn`, adding
        their kernel records to `profiled`."""
        prof = bt.device_profile(fn, GRAPH_PROFILED_CALLS, device)
        profiled["replays"] += GRAPH_PROFILED_CALLS
        for k, n in prof["hand_kernel_launches_per_call"].items():
            profiled["kernel_records"][k] += round(n * GRAPH_PROFILED_CALLS)
        return prof

    for dtype, model in models.items():
        name = str(dtype).replace("torch.", "")
        model.inference_graphs = None           # phase 13 captures its own graphs
        data = {bs: main_path_inputs(cfg, bs, device) for bs in GRAPH_BATCHES}
        eager = {bs: rcnn3d.inference(model, *data[bs], **kw) for bs in GRAPH_BATCHES}

        def step(bs, d=None):
            return rcnn3d.inference_step(model, *(data[bs] if d is None else d), **kw)
        shapes = {}
        counts0 = _graph_counts()
        for bs in GRAPH_BATCHES:
            check_outputs(eager[bs], bs, kw["topk"], C)
            torch.cuda.synchronize()
            before, t1 = rcnn3d.kernel_launch_counts(), time.perf_counter()
            got = step(bs)                       # the eager warm-up and the capture
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t1) * 1e3
            after = rcnn3d.kernel_launch_counts()
            launched = {k: after[k] - before[k] for k in after}
            if launched != {k: 2 * n for k, n in KERNELS_PER_INFERENCE.items()}:
                raise AssertionError(f"{name} bs={bs}: the first call (warm-up and capture) "
                                     f"launched {launched}")
            _equal_outputs(f"{name} bs={bs} first inference_step call", got, eager[bs])
            shapes[bs] = dict(first_call_ms=first_ms, first_call_wrapper_launches=launched)
        graphs = model.inference_graphs
        for bs in GRAPH_ORDER:
            _equal_outputs(f"{name} bs={bs} replay", step(bs), eager[bs])
        counts = tuple(b - a for a, b in zip(counts0, _graph_counts()))
        assert counts == (len(GRAPH_BATCHES), len(GRAPH_ORDER)), counts
        for bs in GRAPH_BATCHES:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")   # raises on a synchronising call
            try:
                step(bs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            prof = profile_replays(lambda bs=bs: step(bs))
            if prof["hand_kernel_launches_per_call"] != KERNELS_PER_INFERENCE:
                raise AssertionError(f"{name} bs={bs}: kernel records per replayed call "
                                     f"{prof['hand_kernel_launches_per_call']}")
            shapes[bs].update(kernels_per_replay=prof["kernels_per_call"],
                              hand_kernels_per_replay=prof["hand_kernel_launches_per_call"])
        print(f"  {name}: outputs bit-equal to eager at bs {GRAPH_BATCHES} (first calls) and "
              f"at replays in the order {GRAPH_ORDER}; per replayed call the kernel records "
              f"hold {KERNELS_PER_INFERENCE}; no synchronising call in a replay")

        # eager vs graphed in turns (no pass or fail)
        cases = {}
        for bs in GRAPH_BATCHES:
            cases[("graphed", bs)] = lambda bs=bs: bt.timed_calls(lambda: step(bs), GRAPH_ITERS)
            cases[("eager", bs)] = lambda bs=bs: bt.timed_calls(
                lambda: rcnn3d.inference(model, *data[bs], **kw), GRAPH_ITERS)
        times = bt.in_turns(cases, GRAPH_ROUNDS)
        for bs in GRAPH_BATCHES:
            row = shapes[bs]
            for mode in ("eager", "graphed"):
                prof = (profile_replays(lambda bs=bs: step(bs)) if mode == "graphed" else
                        bt.device_profile(lambda bs=bs: rcnn3d.inference(model, *data[bs], **kw),
                                          GRAPH_PROFILED_CALLS, device))
                t = times[(mode, bs)]
                row[mode] = dict(ms=t, device_busy_ms=prof["device_busy_ms_per_call"],
                                 busy_share=bt.busy_share(prof, t["median_ms"]),
                                 kernels_per_call=prof["kernels_per_call"])
            print(f"  {name} bs={bs}: first call (warm-up and capture) "
                  f"{row['first_call_ms']:.1f} ms; ms per call eager "
                  f"{row['eager']['ms']['median_ms']:.2f} ({row['eager']['ms']['min_ms']:.2f}-"
                  f"{row['eager']['ms']['max_ms']:.2f}), busy "
                  f"{100 * row['eager']['busy_share']:.0f}%; graphed "
                  f"{row['graphed']['ms']['median_ms']:.2f} ({row['graphed']['ms']['min_ms']:.2f}"
                  f"-{row['graphed']['ms']['max_ms']:.2f}), busy "
                  f"{100 * row['graphed']['busy_share']:.0f}%, device "
                  f"{row['graphed']['device_busy_ms']:.2f} ms; {card}")
        pool = graphs.pool_bytes()
        print(f"  {name}: the graphs' pool holds {pool / 2 ** 20:.1f} MiB; {card}")

        # no aliasing: a later call at the same shape leaves an earlier result
        bs = GRAPH_ALIAS_BS
        other = (data[bs][0].flip(2).contiguous(),) + data[bs][1:]
        want_other = rcnn3d.inference(model, *other, **kw)
        if not _differs(want_other, eager[bs]):
            raise AssertionError("the flipped images give the same outputs: no aliasing test")
        first, second = step(bs), step(bs, other)
        _equal_outputs(f"{name} bs={bs} first of two replays", first, eager[bs])
        _equal_outputs(f"{name} bs={bs} second of two replays", second, want_other)

        # weights written in place are seen; no new capture
        gen = torch.Generator().manual_seed(1)
        state = model.state_dict()
        for k, p in model.named_parameters():
            noise = 1 + WEIGHT_NOISE * torch.randn(p.shape, generator=gen)
            state[k] = (p.detach().float().cpu() * noise).to(p.dtype)
        model.load_state_dict(state)
        captures = _graph_counts()[0]
        got, want = step(bs), rcnn3d.inference(model, *data[bs], **kw)
        _equal_outputs(f"{name} bs={bs} after load_state_dict", got, want)
        assert _graph_counts()[0] == captures and graphs.recaptures == 0, \
            (_graph_counts(), graphs.recaptures)
        if not _differs(want, eager[bs]):
            raise AssertionError("the reloaded weights give the same outputs")

        # a parameter rebound to new storage: the graphs are captured again
        p = next(model.roi_heads.box_predictor.parameters())
        p.data = p.data * 0.5
        got, want = step(bs), rcnn3d.inference(model, *data[bs], **kw)
        assert graphs.recaptures == 1 and _graph_counts()[0] == captures + 1, \
            (graphs.recaptures, _graph_counts())
        _equal_outputs(f"{name} bs={bs} after rebinding", got, want)
        got = step(bs)                           # and the new graph replays
        _equal_outputs(f"{name} bs={bs} replay after rebinding", got, want)
        print(f"  {name} bs={bs}: an earlier result unchanged by a later call; after "
              "load_state_dict the replay equals eager with the new weights (no capture); a "
              "rebound parameter recaptured (recaptures 1), then equal to eager")
        summary[name] = dict(shapes=shapes, pool_bytes=pool, recaptures=graphs.recaptures,
                             **dict(zip(("captures", "replays"),
                                        (b - a for a, b in zip(counts0, _graph_counts())))))
        model.inference_graphs = None
        del data, eager, got, want, first, second
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = {"forward": multilevel_roi_align.launches,
                "backward": multilevel_roi_align.bwd_launches, **_nms_counts()}
    captures, replays = _graph_counts()
    replayed = dict(replays=replays, profiled_replays=profiled["replays"],
                    kernel_records_in_profiled_replays=profiled["kernel_records"])
    print(f"  wrapper launches in phase 13's graphed run {launches} ({captures} captures, "
          f"{replays} replays; the hand-written kernels' records in the "
          f"{profiled['replays']} profiled replays {profiled['kernel_records']})")
    if launches["backward"] or 0 in (launches["forward"], launches["suppression_words"],
                                     launches["greedy_keep"]):
        raise AssertionError(f"phase 13: wrapper launches {launches}")

    # phase 7's graphed --eval-only predictions against an eager run
    real = loop.inference_step
    for bs in EVAL_BATCH_SIZES:
        out_dir = os.path.join(tmp, f"eval_eager_bs{bs}")
        loop.inference_step = rcnn3d.inference
        try:
            train_net.main(eval_argv(device, tmp, weights, bs, out_dir))
        finally:
            loop.inference_step = real
        n = 0
        for name in EVAL_SPLITS:
            got, want = (_predictions(d, name) for d in (os.path.join(tmp, f"eval_bs{bs}"),
                                                         out_dir))
            if got != want:
                raise AssertionError(f"--eval-only bs {bs} {name}: the graphed predictions "
                                     f"differ from the eager run's")
            n += len(got)
        print(f"  --eval-only bs {bs}: phase 7's {n} predictions (inference_step) equal an "
              "eager run's from the same checkpoint")
    summary["eval_predictions_equal_eager"] = list(EVAL_BATCH_SIZES)
    summary["phase_wall_s"] = time.perf_counter() - t0
    print(f"  phase 13 took {summary['phase_wall_s']:.1f} s")
    return summary, launches, replayed


def replay_records(replayed, kernel):
    """Phase 13's replays for one kernel's entry of the kernels line: the
    replays counted, how many of them were profiled, and the kernel's records
    in those (a replay runs no wrapper, so `launches` leaves them out)."""
    return dict(replays=replayed["replays"], profiled_replays=replayed["profiled_replays"],
                kernel_records=replayed["kernel_records_in_profiled_replays"][kernel])


# phase 14: the train-mode BatchNorm kernels
# DLA-34's train-mode BN layers at 512 x 768, batch 32: (N, C, H, W), the
# layers of that shape a step runs forward and backward (the two trees'
# unused projections, one at 128 and one at 256 channels, run under no_grad)
BN_TRUNK = (((32, 16, 512, 768), 2, 2), ((32, 32, 256, 384), 1, 1), ((32, 64, 128, 192), 6, 6),
            ((32, 128, 64, 96), 12, 11), ((32, 256, 32, 48), 12, 11), ((32, 512, 16, 24), 6, 6))
# against the plain float32 formula: this share of the largest |value| (the
# float32 formula's own one-pass variance error), and for y and dx half a
# bf16 ULP of each value more (their one rounding)
BN_REL = 2e-4
BN_PROFILED_CALLS = 10
BN_CHILD_TIMEOUT_S = 300


def _bn_build_facts(build_log):
    """The BN kernels' registers and spills from the build's `ptxas -v`
    lines (phase 1's log): {mangled kernel name: text}."""
    facts, current = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            current = name if "omni3d_bn_" in name else None
        elif current and ("registers" in line or "spill" in line):
            facts[current] = (facts.get(current, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return facts


def bn_plain(x, weight, bias, running_mean, running_var, dy):
    """`BatchNorm2d`'s train-mode formula in float32 through autograd (the
    module's plain path, written out so that it runs on the card): y, dx,
    grad_weight, grad_bias, the running statistics after the update."""
    import torch
    xf = x.float().requires_grad_()
    w, b = weight.clone().requires_grad_(), bias.clone().requires_grad_()
    mean = xf.mean(dim=(0, 2, 3))
    var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
    a = w * torch.rsqrt(var + 1e-5)
    y = xf * a[:, None, None] + (b - mean * a)[:, None, None]
    y.backward(dy.float())
    with torch.no_grad():
        running = (0.9 * running_mean + 0.1 * mean, 0.9 * running_var + 0.1 * var)
    return y.detach(), xf.grad, w.grad, b.grad, running


def _bn_err(got, want, bf16):
    """max |got - want| over the largest |want|, and whether every element
    is within BN_REL of that (plus half a bf16 ULP of its value where
    `bf16`)."""
    got, want = got.double(), want.double()
    scale = float(want.abs().max())
    tol = BN_REL * scale + (2.0 ** -8 * want.abs() if bf16 else 0.0)
    return float((got - want).abs().max()) / scale, bool(((got - want).abs() <= tol).all())


def _bn_kernel_ms(fn, calls=BN_PROFILED_CALLS, sessions=3):
    """Device ms per call of the BN kernels' records (`omni3d_bn_` in the
    name) of `fn()` under torch.profiler, mean of `calls` after one more
    call. A session counts only if it holds `calls` records of each of three
    kernels (reduce, merge, apply); one that does not is run again, up to
    `sessions` in all, and then this raises. Returns (ms, sessions run)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        recs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and "omni3d_bn_" in e.name]
        names = {e.name: sum(r.name == e.name for r in recs) for e in recs}
        if sorted(names.values()) == [calls] * 3:
            return sum(e.time_range.end - e.time_range.start for e in recs) / 1e3 / calls, session
    raise AssertionError(f"{sessions} profiler sessions of {calls} calls: BN kernel records {names}")


def _bn_counts():
    """Train-mode `BatchNorm2d` calls by path and the BN wrappers' launches."""
    from omni3d_tpu_torch.models import layers
    from omni3d_tpu_torch.ops import batch_norm_cuda as bnc
    return {**layers.bn_calls, "forward": bnc.forward.launches,
            "backward": bnc.backward.launches}


def bn_path(device, build_log, tmp):
    """Phase 14: the BN kernels' build facts, then `bn_shapes` in a process
    of its own (`torch.profiler` there has recorded nothing before: after
    the other phases, a session in this process missed or mixed kernel
    records)."""
    from omni3d_tpu_torch.parallel.dist import run_spawned
    t0 = time.perf_counter()
    facts = _bn_build_facts(build_log)
    for kernel, text in facts.items():
        print(f"  {kernel[:70]}: {text}")
    if not facts:
        raise AssertionError("phase 1's log lacks the BN kernels' ptxas lines")
    path = os.path.join(tmp, "batch_norm.json")
    run_spawned(_bn_child, [(str(device), path)], BN_CHILD_TIMEOUT_S)
    with open(path) as f:
        res = json.load(f)
    print(f"  phase 14 took {time.perf_counter() - t0:.1f} s")
    return dict(build=facts, **res)


def _bn_child(device, result_path):
    torch = _child_setup()
    with open(result_path, "w") as f:
        json.dump(bn_shapes(torch.device(device)), f)


def bn_shapes(device):
    """`batch_norm_cuda.forward` and `backward` at each of DLA-34's
    train-mode BN shapes (bf16, batch 32, 512 x 768) against their mirror
    bit for bit and the plain float32 formula (y, dx, the parameters'
    gradients, the running update), two calls bit-equal, with the wrappers'
    ms (CUDA events), the kernels' device ms (torch.profiler), the plain
    formula's ms and the bytes bounds; the step's totals over its 39
    forward and 37 backward layers."""
    import torch
    from omni3d_tpu_torch.ops import batch_norm_cuda as bnc
    from omni3d_tpu_torch.utils.benchtime import bound

    before = _bn_counts()
    rows, calls = [], 0
    profiled = {"forward": 0, "backward": 0}
    for (n, c, h, w), fwd_layers, bwd_layers in BN_TRUNK:
        torch.cuda.empty_cache()
        g = torch.Generator(device=device).manual_seed(c)
        x = (torch.randn(n, h, w, c, generator=g, device=device) * 0.5 + 3).bfloat16()
        x = x.permute(0, 3, 1, 2)
        dy = torch.randn(n, h, w, c, generator=g, device=device).bfloat16().permute(0, 3, 1, 2)
        weight = torch.rand(c, generator=g, device=device) + 0.5
        bias = torch.randn(c, generator=g, device=device)
        stats0 = (torch.randn(c, generator=g, device=device),
                  torch.rand(c, generator=g, device=device) + 0.5)
        running = [s.clone() for s in stats0]
        y, stats = bnc.forward(x, weight, bias, *running, True)
        dx, gw, gb = bnc.backward(x, dy, stats)
        mirror_running = [s.clone() for s in stats0]
        y_m, stats_m = bnc.forward_mirror(x, weight, bias, *mirror_running, True)
        want = (y_m, stats_m, *mirror_running, *bnc.backward_mirror(x, dy, stats_m))
        if not all(torch.equal(a, b) for a, b in zip((y, stats, *running, dx, gw, gb), want)):
            raise AssertionError(f"BN {(n, c, h, w)}: the kernels differ from their mirror")
        del y_m, stats_m, want
        again = bnc.forward(x, weight, bias, *[s.clone() for s in stats0], True)
        again = (*again, *bnc.backward(x, dy, again[1]))
        if not all(torch.equal(a, b) for a, b in zip((y, stats, dx, gw, gb), again)):
            raise AssertionError(f"BN {(n, c, h, w)}: two calls differ")
        del again
        want = bn_plain(x, weight, bias, *stats0, dy)
        errs = {}
        for name, got, ref, bf16 in (("y", y, want[0], True), ("dx", dx, want[1], True),
                                     ("grad_weight", gw, want[2], False),
                                     ("grad_bias", gb, want[3], False),
                                     ("running_mean", running[0], want[4][0], False),
                                     ("running_var", running[1], want[4][1], False)):
            errs[name], ok = _bn_err(got, ref, bf16)
            if not ok:
                raise AssertionError(f"BN {(n, c, h, w)} {name}: {errs[name]:.2e} of the largest "
                                     f"against the plain float32 formula (tol {BN_REL})")
        del want, y, dx
        fwd = lambda: bnc.forward(x, weight, bias, *running, False)
        bwd = lambda: bnc.backward(x, dy, stats)
        fwd_dev, fwd_sessions = _bn_kernel_ms(fwd)
        bwd_dev, bwd_sessions = _bn_kernel_ms(bwd)
        fwd_ms, bwd_ms = cuda_ms(fwd), cuda_ms(bwd)          # 3 warm-up and 10 timed calls
        calls += 2 + 13                # and the profiled calls: one, then 10 a session
        profiled["forward"] += 1 + fwd_sessions * BN_PROFILED_CALLS
        profiled["backward"] += 1 + bwd_sessions * BN_PROFILED_CALLS
        act = n * h * w * c * 2                  # bytes of one bf16 activation
        row = dict(shape=[n, c, h, w], layers_forward=fwd_layers, layers_backward=bwd_layers,
                   max_rel_err_vs_plain_f32=errs, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
                   fwd_device_ms=fwd_dev, bwd_device_ms=bwd_dev,
                   profiler_sessions=[fwd_sessions, bwd_sessions],
                   plain_ms=cuda_ms(lambda: bn_plain(x, weight, bias, *stats0, dy), iters=3,
                                    warmup=1),
                   # once: x read and y written; x and dy read and dx written
                   fwd_bound_ms=bound(2 * act, 0)[0], bwd_bound_ms=bound(3 * act, 0)[0],
                   # two passes: x read twice forward; x and dy read twice backward
                   fwd_two_pass_ms=bound(3 * act, 0)[0], bwd_two_pass_ms=bound(5 * act, 0)[0])
        rows.append(row)
        print(f"  bf16 {n}x{c}x{h}x{w}: == mirror, two calls bit-equal; vs plain f32 "
              + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
              + f"; device fwd {fwd_dev * 1e3:.1f} / bwd {bwd_dev * 1e3:.1f} us (bound "
              f"{row['fwd_bound_ms'] * 1e3:.1f} / {row['bwd_bound_ms'] * 1e3:.1f}, two passes "
              f"{row['fwd_two_pass_ms'] * 1e3:.1f} / {row['bwd_two_pass_ms'] * 1e3:.1f}); "
              f"wrappers {fwd_ms:.3f} / {bwd_ms:.3f} ms; plain fwd + bwd {row['plain_ms']:.3f} ms; "
              f"profiler sessions {fwd_sessions} / {bwd_sessions}")
        del x, dy, stats
    launches = _count_diff(before, _bn_counts())
    if launches != {"fused": 0, "plain": 0, "forward": calls + profiled["forward"],
                    "backward": calls + profiled["backward"]}:
        raise AssertionError(f"phase 14: counts {launches}, {calls} calls each way")
    step = {k: sum(r[k] * r["layers_forward"] for r in rows)
            for k in ("fwd_ms", "fwd_device_ms", "fwd_bound_ms", "fwd_two_pass_ms")}
    step.update({k: sum(r[k] * r["layers_backward"] for r in rows)
                 for k in ("bwd_ms", "bwd_device_ms", "bwd_bound_ms", "bwd_two_pass_ms")})
    step.update(layers_forward=sum(r["layers_forward"] for r in rows),
                layers_backward=sum(r["layers_backward"] for r in rows),
                activations=sum(math.prod(r["shape"]) * r["layers_forward"] for r in rows),
                plain_ms=sum(r["plain_ms"] * r["layers_forward"] for r in rows))
    print(f"  a DLA-34 step ({step['layers_forward']} forward, {step['layers_backward']} "
          f"backward, {step['activations'] / 1e9:.4f} G activations): device "
          f"{step['fwd_device_ms']:.3f} + {step['bwd_device_ms']:.3f} ms, bound once "
          f"{step['fwd_bound_ms'] + step['bwd_bound_ms']:.3f} ms, two passes "
          f"{step['fwd_two_pass_ms'] + step['bwd_two_pass_ms']:.3f} ms; the plain formula "
          f"{step['plain_ms']:.2f} ms (forward and backward of all {step['layers_forward']})")
    print(f"  wrapper launches {launches}", flush=True)
    return dict(shapes=rows, step=step, launches=launches)


def bn_kernel_entry(way, bn, launches_by_path):
    """The kernels line's entry of the BN kernels one way ("forward": reduce,
    merge, apply; "backward": reduce, merge, apply): launches through the
    wrapper in phases 5, 6, 9 and 14, the largest error against the plain
    float32 formula and phase 14's step totals (device ms of the kernel
    records, the bytes bound once and in two passes)."""
    short = {"forward": "fwd", "backward": "bwd"}[way]
    names = ("y",) if way == "forward" else ("dx", "grad_weight", "grad_bias")
    step = bn["step"]
    return {
        "name": f"batch_norm_train_{way}", "route": "cuda",
        "source": "omni3d_tpu_torch/csrc/batch_norm.cu",
        "replaces": "omni3d_tpu/models/layers.py:195 (_TrainPackedBN, left to XLA's fusion)",
        "launches": sum(launches_by_path.values()), "launches_by_path": launches_by_path,
        "max_rel_err_vs_plain_f32": max(r["max_rel_err_vs_plain_f32"][k] for r in bn["shapes"]
                                        for k in names),
        "ms": step[f"{short}_device_ms"], "wrapper_ms": step[f"{short}_ms"],
        "plain_ms": None, "plain_fwd_bwd_ms": step["plain_ms"],
        "bound_ms": step[f"{short}_bound_ms"], "bound_by": "bytes",
        "two_pass_bound_ms": step[f"{short}_two_pass_ms"], "library_ms": None,
        "timed_case": f"a bf16 DLA-34 step's {step[f'layers_{way}']} train-mode BN layers at "
                      "512 x 768, batch 32 (kernel records, torch.profiler, mean of "
                      f"{BN_PROFILED_CALLS} per shape)",
        "bit_reproducible": True,
        "build": {k: v for k, v in bn["build"].items()},
    }


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
    from omni3d_tpu_torch.utils.benchtime import card as card_of
    card = card_of()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; TF32 off (cuDNN and matmul)")

    from omni3d_tpu_torch.utils import cuda_build
    print("[1/14] build")
    path, secs, build_log = cuda_build.build()
    print(f"  {os.path.relpath(path, ROOT)} built in {secs:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip()[:160])
    if sys.argv[1:2] == ["--gate-probe"]:
        print(f"phase 5's old gate state, {sys.argv[2]} replays")
        gate_probe(device, int(sys.argv[2]))
        return

    print("[2/14] forward kernel vs plain PyTorch version")
    main_case, worst = kernel_vs_plain(device)

    print("[3/14] inference main path: DLA34-FPN inference at 512 px")
    timings, launches, models, inference_check = main_path(device)

    print("[4/14] backward kernel vs plain PyTorch version")
    worst_bwd = bwd_vs_plain(device)
    at_train = time_kernels_at_train_shape(device)

    print("[5/14] training main path: DLA34-FPN training steps at 512 px")
    train_rows, train_launches, plain_cmp = train_path(device)

    with tempfile.TemporaryDirectory() as tmp:
        print("[6/14] training entry point: tools.train_net on a synthetic Omni3D-format dataset")
        entry, entry_launches, weights = entry_point_path(device, tmp)

        print("[7/14] evaluation: tools.train_net --eval-only on synthetic test splits")
        evaluation, eval_launches = evaluation_path(device, tmp, weights)

        print("[8/14] data parallelism: DDP over NCCL at world size 1, two ranks on the card "
              "over gloo, --eval-only at world size 2")
        distributed, ddp_launches = distributed_path(device, tmp, weights)

        print("[9/14] other backbones at full width: ResNet34-FPN as phases 3 and 5-7 drive "
              "DLA-34, then every other builder and DLA variant")
        backbones, bb_launches = backbones_path(device, tmp, timings, train_rows)

        print("[10/14] the demo: JPEG fixtures, tools.demo at full width, render_depth_map on "
              "the card, train_net with VIS_PERIOD and TEST.EVAL_PERIOD")
        demo, demo_launches = demo_path(device, tmp, weights)

        print("[11/14] the measurement tools: tools.bench at bs 1 / 8 / 32, tools.bench_train "
              "at bf16 bs 32, tools.profile_stages, tools.profile_backbone")
        measurement, tool_launches, tools_pooler_err = measurement_path(device)

        print("[12/14] the NMS kernels vs plain PyTorch version; host syncs of the proposal "
              "and detection NMS")
        nms = nms_path(device, build_log)

        print("[13/14] inference_step: one CUDA graph per padded shape at full width, f32 and "
              "bf16 at bs 1 / 8 / 32, against eager inference")
        graphs, graph_launches, graph_replayed = graph_path(device, tmp, weights, models, card)

        print("[14/14] the train-mode BatchNorm kernels vs the plain formula at DLA-34's trunk "
              "shapes, bf16, bs 32, 512 x 768")
        bn = bn_path(device, build_log, tmp)

    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "omni3d_tpu")]
    assert not bad, bad
    print("inference: " + json.dumps(timings))
    print("training: " + json.dumps(dict(steps=train_rows, plain_pooler_step=plain_cmp)))
    print("training entry point: " + json.dumps(entry))
    print("evaluation: " + json.dumps(evaluation))
    print("distributed: " + json.dumps(distributed))
    print("backbones: " + json.dumps(backbones))
    print("demo: " + json.dumps(demo))
    print("measurement: " + json.dumps(measurement))
    print("nms: " + json.dumps(nms))
    print("graphs: " + json.dumps(graphs))
    print("batch_norm: " + json.dumps(bn))
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
                     + bb_launches["forward"] + demo_launches["forward"]
                     + sum(n["forward"] for n in tool_launches.values())
                     + graph_launches["forward"]),
        "launches_by_path": {"inference": launches, "training": train_launches["forward"],
                             "training_entry_point": entry_launches["forward"],
                             "evaluation": eval_launches["forward"],
                             "distributed": ddp_launches["forward"],
                             "backbones": bb_launches["forward"],
                             "demo": demo_launches["forward"],
                             **{k: n["forward"] for k, n in tool_launches.items()},
                             "graphs": graph_launches["forward"]},
        "graph_replays": replay_records(graph_replayed, "roi_align_fwd"),
        "max_abs_err": max(worst, at_train["fwd_max_abs_err"], tools_pooler_err,
                           evaluation["roi_align_fwd_max_abs_err"],
                           max(c["max_abs_err"] for c in demo["demo"]["pooler_vs_plain"]),
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
                     + ddp_launches["backward"] + bb_launches["backward"]
                     + sum(n["backward"] for n in tool_launches.values())),
        "launches_by_path": {"training": train_launches["backward"],
                             "training_entry_point": entry_launches["backward"],
                             "evaluation": eval_launches["backward"],
                             "distributed": ddp_launches["backward"],
                             "backbones": bb_launches["backward"],
                             "demo": demo_launches["backward"],
                             **{k: n["backward"] for k, n in tool_launches.items()},
                             "graphs": graph_launches["backward"]},
        "graph_replays": replay_records(graph_replayed, "roi_align_bwd"),
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
    }] + [dict(nms_kernel_entry(kernel, nms["cases"], {
        "inference": inference_check["nms_launches"][kernel],
        "training": train_launches[kernel],
        **{k: n[kernel] for k, n in tool_launches.items()},
        "graphs": graph_launches[kernel]}, nms["build"]),
        graph_replays=replay_records(graph_replayed, kernel))
        for kernel in ("suppression_words", "greedy_keep")]
        + [bn_kernel_entry(way, bn, {
            "training": train_launches["bn"][way],
            "training_entry_point": entry["bn"][way],
            "backbones": sum(r["bn_total"][way] for r in (
                backbones["resnet34"]["training"], backbones["resnet34"]["training_remat_backbone"],
                *(o["training"] for o in backbones["others"]))),
            "phase_14": bn["launches"][way]}) for way in ("forward", "backward")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
