"""Device time of the NMS kernels and of `nms_mask`, on a CUDA card.

    python -m omni3d_tpu_torch.tools.profile_nms [--iters 10] [--out FILE]

The inputs are chip_smoke.py phase 12's, made from seeds:
  * recorded: `nms_mask`'s arguments in the bench's bf16 inference
    (`tools/bench.py`'s model and draws, 512 px) at bs 8 and 32, the RPN's
    (B, 5, 1000) rows at t = 0.7 and, at bs 32, the per-class NMS's (32,
    1024) class-shifted rows at t = 0.5; and the RPN's at the training
    top-k, (32, 5, 2000), from `select_proposals` on the bs 32 call's
    inputs;
  * seeded clusters (`clusters`) at those shapes and at (2, 5000), past the
    greedy kernel's 64 staged tiles;
  * near-threshold pairs (`near_threshold`) at t = 0.5 and 0.7.
Each case times, by CUDA events (median of --iters after 3 warm-ups), the
words kernel and the greedy kernel through their wrappers on the sorted
rows, and `nms_mask` whole (the sort, the gather, both kernels); and each
kernel's device time by torch.profiler over 2 x --iters calls; where the
words wrapper can count them, it also reports the pairs that the fast IoU
test left to the division. The script imports the kernels as
`omni3d_tpu_torch`, so it can time another checkout's kernels on the same
inputs: put that checkout first on PYTHONPATH and run this file as a
script. It prints one JSON object as its last line and writes it to --out.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics

import numpy as np
import torch

REAL_BS = (8, 32)                 # bench batches whose nms_mask inputs are recorded
# seeded cases: (label, shape, IoU threshold, classes for the offsets)
SEEDED = (("rpn test bs 8", (8, 5, 1000), 0.7, 0), ("rpn test bs 32", (32, 5, 1000), 0.7, 0),
          ("rpn train bs 32", (32, 5, 2000), 0.7, 0), ("per-class bs 32", (32, 1024), 0.5, 50),
          ("N 5000", (2, 5000), 0.7, 0))
NEAR = (("near t 0.5", (32, 1000), 0.5), ("near t 0.7", (32, 1000), 0.7))
NEAR_ULPS = 4                     # the near pairs' IoU lies within this many ULP of t


def clusters(shape, seed, classes=0):
    """Seeded NMS inputs (boxes (..., N, 4), scores (..., N), valid): boxes
    in clusters, ~10% exact duplicates, ~5% of zero width, scores on 17
    levels (exact score ties), ~10% invalid rows, a NaN box per row and the
    last eighth of every row padding (score NEG_INF, invalid), as
    `select_proposals` pads its levels; with `classes` > 0 shifted by a
    random class as `batched_nms_indices` shifts them."""
    from omni3d_tpu_torch.ops import nms as nms_ops
    rng = np.random.default_rng(seed)
    n = shape[-1]
    centers = rng.uniform(20, 500, shape[:-1] + (max(1, n // 16), 2))
    pick = rng.integers(0, centers.shape[-2], shape)
    c = np.take_along_axis(centers, pick[..., None], -2) + rng.normal(0, 6, shape + (2,))
    wh = rng.uniform(8, 120, shape + (2,))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    dup = rng.uniform(size=shape) < 0.1
    boxes[dup] = np.repeat(boxes[..., :1, :], n, -2)[dup]
    zero = rng.uniform(size=shape) < 0.05
    boxes[..., 2][zero] = boxes[..., 0][zero]
    boxes[..., n // 2, 1] = np.nan
    scores = (np.round(rng.uniform(0, 1, shape) * 16) / 16).astype(np.float32)
    valid = rng.uniform(size=shape) > 0.1
    pad = n - n // 8
    boxes[..., pad:, :] = 0.0
    scores[..., pad:] = nms_ops.NEG_INF
    valid[..., pad:] = False
    boxes, scores, valid = map(torch.from_numpy, (boxes, scores, valid))
    if classes:
        boxes = nms_ops._offset_by_class(boxes, torch.from_numpy(rng.integers(0, classes, shape)))
    return boxes, scores, valid


def near_threshold(shape, thresh, seed):
    """(boxes (R, N, 4), scores (R, N), valid (R, N), offsets (R, N // 2)):
    N // 2 pairs per row whose IoU, as torch and the kernels compute it in
    float32, lies within NEAR_ULPS ULP of t = float32(thresh). Pair k is a =
    [0, 2k, A, 2k + 1] and b = [0, 2k, B, 2k + 1] with B < A, in a strip of
    its own, a scored above b: inter = B and union = fl(fl(A + B) - B)
    exactly, so IoU = fl(B / union), and b is suppressed iff that is > t.
    `offsets` are (B / union - t) / (t+ - t) (float64), t+ the next float:
    a fourth of the pairs lie nearest to the midpoint 0.5 from below, a
    fourth nearest from above (no quotient of two floats equals the
    midpoint, see `csrc/nms.cu`), the rest spread over [-4, 4]."""
    R, n = shape
    pairs = n // 2
    t = np.float32(thresh)
    ulp = float(np.nextafter(t, np.float32(np.inf))) - float(t)
    rng = np.random.default_rng(seed)
    cand = 64 * R * pairs
    a = rng.uniform(256, 65536, cand).astype(np.float32)
    b = (a.astype(np.float64) * (float(t) + rng.uniform(-5, 5, cand) * ulp)).astype(np.float32)
    b = np.minimum(b, np.nextafter(a, np.float32(0)))
    uni = (a + b) - b                                      # float32, rounded as the kernel does
    off = (b.astype(np.float64) / uni.astype(np.float64) - float(t)) / ulp
    near = np.abs(off) <= NEAR_ULPS
    a, b, off = a[near], b[near], off[near]
    quarter = R * pairs // 4
    below = np.flatnonzero(off < 0.5)[np.argsort(0.5 - off[off < 0.5])[:quarter]]
    above = np.flatnonzero(off > 0.5)[np.argsort(off[off > 0.5] - 0.5)[:quarter]]
    rest = np.setdiff1d(np.arange(len(off)), np.concatenate([below, above]))
    spread = rng.choice(rest, R * pairs - 2 * quarter, replace=False)
    pick = rng.permutation(np.concatenate([below, above, spread])).reshape(R, pairs)
    y = (2 * np.arange(pairs, dtype=np.float32))[None, :].repeat(R, 0)
    zero = np.zeros_like(y)
    first = np.stack([zero, y, a[pick], y + 1], -1)
    second = np.stack([zero, y, b[pick], y + 1], -1)
    boxes = np.stack([first, second], 2).reshape(R, 2 * pairs, 4)
    scores = np.linspace(1, 0.5, 2 * pairs, dtype=np.float32)[None, :].repeat(R, 0)
    valid = np.ones((R, 2 * pairs), bool)
    return (torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid),
            off[pick])


def recorded_inputs(device):
    """`nms_mask`'s arguments (boxes, scores, threshold, valid) recorded in
    bf16 inference (the bench's model and draws) at REAL_BS, and the RPN's
    at the training pre-NMS top-k: `select_proposals` again on the bs 32
    call's own inputs with PRE_NMS_TOPK_TRAIN / POST_NMS_TOPK_TRAIN."""
    from omni3d_tpu_torch.models import rcnn3d, rpn
    from omni3d_tpu_torch.ops import nms as nms_ops
    from omni3d_tpu_torch.tools import bench
    from omni3d_tpu_torch.tools.profile_stages import recorded

    cfg = bench.config()
    kw = rcnn3d.inference_kwargs(cfg)
    model = bench.random_model(cfg, device)
    data = bench.inputs(cfg, REAL_BS, bench.IMG, device)
    cases = {}
    with torch.no_grad():
        for bs in REAL_BS:
            _, images, Ks, ratios = data[bs]
            with recorded(nms_ops, "nms_mask") as calls, \
                    recorded(rcnn3d, "select_proposals") as sel:
                rcnn3d.inference(model, images, Ks, ratios, **kw)
            (rpn_call, _, _), (cls_call, _, _) = calls
            cases[f"rpn test bs {bs}"] = rpn_call
            if bs == REAL_BS[-1]:
                cases[f"per-class bs {bs}"] = cls_call
                args = sel[0][0]
                rpn_cfg = cfg.MODEL.RPN
                with recorded(nms_ops, "nms_mask") as calls:
                    rpn.select_proposals(*args[:4], rpn_cfg.PRE_NMS_TOPK_TRAIN,
                                         rpn_cfg.POST_NMS_TOPK_TRAIN, args[6])
                cases[f"rpn train bs {bs}"] = calls[0][0]
    del model
    torch.cuda.empty_cache()
    return cases


def cases(device):
    """Every case as (label, source, boxes, scores, threshold, valid) on
    `device`; the recorded ones first."""
    out = [(label, "recorded (bench model, bf16 inference)", b, s, t, v)
           for label, (b, s, t, v) in recorded_inputs(device).items()]
    for i, (label, shape, thresh, classes) in enumerate(SEEDED):
        b, s, v = (x.to(device) for x in clusters(shape, i, classes))
        out.append((f"seeded {label}", "seeded clusters", b, s, thresh, v))
    for i, (label, shape, thresh) in enumerate(NEAR):
        b, s, v, _ = near_threshold(shape, thresh, 100 + i)
        out.append((label, "seeded near-threshold pairs", b.to(device), s.to(device), thresh,
                    v.to(device)))
    return out


def cuda_ms(fn, iters=10, warmup=3):
    """Median device time of fn() over `iters` runs, by CUDA events."""
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


def sorted_rows(boxes, scores, valid):
    """`nms_mask`'s sort, flattened to the kernels' (R, N) rows."""
    from omni3d_tpu_torch.ops import nms as nms_ops
    n = scores.shape[-1]
    R = scores.numel() // n
    boxes_s, valid_s, order = nms_ops._sorted(boxes, scores, valid)
    return boxes_s.reshape(R, n, 4), valid_s.reshape(R, n), order.reshape(R, n)


def slow_pairs(boxes_s, valid_s, thresh):
    """The pairs that the words kernel's fast IoU test left to the division,
    or None where the wrapper cannot count them."""
    from omni3d_tpu_torch.ops import nms_cuda
    if "slow_pairs" not in inspect.signature(nms_cuda.suppression_words).parameters:
        return None
    count = torch.zeros(1, dtype=torch.int64, device=boxes_s.device)
    nms_cuda.suppression_words(boxes_s, valid_s, thresh, slow_pairs=count)
    return int(count.item())


def kernel_device_ms(fn, name, calls):
    """Device ms per call of the kernels named `name` in fn(), from
    torch.profiler's kernel intervals (the host's time between launches,
    which the CUDA-event time of one call includes, left out)."""
    from omni3d_tpu_torch.utils.benchtime import device_profile
    prof = device_profile(fn, calls, torch.device("cuda"), top=50)
    return sum(ms for n, ms in prof["top_kernels_ms_per_call"] if name in n)


def time_case(boxes, scores, thresh, valid, iters=10):
    """{words_ms, greedy_ms, nms_mask_ms (CUDA events around one call),
    words_device_ms, greedy_device_ms (torch.profiler), slow_pairs} of one
    case."""
    from omni3d_tpu_torch.ops import nms as nms_ops
    from omni3d_tpu_torch.ops import nms_cuda
    boxes_s, valid_s, order = sorted_rows(boxes, scores, valid)
    words = nms_cuda.suppression_words(boxes_s, valid_s, thresh)
    run_words = lambda: nms_cuda.suppression_words(boxes_s, valid_s, thresh)  # noqa: E731
    run_greedy = lambda: nms_cuda.greedy_keep(words, valid_s, order)           # noqa: E731
    row = dict(words_ms=cuda_ms(run_words, iters), greedy_ms=cuda_ms(run_greedy, iters),
               nms_mask_ms=cuda_ms(lambda: nms_ops.nms_mask(boxes, scores, thresh, valid), iters),
               words_device_ms=kernel_device_ms(run_words, "nms_words_kernel", 2 * iters),
               greedy_device_ms=kernel_device_ms(run_greedy, "nms_greedy_kernel", 2 * iters),
               slow_pairs=slow_pairs(boxes_s, valid_s, thresh))
    del words
    torch.cuda.empty_cache()
    return row


def main(argv=None):
    from omni3d_tpu_torch.utils.benchtime import card

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_nms needs a CUDA device")
    device = torch.device("cuda", 0)
    import omni3d_tpu_torch
    rows = []
    for label, source, boxes, scores, thresh, valid in cases(device):
        row = dict(case=label, source=source, shape=list(scores.shape), threshold=thresh,
                   **time_case(boxes, scores, thresh, valid, args.iters))
        print(f"{label:22s} {tuple(scores.shape)} t={thresh}: words {row['words_ms']:.4f} ms "
              f"(device {row['words_device_ms']:.4f}), greedy {row['greedy_ms']:.4f} ms (device "
              f"{row['greedy_device_ms']:.4f}), nms_mask {row['nms_mask_ms']:.4f} ms, "
              f"slow pairs {row['slow_pairs']}", flush=True)
        rows.append(row)
    record = dict(card=card(), package=os.path.dirname(omni3d_tpu_torch.__file__),
                  iters=args.iters, cases=rows)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
