"""The AP evaluation's host and device costs on a CUDA card (port of the
JAX package's tools/bench_eval.py).

    python -m omni3d_tpu_torch.tools.bench_eval [--images 200] [--out chiprun_out/bench_eval.json]

`synth` makes a dataset at realistic per-image counts (the JAX bench's:
200 images, 12 GTs and 35 detections each, 20 categories, seed 0). The
bench times the full 2D and 3D evaluations (`Omni3DEval.evaluate` and
`accumulate`, host clock, s/img) with IoU3D on the card, IoU3D alone on one
50 x 50 group (CUDA events, median of 20 after 3 warm-ups), the batched
IoU3D of every group of the 3D evaluation (`paired_iou3d`: the pairs, CUDA
events), and the C++ greedy matcher on that 50 x 50 group at the 10 IoU3D
thresholds (host clock, us per call). It prints one JSON object and writes
it to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

N_IMAGES, N_CATS, GTS_PER_IMG, DETS_PER_IMG = 200, 20, 12, 35


def _cuboid(c, dims):
    sx, sy, sz = np.asarray(dims) / 2
    corners = np.array([[dx, dy, dz] for dx in (-sx, sx)
                        for dy in (-sy, sy) for dz in (-sz, sz)], np.float32)
    # an axis-aligned box in the canonical vertex order
    order = [0, 1, 3, 2, 4, 5, 7, 6]
    return corners[order] + np.asarray(c, np.float32)


def synth(n_images=N_IMAGES, n_cats=N_CATS, gts_per_img=GTS_PER_IMG,
          dets_per_img=DETS_PER_IMG, seed=0):
    """COCO-style GT / prediction dict lists with 9-DoF cuboids (jittered GTs
    and false positives, several categories per image), as the JAX
    package's bench makes them, draw for draw."""
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    gid = did = 1
    for img in range(n_images):
        cats = rng.choice(n_cats, size=max(2, n_cats // 4), replace=False)
        boxes3d = []
        for g in range(gts_per_img):
            cat = int(rng.choice(cats))
            x, y = rng.uniform(50, 450, 2)
            w, h = rng.uniform(20, 120, 2)
            z = rng.uniform(2, 45)
            dims = rng.uniform(0.3, 3.0, 3)
            c = np.array([(x - 256) * z / 500, (y - 256) * z / 500, z])
            gts.append({
                "id": gid, "image_id": img, "category_id": cat,
                "bbox": [x, y, w, h], "area": w * h, "depth": z,
                "ignore2D": g % 7 == 6, "ignore3D": g % 7 == 6,
                "bbox3D": _cuboid(c, dims).tolist(),
            })
            boxes3d.append((cat, x, y, w, h, c, dims))
            gid += 1
        for d in range(dets_per_img):
            if d < len(boxes3d) and rng.random() < 0.75:  # jittered TP
                cat, x, y, w, h, c, dims = boxes3d[d]
                c = c + rng.normal(0, 0.15, 3)
                dims = dims * rng.uniform(0.9, 1.1, 3)
                x += rng.normal(0, 3)
                y += rng.normal(0, 3)
            else:  # FP
                cat = int(rng.choice(n_cats))
                x, y = rng.uniform(50, 450, 2)
                w, h = rng.uniform(20, 120, 2)
                z = rng.uniform(2, 45)
                dims = rng.uniform(0.3, 3.0, 3)
                c = np.array([(x - 256) * z / 500, (y - 256) * z / 500, z])
            dts.append({
                "id": did, "image_id": img, "category_id": cat,
                "bbox": [x, y, w, h], "area": w * h, "depth": float(c[2]),
                "score": float(rng.uniform(0.05, 1.0)),
                "bbox3D": _cuboid(c, dims).tolist(),
            })
            did += 1
    return gts, dts


def group_pairs(gts, dts):
    """Every (detection, GT) pair the 3D evaluation sends to IoU3D: (dt
    verts (P, 8, 3), gt verts (P, 8, 3))."""
    from ..evaluation.omni3d_eval import Omni3DEval

    _, dv, gv = Omni3DEval([dict(g) for g in gts], [dict(d) for d in dts],
                           mode="3D").iou3d_pairs()
    return dv, gv


def cuda_ms(fn, iters=20, warmup=3):
    """Median device time of fn() by CUDA events."""
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


def run(n_images: int = N_IMAGES, device="cuda") -> dict:
    from ..evaluation import native
    from ..evaluation.omni3d_eval import PAIRS_PER_CALL, Omni3DEval, paired_iou3d
    from ..ops import iou3d

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit("bench_eval measures the CUDA card; torch.cuda.is_available() is false")
    gts, dts = synth(n_images)
    native.build()
    out = {"device": torch.cuda.get_device_name(device), "n_images": n_images,
           "n_gts": len(gts), "n_dts": len(dts)}

    dv, gv = group_pairs(gts, dts)
    paired_iou3d(dv[:64], gv[:64], device)   # the card's first launches, before the timing
    for mode in ("2D", "3D"):
        ev = Omni3DEval([dict(g) for g in gts], [dict(d) for d in dts], mode=mode,
                        device=device)
        t0 = time.perf_counter()
        ev.evaluate()
        t_eval = time.perf_counter() - t0
        t0 = time.perf_counter()
        ev.accumulate()
        t_acc = time.perf_counter() - t0
        stats = ev.summarize()
        out[mode] = {"evaluate_s": t_eval, "accumulate_s": t_acc,
                     "s_per_img": (t_eval + t_acc) / n_images, f"AP{mode}": stats[f"AP{mode}"]}
        print(f"{mode}: evaluate {t_eval:.3f} s  accumulate {t_acc:.3f} s  "
              f"({(t_eval + t_acc) / n_images * 1e3:.3f} ms/img)  "
              f"AP{mode}={stats[f'AP{mode}']:.2f}", flush=True)

    d_all = torch.from_numpy(dv).to(device)
    g_all = torch.from_numpy(gv).to(device)
    out["iou3d_pairs"] = len(dv)
    out["iou3d_all_pairs_ms"] = cuda_ms(lambda: [
        iou3d.box3d_overlap_tiled(d_all[s:s + PAIRS_PER_CALL, None],
                                  g_all[s:s + PAIRS_PER_CALL, None])
        for s in range(0, len(d_all), PAIRS_PER_CALL)], iters=5)

    D = G = 50
    rng = np.random.default_rng(1)
    d50 = np.stack([_cuboid(rng.uniform(-5, 5, 3) + [0, 0, 10], rng.uniform(0.3, 3, 3))
                    for _ in range(D)])
    g50 = np.stack([_cuboid(rng.uniform(-5, 5, 3) + [0, 0, 10], rng.uniform(0.3, 3, 3))
                    for _ in range(G)])
    d50_t, g50_t = torch.from_numpy(d50).to(device), torch.from_numpy(g50).to(device)
    out["iou3d_50x50_ms"] = cuda_ms(lambda: iou3d.box3d_overlap(d50_t, g50_t))
    ious = iou3d.box3d_overlap(d50_t, g50_t)[1].cpu().numpy()

    thrs = np.linspace(0.05, 0.5, 10)
    gt_ig = np.zeros(G, np.uint8)
    dt_ids = np.arange(1, D + 1, dtype=np.int64)
    gt_ids = np.arange(1, G + 1, dtype=np.int64)
    native.greedy_match(ious, thrs, gt_ig, None, dt_ids, gt_ids)
    t0 = time.perf_counter()
    for _ in range(200):
        native.greedy_match(ious, thrs, gt_ig, None, dt_ids, gt_ids)
    out["greedy_match_us"] = (time.perf_counter() - t0) / 200 * 1e6
    print(f"IoU3D {D}x{G}: {out['iou3d_50x50_ms']:.3f} ms; all {len(dv)} pairs of the 3D "
          f"evaluation: {out['iou3d_all_pairs_ms']:.3f} ms; C++ greedy match {D}x{G}x10 thr: "
          f"{out['greedy_match_us']:.1f} us/call", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=N_IMAGES)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "bench_eval.json"))
    args = ap.parse_args(argv)
    line = json.dumps(run(args.images))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
