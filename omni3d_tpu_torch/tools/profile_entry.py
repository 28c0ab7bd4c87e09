"""The training entry point's time on a CUDA card, by loader worker count.

    python -m omni3d_tpu_torch.tools.profile_entry --workers 4 0 4 0 --out entry.json

Writes the synthetic Omni3D-format dataset of chip_smoke.py's phase 6
(SPLITS: SUN RGB-D- and KITTI-sized images, from a seed) to a temporary
directory and runs `tools.train_net` on configs/cubercnn_DLA34_FPN.yaml at
full width in bfloat16, STEPS iterations from scratch, once for each
DATALOADER.NUM_WORKERS given, in turns. For each run it reports the
median ms per iteration over the iterations at an already-seen padded shape
(the first iteration at each shape apart), the ms blocked in `next(loader)`,
the ms of the step alone, img/s, the device busy ms per step of steps 10-14
(torch.profiler) and the peak memory. At 0 workers the loader runs in the
main thread between steps, so the step's own time there is the step without
loader threads beside it. chip_smoke.py's phase 6 uses the same dataset,
arguments and summary.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import torch

from .synthetic import write_omni3d_dataset, write_omni3d_stats

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# name -> (images, height, width, format, focal): SUN RGB-D's and KITTI's
# image sizes and focal lengths
SPLITS = {"SUNRGBD_train": (48, 530, 730, "ppm", 529.5),
          "KITTI_train": (16, 375, 1242, "png", 721.5)}
BS, STEPS = 8, 24


def write_dataset(root: str) -> None:
    t0 = time.perf_counter()
    for i, (name, (n, h, w, fmt, focal)) in enumerate(SPLITS.items()):
        write_omni3d_dataset(root, name, n, h, w, fmt, seed=i, dataset_id=i + 1, focal=focal,
                             objects=(1, 20))
    write_omni3d_stats(root)
    print(f"  synthetic Omni3D-format dataset written in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {n} x {h}x{w} {fmt}" for k, (n, h, w, fmt, _) in SPLITS.items()))


def train_argv(root: str, out_dir: str, steps: int, *flags: str, workers: int = 4,
               config: str = "cubercnn_DLA34_FPN.yaml") -> list:
    """train_net's arguments for `config` (a file of configs/): bfloat16,
    batch BS, the config's 25 scales, 8 shape buckets, a checkpoint every 8
    iterations."""
    return (["--config-file", os.path.join(ROOT, "configs", config),
             "--datasets-root", os.path.join(root, "Omni3D"), "--device", "cuda",
             "--max-steps", str(steps), *flags]
            + ["OUTPUT_DIR", out_dir, "DATASETS.TRAIN", str(tuple(SPLITS)),
               "SOLVER.IMS_PER_BATCH", str(BS), "SOLVER.CHECKPOINT_PERIOD", "8",
               "TPU.COMPUTE_DTYPE", "bfloat16", "TPU.TRAIN_SIZE_BUCKETS", "8",
               "DATALOADER.NUM_WORKERS", str(workers), "SEED", "0"])


def iteration_times(runs) -> dict:
    """Per-iteration host times of `engine.loop.TrainRun`s: medians over the
    iterations at an already-seen padded shape, apart from them the first
    iteration at each shape and each run's first (it waits for the loader's
    worker processes to start)."""
    steady, seen, firsts, starts = [], set(), [], []
    for run in runs:
        for n, (it, shape, d, s) in enumerate(zip(run.iterations, run.shapes, run.data_ms,
                                                   run.step_ms)):
            if shape not in seen:
                seen.add(shape)
                firsts.append(dict(iteration=it, shape=list(shape), ms=d + s, data_ms=d))
            elif n == 0:
                starts.append(dict(iteration=it, shape=list(shape), ms=d + s, data_ms=d))
            else:
                steady.append((d, s))
    ms = statistics.median(d + s for d, s in steady)
    return dict(
        shapes=sorted(list(s) for s in seen), steady_steps=len(steady),
        ms_per_step=ms, img_per_s=BS * 1e3 / ms,
        ms_blocked_on_loader=statistics.median(d for d, _ in steady),
        ms_blocked_on_loader_mean=statistics.mean(d for d, _ in steady),
        ms_step_only=statistics.median(s for _, s in steady),
        first_step_at_each_shape=firsts, first_step_of_a_resumed_run=starts,
        per_iteration=dict(data_ms=[x for r in runs for x in r.data_ms],
                           step_ms=[x for r in runs for x in r.step_ms],
                           shapes=[list(s) for r in runs for s in r.shapes]))


def main(argv=None):
    from . import train_net
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, nargs="+", default=[4, 0, 4, 0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_entry needs a CUDA device")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        write_dataset(tmp)
        for i, workers in enumerate(args.workers):
            out_dir, prof_dir = os.path.join(tmp, f"out{i}"), os.path.join(tmp, f"prof{i}")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            run = train_net.main(train_argv(tmp, out_dir, STEPS, "--profile-dir", prof_dir,
                                            workers=workers))
            torch.cuda.synchronize()
            with open(os.path.join(prof_dir, "summary.json")) as f:
                profile = json.load(f)
            row = dict(workers=workers, card=torch.cuda.get_device_name(0),
                       peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                       profile=profile, **iteration_times([run]))
            rows.append(row)
            print(f"  workers {workers}: {row['ms_per_step']:.1f} ms/iteration, step alone "
                  f"{row['ms_step_only']:.1f}, blocked on the loader {row['ms_blocked_on_loader']:.1f} "
                  f"(mean {row['ms_blocked_on_loader_mean']:.1f}), {row['img_per_s']:.1f} img/s, "
                  f"device busy {profile['device_busy_ms_per_step']:.1f} ms per profiled step")
    line = json.dumps(rows)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
