"""Data-parallel training steps across the cards of one machine: ms per step
and images/s at each world size, the NCCL kernels' device time, and the
ranks' parameters held bit-equal.

    python -m omni3d_tpu_torch.tools.profile_ddp --world 1 4 4 1 --out ddp.json

For each world size W in --world (in the order given, so sizes can be run in
turns), W processes join an NCCL process group on 127.0.0.1, rank r on
`cuda:r`, and build the full-width DLA34-FPN trainer
(`tools.synthetic.synthetic_trainer`: configs/cubercnn_DLA34_FPN.yaml,
seeded random weights, the stabilized step, which runs under
DistributedDataParallel); rank r trains on its own synthetic batch (seed r)
of --bs images at --img px in --dtype, so a step of W ranks covers W x --bs
images. After --warmup steps every rank times --steps steps (host clock,
each ending in a synchronise); then rank 0 traces --profiled steps with
torch.profiler (device ms per step of the NCCL kernels, which run on their
own stream beside the backward and wait there for the slowest rank, and the
union of all kernels' intervals), and every rank times one all-reduce of a
buffer of the step's gradient size alone (host clock ending in a
synchronise, median of 10; the bus bandwidth is its bytes x 2(W - 1) / W
over that time). Last, each rank's parameters are reduced to one integer
checksum per tensor (the sum of its float32 bit patterns), and the
checksums must be equal on every rank. It prints one JSON object as its
last line and writes it to --out. `--device cpu` runs the same over gloo on
the CPU (narrow the widths with KEY VALUE config overrides).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ALL_REDUCE_WARMUP, ALL_REDUCE_TIMED = 3, 10


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank(rank, world, port, args, result_path):
    """One rank of a run at world size `world`; rank 0 writes the result."""
    from ..config import get_default_cfg
    from ..utils.benchtime import device_busy_ms, kernel_events
    from ..parallel import dist as dist_lib
    from .synthetic import synthetic_trainer, train_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.device == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    device = dist_lib.init_distributed(f"127.0.0.1:{port}", world, rank,
                                       "cpu" if args.device == "cpu" else f"cuda:{rank}")
    try:
        cfg = get_default_cfg()
        cfg.merge_from_file(os.path.join(ROOT, "configs", "cubercnn_DLA34_FPN.yaml"))
        cfg.merge_from_list(list(args.opts))
        model, _, step, _ = synthetic_trainer(cfg, getattr(torch, args.dtype), args.bs, device,
                                              img=args.img)
        batch = train_batch(cfg, args.bs, device, img=args.img, seed=rank)
        gen = torch.Generator().manual_seed(0)
        for _ in range(args.warmup):
            step(batch, gen)
        _sync(device)
        ms = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step(batch, gen)
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.profiled):
                step(batch, gen)
            _sync(device)
        # kernels only: the profiler also puts the "nccl:all_reduce" annotation
        # ranges and the step's spans on the device's timeline
        kernels = [e for e in kernel_events(prof.events()) if not e.name.startswith("nccl:")]
        nccl = [e for e in kernels if "nccl" in e.name.lower()]
        grad_bytes = sum(p.numel() * p.element_size() for p in model.parameters()
                         if p.requires_grad)
        buf = torch.ones(grad_bytes // 4, device=device)
        reduce_ms = []
        for i in range(ALL_REDUCE_WARMUP + ALL_REDUCE_TIMED):
            torch.distributed.barrier()
            t0 = time.perf_counter()
            torch.distributed.all_reduce(buf)
            _sync(device)
            if i >= ALL_REDUCE_WARMUP:
                reduce_ms.append((time.perf_counter() - t0) * 1e3)
        del buf
        medians = [torch.zeros(2, dtype=torch.float64, device=device) for _ in range(world)]
        torch.distributed.all_gather(medians, torch.tensor(
            [statistics.median(ms), statistics.median(reduce_ms)], dtype=torch.float64,
            device=device))
        sums = torch.stack([p.detach().view(torch.int32).long().sum()
                            for p in model.parameters()])
        every = [torch.empty_like(sums) for _ in range(world)]
        torch.distributed.all_gather(every, sums)
        if rank == 0:
            med = statistics.median(ms)
            with open(result_path, "w") as f:
                json.dump({
                    "world": world, "bs_per_rank": args.bs, "ms": ms, "ms_per_step": med,
                    "img_per_s": world * args.bs * 1e3 / med,
                    "device_busy_ms_per_step": device_busy_ms(kernels) / args.profiled,
                    "kernels_per_step": len(kernels) / args.profiled,
                    "nccl_device_ms_per_step": sum(e.time_range.elapsed_us() for e in nccl)
                    / 1e3 / args.profiled,
                    "nccl_kernels_per_step": len(nccl) / args.profiled,
                    "nccl_kernel_names": sorted({e.name for e in nccl}),
                    "grad_mb_per_step": grad_bytes / 1e6,
                    "ms_per_step_by_rank": [float(m[0]) for m in medians],
                    "all_reduce_ms": statistics.median(reduce_ms),
                    "all_reduce_ms_by_rank": [float(m[1]) for m in medians],
                    "all_reduce_bus_gb_per_s": (grad_bytes * 2 * (world - 1) / world
                                                / statistics.median(reduce_ms) / 1e6),
                    "skipped": step.state["skipped"],
                    "params_bit_equal_across_ranks": all(torch.equal(s, every[0])
                                                         for s in every)}, f)
    finally:
        torch.distributed.destroy_process_group()


def run_world(world: int, args, timeout: float = 900.0) -> dict:
    """One run at world size `world`: the ranks in spawned processes, rank
    0's result."""
    from ..parallel.dist import free_port, run_spawned
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "result.json")
        port = free_port()
        run_spawned(_rank, [(r, world, port, args, path) for r in range(world)], timeout)
        with open(path) as f:
            return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, nargs="+", default=None,
                    help="world sizes to run, in order (default: every card)")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--bs", type=int, default=8, help="images per rank and step")
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--profiled", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    ap.add_argument("opts", nargs=argparse.REMAINDER, help="config overrides: KEY VALUE ...")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("profile_ddp needs CUDA cards (or --device cpu)")
        cards = torch.cuda.device_count()
    else:
        cards = None
    worlds = args.world or [cards]
    if cards is not None and max(worlds) > cards:
        raise SystemExit(f"world size {max(worlds)} needs {max(worlds)} cards; {cards} found")
    runs = []
    for world in worlds:
        runs.append(run_world(world, args))
        r = runs[-1]
        print(f"[ddp] world {world}: {r['ms_per_step']:.1f} ms/step (median of {args.steps}), "
              f"{r['img_per_s']:.1f} img/s; ranks' medians {r['ms_per_step_by_rank']}; NCCL "
              f"kernels {r['nccl_device_ms_per_step']:.3f} device ms and "
              f"{r['nccl_kernels_per_step']:.1f} per step; one all-reduce of "
              f"{r['grad_mb_per_step']:.1f} MB alone {r['all_reduce_ms']:.3f} ms "
              f"({r['all_reduce_bus_gb_per_s']:.1f} GB/s bus); device busy "
              f"{r['device_busy_ms_per_step']:.1f} ms per step, parameters bit-equal across "
              f"ranks: {r['params_bit_equal_across_ranks']}", flush=True)
        if not r["params_bit_equal_across_ranks"]:
            raise RuntimeError(f"world size {world}: the ranks' parameters differ")
    summary = {"device": (torch.cuda.get_device_name(0) if cards else "cpu"),
               "device_count": cards, "dtype": args.dtype, "img": args.img, "runs": runs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
