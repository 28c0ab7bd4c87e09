"""The data-parallel training generator: the program's stabilized step
under `DistributedDataParallel`, one process per card, each rank on its own
seeded pool of batches made on its card.

The harness's process is rank 0 on card 0. It spawns ranks 1 ... R - 1
(`ranks` of the workload file), rank r on card r and, where the harness
pinned rank 0 to one core, on a core of its own; every rank joins one
process group (NCCL on the cards, gloo on the CPU) through the program's
`parallel.dist.init_distributed` before the program's step object is
built, so the step is the port's own DDP step (`engine.train.make_train_step`).
Each rank then does what `train.run` does on one card, in lockstep: its
first `check_steps` (K) steps on distinct batches of its pool (drawn from
(seed, rank)), a snapshot of its state, and the window of episodes of
`episode_steps` (E) steps, every rank's snapshot put back between episodes
behind a barrier. Rank 0 decides at each episode boundary whether another
episode runs and tells the others. Rank r's image i is global image
r x B + i for the sampling noise, as the program draws it.

End-to-end: `train_img_per_s` (the global images of the window's accepted
steps over the episodes' time on rank 0), `peak_mem_gib` (the largest of
the ranks' over set-up and window, as `train.run` takes one card's) and
`setup_s` (rank 0's); the notes give each rank's peak after set-up and
after the window. With `--trace 1` rank 0 profiles the traced steps while the others run them;
`rate_img_per_s` in the facts is one card's rate, so `mfu.train` stays a
share of one card's peak.

The check: rank 0's program against the float32 reference run on every
card on that rank's batches (`RankReference`: the gradients averaged over
the ranks, the loss averaged as the program's logs are), by `train.run`'s
numbers, and `rank_param_gap`: the count of parameter and floating buffer
tensors (the BN running statistics among them) whose bit checksum differs
between ranks after the window. The faults: `train.FAULTS` (`half_batch`,
`frozen_head`) on every rank; `no_exchange`, the program's step built with
DDP's gradient reduction left out; `no_bn_mean`, the step's mean of the BN
running statistics over the ranks left out. The control puts
`RankReference` with fp8-rounded products in the program's place on every
rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import os
import statistics
import threading
import time

import torch
import torch.distributed as dist

from .. import checks, trace
from ..reference import model as ref
from ..yardstick.flops import model_flops
from ..yardstick.peaks import peaks
from . import train

FAULTS = (*train.FAULTS, "no_exchange", "no_bn_mean")
JOIN_S = 120     # the wait for the other ranks' exit after rank 0's last collective


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s pool of batches."""
    return seed * 8 + rank


class RankReference(train.Reference):
    """The plain float32 step (or the fp8 control) on this rank's batches,
    data-parallel as the program is: image i draws its sampling noise at
    global index `offset` + i; once the backward has accumulated every
    gradient, one all-reduce (queued by the parameters' post-accumulate-grad
    hooks) replaces each by its mean over the ranks, before the stabilizer
    and SGD read them; the step's loss is its mean over the ranks."""

    def __init__(self, ctx, offset: int, fp8: bool = False):
        super().__init__(ctx, fp8)
        self.offset, self.world, self.queued = offset, dist.get_world_size(), False
        for p in self.trainer.params:
            p.register_post_accumulate_grad_hook(self._queue)

    def _queue(self, _param):
        if not self.queued:
            self.queued = True
            torch.autograd.Variable._execution_engine.queue_callback(self._average)

    def _average(self):
        self.queued = False
        params = self.trainer.params
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        dist.all_reduce(flat)
        flat /= self.world
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p).clone()

    def __call__(self, batch, generator) -> bool:
        real = ref.sampling_noise
        ref.sampling_noise = lambda *a, **k: real(*a, **{**k, "img_offset": self.offset})
        try:
            accepted = super().__call__(batch, generator)
        finally:
            ref.sampling_noise = real
        device = self.trainer.params[0].device
        got = torch.tensor([float(self.last_loss), float(accepted)], dtype=torch.float64,
                           device=device)
        dist.all_reduce(got)
        self.last_loss = got[0].cpu() / self.world
        return bool(got[1] == self.world)


@contextlib.contextmanager
def exchange_left_out(on: bool):
    """While `on`, the program's step is built on a DistributedDataParallel
    that never reduces the gradients (the fault `no_exchange`)."""
    if not on:
        yield
        return
    from omni3d_tpu_torch.engine import train as port_train
    real = port_train.DistributedDataParallel

    def kept(_state, bucket):    # each rank's own gradient, neither summed nor divided
        fut = torch.futures.Future()
        fut.set_result(bucket.buffer())
        return fut

    class NoExchange(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.register_comm_hook(None, kept)

    port_train.DistributedDataParallel = NoExchange
    try:
        yield
    finally:
        port_train.DistributedDataParallel = real


class Program(train.Program):
    """The program's step object on this rank (`train.Program`, which plants
    `train.FAULTS`), and the exchange's faults `no_exchange` and
    `no_bn_mean`."""

    def __init__(self, ctx):
        fault = ctx.substitute
        with exchange_left_out(fault == "no_exchange"):
            super().__init__(dataclasses.replace(
                ctx, substitute=fault if fault in train.FAULTS else None))
        self.left_out = fault

    def __call__(self, batch, generator) -> bool:
        with bn_mean_left_out(self.model) if self.left_out == "no_bn_mean" else \
                contextlib.nullcontext():
            return super().__call__(batch, generator)


@contextlib.contextmanager
def bn_mean_left_out(model):
    """While inside, the program's mean over the ranks of the model's BN
    running statistics returns each rank's own (the fault `no_bn_mean`)."""
    from omni3d_tpu_torch.parallel import dist as dist_lib
    real, stats = dist_lib.mean_across_ranks, {id(b) for b in model.buffers()}
    dist_lib.mean_across_ranks = lambda ts: list(ts) if ts and id(ts[0]) in stats else real(ts)
    try:
        yield
    finally:
        dist_lib.mean_across_ranks = real


BITS = {8: torch.int64, 4: torch.int32, 2: torch.int16}


def param_gap(model) -> int:
    """The number of parameter and floating buffer tensors whose bit
    checksum (the sum of their words) differs on some rank from rank 0's."""
    state = [*model.parameters(), *(b for b in model.buffers() if b.is_floating_point())]
    sums = torch.stack([t.detach().reshape(-1).view(BITS[t.element_size()]).long().sum()
                        for t in state])
    every = [torch.empty_like(sums) for _ in range(dist.get_world_size())]
    dist.all_gather(every, sums)
    return int(torch.stack([s != every[0] for s in every]).any(0).sum())


def run(ctx) -> dict:
    from omni3d_tpu_torch.parallel import dist as dist_lib
    world = ctx.spec["ranks"]
    init = f"127.0.0.1:{dist_lib.free_port()}"
    own = sorted(os.sched_getaffinity(0))
    cores = [(own[0] - r) % os.cpu_count() if len(own) == 1 else None for r in range(world)]
    args = (ctx.name, ctx.spec, ctx.config, ctx.seed, ctx.seconds, ctx.trace, ctx.device.type,
            ctx.substitute, torch.get_num_threads(), init, os.getpid())
    mp = multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_child, args=(*args, r, world, cores[r]), daemon=True)
             for r in range(1, world)]
    for p in procs:
        p.start()
    done = threading.Event()
    threading.Thread(target=_watch, args=(procs, done, ctx), daemon=True).start()
    try:
        res = _rank(ctx, 0, world, init)
    except BaseException:
        for p in procs:   # they would wait in a collective for rank 0
            p.kill()
        if dist.is_initialized():
            dist.destroy_process_group()
        raise
    finally:
        done.set()
        for p in procs:
            p.join(JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks 1-{world - 1} exited with {codes}")
    return res


def _watch(procs, done, ctx):
    """Rank 0 ends the run at once when another rank fails: its collectives
    would otherwise wait for that rank until the group's timeout."""
    while not done.wait(1.0):
        bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
        if bad:
            ctx.note(f"a rank exited with {bad}: ending the run")
            os._exit(5)


def _child(name, spec, config, seed, seconds, traced, device_type, substitute, threads, init,
           parent, rank, world, core):
    """Rank `rank` in a spawned process: it ends itself when rank 0's
    process is gone."""
    from ..harness import Context

    def orphaned():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(6)
    threading.Thread(target=orphaned, daemon=True).start()
    if core is not None:
        with contextlib.suppress(OSError, ValueError):
            os.sched_setaffinity(0, {core})
    torch.set_num_threads(threads)
    device = torch.device(f"cuda:{rank}" if device_type == "cuda" else "cpu")
    _rank(Context(name, spec, config, seed, seconds, traced, device, substitute), rank, world,
          init)


def _rank(ctx, rank: int, world: int, init: str):
    from omni3d_tpu_torch.parallel import dist as dist_lib
    device = dist_lib.init_distributed(init, world, rank,
                                       f"cuda:{rank}" if ctx.on_card() else "cpu")
    res = _ranked(dataclasses.replace(ctx, device=device), rank, world)
    dist.destroy_process_group()
    return res


def _ranked(ctx, rank: int, world: int):
    spec = ctx.spec
    cfg = ctx.config["cfg"]
    B, K, E = spec["batch"], spec["check_steps"], spec["episode_steps"]
    pool = train.batch_pool(spec, cfg, rank_seed(ctx.seed, rank), ctx.device)
    if len(pool) <= K:
        raise ValueError("the pool must hold more batches than the compared steps")
    if E % len(pool):
        raise ValueError("an episode must pass over the pool a whole number of times")
    if ctx.substitute == "control":
        side = RankReference(ctx, rank * B, fp8=True)
    elif ctx.substitute in (None, *FAULTS):
        side = Program(ctx)
    else:
        raise ValueError(f"unknown substitute {ctx.substitute!r}")
    seen = train.first_steps(side, pool, ctx.seed, K)    # the set-up's steps, compared below
    ctx.sync()
    setup_s = ctx.elapsed()
    snapshot = train.Snapshot(side)    # out of set-up and of the window
    setup_peak = ctx.memory_peak()

    def episode_step(s: int) -> bool:
        return side(pool[s % len(pool)], train.step_generator(ctx.seed, s))

    def agreed(flag: bool) -> bool:
        """Rank 0's `flag`, on every rank."""
        t = torch.tensor([int(flag)], device=ctx.device)
        dist.broadcast(t, 0)
        return bool(t.item())

    ok = failed = episodes = restores = 0
    window_s = restore_s = 0.0
    per_episode, episode_s = [], []
    while agreed(episodes == 0 or window_s < ctx.seconds):
        if episodes:
            restore_s += snapshot.restore(side, ctx.sync)
            restores += 1
        dist.barrier()
        t0 = time.perf_counter()
        skips = [s for s in range(K, K + E) if not episode_step(s)]
        ctx.sync()
        episode_s.append(time.perf_counter() - t0)
        window_s += episode_s[-1]
        episodes += 1
        ok, failed = ok + E - len(skips), failed + len(skips)
        per_episode.append((skips, float(side.last_loss)))
    mine = torch.tensor([setup_peak, ctx.memory_peak()], dtype=torch.int64, device=ctx.device)
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    every = [e.tolist() for e in every]
    peak = max(e[1] for e in every)
    gap = param_gap(side.model)
    if rank == 0:
        ctx.note(f"{world} ranks of {B} images; window {window_s:.3f} s, {episodes} episodes of "
                 f"steps {K}-{K + E - 1}, {ok + failed} steps, "
                 f"{1e3 * window_s / (ok + failed):.3f} ms per step; seconds per episode "
                 f"{[round(t, 4) for t in episode_s]}; skipped steps and last loss per episode "
                 f"{per_episode}; set-up losses {seen['losses']}; each rank's peak bytes "
                 f"after set-up and after the window {every}; state tensors unequal across "
                 f"ranks {gap}")
    res = {"attempted": ok + failed, "failed": failed, "memory_peak_bytes": peak,
           "e2e": {"train_img_per_s": ok * B * world / window_s,
                   "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}}
    facts = {}
    if ctx.trace:     # the traced steps and the counted one: the episode's first, anew
        restore_s += snapshot.restore(side, ctx.sync)
        restores += 1
        dist.barrier()
        n = spec["trace_steps"]
        if rank == 0:
            tr = trace.profile(lambda k: episode_step(K + k), n)
            count, _ = model_flops(side.model, lambda: episode_step(K + n))
            peak_rates = peaks(ctx.card_name()) if ctx.on_card() else None
            facts = {"trace": tr, "rate_img_per_s": ok * B / window_s, "peak": peak_rates,
                     "flops_per_image": count.model / B}
            if peak_rates is not None:
                facts["roi_align_bwd"] = {
                    "bound_ms": train._bwd_bound(cfg, pool[0], peak_rates),
                    "kernel_ms": tr.kernel_ms_per_call("roi_align_bwd")[0]}
            res["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
            named = {}
            for name, s0, s1 in tr.kernels:
                if "nccl" in name.lower():
                    named[name[:80]] = named.get(name[:80], 0) + 1
            ctx.note(f"records naming nccl in the {n} traced steps: {named}")
            res["busy_s"], res["window_s"] = tr.busy_us / 1e6, tr.window_us / 1e6
        else:
            for k in range(n + 1):
                episode_step(K + k)
            ctx.sync()
    if rank == 0:
        ctx.note(f"{episodes} episodes, {restores} restores, "
                 f"{1e3 * restore_s:.3f} ms restoring")
    res["facts"] = facts

    # the check, once the program's state is freed
    del side, snapshot, episode_step
    ctx.free_memory()
    ctx.reference_precision()
    t_check = time.perf_counter()
    want = train.first_steps(RankReference(ctx, rank * B), pool, ctx.seed, K)
    if rank:
        return None
    ctx.note(f"reference check {time.perf_counter() - t_check:.3f} s over {K} steps; "
             f"losses {want['losses']}")
    keep = checks.moving_leaves(want["grads"])
    if not (seen["accepted"] and want["accepted"]) or seen["momentum"].keys() != want["momentum"].keys():
        names = [*checks.group_worst("grad_gap", {}, {}), *checks.group_worst("update_gap", {}, {})]
        res["numbers"] = dict.fromkeys(("loss_gap", "grad_gap", "update_gap", *names),
                                       float("inf"))
    else:
        grad = checks.leaf_gaps(seen["momentum"], want["momentum"])
        update = checks.leaf_gaps(seen["update"], want["update"], keep)
        res["numbers"] = {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(seen["losses"], want["losses"])),
            "grad_gap": statistics.median(grad.values()),
            "update_gap": statistics.median(update.values()),
            **checks.group_worst("grad_gap", grad, want["momentum"]),
            **checks.group_worst("update_gap", update, want["momentum"])}
        ctx.note("worst leaves: " + ", ".join(
            f"{n} {g:.4g}/{update.get(n, float('nan')):.4g}"
            for n, g in sorted(grad.items(), key=lambda x: -x[1])[:12]))
    res["numbers"]["rank_param_gap"] = gap
    res["moving_leaves"] = [len(keep), len(want["grads"])]
    return res
