"""The training generator: the program's stabilized training step on a
seeded pool of batches made on the device.

Set-up builds ONE step object (`engine.train.make_train_step` over the
port's train-mode model with the benchmark's weights, the config's SGD and
LR schedule) and drives it through its first `check_steps` (K) steps on
distinct batches. Its state is then copied to the host (`Snapshot`), and
the window repeats one fixed episode of `episode_steps` (E) steps from that
state: steps K ... K + E - 1 on `pool[s % len(pool)]`, the state put back
in place between episodes, out of the window's time. The window ends at
the first episode boundary after `--seconds`, so every run, of any
program, times and judges the same E steps, whatever its speed. Each step
gets its own CPU generator for the sampling noise, made from (seed, step).
The batches: images of the cell's frame size, normalized with zero in the
padding, and the frozen synthetic ground truth, all drawn on the device
from the seed. Parameters come from the cell's workload file.

End-to-end: `train_img_per_s` (images of the window's accepted steps over
the episodes' time, each to the end of its last step; a step the
stabilizer skips counts as failed), `peak_mem_gib`.
"""
from __future__ import annotations

import copy
import statistics
import time

import torch

from .. import checks, trace
from ..reference import model as ref
from ..weights import init_state, shapes_of
from ..yardstick.flops import model_flops
from ..yardstick.peaks import peaks
from ..yardstick.synth import ground_truth
from .frames import frame_shape


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's sampling noise."""
    return torch.Generator().manual_seed((seed * 1_000_003 + step) % (1 << 63))


def batch_pool(spec: dict, cfg: dict, seed: int, device) -> list:
    """`pool_batches` distinct batches of `batch` images on the device."""
    h0 = spec["source_hw"][0]
    (h, w), (hp, wp) = frame_shape(spec, cfg, train=True)
    B = spec["batch"]
    gen = torch.Generator(device=device).manual_seed((seed * 2 + 1) % (1 << 63))
    mean = torch.tensor(cfg["MODEL"]["PIXEL_MEAN"], device=device)
    std = torch.tensor(cfg["MODEL"]["PIXEL_STD"], device=device)
    out = []
    for _ in range(spec["pool_batches"]):
        images = torch.zeros((B, hp, wp, 3), device=device)
        raw = torch.randint(0, 256, (B, h, w, 3), generator=gen, device=device,
                            dtype=torch.uint8)
        images[:, :h, :w] = (raw.float() - mean) / std
        batch = ground_truth(B, h, w, cfg["MODEL"]["ROI_HEADS"]["NUM_CLASSES"], gen, device)
        batch.update(images=images,
                     Ks=torch.tensor(spec["K"], device=device).expand(B, 3, 3).contiguous(),
                     ratios=torch.full((B,), h0 / h, device=device),
                     hw=torch.tensor([float(h), float(w)], device=device).expand(B, 2).contiguous())
        out.append(batch)
    return out


FAULTS = ("half_batch", "frozen_head")


def _host(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` in host memory, pinned when `t` is on the card."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda).copy_(t)


class Snapshot:
    """Everything a step object carries from one step to the next, in host
    memory: the model's parameters and buffers (BN running statistics
    included), the optimizer's per-parameter state (the momentum), the LR
    schedule's state and each group's `lr`, and the side's `COUNTERS` (the
    step count, the skips, the stabilizer's rolling mean). `restore` puts
    it back in place, into the tensors the side holds, so the optimizer's
    state and the step's BN list keep their identities and nothing is
    allocated on the card."""

    def __init__(self, side):
        opt = side.optimizer
        self.stateful = set(opt.state)
        self.tensors = [_host(t) for t in self._tensors(side)]
        self.schedule = copy.deepcopy(side.scheduler.state_dict())
        self.lrs = [g["lr"] for g in opt.param_groups]
        live = side.counters
        self.counters = {k: _host(live[k]) if torch.is_tensor(live[k]) else live[k]
                         for k in side.COUNTERS}

    @staticmethod
    def _tensors(side) -> list:
        opt = side.optimizer
        return [*side.model.state_dict().values(),
                *(v for g in opt.param_groups for p in g["params"]
                  for _, v in sorted(opt.state.get(p, {}).items()) if torch.is_tensor(v))]

    def restore(self, side, sync) -> float:
        """Put the snapshot back into `side`, synchronised before and
        after; its seconds."""
        sync()
        t0 = time.perf_counter()
        opt = side.optimizer
        for p in [p for p in opt.state if p not in self.stateful]:
            del opt.state[p]
        with torch.no_grad():
            for t, h in zip(self._tensors(side), self.tensors, strict=True):
                t.copy_(h, non_blocking=True)
            for k, v in self.counters.items():
                if torch.is_tensor(v):
                    side.counters[k].copy_(v, non_blocking=True)
                else:
                    side.counters[k] = v
        side.scheduler.load_state_dict(copy.deepcopy(self.schedule))
        for g, lr in zip(opt.param_groups, self.lrs, strict=True):
            g["lr"] = lr
        sync()
        return time.perf_counter() - t0


class Program:
    """The port's training step object and what the check reads of it. A
    planted fault (`--substitute`): `half_batch`, half of each batch left
    out and the mean taken over the rest; `frozen_head`, the cube head's
    parameters put back after each step (one group's update left out)."""

    COUNTERS = ("step", "skipped", "recent_loss")   # of `counters`, the step's state

    def __init__(self, ctx):
        from omni3d_tpu_torch.engine.train import make_train_step
        from omni3d_tpu_torch.models import rcnn3d
        from omni3d_tpu_torch.solver.build import build_lr_schedule, build_optimizer
        cfg = ctx.port_cfg()
        cfg.SOLVER.IMS_PER_BATCH = ctx.spec["batch"]    # the whole batch on one card
        self.model = rcnn3d.build_model(cfg, device=ctx.device, train=True)
        self.model.load_state_dict(init_state(shapes_of(self.model), ctx.seed, ctx.device))
        self.optimizer = build_optimizer(cfg, self.model)
        self.scheduler = build_lr_schedule(cfg, self.optimizer)
        self.step = make_train_step(cfg, self.model, self.optimizer, self.scheduler)
        self.counters = self.step.state
        self.fault = ctx.substitute
        if self.fault not in (None, *FAULTS):
            raise ValueError(f"unknown substitute {self.fault!r}")
        self.frozen = [p for n, p in self.model.named_parameters()
                       if n.startswith("roi_heads.cube_head.")]

    def __call__(self, batch, generator) -> bool:
        """One step; True when the stabilizer accepted it."""
        if self.fault == "half_batch":
            n = batch["images"].shape[0] // 2
            batch = {k: v[:n] for k, v in batch.items()}
        if self.fault == "frozen_head":
            before = [p.detach().clone() for p in self.frozen]
        with trace.span("step"):
            logs = self.step(batch, generator)
        if self.fault == "frozen_head":
            with torch.no_grad():
                for p, b in zip(self.frozen, before):
                    p.copy_(b)
        self.last_loss = logs["total_loss"]
        return logs["finite"] == 1.0

    def params(self) -> dict:
        return {n: p.detach().clone() for n, p in self.model.named_parameters()}

    def momentum(self) -> dict:
        st = self.optimizer.state
        return {n: st[p]["momentum_buffer"].clone() for n, p in self.model.named_parameters()
                if "momentum_buffer" in st.get(p, {})}


class Reference:
    """The plain step in float32 (or, as the control, with fp8-rounded
    products) from the same weights."""

    COUNTERS = ("skipped", "recent")   # of `counters`, the trainer's attributes

    def __init__(self, ctx, fp8: bool = False):
        model = ref.build(ctx.config["cfg"], ctx.device, train=True)
        model.load_state_dict(init_state(shapes_of(model), ctx.seed, ctx.device))
        model.checkpoint_trunk = True
        self.model = ref.set_fp8(model, fp8)
        self.trainer = ref.Trainer(self.model)
        self.optimizer, self.scheduler = self.trainer.optimizer, self.trainer.scheduler
        self.counters = vars(self.trainer)

    def __call__(self, batch, generator) -> bool:
        skipped = self.trainer.skipped
        self.last_loss = torch.tensor(self.trainer.step(batch, generator))
        return self.trainer.skipped == skipped

    def params(self) -> dict:
        return {n: p.detach().clone() for n, p in self.model.named_parameters()}

    def momentum(self) -> dict:
        st = self.trainer.optimizer.state
        return {n: st[p]["momentum_buffer"].clone() for n, p in self.model.named_parameters()
                if "momentum_buffer" in st.get(p, {})}

    def grad_norms(self) -> dict:
        return {n: float(torch.linalg.vector_norm(p.grad.double()))
                for n, p in self.model.named_parameters()}


def first_steps(side, pool: list, seed: int, steps: int) -> dict:
    """Drive `side` through its first steps on distinct batches: each
    step's loss, the momentum after step 1 and the parameters before and
    after."""
    p0 = side.params()
    losses, momentum, grads, accepted = [], None, None, True
    for s in range(steps):
        accepted &= side(pool[s], step_generator(seed, s))
        losses.append(float(side.last_loss))
        if s == 0:
            momentum = side.momentum()
            if isinstance(side, Reference):
                grads = side.grad_norms()
    p1 = side.params()
    return {"losses": losses, "momentum": momentum, "grads": grads, "accepted": accepted,
            "update": {n: p1[n] - p0[n] for n in p0}}


def run(ctx) -> dict:
    spec = ctx.spec
    cfg = ctx.config["cfg"]
    B = spec["batch"]
    K = spec["check_steps"]
    pool = batch_pool(spec, cfg, ctx.seed, ctx.device)
    if len(pool) <= K:
        raise ValueError("the pool must hold more batches than the compared steps")
    side = Reference(ctx, fp8=True) if ctx.substitute == "control" else Program(ctx)
    seen = first_steps(side, pool, ctx.seed, K)     # the set-up's steps, compared below
    ctx.sync()
    setup_s = ctx.elapsed()

    E = spec["episode_steps"]
    if E % len(pool):
        raise ValueError("an episode must pass over the pool a whole number of times")
    snapshot = Snapshot(side)    # out of set-up and of the window

    def episode_step(s: int) -> bool:
        return side(pool[s % len(pool)], step_generator(ctx.seed, s))

    ok = failed = episodes = restores = 0
    window_s = restore_s = 0.0
    per_episode, episode_s = [], []
    while episodes == 0 or window_s < ctx.seconds:
        if episodes:
            restore_s += snapshot.restore(side, ctx.sync)
            restores += 1
        t0 = time.perf_counter()
        skips = [s for s in range(K, K + E) if not episode_step(s)]
        ctx.sync()
        episode_s.append(time.perf_counter() - t0)
        window_s += episode_s[-1]
        episodes += 1
        ok, failed = ok + E - len(skips), failed + len(skips)
        per_episode.append((skips, float(side.last_loss)))
    ctx.note(f"window {window_s:.3f} s, {episodes} episodes of steps {K}-{K + E - 1}, "
             f"{ok + failed} steps, {1e3 * window_s / (ok + failed):.3f} ms per step; "
             f"seconds per episode {[round(t, 4) for t in episode_s]}; "
             f"skipped steps and last loss per episode {per_episode}; "
             f"set-up losses {seen['losses']}")
    peak_bytes = ctx.memory_peak()
    res = {"attempted": ok + failed, "failed": failed, "memory_peak_bytes": peak_bytes,
           "e2e": {"train_img_per_s": ok * B / window_s, "peak_mem_gib": peak_bytes / 2 ** 30,
                   "setup_s": setup_s}}
    facts = {}
    if ctx.trace:     # the traced steps and the counted one: the episode's first, anew
        restore_s += snapshot.restore(side, ctx.sync)
        restores += 1
        n = spec["trace_steps"]
        tr = trace.profile(lambda k: episode_step(K + k), n)
        count, _ = model_flops(side.model, lambda: episode_step(K + n))
        peak = peaks(ctx.card_name()) if ctx.on_card() else None
        facts = {"trace": tr, "rate_img_per_s": ok * B / window_s, "peak": peak,
                 "flops_per_image": count.model / B}
        if peak is not None:
            facts["roi_align_bwd"] = {"bound_ms": _bwd_bound(ctx.config["cfg"], pool[0], peak),
                                      "kernel_ms": tr.kernel_ms_per_call("roi_align_bwd")[0]}
        res["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        res["busy_s"], res["window_s"] = tr.busy_us / 1e6, tr.window_us / 1e6
    ctx.note(f"{episodes} episodes, {restores} restores, {1e3 * restore_s:.3f} ms restoring")
    res["facts"] = facts

    # the check, once the program's state is freed
    del side, snapshot, episode_step
    ctx.free_memory()
    ctx.reference_precision()
    t_check = time.perf_counter()
    want = first_steps(Reference(ctx), pool, ctx.seed, K)
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
    res["moving_leaves"] = [len(keep), len(want["grads"])]
    return res


def _bwd_bound(cfg: dict, batch: dict, peak: dict) -> float:
    """The backward pooler's bound ms per step from shapes alone: the
    pooled gradient read once (B x (S + F) RoIs x P x P x C bf16) and the
    pyramid gradient written once (bf16, levels of ceil(H / stride) x
    ceil(W / stride) cells), no operations counted."""
    B, Hp, Wp = batch["images"].shape[:3]
    C = cfg["MODEL"]["FPN"]["OUT_CHANNELS"]
    S = cfg["MODEL"]["ROI_HEADS"]["BATCH_SIZE_PER_IMAGE"]
    F = int(S * cfg["MODEL"]["ROI_HEADS"]["POSITIVE_FRACTION"])
    P = cfg["MODEL"]["ROI_BOX_HEAD"]["POOLER_RESOLUTION"]
    cells = sum(-(-Hp // st) * -(-Wp // st) for st in ref.FEATURE_STRIDES)
    return (B * (S + F) * P * P * C * 2 + B * cells * C * 2) / peak["hbm_bytes_per_s"] * 1e3
