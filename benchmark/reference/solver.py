"""Frozen copy of omni3d_tpu_torch/solver/build.py (commit 5a24e3a), part of the
benchmark's plain reference; the original's docstring follows.

Optimizer and LR schedule (port of `omni3d_tpu.solver.build` onto
`torch.optim`).

The reference solver (cubercnn/solver/build.py:6-78): SGD or Adam(W)
(+amsgrad) with torch-coupled weight decay for sgd/adam and decoupled for
adamw, per-parameter groups, and WarmupMultiStepLR. The JAX package builds
the same from an optax chain; `torch.optim` holds each piece directly:

  * groups with the precedence of the JAX package's `_param_class`: BN
    parameters ("norm", WEIGHT_DECAY_NORM, base LR), then biases ("bias",
    WEIGHT_DECAY_BIAS or WEIGHT_DECAY, LR x BIAS_LR_FACTOR), then the rest
    (WEIGHT_DECAY). The priors are buffers in the port, so they get neither
    an update nor weight decay, as the JAX package's zero-decay "prior"
    group with stopped gradients gives;
  * SGD with `momentum`, dampening 0 and coupled decay is the chain
    add_decayed_weights -> trace -> scale_by_learning_rate;
  * Adam(W) with eps 1e-2 and `amsgrad=True` for "+amsgrad", which is the
    JAX package's `scale_by_amsgrad_torch`;
  * gradient clipping (`clip_gradients`) before the step, by value or by
    global norm, as the chain's first element.
"""
from __future__ import annotations

import torch

from .layers import BatchNorm2d

ADAM_EPS = 1e-2  # reference solver/build.py:58-66 passes eps=1e-02 to Adam(W)


def lr_factor(cfg, step: int) -> float:
    """WarmupMultiStepLR factor of BASE_LR at update `step` (0-based):
    linear warmup from WARMUP_FACTOR over WARMUP_ITERS, then GAMMA at each of
    STEPS (omni3d_tpu/solver/build.py:52-67)."""
    warmup_iters = max(int(cfg.SOLVER.WARMUP_ITERS), 1)
    alpha = min(max(step / warmup_iters, 0.0), 1.0)
    warm = cfg.SOLVER.WARMUP_FACTOR * (1.0 - alpha) + alpha
    decays = sum(step >= s for s in cfg.SOLVER.STEPS)
    return warm * cfg.SOLVER.GAMMA ** decays


def build_lr_schedule(cfg, optimizer) -> torch.optim.lr_scheduler.LambdaLR:
    """WarmupMultiStepLR over every group's initial LR; step it once after
    each applied update."""
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: lr_factor(cfg, step))


def param_groups(cfg, model: torch.nn.Module) -> list[dict]:
    """norm / bias / rest groups of the model's trainable parameters with
    their weight decay and LR (reference solver/build.py:33-46)."""
    wd = cfg.SOLVER.WEIGHT_DECAY
    wd_bias = wd if cfg.SOLVER.WEIGHT_DECAY_BIAS is None else cfg.SOLVER.WEIGHT_DECAY_BIAS
    bias_lr = 1.0 if cfg.SOLVER.BIAS_LR_FACTOR is None else cfg.SOLVER.BIAS_LR_FACTOR
    base = cfg.SOLVER.BASE_LR
    groups = {"norm": [], "bias": [], "rest": []}
    norm_ids = {id(p) for m in model.modules() if isinstance(m, BatchNorm2d)
                for p in m.parameters(recurse=False)}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        cls = "norm" if id(p) in norm_ids else "bias" if name.endswith("bias") else "rest"
        groups[cls].append(p)
    spec = {"norm": (cfg.SOLVER.WEIGHT_DECAY_NORM, base), "bias": (wd_bias, base * bias_lr),
            "rest": (wd, base)}
    return [{"params": ps, "weight_decay": spec[c][0], "lr": spec[c][1], "name": c}
            for c, ps in groups.items() if ps]


def build_optimizer(cfg, model: torch.nn.Module) -> torch.optim.Optimizer:
    """SGD / Adam / AdamW (+amsgrad) over `param_groups` (reference
    solver/build.py:6-70); the LR of each group is its initial LR, which
    `build_lr_schedule` scales."""
    solver_type = cfg.SOLVER.TYPE.lower()
    amsgrad = solver_type.endswith("+amsgrad")
    base_type = solver_type.removesuffix("+amsgrad")
    groups = param_groups(cfg, model)
    if base_type == "sgd":
        return torch.optim.SGD(groups, lr=cfg.SOLVER.BASE_LR, momentum=cfg.SOLVER.MOMENTUM,
                               dampening=0.0, nesterov=cfg.SOLVER.NESTEROV)
    if base_type == "adam":
        return torch.optim.Adam(groups, lr=cfg.SOLVER.BASE_LR, eps=ADAM_EPS, amsgrad=amsgrad)
    if base_type == "adamw":
        return torch.optim.AdamW(groups, lr=cfg.SOLVER.BASE_LR, eps=ADAM_EPS, amsgrad=amsgrad)
    raise ValueError(f"Unknown solver type {cfg.SOLVER.TYPE}")


def clip_gradients(cfg, params) -> None:
    """SOLVER.CLIP_GRADIENTS: clip each gradient element to +-CLIP_VALUE
    ("value") or the global L2 norm to CLIP_VALUE ("norm"), in place, as
    optax.clip / clip_by_global_norm do."""
    clip = cfg.SOLVER.CLIP_GRADIENTS
    if not clip.ENABLED:
        return
    if clip.CLIP_TYPE == "norm":
        torch.nn.utils.clip_grad_norm_(params, clip.CLIP_VALUE)
    else:
        torch.nn.utils.clip_grad_value_(params, clip.CLIP_VALUE)
