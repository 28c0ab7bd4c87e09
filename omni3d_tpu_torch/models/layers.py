"""Shared layers (port of `omni3d_tpu.models.layers`, NCHW).

The JAX package's space-to-depth stem pieces (`_S2DConvInner`,
`max_pool_packed`, `_TrainPackedBN`) are TPU workarounds and have no
counterpart here: the port evaluates the same convolutions directly.

Mixed precision is by explicit casts, not autocast: `Conv2d` and `Linear`
cast their weights to the dtype of their input, so float32 (master)
parameters compute in the activations' dtype, as flax's `dtype=` does with
float32 `param_dtype`. The model casts the images to the compute dtype once
at its entry; everything downstream follows the activations.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import batch_norm_cuda

BN_EPS = 1e-5
BN_MOMENTUM = 0.1   # running-stat update weight of the batch statistics

# Train-mode `BatchNorm2d` calls by the path they took: "fused", the kernels
# of `ops.batch_norm_cuda` (every CUDA input); "plain", the PyTorch formula
# (every CPU input), so that a step on the card that reads 0 here ran no BN
# layer off the kernels.
bn_calls = {"fused": 0, "plain": 0}


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in its input's dtype (weights cast per call)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype (weights cast per call)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def conv2d(cin: int, cout: int, kernel: int, stride: int = 1,
           padding: int | None = None, bias: bool = False, groups: int = 1,
           dtype=None) -> Conv2d:
    """Conv with torch-style (kernel - 1) // 2 padding by default; `groups`
    splits the channels as flax's `feature_group_count` does (the weight is
    (cout, cin / groups, k, k))."""
    pad = (kernel - 1) // 2 if padding is None else padding
    return Conv2d(cin, cout, kernel, stride=stride, padding=pad, bias=bias, groups=groups,
                  dtype=dtype)


def _bn_affine(x, weight, bias, mean, var):
    """x * a + b with a = weight * rsqrt(var + eps), b = bias - mean * a
    formed in float32 and applied in x's dtype."""
    a = weight * torch.rsqrt(var + BN_EPS)
    b = bias - mean * a
    return x * a.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


class BatchNorm2d(nn.Module):
    """Trainable BatchNorm with the JAX package's semantics (flax
    nn.BatchNorm / `_TrainPackedBN`, layers.py:195-239): eps 1e-5, running
    stats updated with weight 0.1, batch statistics in float32 with the
    BIASED variance (mean(x^2) - mean(x)^2) both for normalising and for the
    running update, normalisation applied as the affine x * a + b in the
    compute dtype. `torch.nn.BatchNorm2d` would update the running variance
    with the unbiased one. `weight` and `bias` are float32 parameters and the
    statistics float32 buffers, under `nn.BatchNorm2d`'s state-dict keys, so
    detectron2 state dicts load into it. In eval mode it is the inference
    affine of the JAX package's `_EvalBN`: x * a + b, a and b formed in
    float32 from the running statistics and applied in x's dtype.

    `update_stats` False (see `running_stats_frozen`) keeps the running
    statistics where they are in train mode, for a forward that recomputes
    one already counted.

    In train mode a CUDA input goes through the kernels of
    `ops.batch_norm_cuda`, which compute the same formula with the affine
    formed in float32 and one rounding to x's dtype, update the running
    statistics in place, and keep only x (made channels-last contiguous if
    it is not) and (4, C) statistics for the backward; they take bf16 and
    float32 and raise on any other dtype. A CPU input takes the plain
    formula. `bn_calls` counts the two."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.update_stats = True

    def forward(self, x):
        if not self.training:
            return _bn_affine(x, self.weight, self.bias, self.running_mean, self.running_var)
        if x.is_cuda:
            y = batch_norm_cuda.TrainBatchNorm.apply(x, self.weight, self.bias, self.running_mean,
                                                     self.running_var, self.update_stats)
            bn_calls["fused"] += 1
            return y
        bn_calls["plain"] += 1
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.copy_((1 - BN_MOMENTUM) * self.running_mean + BN_MOMENTUM * mean)
                self.running_var.copy_((1 - BN_MOMENTUM) * self.running_var
                                       + BN_MOMENTUM * var)
        return _bn_affine(x, self.weight, self.bias, mean, var)


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module):
    """Within the block, no `BatchNorm2d` under `module` updates its running
    statistics (the recomputing forward of `torch.utils.checkpoint`)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


def conv_bn(cin: int, cout: int, kernel: int, stride: int = 1, relu: bool = True,
            padding: int | None = None, groups: int = 1, dtype=None) -> nn.Sequential:
    """conv -> BN (-> relu), keyed `.0` / `.1` like the reference's
    Sequential blocks."""
    mods = [conv2d(cin, cout, kernel, stride, padding, groups=groups, dtype=dtype),
            BatchNorm2d(cout)]
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


def max_pool(x, window: int, stride: int, padding: int = 0):
    """torch MaxPool2d on NCHW."""
    return F.max_pool2d(x, window, stride, padding)


def avg_pool(x, window: int, stride: int):
    """Unpadded average pool on NCHW (flax `nn.avg_pool` with VALID
    padding: DenseNet's transitions, 2 x 2 / 2)."""
    return F.avg_pool2d(x, window, stride)


def upsample_nearest_2x(x):
    """Nearest 2x upsample (F.interpolate(scale_factor=2) semantics)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
