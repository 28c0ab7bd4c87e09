"""Frozen copy of omni3d_tpu_torch/models/layers.py (commit 5a24e3a), part of the
benchmark's plain reference; the original's docstring follows.

Shared layers (port of `omni3d_tpu.models.layers`, NCHW).

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


import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1   # running-stat update weight of the batch statistics


FP8_MAX = 448.0   # largest finite float8_e4m3fn


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8_e4m3fn under a per-tensor scale that maps its
    largest magnitude to FP8_MAX, returned in x's dtype: the inputs of an
    fp8 product with current scaling (the benchmark's lower-precision
    control; not in the original)."""
    scale = FP8_MAX / x.detach().abs().amax().float().clamp(min=1e-30)
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in its input's dtype (weights cast per call);
    with `fp8` set, on fp8-rounded inputs and weights."""

    fp8 = False

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        w = self.weight.to(x.dtype)
        if self.fp8:
            x, w = fake_fp8(x), fake_fp8(w)
        return self._conv_forward(x, w, bias)


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype (weights cast per call);
    with `fp8` set, on fp8-rounded inputs and weights."""

    fp8 = False

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        w = self.weight.to(x.dtype)
        if self.fp8:
            x, w = fake_fp8(x), fake_fp8(w)
        return F.linear(x, w, bias)


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

    `update_stats` False keeps the running
    statistics where they are in train mode, for a forward that recomputes
    one already counted."""

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
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.copy_((1 - BN_MOMENTUM) * self.running_mean + BN_MOMENTUM * mean)
                self.running_var.copy_((1 - BN_MOMENTUM) * self.running_var
                                       + BN_MOMENTUM * var)
        return _bn_affine(x, self.weight, self.bias, mean, var)


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


def upsample_nearest_2x(x):
    """Nearest 2x upsample (F.interpolate(scale_factor=2) semantics)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
