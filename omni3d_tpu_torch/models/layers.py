"""Shared layers (port of `omni3d_tpu.models.layers`, eval mode, NCHW).

The JAX package's space-to-depth stem pieces (`_S2DConvInner`,
`max_pool_packed`, `_TrainPackedBN`) are TPU workarounds and have no
counterpart here: the port evaluates the same convolutions directly.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


def conv2d(cin: int, cout: int, kernel: int, stride: int = 1,
           padding: int | None = None, bias: bool = False, dtype=None) -> nn.Conv2d:
    """Conv with torch-style (kernel - 1) // 2 padding by default."""
    pad = (kernel - 1) // 2 if padding is None else padding
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad, bias=bias,
                     dtype=dtype)


class FrozenBatchNorm2d(nn.Module):
    """Inference BatchNorm as a per-channel affine x * a + b.

    a = weight * rsqrt(running_var + eps) and b = bias - running_mean * a are
    formed in float32 from float32 buffers and applied in the activation's
    dtype, as the JAX package's `_EvalBN` does. Buffer names follow
    `nn.BatchNorm2d`, so detectron2 state dicts load into it.
    """

    def __init__(self, num_features: int):
        super().__init__()
        for name, fill in (("weight", 1.0), ("bias", 0.0),
                           ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((num_features,), fill))

    def forward(self, x):
        a = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        b = self.bias - self.running_mean * a
        return x * a.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


def conv_bn(cin: int, cout: int, kernel: int, stride: int = 1, relu: bool = True,
            padding: int | None = None, dtype=None) -> nn.Sequential:
    """conv -> frozen BN (-> relu), keyed `.0` / `.1` like the reference's
    Sequential blocks."""
    mods = [conv2d(cin, cout, kernel, stride, padding, dtype=dtype),
            FrozenBatchNorm2d(cout)]
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


def max_pool(x, window: int, stride: int, padding: int = 0):
    """torch MaxPool2d on NCHW."""
    return F.max_pool2d(x, window, stride, padding)


def upsample_nearest_2x(x):
    """Nearest 2x upsample (F.interpolate(scale_factor=2) semantics)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
