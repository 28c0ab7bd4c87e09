"""Frozen copy of the DenseNet-121 part of omni3d_tpu_torch/models/extra_backbones.py
(commit 2071a4d), part of the benchmark's plain reference: the same module
names and p2..p6 taps, the reference's own `BatchNorm2d` and `conv2d`, and
the transitions' average pool as plain `F.avg_pool2d`. The original's
docstring, of its DenseNet part, follows.

The torchvision architecture the reference wraps as an FPN bottom-up
(reference cubercnn/modeling/backbone/densenet.py), with the same p2..p6
taps:

  densenet: p2..p5 = denseblock outputs at strides 4..32, p5 after norm5
            with no ReLU (densenet.py:26-37)

p6 = stride-2 1x1 max-pool of p5. Module names are torchvision's: the
`features` live under `base` (the reference's attribute).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, conv2d, max_pool


class DenseLayer(nn.Module):
    """Pre-activation BN -> ReLU -> 1x1 (bn_size * growth) -> BN -> ReLU ->
    3x3 (growth), concatenated onto the input."""

    def __init__(self, cin, growth=32, bn_size=4, dtype=None):
        super().__init__()
        self.norm1 = BatchNorm2d(cin)
        self.conv1 = conv2d(cin, bn_size * growth, 1, padding=0, dtype=dtype)
        self.norm2 = BatchNorm2d(bn_size * growth)
        self.conv2 = conv2d(bn_size * growth, growth, 3, dtype=dtype)

    def forward(self, x):
        h = self.conv1(F.relu(self.norm1(x)))
        h = self.conv2(F.relu(self.norm2(h)))
        return torch.cat([x, h], dim=1)


class DenseBlock(nn.Sequential):
    def __init__(self, cin, num_layers, growth=32, dtype=None):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}", DenseLayer(cin + i * growth, growth,
                                                             dtype=dtype))


class Transition(nn.Module):
    """BN -> ReLU -> 1x1 conv -> 2x2/2 average pool."""

    def __init__(self, cin, cout, dtype=None):
        super().__init__()
        self.norm = BatchNorm2d(cin)
        self.conv = conv2d(cin, cout, 1, padding=0, dtype=dtype)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class _DenseNetFeatures(nn.Module):
    """torchvision densenet121 `features` (conv0 .. norm5)."""

    def __init__(self, dtype=None):
        super().__init__()
        self.conv0 = conv2d(3, 64, 7, 2, padding=3, dtype=dtype)
        self.norm0 = BatchNorm2d(64)
        cin = 64
        for i, n in enumerate((6, 12, 24, 16)):
            self.add_module(f"denseblock{i + 1}", DenseBlock(cin, n, dtype=dtype))
            cin += 32 * n
            if i < 3:
                self.add_module(f"transition{i + 1}", Transition(cin, cin // 2, dtype=dtype))
                cin //= 2
        self.norm5 = BatchNorm2d(cin)


class DenseNet121(nn.Module):
    def __init__(self, dtype=None):
        super().__init__()
        self.base = _DenseNetFeatures(dtype)
        self.out_channels = densenet_out_channels()

    def forward(self, x):
        b = self.base
        x = max_pool(F.relu(b.norm0(b.conv0(x))), 3, 2, padding=1)
        p2 = b.denseblock1(x)                            # 64 + 6 * 32 = 256, s4
        p3 = b.denseblock2(b.transition1(p2))            # 128 + 384 = 512, s8
        p4 = b.denseblock3(b.transition2(p3))            # 256 + 768 = 1024, s16
        p5 = b.norm5(b.denseblock4(b.transition3(p4)))   # 512 + 512 = 1024, s32
        return {"p2": p2, "p3": p3, "p4": p4, "p5": p5, "p6": max_pool(p5, 1, 2)}


def densenet_out_channels():
    return {"p2": 256, "p3": 512, "p4": 1024, "p5": 1024, "p6": 1024}
