"""DenseNet-121, MNASNet-1.0 and ShuffleNetV2-x1.0 backbones (port of
`omni3d_tpu.models.extra_backbones`), NCHW.

The torchvision architectures the reference wraps as FPN bottom-ups
(reference cubercnn/modeling/backbone/{densenet,mnasnet,shufflenet}.py),
with the same p2..p6 taps:

  densenet: p2..p5 = denseblock outputs at strides 4..32, p5 after norm5
            with no ReLU (densenet.py:26-37)
  mnasnet:  p2..p5 = inverted-residual stack outputs, channels 24/40/96/320
            (mnasnet.py:25-37)
  shufflenet: p2 = post-stem max-pool, p3..p5 = stages 2..4
            (shufflenet.py:27-43)

All emit p6 = stride-2 1x1 max-pool of p5. Module names are torchvision's:
DenseNet's `features` and MNASNet's `layers` live under `base` (the
reference's attribute), ShuffleNet's `conv1` and `stage{2,3,4}` at the top.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, avg_pool, conv2d, max_pool


def _pyramid(p2, p3, p4, p5):
    return {"p2": p2, "p3": p3, "p4": p4, "p5": p5, "p6": max_pool(p5, 1, 2)}


# ------------------------------ DenseNet-121 ------------------------------

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
        return avg_pool(self.conv(F.relu(self.norm(x))), 2, 2)


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
        return _pyramid(p2, p3, p4, p5)


# ------------------------------ MNASNet-1.0 ------------------------------

def _conv_bn_seq(cin, cout, kernel, stride=1, groups=1, relu=True, dtype=None):
    """[conv, BN(, ReLU)] as flat modules, for torchvision's flat
    Sequential indices."""
    mods = [conv2d(cin, cout, kernel, stride, groups=groups, dtype=dtype), BatchNorm2d(cout)]
    return mods + [nn.ReLU()] if relu else mods


class InvertedResidual(nn.Module):
    """1x1 expand -> depthwise k x k (stride) -> 1x1 project, `layers.0..7`;
    the input is added where stride 1 keeps the width."""

    def __init__(self, cin, cout, kernel, stride, expansion, dtype=None):
        super().__init__()
        mid = cin * expansion
        self.layers = nn.Sequential(
            *_conv_bn_seq(cin, mid, 1, dtype=dtype),
            *_conv_bn_seq(mid, mid, kernel, stride, groups=mid, dtype=dtype),
            *_conv_bn_seq(mid, cout, 1, relu=False, dtype=dtype))
        self.apply_residual = stride == 1 and cin == cout

    def forward(self, x):
        out = self.layers(x)
        return out + x if self.apply_residual else out


# (out channels, kernel, first stride, expansion, blocks) of stacks 1..6
MNASNET_STACKS = ((24, 3, 2, 3, 3), (40, 5, 2, 3, 3), (80, 5, 2, 6, 3),
                  (96, 3, 1, 6, 2), (192, 5, 2, 6, 4), (320, 3, 1, 6, 1))


class MNASNet10(nn.Module):
    """torchvision mnasnet1_0 `layers[0:14]` as `base`: the stem at indices
    0-7, the six stacks at 8-13 (the 1280-wide head convs are not built)."""

    def __init__(self, dtype=None):
        super().__init__()
        mods = (_conv_bn_seq(3, 32, 3, 2, dtype=dtype)
                + _conv_bn_seq(32, 32, 3, 1, groups=32, dtype=dtype)
                + _conv_bn_seq(32, 16, 1, relu=False, dtype=dtype))
        cin = 16
        for cout, k, s, e, n in MNASNET_STACKS:
            mods.append(nn.Sequential(*[
                InvertedResidual(cin if i == 0 else cout, cout, k, s if i == 0 else 1, e,
                                 dtype=dtype) for i in range(n)]))
            cin = cout
        self.base = nn.Sequential(*mods)
        self.out_channels = mnasnet_out_channels()

    def forward(self, x):
        b = self.base
        p2 = b[0:9](x)          # s4, 24
        p3 = b[9](p2)           # s8, 40
        p4 = b[10:12](p3)       # s16, 96
        p5 = b[12:14](p4)       # s32, 320
        return _pyramid(p2, p3, p4, p5)


# ------------------------------ ShuffleNetV2-x1.0 ------------------------------

def channel_shuffle(x, groups: int = 2):
    """Channel shuffle of an NCHW tensor: out channel i * groups + j is in
    channel j * (C / groups) + i, as torchvision's view(n, g, C / g, h,
    w).transpose(1, 2) orders them. Shuffled in the NHWC view, as the JAX
    package does, so the one copy comes out channels-last."""
    n, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1).reshape(n, h, w, groups, c // groups).transpose(3, 4)
    return y.reshape(n, h, w, c).permute(0, 3, 1, 2)


class ShuffleUnit(nn.Module):
    """ShuffleNetV2 unit: stride 1 splits the channels and transforms one
    half (`branch2`), stride 2 transforms the whole input twice (`branch1`
    depthwise + 1x1, `branch2` 1x1 + depthwise + 1x1); concat, shuffle."""

    def __init__(self, cin, cout, stride, dtype=None):
        super().__init__()
        half = cout // 2
        self.stride = stride
        if stride > 1:
            self.branch1 = nn.Sequential(
                *_conv_bn_seq(cin, cin, 3, stride, groups=cin, relu=False, dtype=dtype),
                *_conv_bn_seq(cin, half, 1, dtype=dtype))
        b2_in = cin if stride > 1 else half
        self.branch2 = nn.Sequential(
            *_conv_bn_seq(b2_in, half, 1, dtype=dtype),
            *_conv_bn_seq(half, half, 3, stride, groups=half, relu=False, dtype=dtype),
            *_conv_bn_seq(half, half, 1, dtype=dtype))

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self.branch2(x2)], dim=1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        return channel_shuffle(out)


class ShuffleNetV2(nn.Module):
    def __init__(self, dtype=None):
        super().__init__()
        self.conv1 = nn.Sequential(*_conv_bn_seq(3, 24, 3, 2, dtype=dtype))
        cin = 24
        for stage, (cout, n) in zip((2, 3, 4), ((116, 4), (232, 8), (464, 4))):
            self.add_module(f"stage{stage}", nn.Sequential(*[
                ShuffleUnit(cin if i == 0 else cout, cout, 2 if i == 0 else 1, dtype=dtype)
                for i in range(n)]))
            cin = cout
        self.out_channels = shufflenet_out_channels()

    def forward(self, x):
        p2 = max_pool(self.conv1(x), 3, 2, padding=1)   # s4, 24
        p3 = self.stage2(p2)                           # s8
        p4 = self.stage3(p3)                           # s16
        p5 = self.stage4(p4)                           # s32
        return _pyramid(p2, p3, p4, p5)


def densenet_out_channels():
    return {"p2": 256, "p3": 512, "p4": 1024, "p5": 1024, "p6": 1024}


def mnasnet_out_channels():
    return {"p2": 24, "p3": 40, "p4": 96, "p5": 320, "p6": 320}


def shufflenet_out_channels():
    return {"p2": 24, "p3": 116, "p4": 232, "p5": 464, "p6": 464}
