"""Torchvision-style ResNet backbones (port of `omni3d_tpu.models.resnet`),
NCHW.

Stem conv 7x7/2 + BN + ReLU and max-pool 3/2/1, layer1..layer4 emitting
p2..p5 at strides 4..32, p6 = stride-2 1x1 max-pool of p5 (reference
cubercnn/modeling/backbone/resnet.py:12-63). Module names are
torchvision's (`conv1`, `bn1`, `layer{i}.{j}.conv{k}` / `bn{k}`,
`downsample.0/1`), the keys `flax_path_to_torch` emits.
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, conv2d, conv_bn, max_pool

# depth -> (block, blocks per stage, stage base channels, expansion)
RESNET_SPECS = {
    18: ("basic", [2, 2, 2, 2], [64, 128, 256, 512], 1),
    34: ("basic", [3, 4, 6, 3], [64, 128, 256, 512], 1),
    50: ("bottleneck", [3, 4, 6, 3], [64, 128, 256, 512], 4),
    101: ("bottleneck", [3, 4, 23, 3], [64, 128, 256, 512], 4),
}


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block; `downsample` (1x1 conv + BN) projects the
    identity where the stride or the width changes."""

    def __init__(self, cin, cout, stride=1, downsample=False, dtype=None):
        super().__init__()
        self.conv1 = conv2d(cin, cout, 3, stride, dtype=dtype)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = conv2d(cout, cout, 3, 1, dtype=dtype)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = (conv_bn(cin, cout, 1, stride, relu=False, padding=0, dtype=dtype)
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here, torchvision v1.5) -> 1x1 over cout / 4
    channels, `downsample` as in `BasicBlock`."""

    def __init__(self, cin, cout, stride=1, downsample=False, dtype=None):
        super().__init__()
        mid = cout // 4
        self.conv1 = conv2d(cin, mid, 1, padding=0, dtype=dtype)
        self.bn1 = BatchNorm2d(mid)
        self.conv2 = conv2d(mid, mid, 3, stride, dtype=dtype)
        self.bn2 = BatchNorm2d(mid)
        self.conv3 = conv2d(mid, cout, 1, padding=0, dtype=dtype)
        self.bn3 = BatchNorm2d(cout)
        self.downsample = (conv_bn(cin, cout, 1, stride, relu=False, padding=0, dtype=dtype)
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet-`depth` trunk emitting {p2..p6} at strides {4..64}."""

    def __init__(self, depth: int = 34, dtype=None):
        super().__init__()
        kind, blocks, channels, expansion = RESNET_SPECS[depth]
        Block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = conv2d(3, 64, 7, 2, padding=3, dtype=dtype)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for stage, (n, ch) in enumerate(zip(blocks, channels)):
            cout = ch * expansion
            stride = 1 if stage == 0 else 2
            layer = []
            for b in range(n):
                s = stride if b == 0 else 1
                layer.append(Block(cin, cout, s, downsample=b == 0 and (s != 1 or cin != cout),
                                   dtype=dtype))
                cin = cout
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))
        self.out_channels = resnet_out_channels(depth)

    def forward(self, x):
        x = max_pool(F.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        out = {}
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            out[f"p{i + 2}"] = x
        out["p6"] = max_pool(x, 1, 2)
        return out


def resnet_out_channels(depth: int) -> dict:
    _, _, channels, expansion = RESNET_SPECS[depth]
    ch = [c * expansion for c in channels]
    return {"p2": ch[0], "p3": ch[1], "p4": ch[2], "p5": ch[3], "p6": ch[3]}
