"""DLA backbones (port of `omni3d_tpu.models.dla`), NCHW.

Module names follow the reference checkpoint namespace (the public
ucbdrive/dla layout the reference vendors, cubercnn/modeling/backbone/
dla.py:40-298), i.e. the keys `flax_path_to_torch` emits. Emits {p2..p6} at
strides {4..64}; p6 is a stride-2 1x1 max-pool of p5. Every variant runs
plain convolutions: the JAX package's space-to-depth stem is a TPU
workaround.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, conv2d, conv_bn, max_pool

# variant -> (levels per stage, channels per stage, block)
# (omni3d_tpu/models/dla.py:25-36; _r = residual roots, x = grouped
# BottleneckX with cardinality 32, x2 = cardinality 64)
DLA_SPECS = {
    "dla34":    ([1, 1, 1, 2, 2, 1], [16, 32, 64, 128, 256, 512], "basic"),
    "dla46_c":  ([1, 1, 1, 2, 2, 1], [16, 32, 64, 64, 128, 256], "bottleneck"),
    "dla46x_c": ([1, 1, 1, 2, 2, 1], [16, 32, 64, 64, 128, 256], "bottleneckx"),
    "dla60x_c": ([1, 1, 1, 2, 3, 1], [16, 32, 64, 64, 128, 256], "bottleneckx"),
    "dla60":    ([1, 1, 1, 2, 3, 1], [16, 32, 128, 256, 512, 1024], "bottleneck"),
    "dla60x":   ([1, 1, 1, 2, 3, 1], [16, 32, 128, 256, 512, 1024], "bottleneckx"),
    "dla102":   ([1, 1, 1, 3, 4, 1], [16, 32, 128, 256, 512, 1024], "bottleneck_r"),
    "dla102x":  ([1, 1, 1, 3, 4, 1], [16, 32, 128, 256, 512, 1024], "bottleneckx_r"),
    "dla102x2": ([1, 1, 1, 3, 4, 1], [16, 32, 128, 256, 512, 1024], "bottleneckx2_r"),
    "dla169":   ([1, 1, 2, 3, 5, 1], [16, 32, 128, 256, 512, 1024], "bottleneck_r"),
}
RESIDUAL_ROOT = ("dla102", "dla102x", "dla102x2", "dla169")


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block; the caller supplies the residual."""

    def __init__(self, cin, cout, stride=1, dtype=None):
        super().__init__()
        self.conv1 = conv2d(cin, cout, 3, stride, dtype=dtype)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = conv2d(cout, cout, 3, 1, dtype=dtype)
        self.bn2 = BatchNorm2d(cout)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, `groups`) -> 1x1 residual block over `mid`
    channels; the caller supplies the residual."""

    def __init__(self, cin, cout, stride=1, mid=None, groups=1, dtype=None):
        super().__init__()
        mid = cout // 2 if mid is None else mid     # expansion 2
        self.conv1 = conv2d(cin, mid, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(mid)
        self.conv2 = conv2d(mid, mid, 3, stride, groups=groups, dtype=dtype)
        self.bn2 = BatchNorm2d(mid)
        self.conv3 = conv2d(mid, cout, 1, dtype=dtype)
        self.bn3 = BatchNorm2d(cout)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + residual)


def _bottleneck_x(cardinality):
    """Grouped (ResNeXt-style) Bottleneck: mid = cout * cardinality // 32
    channels, the 3x3 in `cardinality` groups (reference dla.py:112-153)."""
    def make(cin, cout, stride=1, dtype=None):
        return Bottleneck(cin, cout, stride, mid=cout * cardinality // 32, groups=cardinality,
                          dtype=dtype)
    return make


_BLOCKS = {
    "basic": BasicBlock,
    "bottleneck": Bottleneck,
    "bottleneck_r": Bottleneck,
    "bottleneckx": _bottleneck_x(32),
    "bottleneckx_r": _bottleneck_x(32),
    "bottleneckx2_r": _bottleneck_x(64),
}


class Root(nn.Module):
    """Aggregation node: 1x1 conv over concatenated children + BN (+res) +
    relu; `cin` is the children's total width."""

    def __init__(self, cin, cout, residual=False, dtype=None):
        super().__init__()
        self.conv = conv2d(cin, cout, 1, 1, padding=0, dtype=dtype)
        self.bn = BatchNorm2d(cout)
        self.residual = residual

    def forward(self, children):
        x = self.bn(self.conv(torch.cat(children, dim=1)))
        if self.residual:
            x = x + children[0]
        return F.relu(x)


class Tree(nn.Module):
    """Recursive DLA aggregation tree. `root_dim` is the width its leaf root
    concatenates (the reference's arithmetic: 2 * cout, plus cin under a
    level root, plus cout per level above the leaf). `project` exists
    whenever cin != cout, also on multi-level trees whose forward never uses
    it: the reference checkpoint (and the JAX package) carry those tensors."""

    def __init__(self, levels, block, cin, cout, stride=1, level_root=False,
                 root_dim=0, root_residual=False, dtype=None):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * cout
        if level_root:
            root_dim += cin
        if levels == 1:
            self.tree1 = _BLOCKS[block](cin, cout, stride, dtype=dtype)
            self.tree2 = _BLOCKS[block](cout, cout, 1, dtype=dtype)
            self.root = Root(root_dim, cout, root_residual, dtype=dtype)
        else:
            self.tree1 = Tree(levels - 1, block, cin, cout, stride, root_dim=0,
                              root_residual=root_residual, dtype=dtype)
            self.tree2 = Tree(levels - 1, block, cout, cout, root_dim=root_dim + cout,
                              root_residual=root_residual, dtype=dtype)
        self.project = (conv_bn(cin, cout, 1, relu=False, padding=0, dtype=dtype)
                        if cin != cout else None)
        self.levels = levels
        self.level_root = level_root
        self.stride = stride

    def forward(self, x, children=None):
        children = [] if children is None else children
        bottom = max_pool(x, self.stride, self.stride) if self.stride > 1 else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            residual = self.project(bottom) if self.project is not None else bottom
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        if self.project is not None and self.project[1].training:
            # the JAX package evaluates the unused projection here too, so
            # its BN running statistics move in training; so do they here
            with torch.no_grad():
                self.project(bottom)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLA(nn.Module):
    """DLA trunk of any `DLA_SPECS` variant emitting {p2..p6} at strides
    {4..64}."""

    def __init__(self, variant: str = "dla34", dtype=None):
        super().__init__()
        levels, ch, block = DLA_SPECS[variant]
        res = variant in RESIDUAL_ROOT
        self.base_layer = conv_bn(3, ch[0], 7, dtype=dtype)
        self.level0 = conv_bn(ch[0], ch[0], 3, dtype=dtype)
        self.level1 = conv_bn(ch[0], ch[1], 3, stride=2, dtype=dtype)
        self.level2 = Tree(levels[2], block, ch[1], ch[2], 2, root_residual=res, dtype=dtype)
        self.level3 = Tree(levels[3], block, ch[2], ch[3], 2, level_root=True,
                           root_residual=res, dtype=dtype)
        self.level4 = Tree(levels[4], block, ch[3], ch[4], 2, level_root=True,
                           root_residual=res, dtype=dtype)
        self.level5 = Tree(levels[5], block, ch[4], ch[5], 2, level_root=True,
                           root_residual=res, dtype=dtype)
        self.out_channels = dla_out_channels(variant)

    def forward(self, x):
        x = self.level1(self.level0(self.base_layer(x)))
        l2 = self.level2(x)
        l3 = self.level3(l2)
        l4 = self.level4(l3)
        l5 = self.level5(l4)
        return {"p2": l2, "p3": l3, "p4": l4, "p5": l5, "p6": max_pool(l5, 1, 2)}


def dla_out_channels(variant: str) -> dict:
    ch = DLA_SPECS[variant][1]
    return {"p2": ch[2], "p3": ch[3], "p4": ch[4], "p5": ch[5], "p6": ch[5]}
