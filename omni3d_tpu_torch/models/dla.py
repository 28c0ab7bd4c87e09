"""DLA-34 backbone (port of `omni3d_tpu.models.dla`), NCHW.

Module names follow the reference checkpoint namespace (the public
ucbdrive/dla layout the reference vendors, cubercnn/modeling/backbone/
dla.py:40-298), i.e. the keys `flax_path_to_torch` emits. Emits {p2..p6} at
strides {4..64}; p6 is a stride-2 1x1 max-pool of p5.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import FrozenBatchNorm2d, conv2d, conv_bn, max_pool

# variant -> (levels per stage, channels per stage, block). The other
# variants of `omni3d_tpu.models.dla.DLA_SPECS` are not ported yet.
DLA_SPECS = {
    "dla34": ([1, 1, 1, 2, 2, 1], [16, 32, 64, 128, 256, 512], "basic"),
}


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block; the caller supplies the residual."""

    def __init__(self, cin, cout, stride=1, dtype=None, norm=FrozenBatchNorm2d):
        super().__init__()
        self.conv1 = conv2d(cin, cout, 3, stride, dtype=dtype)
        self.bn1 = norm(cout)
        self.conv2 = conv2d(cout, cout, 3, 1, dtype=dtype)
        self.bn2 = norm(cout)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + residual)


class Root(nn.Module):
    """Aggregation node: 1x1 conv over concatenated children + BN (+res) + relu."""

    def __init__(self, cin, cout, residual=False, dtype=None, norm=FrozenBatchNorm2d):
        super().__init__()
        self.conv = conv2d(cin, cout, 1, 1, padding=0, dtype=dtype)
        self.bn = norm(cout)
        self.residual = residual

    def forward(self, children):
        x = self.bn(self.conv(torch.cat(children, dim=1)))
        if self.residual:
            x = x + children[0]
        return F.relu(x)


class Tree(nn.Module):
    """Recursive DLA aggregation tree. `project` exists whenever cin != cout,
    also on multi-level trees whose forward never uses it: the reference
    checkpoint (and the JAX package) carry those tensors."""

    def __init__(self, levels, cin, cout, stride=1, level_root=False,
                 root_dim=0, root_residual=False, dtype=None, norm=FrozenBatchNorm2d):
        super().__init__()
        nd = dict(dtype=dtype, norm=norm)
        if root_dim == 0:
            root_dim = 2 * cout
        if level_root:
            root_dim += cin
        if levels == 1:
            self.tree1 = BasicBlock(cin, cout, stride, **nd)
            self.tree2 = BasicBlock(cout, cout, 1, **nd)
            self.root = Root(root_dim, cout, root_residual, **nd)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, stride, root_dim=0,
                              root_residual=root_residual, **nd)
            self.tree2 = Tree(levels - 1, cout, cout, root_dim=root_dim + cout,
                              root_residual=root_residual, **nd)
        self.project = (conv_bn(cin, cout, 1, relu=False, padding=0, **nd)
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
    """DLA trunk emitting {p2..p6} at strides {4..64}; `norm` is the BN
    module (FrozenBatchNorm2d for inference, BatchNorm2d for training)."""

    def __init__(self, variant: str = "dla34", dtype=None, norm=FrozenBatchNorm2d):
        super().__init__()
        if variant not in DLA_SPECS:
            raise NotImplementedError(f"DLA variant {variant} is not ported")
        levels, ch, _ = DLA_SPECS[variant]
        nd = dict(dtype=dtype, norm=norm)
        self.base_layer = conv_bn(3, ch[0], 7, **nd)
        self.level0 = conv_bn(ch[0], ch[0], 3, **nd)
        self.level1 = conv_bn(ch[0], ch[1], 3, stride=2, **nd)
        self.level2 = Tree(levels[2], ch[1], ch[2], 2, **nd)
        self.level3 = Tree(levels[3], ch[2], ch[3], 2, level_root=True, **nd)
        self.level4 = Tree(levels[4], ch[3], ch[4], 2, level_root=True, **nd)
        self.level5 = Tree(levels[5], ch[4], ch[5], 2, level_root=True, **nd)
        self.out_channels = {"p2": ch[2], "p3": ch[3], "p4": ch[4], "p5": ch[5],
                             "p6": ch[5]}

    def forward(self, x):
        x = self.level1(self.level0(self.base_layer(x)))
        l2 = self.level2(x)
        l3 = self.level3(l2)
        l4 = self.level4(l3)
        l5 = self.level5(l4)
        return {"p2": l2, "p3": l3, "p4": l4, "p5": l5, "p6": max_pool(l5, 1, 2)}
