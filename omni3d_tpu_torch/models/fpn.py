"""Feature Pyramid Network (port of `omni3d_tpu.models.fpn`), detectron2
module names: the bottom-up trunk lives at `bottom_up`, the convs at
`fpn_lateral{s}` / `fpn_output{s}` with s = log2(stride)."""
from __future__ import annotations

from typing import Sequence

import torch.nn as nn

from .layers import conv2d, upsample_nearest_2x


class FPN(nn.Module):
    """1x1 laterals, nearest-2x top-down path with sum (or avg) fusion, 3x3
    outputs, `out_channels` at every level."""

    def __init__(self, bottom_up: nn.Module, in_channels: dict,
                 in_features: Sequence[str] = ("p2", "p3", "p4", "p5", "p6"),
                 out_channels: int = 256, fuse_type: str = "sum", dtype=None):
        super().__init__()
        self.bottom_up = bottom_up
        self.in_features = tuple(in_features)
        self.fuse_type = fuse_type
        self.stages = list(range(2, 2 + len(self.in_features)))
        for s, f in zip(self.stages, self.in_features):
            self.add_module(f"fpn_lateral{s}", conv2d(in_channels[f], out_channels, 1,
                                                      bias=True, dtype=dtype))
            self.add_module(f"fpn_output{s}", conv2d(out_channels, out_channels, 3,
                                                     bias=True, dtype=dtype))

    def forward(self, x) -> dict:
        bottom_up = self.bottom_up(x)
        feats = [bottom_up[f] for f in self.in_features]
        laterals = [getattr(self, f"fpn_lateral{s}")(f)
                    for s, f in zip(self.stages, feats)]
        results = {}
        prev = laterals[-1]
        for i in range(len(feats) - 1, -1, -1):
            if i < len(feats) - 1:
                td = upsample_nearest_2x(prev)
                # odd spatial dims: crop to the lateral's shape
                td = td[:, :, : laterals[i].shape[2], : laterals[i].shape[3]]
                prev = laterals[i] + td
                if self.fuse_type == "avg":
                    prev = prev * 0.5
            results[self.in_features[i]] = getattr(self, f"fpn_output{self.stages[i]}")(prev)
        return results
