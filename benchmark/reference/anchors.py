"""Frozen copy of omni3d_tpu_torch/models/anchors.py (commit 5a24e3a), part of the
benchmark's plain reference; the original's docstring follows.

Anchor generation (detectron2 DefaultAnchorGenerator semantics), a copy of
`omni3d_tpu.models.anchors`: that module cannot be imported without JAX,
because `omni3d_tpu.models.__init__` imports the JAX model.

Anchors depend only on feature shapes, so they are numpy constants that
`models.rcnn3d` caches per shape and device (configs/Base.yaml:46-57).
"""
from __future__ import annotations

import numpy as np


def cell_anchors(sizes, aspect_ratios) -> np.ndarray:
    """(A, 4) anchors centered at (0, 0): for each size, for each ratio,
    w = sqrt(size^2 / ratio), h = ratio * w."""
    out = []
    for size in sizes:
        area = float(size) ** 2
        for ar in aspect_ratios:
            w = np.sqrt(area / ar)
            h = ar * w
            out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, np.float32)


def grid_anchors(feat_h: int, feat_w: int, stride: int, cell: np.ndarray,
                 offset: float = 0.0) -> np.ndarray:
    """(H*W*A, 4) anchors for one level, position-major then anchor-major
    (matching the head's NHWC (H, W, A*4) channel layout)."""
    shift_x = (np.arange(feat_w) + offset) * stride
    shift_y = (np.arange(feat_h) + offset) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)  # (H, W)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)  # (H*W, 1, 4)
    anchors = shifts + cell[None]  # (H*W, A, 4)
    return anchors.reshape(-1, 4).astype(np.float32)


def pyramid_anchors(feat_shapes, strides, sizes, aspect_ratios, offset=0.0):
    """Anchors for every FPN level.

    Args:
      feat_shapes: [(H_l, W_l)] per level.
      strides: [int] per level.
      sizes: per-level size lists, e.g. [[32],[64],[128],[256],[512]].
      aspect_ratios: shared or per-level ratio lists.
    Returns: list of (H_l*W_l*A, 4) arrays.
    """
    n = len(feat_shapes)
    if len(sizes) == 1:
        sizes = list(sizes) * n
    if len(aspect_ratios) == 1:
        aspect_ratios = list(aspect_ratios) * n
    out = []
    for (h, w), stride, sz, ar in zip(feat_shapes, strides, sizes, aspect_ratios):
        out.append(grid_anchors(h, w, stride, cell_anchors(sz, ar), offset))
    return out
