"""Frozen copy of omni3d_tpu_torch/utils/boxes.py (commit 5a24e3a), part of the
benchmark's plain reference; the original's docstring follows.

2D box math on (..., 4) XYXY tensors (port of `omni3d_tpu.utils.boxes`).

Leading batch dimensions broadcast; invalid/padded rows are handled by
callers via masks.
"""
from __future__ import annotations

import math

import torch

# detectron2 Box2BoxTransform default scale clamp.
SCALE_CLAMP = math.log(1000.0 / 16)


def area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * (
        boxes[..., 3] - boxes[..., 1]).clamp(min=0)


def pairwise_intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection areas between all pairs; (..., M, 4) x (..., N, 4) ->
    (..., M, N)."""
    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    return (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)


def _safe_div(num, den):
    """num / den where den > 0, else 0."""
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def iou_from_intersection(inter: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of all pairs from their (..., M, N) intersections; zero-area
    pairs -> 0."""
    return _safe_div(inter, area(a)[..., :, None] + area(b)[..., None, :] - inter)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between all pairs; (..., M, 4) x (..., N, 4) -> (..., M, N).
    Zero-area pairs -> 0."""
    return iou_from_intersection(pairwise_intersection(a, b), a, b)


def pairwise_ioa(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection over the area of `b` (how much of b lies inside a);
    (..., M, 4) x (..., N, 4) -> (..., M, N), detectron2 pairwise_ioa."""
    inter = pairwise_intersection(a, b)
    return _safe_div(inter, area(b)[..., None, :].expand_as(inter))


def matched_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of matched box lists, both (..., 4)."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return _safe_div(inter, area(a) + area(b) - inter)


def encode_deltas(src: torch.Tensor, target: torch.Tensor,
                  weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Box -> regression deltas (dx, dy, dw, dh), detectron2
    Box2BoxTransform.get_deltas semantics."""
    sw = src[..., 2] - src[..., 0]
    sh = src[..., 3] - src[..., 1]
    scx = src[..., 0] + 0.5 * sw
    scy = src[..., 1] + 0.5 * sh
    tw = target[..., 2] - target[..., 0]
    th = target[..., 3] - target[..., 1]
    tcx = target[..., 0] + 0.5 * tw
    tcy = target[..., 1] + 0.5 * th
    wx, wy, ww, wh = weights
    sw = torch.where(sw <= 0, torch.full_like(sw, 1e-6), sw)
    sh = torch.where(sh <= 0, torch.full_like(sh, 1e-6), sh)
    dx = wx * (tcx - scx) / sw
    dy = wy * (tcy - scy) / sh
    dw = ww * torch.log(tw.clamp(min=1e-6) / sw)
    dh = wh * torch.log(th.clamp(min=1e-6) / sh)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                  weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Regression deltas + source boxes -> boxes, detectron2
    Box2BoxTransform.apply_deltas semantics (incl. SCALE_CLAMP)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=SCALE_CLAMP)
    dh = (deltas[..., 3] / wh).clamp(max=SCALE_CLAMP)
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack(
        [pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)


def clip_boxes(boxes: torch.Tensor, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Clip boxes to [0, w] x [0, h] (detectron2 Boxes.clip); `h` and `w`
    broadcast against boxes[..., 0]."""
    x1 = torch.minimum(boxes[..., 0].clamp(min=0), w)
    y1 = torch.minimum(boxes[..., 1].clamp(min=0), h)
    x2 = torch.minimum(boxes[..., 2].clamp(min=0), w)
    y2 = torch.minimum(boxes[..., 3].clamp(min=0), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Mask of boxes with width and height > threshold (detectron2 Boxes.nonempty)."""
    return ((boxes[..., 2] - boxes[..., 0]) > threshold) & (
        (boxes[..., 3] - boxes[..., 1]) > threshold)


# ------------------------- numpy host-side versions -------------------------

