"""Pooling work and the roofline bound, frozen from
omni3d_tpu_torch/utils/benchtime.py `pool_work` and `bound` (commit
5a24e3a), over the reference's copy of the pooler's geometry.

`pool_work` counts what the data needs of one multilevel ROIAlign: the
distinct pyramid cells with a nonzero tap weight and the float32
operations of the forward and of its transpose (2 per fused multiply-add,
the fewer of the dense-tap count and the banded form's count). `bound` is
the least time the card could take: the larger of the bytes over its
memory rate and the operations over its float32 rate outside the tensor
cores."""
from __future__ import annotations

import torch

from ..reference.roi_align import _chunk_taps, axis_bands, route_levels


def pool_work(boxes, shapes, strides, sampling_ratio, C, P=7):
    """(touched cells, forward operations, backward operations) of pooling
    (B, N, 4) `boxes` from a pyramid of (H_l, W_l) `shapes` with C channels,
    each box at detectron2's level."""
    levels = route_levels(boxes, strides)
    B = boxes.shape[0]
    touched = torch.zeros(sum(B * h * w for h, w in shapes), dtype=torch.bool,
                          device=boxes.device)
    taps_live = 0
    for _, _, taps, wy, wx in _chunk_taps(boxes, levels, shapes, strides, P,
                                          sampling_ratio, C):
        live = (wy[:, :, None] * wx[:, None, :]) != 0
        for idx, w in taps:
            nz = live & (w != 0)
            taps_live += int(nz.sum())
            touched[idx[nz]] = True
    lv = levels.reshape(-1).long()
    hs = torch.tensor([h for h, _ in shapes], device=boxes.device)[lv]
    ws = torch.tensor([w for _, w in shapes], device=boxes.device)[lv]
    scale = torch.tensor([1.0 / s for s in strides], dtype=torch.float32,
                         device=boxes.device)[lv]
    b = boxes.reshape(-1, 4) * scale[:, None] - 0.5
    _, ny, ay = axis_bands(b[:, 1], b[:, 3] - b[:, 1], hs, P, sampling_ratio)
    _, nx, ax = axis_bands(b[:, 0], b[:, 2] - b[:, 0], ws, P, sampling_ratio)
    nnz_y, nnz_x = (ay != 0).sum((1, 2)), (ax != 0).sum((1, 2))
    live = (ny > 0) & (nx > 0)
    fwd = int(((ny * nnz_x + P * nnz_y) * live).sum())
    bwd = int(((P * nnz_x + nnz_y * nx) * live).sum())
    return int(touched.sum()), min(taps_live, fwd) * C * 2, min(taps_live, bwd) * C * 2


def bound_ms(bytes_moved: float, ops: float, peak: dict) -> float:
    """The roofline bound in ms: max(bytes / memory rate, float32
    operations / float32 rate)."""
    return max(bytes_moved / peak["hbm_bytes_per_s"], ops / peak["float32"]) * 1e3
