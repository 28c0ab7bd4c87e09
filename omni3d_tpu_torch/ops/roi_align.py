"""Multilevel ROIAlignV2 (`aligned=True`), plain PyTorch version, and the
FPN level routing (port of `omni3d_tpu.ops.roi_align` plus the level
routing of `omni3d_tpu.ops.roi_align_pallas._plan`).

`multilevel_roi_align_plain` is the reference the CUDA kernel
(`ops/roi_align_cuda.py`) is held to, and the path CPU tensors take. Each box
is pooled from the level it is given:
  * box coords scaled by 1/stride of its level, then shifted by -0.5,
  * each of the P x P bins is sampled on a grid of S per axis: S fixed when
    sampling_ratio > 0, else torchvision's adaptive ceil(extent / P) per box
    and axis, clamped to ADAPTIVE_SMAX (beyond the clamp the grid is a static
    SMAX grid, which torchvision's is not; the JAX package does the same),
  * samples are bilinear, zero outside [-1, H] and edge-clamped inside,
  * a bin is the mean of its samples, accumulated in float32 and rounded
    once to the feature dtype.
"""
from __future__ import annotations

import torch

# samples per bin-axis bound of the adaptive grid (omni3d_tpu/ops/roi_align.py:42)
ADAPTIVE_SMAX = 9

# level-routing fit caps of the JAX package's TPU kernel, in tap-extent cells
# at the pooled level (omni3d_tpu/ops/roi_align_pallas.py:89-92)
PATCH_X = 16
FIT_X1 = PATCH_X - 2
FIT_X2 = 2 * PATCH_X - 2
FIT_Y1 = 31
FIT_Y2 = 71

ROUTINGS = ("canonical", "fit")

# bound on one gathered-sample buffer of the plain version (bytes per chunk
# of boxes); four such buffers are live at once
_CHUNK_BYTES = 1 << 28


def assign_fpn_levels(boxes: torch.Tensor, min_level: int = 2, max_level: int = 6,
                      canonical_size: float = 224.0, canonical_level: int = 4):
    """detectron2 assign_boxes_to_levels: floor(canonical_level +
    log2(sqrt(area) / canonical_size + 1e-8)) clamped to [min_level,
    max_level]. Returns absolute levels, int32, shape boxes.shape[:-1]."""
    area = ((boxes[..., 2] - boxes[..., 0]).clamp(min=0)
            * (boxes[..., 3] - boxes[..., 1]).clamp(min=0))
    lvl = torch.floor(canonical_level + torch.log2(torch.sqrt(area) / canonical_size + 1e-8))
    return lvl.clamp(min_level, max_level).to(torch.int32)


def fit_levels(boxes: torch.Tensor, strides, min_level: int = 2) -> torch.Tensor:
    """0-based level index the JAX package's TPU kernel pools each box from
    (`_plan`, roi_align_pallas.py:179-196): the canonical level, bumped to
    the first coarser level where the box's taps fit two 16-cell x windows
    (x <= FIT_X2 and y <= FIT_Y1 cells) or two y windows (x <= FIT_X1 and
    y <= FIT_Y2). PARITY.md #2 documents this deviation from detectron2."""
    n_levels = len(strides)
    lvl = assign_fpn_levels(boxes, min_level, min_level + n_levels - 1) - min_level
    sx = boxes[..., 2] - boxes[..., 0]
    sy = boxes[..., 3] - boxes[..., 1]

    def need(side, cap):
        return torch.ceil(torch.log2(side.clamp(min=1.0) / (strides[0] * cap)))

    l_split_x = torch.maximum(need(sx, FIT_X2), need(sy, FIT_Y1))
    l_split_y = torch.maximum(need(sx, FIT_X1), need(sy, FIT_Y2))
    fit = torch.minimum(l_split_x, l_split_y).to(torch.int32)
    return torch.maximum(lvl, fit).clamp(0, n_levels - 1).to(torch.int32)


def route_levels(boxes, strides, min_level: int = 2, routing: str = "canonical"):
    """0-based level index per box under `routing`: "canonical" is
    detectron2's (and the JAX package's on the CPU, and with
    TPU.POOLER_EXACT_ROUTING); "fit" reproduces the JAX TPU kernel's bump."""
    if routing == "canonical":
        n = len(strides)
        return assign_fpn_levels(boxes, min_level, min_level + n - 1) - min_level
    if routing == "fit":
        return fit_levels(boxes, strides, min_level)
    raise ValueError(f"routing must be one of {ROUTINGS}, got {routing!r}")


def _sample_grid_1d(lo, size, out_size: int, sampling_ratio: int):
    """Sample positions and weights along one axis, per box.

    lo, size (n,) f32 -> pos, w (n, out_size * S) with S = sampling_ratio, or
    ADAPTIVE_SMAX when sampling_ratio == 0: then g = ceil(size / out_size)
    samples per bin, clamped to [1, SMAX]; samples past g repeat the last
    position at weight 0 (omni3d_tpu/ops/roi_align.py:50-80).
    """
    # Divisions are tensor by tensor: on CUDA, PyTorch divides by a Python
    # scalar as a multiply by the float reciprocal, an ulp off the IEEE
    # quotient that the CPU and the kernel compute. Positions must agree to
    # the bit, since the inside test is a step and one ulp of a position
    # moves a bilinear value by ulp x the feature step between cells.
    bin_sz = size / torch.full_like(size, out_size)
    ph = torch.arange(out_size, dtype=lo.dtype, device=lo.device)
    start = lo[:, None, None] + ph[None, :, None] * bin_sz[:, None, None]
    if sampling_ratio > 0:
        S = sampling_ratio
        iy = torch.arange(S, dtype=lo.dtype, device=lo.device)
        pos = start + (iy + 0.5) * (bin_sz / torch.full_like(bin_sz, S))[:, None, None]
        w = torch.full_like(pos, 1.0 / S)
        return pos.reshape(lo.shape[0], -1), w.reshape(lo.shape[0], -1)
    smax = ADAPTIVE_SMAX
    g = torch.ceil(bin_sz)
    gc = g.clamp(1, smax)
    i = torch.arange(smax, dtype=lo.dtype, device=lo.device)
    iy = torch.minimum(i[None, :], gc[:, None] - 1.0)
    pos = start + ((iy + 0.5) * (bin_sz / gc)[:, None])[:, None, :]
    w = torch.where(i[None, :] < g[:, None], 1.0 / gc[:, None], torch.zeros_like(iy))
    w = w[:, None, :].expand(-1, out_size, -1)
    return pos.reshape(lo.shape[0], -1), w.reshape(lo.shape[0], -1)


def _bilinear_1d(pos, limit):
    """Tap indices and weights with torchvision's boundary rules; `limit`
    (n,) int64 is the axis length of each box's level. Returns
    (lo, hi, w_lo, w_hi, inside) with inside 0 outside [-1, limit]."""
    lim = limit[:, None]
    inside = (pos >= -1.0) & (pos <= lim.to(pos.dtype))
    p = pos.clamp(min=0.0)
    lo = torch.floor(p).long()
    at_edge = lo >= lim - 1
    lo = torch.where(at_edge, lim - 1, lo)
    hi = torch.where(at_edge, lo, lo + 1)
    frac = torch.where(at_edge, torch.zeros_like(p), p - lo.to(p.dtype))
    return lo, hi, 1.0 - frac, frac, inside.to(p.dtype)


def multilevel_roi_align_plain(features, boxes, levels, strides, out_size: int = 7,
                               sampling_ratio: int = 0) -> torch.Tensor:
    """Plain PyTorch multilevel ROIAlignV2 with given per-box levels.

    Args:
      features: list of (B, H_l, W_l, C) maps (NHWC), finest level first.
      boxes: (B, N, 4) XYXY f32 in image coordinates.
      levels: (B, N) 0-based level index of each box.
      strides: per-level strides.
    Returns (B, N, P, P, C) in the features' dtype.
    """
    B, N = boxes.shape[:2]
    C = features[0].shape[-1]
    P = out_size
    S = sampling_ratio if sampling_ratio > 0 else ADAPTIVE_SMAX
    dev = boxes.device
    flat = torch.cat([f.reshape(-1, C) for f in features], 0)
    sizes = [f.shape[0] * f.shape[1] * f.shape[2] for f in features]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))], device=dev)
    Hs = torch.tensor([f.shape[1] for f in features], device=dev)
    Ws = torch.tensor([f.shape[2] for f in features], device=dev)
    scales = torch.tensor([1.0 / s for s in strides], dtype=torch.float32, device=dev)

    bx = boxes.reshape(-1, 4).float()
    lv = levels.reshape(-1).long()
    img = torch.arange(B, device=dev).repeat_interleave(N)
    out = torch.empty((B * N, P, P, C), dtype=features[0].dtype, device=dev)
    per_box = (P * S) ** 2 * C * 4
    step = max(1, _CHUNK_BYTES // per_box)
    for s in range(0, B * N, step):
        l = lv[s:s + step]
        Hc, Wc = Hs[l], Ws[l]
        base = offsets[l] + img[s:s + step] * Hc * Wc   # image's plane in its level
        b = bx[s:s + step] * scales[l][:, None] - 0.5
        ys, wys = _sample_grid_1d(b[:, 1], b[:, 3] - b[:, 1], P, sampling_ratio)
        xs, wxs = _sample_grid_1d(b[:, 0], b[:, 2] - b[:, 0], P, sampling_ratio)
        ylo, yhi, wy0, wy1, yin = _bilinear_1d(ys, Hc)
        xlo, xhi, wx0, wx1, xin = _bilinear_1d(xs, Wc)

        def tap(yi, xi, wgt_y, wgt_x):
            idx = base[:, None, None] + yi[:, :, None] * Wc[:, None, None] + xi[:, None, :]
            vals = flat[idx.reshape(-1)].reshape(idx.shape + (C,)).float()
            return vals * (wgt_y[:, :, None] * wgt_x[:, None, :])[..., None]

        acc = (tap(ylo, xlo, wy0, wx0) + tap(ylo, xhi, wy0, wx1)
               + tap(yhi, xlo, wy1, wx0) + tap(yhi, xhi, wy1, wx1))
        acc = acc * ((yin * wys)[:, :, None] * (xin * wxs)[:, None, :])[..., None]
        out[s:s + step] = acc.reshape(-1, P, S, P, S, C).sum(dim=(2, 4)).to(out.dtype)
    return out.reshape(B, N, P, P, C)
