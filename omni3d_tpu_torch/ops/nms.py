"""Fixed-shape greedy NMS (port of `omni3d_tpu.ops.nms`), batched over
leading dimensions.

Exact sequential-greedy semantics: a box is suppressed only by a kept
higher-scoring box. The keep set is the unique fixpoint of
F(K)_i = valid_i and not exists j < i (score order): K_j and IoU(j, i) > t,
reached by iterating F from K = valid; iterate m is exact for every box whose
suppression chain is at most m deep, so the loop runs chain-depth times,
each one batched matrix-vector product over the (..., N, N) overlap matrix.
Ties in score keep input order (a stable sort), as `jnp.argsort` and
`lax.top_k` do in the JAX package.
"""
from __future__ import annotations

import torch

from ..utils import boxes as box_ops

NEG_INF = -1e10


def sort_desc(x: torch.Tensor, k: int | None = None):
    """Top-k of a float32 tensor along the last dim in `lax.top_k`'s order:
    XLA's total order on floats (-0.0 sorts below +0.0, unlike torch's
    comparison) and ties in index order. The sort runs on integer keys
    that have that order."""
    if x.dtype != torch.float32:
        raise TypeError(f"sort_desc takes float32, got {x.dtype}")
    bits = x.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    _, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    if k is not None:
        idx = idx[..., :k]
    return torch.gather(x, -1, idx), idx


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy NMS keep mask aligned with the inputs.

    boxes (..., N, 4) XYXY; scores (..., N), padding rows carry score <=
    NEG_INF or valid=False; suppresses IoU > iou_threshold vs a kept box.
    """
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    scores_s, order = sort_desc(scores)
    boxes_s = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    valid_s = scores_s > NEG_INF / 2
    n = scores.shape[-1]
    upper = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    sup = ((box_ops.pairwise_iou(boxes_s, boxes_s) > iou_threshold) & upper
           & valid_s[..., :, None]).to(boxes.dtype)
    keep = valid_s
    while True:
        hit = (keep.to(sup.dtype)[..., None, :] @ sup)[..., 0, :] > 0
        new = valid_s & ~hit
        if torch.equal(new, keep):
            break
        keep = new
    return torch.empty_like(keep).scatter_(-1, order, keep)


def nms_indices(boxes, scores, iou_threshold, max_out: int, valid=None):
    """Greedy NMS returning the top `max_out` kept indices in score order:
    (indices (..., max_out) int64, keep_valid (..., max_out) bool). Padding
    slots point at index 0 with keep_valid False."""
    n = scores.shape[-1]
    keep = nms_mask(boxes, scores, iou_threshold, valid)
    masked = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    k = min(max_out, n)
    top_scores, top_idx = sort_desc(masked, k)
    out_valid = top_scores > NEG_INF / 2
    top_idx = torch.where(out_valid, top_idx, torch.zeros_like(top_idx))
    if k < max_out:
        pad = [0, max_out - k]
        top_idx = torch.nn.functional.pad(top_idx, pad)
        out_valid = torch.nn.functional.pad(out_valid, pad)
    return top_idx, out_valid


def _offset_by_class(boxes, idxs):
    """detectron2's coordinate offset: each row's boxes shifted by idx x
    (the row's largest finite coordinate + 1), so boxes of different `idxs`
    never overlap."""
    finite = torch.where(torch.isfinite(boxes), boxes, torch.zeros_like(boxes))
    max_coord = finite.amax(dim=(-2, -1), keepdim=True)[..., 0] + 1.0
    return boxes + (idxs.to(boxes.dtype) * max_coord)[..., None]


def batched_nms_mask(boxes, scores, idxs, iou_threshold, valid=None):
    """Class-aware `nms_mask`: boxes of different `idxs` never suppress each
    other. idxs (..., N) int."""
    return nms_mask(_offset_by_class(boxes, idxs), scores, iou_threshold, valid)


def batched_nms_indices(boxes, scores, idxs, iou_threshold, max_out, valid=None):
    """Class-aware `nms_indices` through the same coordinate offset."""
    return nms_indices(_offset_by_class(boxes, idxs), scores, iou_threshold, max_out, valid)
