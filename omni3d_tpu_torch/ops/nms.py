"""Fixed-shape greedy NMS (port of `omni3d_tpu.ops.nms`), batched over
leading dimensions.

Exact sequential-greedy semantics: a box is suppressed only by a kept
higher-scoring box. Ties in score keep input order (a stable sort), as
`jnp.argsort` and `lax.top_k` do in the JAX package.

`nms_mask` dispatches on the tensors' device; both paths first sort with
`sort_desc` in torch. On the CPU it runs `nms_mask_plain`, the keep set as
the unique fixpoint of
F(K)_i = valid_i and not exists j < i (score order): K_j and IoU(j, i) > t,
reached by iterating F from K = valid (iterate m is exact for every box
whose suppression chain is at most m deep, so the loop runs chain-depth
times, each one batched matrix-vector product over the (..., N, N) overlap
matrix, with a host sync per iteration). On CUDA tensors it launches the
two kernels of `csrc/nms.cu` through `ops/nms_cuda.py`, or the wrapper
raises: 64-bit suppression words per 64 x 64 pair tile, then one block per
row walking them greedily in score order, with no host sync. Sequential greedy
is the fixpoint, so both give the same mask bit for bit.
`suppression_words` and `greedy_keep_from_words` are the kernels' CPU
mirror: the same words, in the same layout and bit order, and the same walk.
"""
from __future__ import annotations

import math

import torch

from ..utils import boxes as box_ops
from . import nms_cuda

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


def _sorted(boxes, scores, valid):
    """Boxes, validity and the sort's indices in `sort_desc` order."""
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    scores_s, order = sort_desc(scores)
    boxes_s = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    return boxes_s, scores_s > NEG_INF / 2, order


def _upper(n, device):
    return torch.ones(n, n, dtype=torch.bool, device=device).triu(1)


def nms_mask_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """`nms_mask` by the fixpoint iteration (module docstring) in plain
    torch, on any device; the kernels' reference."""
    boxes_s, valid_s, order = _sorted(boxes, scores, valid)
    sup = ((box_ops.pairwise_iou(boxes_s, boxes_s) > iou_threshold)
           & _upper(boxes.shape[-2], boxes.device) & valid_s[..., :, None]).to(boxes.dtype)
    keep = valid_s
    while True:
        hit = (keep.to(sup.dtype)[..., None, :] @ sup)[..., 0, :] > 0
        new = valid_s & ~hit
        if torch.equal(new, keep):
            break
        keep = new
    return torch.empty_like(keep).scatter_(-1, order, keep)


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy NMS keep mask aligned with the inputs.

    boxes (..., N, 4) XYXY; scores (..., N), padding rows carry score <=
    NEG_INF or valid=False; suppresses IoU > iou_threshold vs a kept box.
    CPU tensors take `nms_mask_plain`; CUDA tensors (float32 boxes) the
    kernels, with no host sync; anything else raises.
    """
    if boxes.device.type == "cpu":
        return nms_mask_plain(boxes, scores, iou_threshold, valid)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_mask runs on CPU or CUDA tensors, got {boxes.device}")
    boxes_s, valid_s, order = _sorted(boxes, scores, valid)
    rows = (math.prod(scores.shape[:-1]), scores.shape[-1])
    words = nms_cuda.suppression_words(boxes_s.reshape(*rows, 4), valid_s.reshape(rows),
                                       iou_threshold)
    keep = nms_cuda.greedy_keep(words, valid_s.reshape(rows), order.reshape(rows))
    return keep.reshape(scores.shape)


def suppression_words(boxes_s: torch.Tensor, valid_s: torch.Tensor,
                      iou_threshold: float) -> torch.Tensor:
    """CPU mirror of the words kernel: (..., W, 64 W) int64, W = ceil(N /
    64), for score-sorted boxes (..., N, 4) and their validity (..., N);
    bit b of words[..., w, i] is set iff valid_s[i], valid_s[j], j = 64 w +
    b > i, j < N and IoU(i, j) > iou_threshold (bit 63 is the sign bit).
    Blocks w < i // 64, which the kernel leaves unwritten, are 0 here."""
    n = boxes_s.shape[-2]
    n_pad = -(-n // nms_cuda.TILE) * nms_cuda.TILE
    sup = ((box_ops.pairwise_iou(boxes_s, boxes_s) > iou_threshold)
           & _upper(n, boxes_s.device) & valid_s[..., :, None] & valid_s[..., None, :])
    sup = torch.nn.functional.pad(sup, (0, n_pad - n, 0, n_pad - n))
    bits = sup.reshape(*sup.shape[:-1], -1, nms_cuda.TILE).to(torch.int64)
    weights = torch.ones((), dtype=torch.int64) << torch.arange(nms_cuda.TILE)
    words = (bits * weights.to(boxes_s.device)).sum(-1)   # distinct bits: the sum is their OR
    return words.transpose(-1, -2).contiguous()


def greedy_keep_from_words(words: torch.Tensor, valid_s: torch.Tensor) -> torch.Tensor:
    """CPU mirror of the greedy kernel: the keep mask (..., N) in score
    order from suppression words (..., W, 64 W) and validity (..., N). Box
    i is kept iff valid and not removed; a kept box ORs its words w >= i //
    64 into the removed bits (the lower words are never read)."""
    n = valid_s.shape[-1]
    removed = torch.zeros(words.shape[:-1], dtype=torch.int64, device=words.device)
    keep = torch.zeros_like(valid_s)
    for i in range(n):
        w, b = divmod(i, nms_cuda.TILE)
        k = valid_s[..., i] & (((removed[..., w] >> b) & 1) == 0)
        keep[..., i] = k
        removed[..., w:] |= torch.where(k[..., None], words[..., w:, i],
                                        torch.zeros_like(words[..., w:, i]))
    return keep


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
