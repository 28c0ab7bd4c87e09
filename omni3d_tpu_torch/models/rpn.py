"""Region Proposal Network, inference (port of `omni3d_tpu.models.rpn`):
the detectron2 StandardRPNHead and static-shape proposal selection."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import nms as nms_ops
from ..utils import boxes as box_ops
from .layers import conv2d

NEG_INF = -1e10


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 objectness / anchor deltas. Outputs follow the
    JAX package's layout: logits (B, H*W*A) and deltas (B, H*W*A, 4),
    position-major then anchor."""

    def __init__(self, num_anchors: int, conv_dim: int = 256, dtype=None):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv = conv2d(conv_dim, conv_dim, 3, bias=True, dtype=dtype)
        self.objectness_logits = conv2d(conv_dim, num_anchors, 1, bias=True, dtype=dtype)
        self.anchor_deltas = conv2d(conv_dim, num_anchors * 4, 1, bias=True, dtype=dtype)

    def forward(self, features):
        logits, regs = [], []
        for f in features:
            t = F.relu(self.conv(f))
            n = t.shape[0]
            logits.append(self.objectness_logits(t).permute(0, 2, 3, 1).reshape(n, -1))
            regs.append(self.anchor_deltas(t).permute(0, 2, 3, 1).reshape(n, -1, 4))
        return logits, regs


def select_proposals(anchors_per_level, logits_per_level, deltas_per_level,
                     image_hw, pre_nms_topk: int, post_nms_topk: int,
                     nms_thresh: float = 0.7):
    """find_top_rpn_proposals with static shapes, batched over images.

    Args:
      anchors_per_level: list of (R_l, 4).
      logits_per_level: list of (B, R_l) f32.
      deltas_per_level: list of (B, R_l, 4) f32.
      image_hw: (B, 2) f32 (height, width) each image's boxes clip to.

    Returns boxes (B, P, 4), scores (B, P), valid (B, P), P = post_nms_topk.

    Per-level NMS runs for all levels in one batched call: each level's
    top-k candidates are padded to the largest k with invalid rows, which
    never keep and never suppress.
    """
    B = image_hw.shape[0]
    h, w = image_hw[:, 0, None], image_hw[:, 1, None]
    ks = [min(pre_nms_topk, a.shape[0]) for a in anchors_per_level]
    kmax = max(ks)
    lvl_boxes, lvl_scores, lvl_valid = [], [], []
    for anch, logit, delta, k in zip(anchors_per_level, logits_per_level,
                                     deltas_per_level, ks):
        top_scores, top_idx = nms_ops.sort_desc(logit, k)
        d = torch.gather(delta, 1, top_idx[..., None].expand(B, k, 4))
        boxes = box_ops.decode_deltas(d, anch[top_idx])
        boxes = box_ops.clip_boxes(boxes, h, w)
        valid = box_ops.nonempty(boxes) & torch.isfinite(top_scores)
        pad = kmax - k
        lvl_boxes.append(F.pad(boxes, (0, 0, 0, pad)))
        lvl_scores.append(F.pad(top_scores, (0, pad), value=NEG_INF))
        lvl_valid.append(F.pad(valid, (0, pad)))
    boxes = torch.stack(lvl_boxes, 1)      # (B, L, kmax, 4)
    scores = torch.stack(lvl_scores, 1)
    keep = nms_ops.nms_mask(boxes, scores, nms_thresh, torch.stack(lvl_valid, 1))
    scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))

    # drop the level padding again: the global top-k ranks the same
    # candidates, in the same index order, as the JAX package's concatenation
    boxes = torch.cat([boxes[:, i, :k] for i, k in enumerate(ks)], 1)
    scores = torch.cat([scores[:, i, :k] for i, k in enumerate(ks)], 1)
    p = min(post_nms_topk, scores.shape[1])
    top_scores, top_idx = nms_ops.sort_desc(scores, p)
    out_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(B, p, 4))
    out_valid = top_scores > NEG_INF / 2
    if p < post_nms_topk:
        pad = post_nms_topk - p
        out_boxes = F.pad(out_boxes, (0, 0, 0, pad))
        top_scores = F.pad(top_scores, (0, pad), value=NEG_INF)
        out_valid = F.pad(out_valid, (0, pad))
    return out_boxes, top_scores, out_valid
