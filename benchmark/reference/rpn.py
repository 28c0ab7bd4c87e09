"""Frozen copy of omni3d_tpu_torch/models/rpn.py (commit 5a24e3a), part of the
benchmark's plain reference; the original's docstring follows.

Region Proposal Network (port of `omni3d_tpu.models.rpn`): the
detectron2 StandardRPNHead, static-shape proposal selection, and the
training half (anchor matching, IoU-weighted Gumbel-top-k sampling with
ignore regions, the IoUness losses), batched over images.

Sampling takes its uniforms as an argument: torch cannot reproduce
`jax.random`'s bits, so parity tests inject the JAX draws and training draws
them from a `torch.Generator` (`engine.train.sampling_noise`)."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import nms as nms_ops
from . import boxes as box_ops
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


# ------------------------- training: matching + sampling -------------------------

def gumbel_topk_mask(log_weights, k, eligible, max_k: int | None = None, uniforms=None,
                     generator: torch.Generator | None = None):
    """Select k[b] items of row b proportional to exp(log_weights) without
    replacement (Gumbel-top-k == torch.multinomial without replacement).

    log_weights, eligible (B, n); k (B,) int. `uniforms` (B, n) in [0, 1)
    are the draws; by default they come from `generator` on the weights'
    device. Selection thresholds at the k-th largest key, as the JAX package
    does (ties have measure zero). Returns a bool mask; ineligible items are
    never selected.
    """
    n = log_weights.shape[-1]
    max_k = min(n if max_k is None else max_k, n)
    if uniforms is None:
        uniforms = torch.rand(log_weights.shape, generator=generator,
                              device=log_weights.device)
    g = -torch.log(-torch.log(uniforms + 1e-20) + 1e-20)
    keys = torch.where(eligible, log_weights + g, torch.full_like(g, NEG_INF))
    top_vals = torch.topk(keys, max_k, dim=-1).values
    thr = torch.gather(top_vals, -1, (k.long() - 1).clamp(0, max_k - 1)[..., None])
    return (keys >= thr) & (k > 0)[..., None] & eligible


def _match(iou, real_gt, thresh):
    matched_iou, matched_idx = iou.max(dim=1)                      # first max, as argmax
    has_gt = real_gt.any(dim=1, keepdim=True)
    matched_iou = torch.where(has_gt, matched_iou, torch.zeros_like(matched_iou))
    fg = matched_iou >= thresh
    best_per_gt = iou.max(dim=2, keepdim=True).values             # (B, G, 1)
    is_best = (iou >= best_per_gt) & (best_per_gt > 0) & real_gt[..., None]
    fg = (fg | is_best.any(dim=1)) & has_gt
    return matched_idx, matched_iou.clamp(min=0.0), fg


def label_and_sample_anchors(anchors, gt_boxes, gt_classes, gt_valid, uniforms_pos,
                             uniforms_neg, batch_size: int = 256,
                             positive_fraction: float = 1.0, fg_thresh: float = 0.05,
                             ignore_thresh: float = 0.5, eps: float = 1e-4):
    """Anchor labelling of a batch (reference rpn.py:43-127), static-shape.

    anchors (R, 4) shared by the batch; gt_boxes (B, G, 4), gt_classes
    (B, G) with -1 rows = ignore regions, gt_valid (B, G); uniforms_pos/neg
    (B, R) the sampling draws. Returns labels (B, R) int32 in {-1, 0, 1},
    matched_gt (B, R, 4) and matched_iou (B, R).
    """
    is_ignore_gt = gt_valid & (gt_classes < 0)
    is_real_gt = gt_valid & (gt_classes >= 0)
    inter = box_ops.pairwise_intersection(gt_boxes, anchors)       # (B, G, R)
    area_a = box_ops.area(anchors)                                 # (R,)
    iou = box_ops.iou_from_intersection(inter, gt_boxes, anchors)
    iou = torch.where(is_real_gt[..., None], iou, torch.full_like(iou, -1.0))
    matched_idx, matched_iou, fg = _match(iou, is_real_gt, fg_thresh)
    matched_gt = torch.gather(gt_boxes, 1, matched_idx[..., None].expand(-1, -1, 4))

    # subsample with IoU-weighted multinomial (rpn.py:275-328)
    num_pos = fg.sum(1).clamp(max=int(batch_size * positive_fraction))
    bg = ~fg
    num_neg = torch.minimum(bg.sum(1), batch_size - num_pos)
    logw = torch.log(matched_iou + eps)
    pos_sel = gumbel_topk_mask(logw, num_pos, fg, batch_size, uniforms_pos)
    neg_sel = gumbel_topk_mask(logw, num_neg, bg, batch_size, uniforms_neg)
    labels = torch.full_like(matched_idx, -1, dtype=torch.int32)
    labels = torch.where(pos_sel, torch.ones_like(labels), labels)
    labels = torch.where(neg_sel, torch.zeros_like(labels), labels)

    # always keep the best anchor per gt (rpn.py:75-84). The JAX package
    # scatters is_real_gt to each gt's best anchor in gt order, so where two
    # gts share a best anchor the last one's flag stands (padded rows'
    # best anchor is anchor 0); the same rule here, without the scatter's
    # order dependence.
    best_anchor = iou.argmax(dim=2)                                # (B, G)
    G = gt_boxes.shape[1]
    g_idx = torch.arange(G, device=anchors.device).expand_as(best_anchor)
    last_gt = torch.full_like(labels, -1, dtype=torch.int64)
    last_gt.scatter_reduce_(1, best_anchor, g_idx, reduce="amax")
    force = (last_gt >= 0) & torch.gather(is_real_gt, 1, last_gt.clamp(min=0))
    labels = torch.where(force & fg, torch.ones_like(labels), labels)

    # ignore regions: background anchors with IoA >= thresh -> -1 (rpn.py:93-105)
    ioa = torch.where(is_ignore_gt[..., None] & (area_a > 0),
                      inter / torch.where(area_a > 0, area_a, torch.ones_like(area_a)),
                      torch.zeros_like(inter))
    in_ignore = ioa.max(dim=1).values >= ignore_thresh
    labels = torch.where((labels == 0) & in_ignore, torch.full_like(labels, -1), labels)
    return {"labels": labels, "matched_gt": matched_gt, "matched_iou": matched_iou}


def smooth_l1(pred, target, beta: float = 0.0):
    """fvcore smooth_l1_loss; beta = 0 reduces to pure L1."""
    diff = (pred - target).abs()
    if beta <= 1e-8:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def rpn_losses(anchors, labels, matched_gt, pred_logits, pred_deltas,
               batch_size: int = 256, objectness: str = "IoUness"):
    """RPN losses over the batch (reference rpn.py:206-273), masked sums.

    anchors (R, 4); labels (B, R); matched_gt (B, R, 4); pred_logits (B, R);
    pred_deltas (B, R, 4). In IoUness mode both the objectness BCE and the
    box L1 are taken on foreground anchors and weighted by the anchor's IoU
    with its matched gt; the normaliser is batch_size * images.
    """
    num_images = labels.shape[0]
    fg = labels == 1
    anchors_b = anchors.expand_as(matched_gt)
    iou_w = torch.where(fg, box_ops.matched_iou(anchors_b, matched_gt),
                        torch.zeros_like(pred_logits))
    gt_deltas = box_ops.encode_deltas(anchors_b, matched_gt)
    reg = smooth_l1(pred_deltas, gt_deltas.detach()).sum(-1)
    loss_loc = (reg * iou_w.detach()).sum()

    def bce(tgt):
        return (pred_logits.clamp(min=0) - pred_logits * tgt
                + torch.log1p(torch.exp(-pred_logits.abs())))

    zero = torch.zeros_like(pred_logits)
    if objectness.lower() == "iouness":
        tgt = iou_w.detach()
        loss_cls = torch.where(fg, bce(tgt) * tgt, zero).sum()
    else:
        loss_cls = torch.where(labels >= 0, bce(fg.to(pred_logits.dtype)), zero).sum()
    norm = batch_size * num_images
    return {"rpn/cls": loss_cls / norm, "rpn/loc": loss_loc / norm}
