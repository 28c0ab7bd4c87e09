"""Frozen copy of omni3d_tpu_torch/models/roi_training.py (commit 5a24e3a), part of the
benchmark's plain reference; the original's docstring follows.

Training-time ROI logic (port of `omni3d_tpu.models.roi_training`),
batched over images: proposal labelling and sampling, the FastRCNN losses
and the disentangled cube losses.

Every reduction is a masked mean or sum over fixed-size tensors; the
reference's `safely_reduce_losses` NaN/Inf filtering (roi_heads.py:932-940)
is reproduced with masks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import boxes as box_ops
from . import geometry as G
from .rpn import gumbel_topk_mask, smooth_l1

SQRT_2 = 1.41421356
E_CONSTANT = 2.71828183


def label_and_sample_proposals(proposals, proposal_valid, gt_boxes, gt_classes, gt_valid,
                               num_classes: int, uniforms_pos, uniforms_neg,
                               batch_size: int = 512, positive_fraction: float = 0.25,
                               iou_thresh: float = 0.5, ignore_thresh: float = 0.5,
                               append_gt: bool = True, eps: float = 1e-4):
    """Proposal labelling and IoU-weighted sampling (reference
    roi_heads.py:826-929), batched.

    Args:
      proposals (B, P, 4); proposal_valid (B, P).
      gt_boxes (B, G, 4) padded; gt_classes (B, G) with -1 rows = ignore
        regions; gt_valid (B, G).
      uniforms_pos, uniforms_neg: (B, P + G) sampling draws (B, P without
        append_gt).
    Returns a dict of S = batch_size slots per image, foreground first:
      idx (B, S) into the candidates, boxes (B, S, 4), classes (B, S) int32
      in [0, num_classes] (background = num_classes), gt_idx (B, S) matched
      gt row, fg (B, S), valid (B, S), num_fg (B,).
    """
    is_ignore_gt = gt_valid & (gt_classes < 0)
    is_real_gt = gt_valid & (gt_classes >= 0)
    if append_gt:
        cand_boxes = torch.cat([proposals, gt_boxes], 1)
        cand_valid = torch.cat([proposal_valid, is_real_gt], 1)
    else:
        cand_boxes, cand_valid = proposals, proposal_valid
    N = cand_boxes.shape[1]
    zero = torch.zeros_like(gt_boxes)

    iou = box_ops.pairwise_iou(torch.where(is_real_gt[..., None], gt_boxes, zero), cand_boxes)
    iou = torch.where(is_real_gt[..., None], iou, torch.full_like(iou, -1.0))
    matched_iou, matched_idx = iou.max(dim=1)
    matched_iou = matched_iou.clamp(min=0.0)
    has_gt = is_real_gt.any(dim=1, keepdim=True)
    fg = (matched_iou >= iou_thresh) & cand_valid & has_gt
    classes = torch.where(fg, torch.gather(gt_classes.long(), 1, matched_idx),
                          torch.full_like(matched_idx, num_classes))

    # ignore regions: background candidates covered by an ignore gt -> dropped
    ioa = box_ops.pairwise_ioa(torch.where(is_ignore_gt[..., None], gt_boxes, zero), cand_boxes)
    ioa = torch.where(is_ignore_gt[..., None], ioa, torch.zeros_like(ioa))
    in_ignore = ioa.max(dim=1).values >= ignore_thresh
    bg = ~fg & cand_valid & ~in_ignore

    max_pos = int(batch_size * positive_fraction)
    num_pos = fg.sum(1).clamp(max=max_pos)
    num_neg = torch.minimum(bg.sum(1), batch_size - num_pos)
    logw = torch.log(matched_iou + eps)
    pos_sel = gumbel_topk_mask(logw, num_pos, fg, max_pos, uniforms_pos)
    neg_sel = gumbel_topk_mask(logw, num_neg, bg, batch_size, uniforms_neg)

    # compact: positives first, then negatives, then the rest (stable)
    key = torch.where(pos_sel, 2.0, torch.where(neg_sel, 1.0, 0.0))
    order = torch.sort(-key, dim=1, stable=True).indices
    idx = order[:, :min(batch_size, N)]
    if idx.shape[1] < batch_size:   # fewer candidates than sample slots: pad
        idx = F.pad(idx, (0, batch_size - idx.shape[1]))
    slot = torch.arange(batch_size, device=proposals.device)
    out_fg = slot < num_pos[:, None]
    out_valid = slot < (num_pos + num_neg)[:, None]
    return {
        "idx": idx,
        "boxes": torch.gather(cand_boxes, 1, idx[..., None].expand(-1, -1, 4)),
        "classes": torch.where(out_valid, torch.gather(classes, 1, idx),
                               torch.full_like(idx, num_classes)).to(torch.int32),
        "gt_idx": torch.gather(matched_idx, 1, idx),
        "fg": out_fg,
        "valid": out_valid,
        "num_fg": num_pos,
    }


def fast_rcnn_losses(scores, deltas, sampled_boxes, sampled_classes, sampled_valid,
                     gt_boxes_matched, num_classes: int,
                     bbox_reg_weights=(10.0, 10.0, 5.0, 5.0)):
    """FastRCNN losses (reference fast_rcnn.py:145-260), masked.

    scores (S, C+1) logits; deltas (S, C*4); sampled_* flattened to (S, ...);
    gt_boxes_matched (S, 4).
    """
    S = scores.shape[0]
    valid = sampled_valid
    norm = valid.sum().clamp(min=1).to(scores.dtype)
    cls = sampled_classes.long()
    ce = -torch.gather(torch.log_softmax(scores, dim=-1), 1, cls[:, None])[:, 0]
    loss_cls = torch.where(valid, ce, torch.zeros_like(ce)).sum() / norm

    fg = valid & (cls < num_classes)
    cls_safe = cls.clamp(max=num_classes - 1)
    fg_deltas = torch.gather(deltas.reshape(S, num_classes, 4), 1,
                             cls_safe[:, None, None].expand(-1, 1, 4))[:, 0]
    gt_deltas = box_ops.encode_deltas(sampled_boxes, gt_boxes_matched, bbox_reg_weights)
    reg = smooth_l1(fg_deltas, gt_deltas.detach()).sum(-1)
    loss_reg = torch.where(fg, reg, torch.zeros_like(reg)).sum() / norm
    return {"BoxHead/loss_cls": loss_cls, "BoxHead/loss_box_reg": loss_reg}


def l1_corner_loss(pred_corners, gt_corners):
    """Mean |.| over the 24 corner coordinates per box (roi_heads.py:295-296)."""
    return (pred_corners - gt_corners).abs().reshape(pred_corners.shape[0], -1).mean(-1)


def chamfer_corner_loss(pred_corners, gt_corners):
    """Symmetric L1 chamfer over the 8 corners (roi_heads.py:298-304)."""
    d = (pred_corners[:, :, None, :] - gt_corners[:, None, :, :]).abs().sum(-1)
    return d.min(dim=1).values.mean(-1) + d.min(dim=2).values.mean(-1)


def masked_mean(x, mask):
    """safely_reduce_losses (roi_heads.py:932-940): mean over valid & finite."""
    ok = mask & torch.isfinite(x)
    denom = ok.sum()
    s = torch.where(ok, x, torch.zeros_like(x)).sum()
    return torch.where(denom > 0, s / denom.clamp(min=1), torch.zeros_like(s))


def cube_losses(cube, fg_mask, gt_boxes3D, gt_poses, Ks_scaled, cfg_head, src_boxes):
    """Disentangled 3D losses (reference roi_heads.py:527-768), every branch
    of the JAX package's `cube_losses`.

    Args:
      cube: `heads.decode_cube` output for the foreground slots.
      fg_mask (F,); gt_boxes3D (F, 6) [u, v, z, w, h, l]; gt_poses (F, 3, 3)
      egocentric; Ks_scaled (F, 3, 3) network-res intrinsics; cfg_head the
      MODEL.ROI_CUBE_HEAD node; src_boxes (F, 4) proposal boxes.
    Returns (losses dict, metrics dict).
    """
    gt_2d = gt_boxes3D[:, :2]
    gt_z = gt_boxes3D[:, 2]
    gt_dims = gt_boxes3D[:, 3:6]
    fx, fy = Ks_scaled[:, 0, 0], Ks_scaled[:, 1, 1]
    sx, sy = Ks_scaled[:, 0, 2], Ks_scaled[:, 1, 2]

    def backproject(u, v, z):
        return torch.stack([z * (u - sx) / fx, z * (v - sy) / fy, z], dim=-1)

    gt_3d = backproject(gt_2d[:, 0], gt_2d[:, 1], gt_z)
    gt_box3d = torch.cat([gt_3d, gt_dims], -1)
    gt_corners = G.cuboid_verts(gt_box3d, gt_poses)

    x, y = cube["xy"][:, 0], cube["xy"][:, 1]
    z = cube["z"]
    dims = cube["dims"]
    pose = cube["pose"]

    if cfg_head.DISENTANGLED_LOSS:
        # disentangled substitutions (roi_heads.py:567-603)
        dis_z = torch.cat([backproject(gt_2d[:, 0], gt_2d[:, 1], z), gt_dims], -1)
        loss_z = l1_corner_loss(G.cuboid_verts(dis_z, gt_poses), gt_corners)
        dis_xy = torch.cat([backproject(x, y, gt_z), gt_dims], -1)
        loss_xy = l1_corner_loss(G.cuboid_verts(dis_xy, gt_poses), gt_corners)
        dis_dims = torch.cat([gt_3d, dims], -1)
        loss_dims = l1_corner_loss(G.cuboid_verts(dis_dims, gt_poses), gt_corners)
        pose_corners = G.cuboid_verts(gt_box3d, pose)
        if cfg_head.CHAMFER_POSE:
            loss_pose = chamfer_corner_loss(pose_corners, gt_corners)
        else:
            loss_pose = l1_corner_loss(pose_corners, gt_corners)
    else:
        # non-disentangled variants (roi_heads.py:606-649)
        sw = src_boxes[:, 2] - src_boxes[:, 0]
        sh = src_boxes[:, 3] - src_boxes[:, 1]
        scx = src_boxes[:, 0] + 0.5 * sw
        scy = src_boxes[:, 1] + 0.5 * sh
        gt_deltas = ((gt_2d - torch.stack([scx, scy], -1))
                     / torch.stack([sw.clamp(min=1e-6), sh.clamp(min=1e-6)], -1))
        loss_xy = (cube["deltas"] - gt_deltas).abs().mean(-1)

        if cfg_head.DIMS_PRIORS_ENABLED:
            # dims_norm compared to log(gt / prior_mean) (roi_heads.py:620-622)
            prior_mean = dims / torch.exp(cube["dims_norm"].clamp(max=5.0))
            tgt = torch.log(gt_dims.clamp(min=1e-6) / prior_mean.clamp(min=1e-6))
            loss_dims = (cube["dims_norm"] - tgt).abs().mean(-1)
        else:
            loss_dims = (cube["dims_norm"] - torch.log(gt_dims.clamp(min=1e-6))).abs().mean(-1)

        if cfg_head.ALLOCENTRIC_POSE:
            gt_allo = G.R_to_allocentric(Ks_scaled, gt_poses, x.detach(), y.detach())
            loss_pose = 1.0 - G.so3_relative_angle(cube["pose_allo"], gt_allo, eps=0.1,
                                                   cos_angle=True)
        else:
            loss_pose = 1.0 - G.so3_relative_angle(pose, gt_poses, eps=0.1, cos_angle=True)

        r2v = 1.0 / cube["virtual_to_real"].clamp(min=1e-8)
        zt = cfg_head.Z_TYPE
        if zt == "direct":
            loss_z = (z - gt_z).abs()
        elif zt == "sigmoid":
            loss_z = (cube["z_norm"] - (gt_z * r2v / 100.0).clamp(0, 1)).abs()
        elif zt == "log":
            loss_z = (cube["z_norm"] - torch.log((gt_z * r2v).clamp(min=0.01))).abs()
        else:  # clusters: raw logit vs standardized virtual depth (roi_heads.py:648-649)
            z_std = cube["z_std"].abs().clamp(min=1e-6)
            loss_z = (cube["z_norm"] - (gt_z * r2v - cube["z_mean"]) / z_std).abs()

    losses, metrics = {}, {}
    w3d = cfg_head.LOSS_W_3D

    # joint entangled loss (roi_heads.py:665-683)
    loss_joint = None
    if cfg_head.LOSS_W_JOINT > 0:
        joint_corners = G.cuboid_verts(torch.cat([backproject(x, y, z), dims], -1), pose)
        if cfg_head.CHAMFER_POSE and cfg_head.DISENTANGLED_LOSS:
            loss_joint = chamfer_corner_loss(joint_corners, gt_corners)
        else:
            loss_joint = l1_corner_loss(joint_corners, gt_corners)

    def scale_all(w):
        nonlocal loss_xy, loss_z, loss_dims, loss_pose, loss_joint
        loss_xy, loss_z, loss_dims, loss_pose = (loss_xy * w, loss_z * w, loss_dims * w,
                                                 loss_pose * w)
        if loss_joint is not None:
            loss_joint = loss_joint * w

    # inverse-z weighting (roi_heads.py:697-719)
    if cfg_head.INVERSE_Z_WEIGHT:
        scale_all(1.0 / torch.log(gt_z.clamp(min=E_CONSTANT)))

    # uncertainty scaling (roi_heads.py:721-740)
    if cube["uncert"] is not None and cfg_head.USE_CONFIDENCE > 0:
        u = cube["uncert"]
        scale_all(SQRT_2 * torch.exp(-u))
        losses["Cube/uncert"] = cfg_head.USE_CONFIDENCE * masked_mean(u, fg_mask)
        metrics["Cube/conf"] = masked_mean(torch.exp(-u), fg_mask)

    losses["Cube/loss_dims"] = masked_mean(loss_dims, fg_mask) * cfg_head.LOSS_W_DIMS * w3d
    losses["Cube/loss_xy"] = masked_mean(loss_xy, fg_mask) * cfg_head.LOSS_W_XY * w3d
    losses["Cube/loss_z"] = masked_mean(loss_z, fg_mask) * cfg_head.LOSS_W_Z * w3d
    losses["Cube/loss_pose"] = masked_mean(loss_pose, fg_mask) * cfg_head.LOSS_W_POSE * w3d
    if loss_joint is not None:
        losses["Cube/loss_joint"] = (masked_mean(loss_joint, fg_mask) * cfg_head.LOSS_W_JOINT
                                     * w3d)

    metrics["Cube/z_error"] = masked_mean((z - gt_z).abs(), fg_mask)
    metrics["Cube/dims_error"] = masked_mean((dims - gt_dims).abs().mean(-1), fg_mask)
    metrics["Cube/xy_error"] = masked_mean((cube["xy"] - gt_2d).abs().mean(-1), fg_mask)
    metrics["Cube/z_close"] = masked_mean(((z - gt_z).abs() < 0.2).float(), fg_mask)
    return losses, metrics
