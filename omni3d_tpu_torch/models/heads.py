"""Detection heads (port of `omni3d_tpu.models.heads`): the 2D box head and
predictor, `fast_rcnn_inference`, and the 3D cube head with `decode_cube`.

The heads take pooled features in the JAX package's (N, P, P, C) layout and
flatten them in detectron2's (C, P, P) order, so the first FC keeps the
reference checkpoint's column layout.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import nms as nms_ops
from ..utils import boxes as box_ops
from ..utils import geometry as G

NEG_INF = -1e10


def _flatten_chw(x):
    """(N, P, P, C) pooled features -> (N, C*P*P) in detectron2's order."""
    return x.permute(0, 3, 1, 2).flatten(1)


class _FCTrunk(nn.Module):
    """fc1 -> relu -> ... -> fcN -> relu, keyed `fc1`..`fcN`."""

    def __init__(self, in_dim: int, fc_dim: int, num_fc: int, dtype=None):
        super().__init__()
        self.num_fc = num_fc
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(in_dim if i == 0 else fc_dim,
                                                    fc_dim, dtype=dtype))

    def forward(self, x):
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class BoxHead(_FCTrunk):
    """FastRCNNConvFCHead with NUM_FC fully connected layers."""

    def forward(self, x):
        return super().forward(_flatten_chw(x))


class FastRCNNPredictor(nn.Module):
    """cls_score (C+1) + per-class bbox_pred (C*4)."""

    def __init__(self, in_dim: int, num_classes: int, dtype=None):
        super().__init__()
        self.cls_score = nn.Linear(in_dim, num_classes + 1, dtype=dtype)
        self.bbox_pred = nn.Linear(in_dim, num_classes * 4, dtype=dtype)

    def forward(self, x):
        return self.cls_score(x), self.bbox_pred(x)


def fast_rcnn_inference(scores, deltas, proposal_boxes, proposal_valid, image_hw,
                        num_classes: int, score_thresh: float = 0.01,
                        nms_thresh: float = 0.5, topk: int = 100,
                        nms_candidates: int = 1024,
                        bbox_reg_weights=(10.0, 10.0, 5.0, 5.0)):
    """Static-shape fast_rcnn_inference (reference fast_rcnn.py:57-116),
    batched over images: score threshold -> per-class NMS -> top-k.

    Args:
      scores (B, P, C+1) f32 logits; deltas (B, P, C*4) f32;
      proposal_boxes (B, P, 4); proposal_valid (B, P); image_hw (B, 2).
    Returns dict of detections padded to K = topk: boxes (B, K, 4),
      scores (B, K), classes (B, K) int32, valid (B, K), scores_full (B, K, C).
    """
    B, P = scores.shape[:2]
    C = num_classes
    probs = torch.softmax(scores, dim=-1)[..., :C]
    boxes_pc = box_ops.decode_deltas(deltas.reshape(B, P, C, 4),
                                     proposal_boxes[:, :, None, :], bbox_reg_weights)
    boxes_pc = box_ops.clip_boxes(boxes_pc, image_hw[:, 0, None, None],
                                  image_hw[:, 1, None, None])

    flat = torch.where(proposal_valid[..., None], probs, torch.zeros_like(probs))
    flat = flat.reshape(B, P * C)
    flat = torch.where(flat > score_thresh, flat, torch.full_like(flat, NEG_INF))
    top_scores, top_idx = nms_ops.sort_desc(flat, min(nms_candidates, P * C))
    cand_valid = top_scores > NEG_INF / 2
    prop_idx = top_idx // C
    cls_idx = top_idx % C
    cand_boxes = torch.gather(boxes_pc.reshape(B, P * C, 4), 1,
                              top_idx[..., None].expand(-1, -1, 4))

    keep_idx, keep_valid = nms_ops.batched_nms_indices(
        cand_boxes, top_scores, cls_idx, nms_thresh, topk, cand_valid)
    det_boxes = torch.gather(cand_boxes, 1, keep_idx[..., None].expand(-1, -1, 4))
    det_scores = torch.where(keep_valid, torch.gather(top_scores, 1, keep_idx),
                             torch.zeros((), device=scores.device))
    det_classes = torch.where(keep_valid, torch.gather(cls_idx, 1, keep_idx),
                              torch.zeros((), dtype=cls_idx.dtype, device=scores.device))
    det_prop = torch.gather(prop_idx, 1, keep_idx)
    det_scores_full = torch.gather(probs, 1, det_prop[..., None].expand(-1, -1, C))
    return {
        "boxes": det_boxes,
        "scores": det_scores,
        "classes": det_classes.to(torch.int32),
        "valid": keep_valid,
        "scores_full": det_scores_full,
    }


def scale_proposals(boxes: torch.Tensor, factor: float) -> torch.Tensor:
    """Zoom RoIs about their centers before cube pooling (reference
    roi_heads.py:306-324; off when factor <= 0)."""
    if factor <= 0:
        return boxes
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    w = (boxes[..., 2] - boxes[..., 0]) * factor * 0.5
    h = (boxes[..., 3] - boxes[..., 1]) * factor * 0.5
    return torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)


_POSE_DIM = {"6d": 6, "quaternion": 4, "euler": 3}


class CubeHead(nn.Module):
    """3D cuboid head (reference cube_head.py:19-197): shared (or
    per-branch) FC trunk + per-class linear outputs for 2D center deltas,
    dims, pose, depth and uncertainty."""

    def __init__(self, in_dim: int, num_classes: int, pose_type: str = "6d",
                 cluster_bins: int = 1, shared_fc: bool = True, use_conf: bool = True,
                 num_fc: int = 2, fc_dim: int = 1024, dtype=None):
        super().__init__()
        if pose_type not in _POSE_DIM:
            raise ValueError(f"unknown POSE_TYPE {pose_type}")
        self.num_classes = num_classes
        self.pose_type = pose_type
        self.cluster_bins = cluster_bins
        self.shared_fc = shared_fc
        self.use_conf = use_conf
        C = num_classes
        bins = max(cluster_bins, 1)
        branches = ([""] if shared_fc
                    else ["_XY", "_dims", "_pose", "_Z"] + (["_conf"] if use_conf else []))
        for b in branches:
            self.add_module(f"feature_generator{b}", _FCTrunk(in_dim, fc_dim, num_fc, dtype))
        feat = fc_dim if num_fc else in_dim
        self.bbox_3D_center_deltas = nn.Linear(feat, C * 2, dtype=dtype)
        self.bbox_3D_dims = nn.Linear(feat, C * 3, dtype=dtype)
        self.bbox_3D_pose = nn.Linear(feat, C * _POSE_DIM[pose_type], dtype=dtype)
        self.bbox_3D_center_depth = nn.Linear(feat, C * bins, dtype=dtype)
        self.bbox_3D_uncertainty = nn.Linear(feat, C, dtype=dtype) if use_conf else None

    def forward(self, x):
        """x (N, P, P, C) -> deltas (N, C, 2), z (N, C) or (N, bins, C),
        dims (N, C, 3), R (N, C, 3, 3) f32, uncert (N, C) or None."""
        n, C = x.shape[0], self.num_classes
        x = _flatten_chw(x)
        if self.shared_fc:
            f_xy = f_dims = f_pose = f_z = f_conf = self.feature_generator(x)
        else:
            f_xy = self.feature_generator_XY(x)
            f_dims = self.feature_generator_dims(x)
            f_pose = self.feature_generator_pose(x)
            f_z = self.feature_generator_Z(x)
            f_conf = self.feature_generator_conf(x) if self.use_conf else None
        deltas = self.bbox_3D_center_deltas(f_xy)
        dims = self.bbox_3D_dims(f_dims)
        pose_raw = self.bbox_3D_pose(f_pose)
        z = self.bbox_3D_center_depth(f_z)
        uncert = None
        if self.use_conf:
            uncert = self.bbox_3D_uncertainty(f_conf).clamp(min=0.01)

        p = pose_raw.reshape(n * C, _POSE_DIM[self.pose_type]).float()
        if self.pose_type == "6d":
            R = G.rotation_6d_to_matrix(p)
        elif self.pose_type == "quaternion":
            R = G.quaternion_to_matrix(G.normalize_quaternion(p))
        else:
            R = G.euler_angles_to_matrix(p, "XYZ")
        R = R.reshape(n, C, 3, 3)
        z = z.reshape(n, self.cluster_bins, C) if self.cluster_bins > 1 else z.reshape(n, C)
        return deltas.reshape(n, C, 2), z, dims.reshape(n, C, 3), R, uncert


def select_per_class(t: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """t[i, classes[i], ...] for t of shape (N, C, ...)."""
    idx = classes.long().reshape(classes.shape[0], *([1] * (t.ndim - 1)))
    idx = idx.expand(classes.shape[0], 1, *t.shape[2:])
    return torch.gather(t, 1, idx).squeeze(1)


def decode_cube(outputs, classes, src_boxes, Ks_scaled, fy_net, priors_dims,
                z_type: str = "direct", virtual_depth: bool = True,
                virtual_focal: float = 512.0, dims_priors_enabled: bool = True,
                dims_priors_func: str = "exp", allocentric: bool = True,
                priors_z_stats=None, priors_z_scales=None, cluster_bins: int = 1):
    """Decode raw cube-head outputs into camera-space cuboids
    (reference roi_heads.py:426-525), for a flat list of N padded boxes.

    Args:
      outputs: (deltas (N,C,2), z, dims (N,C,3), pose (N,C,3,3), uncert (N,C)).
      classes (N,) int; src_boxes (N, 4); Ks_scaled (N, 3, 3) network-res
      intrinsics; fy_net (N,); priors_dims (C, 2, 3).
    Returns dict with xy, z, dims, pose, pose_allo, uncert, center, corners,
      virtual_to_real, deltas, z_norm, dims_norm, bin_assign, z_mean, z_std.
    """
    deltas_all, z_all, dims_all, pose_all, uncert_all = outputs
    classes = classes.long()
    deltas = select_per_class(deltas_all, classes)
    dims_norm = select_per_class(dims_all, classes)
    pose = select_per_class(pose_all, classes)
    uncert = select_per_class(uncert_all, classes) if uncert_all is not None else None

    w = src_boxes[:, 2] - src_boxes[:, 0]
    h = src_boxes[:, 3] - src_boxes[:, 1]
    cx = src_boxes[:, 0] + 0.5 * w
    cy = src_boxes[:, 1] + 0.5 * h
    x = cx + w * deltas[:, 0]
    y = cy + h * deltas[:, 1]
    xy = torch.stack([x, y], dim=-1)

    assign = None
    if cluster_bins > 1:
        # depth bin by 2D scale proximity (roi_heads.py:432-442)
        scales = torch.sqrt(h ** 2 + w ** 2)
        pz = priors_z_scales[classes]                                  # (N, bins)
        assign = torch.argmin((pz - scales[:, None]).abs(), dim=1)
        z_sel = torch.gather(z_all, 2, classes[:, None, None].expand(-1, z_all.shape[1], 1))[..., 0]
        z_raw = torch.gather(z_sel, 1, assign[:, None])[:, 0]
    else:
        z_raw = select_per_class(z_all, classes)

    if dims_priors_enabled:
        prior = priors_dims[classes]
        p_mean, p_std = prior[:, 0], prior[:, 1]
        if dims_priors_func == "sigmoid":
            dims = G.scaled_sigmoid(dims_norm, (p_mean - 3 * p_std).clamp(min=0.0),
                                    p_mean + 3 * p_std)
        else:
            dims = torch.exp(dims_norm.clamp(max=5.0)) * p_mean
    else:
        dims = torch.exp(dims_norm.clamp(max=5.0))

    pose_allo = pose
    if allocentric:
        pose = G.R_from_allocentric(Ks_scaled, pose_allo, x, y)

    z_norm = z_raw
    z_mean = z_std = None
    if z_type == "sigmoid":
        z_norm = torch.sigmoid(z_raw)
        z = z_norm * 100.0
    elif z_type == "log":
        z = torch.exp(z_raw)
    elif z_type == "clusters":
        zm = priors_z_stats[classes]                                   # (N, bins, 2)
        z_mean = torch.gather(zm[..., 0], 1, assign[:, None])[:, 0]
        z_std = torch.gather(zm[..., 1], 1, assign[:, None])[:, 0]
        z = G.scaled_sigmoid(z_raw, (z_mean - 3 * z_std).clamp(min=0.0), z_mean + 3 * z_std)
    else:
        z = z_raw

    if virtual_depth:
        virtual_to_real = fy_net / virtual_focal
        z = z * virtual_to_real
    else:
        virtual_to_real = torch.ones_like(z)

    fx, fy = Ks_scaled[:, 0, 0], Ks_scaled[:, 1, 1]
    sx, sy = Ks_scaled[:, 0, 2], Ks_scaled[:, 1, 2]
    center = torch.stack([z * (x - sx) / fx, z * (y - sy) / fy, z], dim=-1)
    corners = G.cuboid_verts(torch.cat([center, dims], dim=-1), pose)
    return {
        "xy": xy, "z": z, "z_norm": z_norm, "dims": dims, "dims_norm": dims_norm,
        "pose": pose, "pose_allo": pose_allo, "uncert": uncert, "center": center,
        "corners": corners, "virtual_to_real": virtual_to_real, "deltas": deltas,
        "bin_assign": assign, "z_mean": z_mean, "z_std": z_std,
    }
