"""Cube R-CNN meta-architecture (port of `omni3d_tpu.models.rcnn3d`).

`CubeRCNN` holds every parameter under detectron2's key names (backbone,
proposal_generator.rpn_head, roi_heads.{box_head, box_predictor, cube_head,
priors_*}), so a state dict from `utils.checkpoint.state_dict_from_flax`
loads with strict=True, in inference and in training mode alike.
`inference` is the counterpart of the JAX package's `inference_impl`: the
same arguments, the same padded fixed-size outputs and keys. Both poolers go
through `ops.roi_align_cuda`. The training losses live in `engine.train`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..config.cfg import StaticCfg
from ..ops.roi_align_cuda import multilevel_roi_align
from . import anchors as anchor_lib
from .dla import DLA
from .extra_backbones import DenseNet121, MNASNet10, ShuffleNetV2
from .fpn import FPN
from .heads import (BoxHead, CubeHead, FastRCNNPredictor, decode_cube,
                    fast_rcnn_inference, scale_proposals)
from .layers import BatchNorm2d
from .resnet import ResNet
from .rpn import RPNHead, select_proposals

FEATURE_NAMES = ("p2", "p3", "p4", "p5", "p6")
FEATURE_STRIDES = (4, 8, 16, 32, 64)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_bottom_up(cfg, dtype=None) -> nn.Module:
    """The FPN's bottom-up network, keyed by the reference builder names
    (omni3d_tpu/models/rcnn3d.py:40-62; reference rcnn3d.py:259-272
    BACKBONE_REGISTRY); MODEL.DLA.TYPE and MODEL.RESNETS.DEPTH pick the
    variant. Its `out_channels` maps p2..p6 to their widths; `dtype` is the
    parameters' dtype."""
    name = cfg.MODEL.BACKBONE.NAME
    if name == "build_dla_from_vision_fpn_backbone":
        return DLA(cfg.MODEL.DLA.TYPE, dtype=dtype)
    if name == "build_resnet_from_vision_fpn_backbone":
        return ResNet(cfg.MODEL.RESNETS.DEPTH, dtype=dtype)
    if name == "build_densenet_fpn_backbone":
        return DenseNet121(dtype=dtype)
    if name == "build_mnasnet_fpn_backbone":
        return MNASNet10(dtype=dtype)
    if name == "build_shufflenet_fpn_backbone":
        return ShuffleNetV2(dtype=dtype)
    raise ValueError(f"Unknown backbone builder {name}")


class ROIHeads(nn.Module):
    """Box head, box predictor, cube head and the prior buffers
    (reference roi_heads.py:117-143)."""

    def __init__(self, cfg, in_channels: int, dtype=None):
        super().__init__()
        C = cfg.MODEL.ROI_HEADS.NUM_CLASSES
        bh, ch = cfg.MODEL.ROI_BOX_HEAD, cfg.MODEL.ROI_CUBE_HEAD
        box_in = in_channels * bh.POOLER_RESOLUTION ** 2
        self.box_head = BoxHead(box_in, bh.FC_DIM, bh.NUM_FC, dtype)
        self.box_predictor = FastRCNNPredictor(bh.FC_DIM if bh.NUM_FC else box_in, C, dtype)
        self.cube_head = CubeHead(
            in_channels * ch.POOLER_RESOLUTION ** 2, C, pose_type=ch.POSE_TYPE,
            cluster_bins=ch.CLUSTER_BINS, shared_fc=ch.SHARED_FC,
            use_conf=ch.USE_CONFIDENCE > 0, num_fc=ch.NUM_FC, fc_dim=ch.FC_DIM,
            dtype=dtype)
        bins = max(ch.CLUSTER_BINS, 1)
        self.register_buffer("priors_dims_per_cat", torch.ones(C, 2, 3))
        self.register_buffer("priors_z_scales", torch.ones(C, bins))
        self.register_buffer("priors_z_stats", torch.ones(C, bins, 2))


class CubeRCNN(nn.Module):
    """All Cube R-CNN parameters over any `build_bottom_up` backbone;
    `dtype` is the compute dtype, which the images are cast to at the entry.

    Inference (`train=False`): convolutions and linear layers hold their
    weights in `dtype`. Training (`train=True`): every parameter is float32
    (the master weights) and the layers cast them to `dtype` per call, as
    flax's `dtype=` with float32 `param_dtype` does. BN is `BatchNorm2d`
    with float32 affine and statistics in both: in eval mode it applies its
    running statistics; in train mode it uses and tracks batch statistics
    unless MODEL.USE_BN is False (then BN keeps its running statistics and
    only its affine trains, as the JAX package's `_EvalBN` parameters do).
    Priors are float32 buffers in both: they get no gradient and no weight
    decay.
    """

    def __init__(self, cfg, dtype=torch.float32, train: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        pdtype = torch.float32 if train else dtype
        bottom_up = build_bottom_up(cfg, pdtype)
        out_ch = cfg.MODEL.FPN.OUT_CHANNELS
        self.backbone = FPN(bottom_up, bottom_up.out_channels,
                            tuple(cfg.MODEL.FPN.IN_FEATURES), out_ch,
                            cfg.MODEL.FPN.FUSE_TYPE, dtype=pdtype)
        ag = cfg.MODEL.ANCHOR_GENERATOR
        num_anchors = len(ag.ASPECT_RATIOS[0]) * len(ag.SIZES[0])
        self.proposal_generator = nn.ModuleDict(
            {"rpn_head": RPNHead(num_anchors, out_ch, dtype=pdtype)})
        self.roi_heads = ROIHeads(cfg, out_ch, dtype=pdtype)
        self._anchors = {}

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and not self.cfg.MODEL.USE_BN:   # frozen BN statistics
            for m in self.modules():
                if isinstance(m, BatchNorm2d):
                    m.eval()
        return self

    def features(self, images):
        """(B, H, W, 3) normalized images -> the p2..p6 maps as channels-last
        NCHW tensors in the compute dtype, and their NHWC views."""
        feats = self.backbone(images.permute(0, 3, 1, 2).to(self.dtype))
        # NHWC views of the channels-last maps: the pooler reads them in place
        return feats, [feats[f].permute(0, 2, 3, 1).contiguous() for f in FEATURE_NAMES]

    def anchors(self, feat_shapes, device):
        """Anchors per level as tensors, cached per feature shapes and device."""
        key = (tuple(feat_shapes), str(device))
        if key not in self._anchors:
            ag = self.cfg.MODEL.ANCHOR_GENERATOR
            self._anchors[key] = [
                torch.from_numpy(a).to(device)
                for a in anchor_lib.pyramid_anchors(feat_shapes, FEATURE_STRIDES,
                                                    ag.SIZES, ag.ASPECT_RATIOS, ag.OFFSET)]
        return self._anchors[key]


def init_random_(model: CubeRCNN, generator: torch.Generator) -> CubeRCNN:
    """Seeded random weights in the JAX package's init scheme: normal
    weights with variance 1/fan_in, zero biases, identity BN, unit priors;
    the cube head's output layers at std 0.001 and the uncertainty bias at 5
    (omni3d_tpu/models/heads.py:174-191). Values are drawn in float32 on the
    CPU, so one seed gives the same weights at any dtype and on any device."""
    cube_out = ("bbox_3D_center_deltas", "bbox_3D_dims", "bbox_3D_pose",
                "bbox_3D_center_depth", "bbox_3D_uncertainty")
    sd = {}
    for name, t in model.state_dict().items():
        if name.endswith("weight") and t.ndim >= 2:
            fan_in = int(np.prod(t.shape[1:]))
            std = 0.001 if any(k in name for k in cube_out) else fan_in ** -0.5
            v = torch.randn(t.shape, generator=generator) * std
        elif name.endswith(("running_var", ".weight")) or name.startswith("roi_heads.priors"):
            v = torch.ones(t.shape)   # BN scale and variance, priors
        elif "bbox_3D_uncertainty" in name:
            v = torch.full(t.shape, 5.0)
        else:
            v = torch.zeros(t.shape)  # biases, BN shift and mean
        sd[name] = v
    model.load_state_dict(sd)
    return model


def build_model(cfg, device="cuda", dtype=None, seed: int | None = None,
                train: bool = False) -> CubeRCNN:
    """`CubeRCNN` on `device` (the CUDA card unless the caller asks for the
    CPU), computing in the config's TPU.COMPUTE_DTYPE unless `dtype` is
    given, with channels-last convolutions. `train=False` gives an
    eval-mode inference model, `train=True` a train-mode model with float32
    parameters (see `CubeRCNN`). `seed` fills it with `init_random_`
    weights; otherwise load a state dict. Raises if `device` is a CUDA
    device and none is present: there is no silent fallback to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model targets the CUDA card, and torch.cuda.is_available() "
                           "is false; pass device='cpu' to build on the CPU")
    scfg = StaticCfg(cfg.clone()) if hasattr(cfg, "clone") else cfg
    dtype = dtype or _DTYPES[scfg.TPU.COMPUTE_DTYPE]
    model = CubeRCNN(scfg, dtype=dtype, train=train)
    if seed is not None:
        init_random_(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.train() if train else model.eval()


def preprocess(images_bgr: torch.Tensor, pixel_mean, pixel_std) -> torch.Tensor:
    """(B, H, W, 3) BGR uint8/float -> normalized float32 (B, H, W, 3)."""
    mean = torch.as_tensor(pixel_mean, dtype=torch.float32, device=images_bgr.device)
    std = torch.as_tensor(pixel_std, dtype=torch.float32, device=images_bgr.device)
    return (images_bgr.float() - mean) / std


def inference_kwargs(cfg) -> dict:
    """Inference settings from the config (same keys as the JAX package's
    `inference_kwargs`); pass as **inference_kwargs(cfg) to `inference`."""
    return dict(
        score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
        nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
        topk=cfg.TEST.DETECTIONS_PER_IMAGE,
        nms_candidates=cfg.TPU.NMS_CANDIDATES,
        pre_nms_topk=cfg.MODEL.RPN.PRE_NMS_TOPK_TEST,
        post_nms_topk=cfg.MODEL.RPN.POST_NMS_TOPK_TEST,
        rpn_nms_thresh=cfg.MODEL.RPN.NMS_THRESH,
        sampling_ratio=cfg.TPU.ROI_SAMPLING_RATIO,
    )


@torch.no_grad()
def inference(model: CubeRCNN, images, Ks, im_scales_ratio, hw=None, oracle=None,
              score_thresh=0.01, nms_thresh=0.5, topk=100, nms_candidates=1024,
              pre_nms_topk=1000, post_nms_topk=1000, rpn_nms_thresh=0.7,
              sampling_ratio=2):
    """End-to-end Cube R-CNN inference on a padded batch.

    The defaults are those of the JAX package's `inference_impl`; the
    config's values come from **inference_kwargs(cfg).

    Args:
      images: (B, H, W, 3) normalized BGR at network resolution, on the
        model's device.
      Ks: (B, 3, 3) ORIGINAL-resolution intrinsics.
      im_scales_ratio: (B,) original_height / network_height.
      hw: optional (B, 2) per-image network (height, width) before padding;
        proposals and detections clip to it.
      oracle: optional (boxes (B, K, 4), classes (B, K), valid (B, K)):
        skips the RPN and the 2D box branch and runs the cube branch on the
        given boxes with score 1.

    Returns a dict of per-image padded detections: boxes, boxes_orig,
      scores_2d, scores, classes, valid, scores_full, center_cam, dims,
      pose, corners, center_2D, proposal_boxes, proposal_valid.
    """
    cfg = model.cfg
    B, H, W, _ = images.shape
    C = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    feats, flist = model.features(images)

    if oracle is not None:
        o_boxes, o_classes, o_valid = oracle
        k = o_boxes.shape[1]
        dets = {
            "boxes": o_boxes,
            "scores": o_valid.float(),
            "classes": o_classes.to(torch.int32),
            "valid": o_valid,
            "scores_full": torch.zeros((B, k, C), device=images.device),
        }
        return _cube_branch_outputs(model, flist, dets, Ks, im_scales_ratio,
                                    sampling_ratio, o_boxes, o_valid)

    logits, deltas = model.proposal_generator["rpn_head"]([feats[f] for f in FEATURE_NAMES])
    anchors = model.anchors([(f.shape[1], f.shape[2]) for f in flist], images.device)
    image_hw = (torch.tensor([H, W], dtype=torch.float32, device=images.device).expand(B, 2)
                if hw is None else torch.as_tensor(hw, dtype=torch.float32, device=images.device))
    prop_boxes, _, prop_valid = select_proposals(
        anchors, [l.float() for l in logits], [d.float() for d in deltas], image_hw,
        pre_nms_topk, post_nms_topk, rpn_nms_thresh)

    heads = model.roi_heads
    P = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
    pooled = multilevel_roi_align(flist, prop_boxes, FEATURE_STRIDES, P, sampling_ratio)
    scores2d, deltas2d = heads.box_predictor(heads.box_head(pooled.reshape(B * post_nms_topk, *pooled.shape[2:])))
    dets = fast_rcnn_inference(
        scores2d.reshape(B, post_nms_topk, C + 1).float(),
        deltas2d.reshape(B, post_nms_topk, C * 4).float(),
        prop_boxes, prop_valid, image_hw, C, score_thresh, nms_thresh, topk,
        nms_candidates, tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS))
    return _cube_branch_outputs(model, flist, dets, Ks, im_scales_ratio,
                                sampling_ratio, prop_boxes, prop_valid)


def _cube_branch_outputs(model, flist, dets, Ks, im_scales_ratio, sampling_ratio,
                         prop_boxes, prop_valid):
    """Cube branch + output packing shared by normal and oracle inference."""
    cfg = model.cfg
    ch_cfg = cfg.MODEL.ROI_CUBE_HEAD
    heads = model.roi_heads
    det_boxes = dets["boxes"]
    B, topk = det_boxes.shape[:2]
    cube_boxes = scale_proposals(det_boxes, ch_cfg.SCALE_ROI_BOXES)
    pooled = multilevel_roi_align(flist, cube_boxes, FEATURE_STRIDES,
                                  ch_cfg.POOLER_RESOLUTION, sampling_ratio)
    cube_out = heads.cube_head(pooled.reshape(B * topk, *pooled.shape[2:]))
    cube_out = tuple(t.float() if t is not None else None for t in cube_out)

    # per-box network-res intrinsics (reference roi_heads.py:374-396); the
    # division makes a new tensor, so setting [2, 2] leaves the caller's Ks
    Ks_scaled = Ks / im_scales_ratio[:, None, None]
    Ks_scaled[:, 2, 2] = 1.0
    Ks_per_box = Ks_scaled[:, None].expand(B, topk, 3, 3).reshape(-1, 3, 3)

    cube = decode_cube(
        cube_out, dets["classes"].reshape(-1), det_boxes.reshape(-1, 4),
        Ks_per_box, Ks_per_box[:, 1, 1], heads.priors_dims_per_cat,
        z_type=ch_cfg.Z_TYPE, virtual_depth=ch_cfg.VIRTUAL_DEPTH,
        virtual_focal=ch_cfg.VIRTUAL_FOCAL,
        dims_priors_enabled=ch_cfg.DIMS_PRIORS_ENABLED,
        dims_priors_func=ch_cfg.DIMS_PRIORS_FUNC,
        allocentric=ch_cfg.ALLOCENTRIC_POSE,
        priors_z_stats=heads.priors_z_stats, priors_z_scales=heads.priors_z_scales,
        cluster_bins=ch_cfg.CLUSTER_BINS)

    def r(t, shape):
        return t.reshape((B, topk) + shape)

    conf = (torch.exp(-cube["uncert"]) if cube["uncert"] is not None
            else torch.ones(B * topk, device=det_boxes.device))
    fused = torch.sqrt((dets["scores"] * r(conf, ())).clamp(min=0.0))
    ratio = im_scales_ratio[:, None, None]
    return {
        "boxes": det_boxes,
        "boxes_orig": det_boxes * ratio,
        "scores_2d": dets["scores"],
        "scores": torch.where(dets["valid"], fused, torch.zeros_like(fused)),
        "classes": dets["classes"],
        "valid": dets["valid"],
        "scores_full": dets["scores_full"],
        "center_cam": r(cube["center"], (3,)),
        "dims": r(cube["dims"], (3,)),
        "pose": r(cube["pose"], (3, 3)),
        "corners": r(cube["corners"], (8, 3)),
        "center_2D": r(cube["xy"], (2,)) * ratio,
        "proposal_boxes": prop_boxes,
        "proposal_valid": prop_valid,
    }
