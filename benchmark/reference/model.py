"""The benchmark's plain Cube R-CNN: the model, inference and the training
step in plain PyTorch, with no kernel, graph or cache of the program.

Frozen from omni3d_tpu_torch/models/rcnn3d.py and engine/train.py (commit
5a24e3a): the same parameter names, so one state dict loads into both;
each trunk family is a file of its own, `trunks/<MODEL.BACKBONE.NAME>.py`,
found by the builder's name; the pooler is the plain ROIAlign and NMS the
plain fixpoint. Beside `inference` it has the two stages that judge the
program's outputs from the program's own choices (`box_stage`,
`cube_stage`), and `train_step`, the single-device step of
`make_train_step` (SGD, the stabilizer, the sampling noise of
`sampling_noise`).

Precision is the model's `dtype` (float32 for the reference); `set_fp8`
rounds every convolution's and linear layer's inputs and weights to
float8_e4m3fn, the lower-precision control.
"""
from __future__ import annotations

import importlib
import os

import torch
import torch.nn as nn
import torch.utils.checkpoint

from . import anchors as anchor_lib
from .fpn import FPN
from .heads import (BoxHead, CubeHead, FastRCNNPredictor, decode_cube,
                    fast_rcnn_inference, scale_proposals)
from .layers import BatchNorm2d, Conv2d, Linear
from .roi_align import multilevel_roi_align
from .roi_training import cube_losses, fast_rcnn_losses, label_and_sample_proposals
from .rpn import RPNHead, label_and_sample_anchors, rpn_losses, select_proposals
from .solver import build_optimizer, clip_gradients, lr_factor

FEATURE_NAMES = ("p2", "p3", "p4", "p5", "p6")
FEATURE_STRIDES = (4, 8, 16, 32, 64)
TOLERANCE = 4.0  # the stabilizer's loss-spike threshold
GAMMA = 0.02     # its rolling-mean gain
NOISE_KEYS = ("anchor_pos", "anchor_neg", "prop_pos", "prop_neg")


class Cfg(dict):
    """A nested plain dict (a configuration file's `cfg`) read by attribute."""

    def __getattr__(self, name):
        try:
            v = self[name]
        except KeyError:
            raise AttributeError(name) from None
        return Cfg(v) if isinstance(v, dict) else v


def build_bottom_up(cfg, dtype):
    """The FPN's bottom-up network: `build(cfg, dtype)` of
    `trunks/<MODEL.BACKBONE.NAME>.py`, an nn.Module whose `out_channels`
    maps p2..p6 to their widths. A new trunk family is one new file."""
    name = cfg.MODEL.BACKBONE.NAME
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "trunks", f"{name}.py")
    if not (name.isidentifier() and os.path.isfile(path)):
        raise ValueError(f"the reference has no backbone {name!r}: no file {path}")
    return importlib.import_module(f".trunks.{name}", __package__).build(cfg, dtype)


class ROIHeads(nn.Module):
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
    """Every parameter under the program's names; float32 parameters,
    computing in `dtype`."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        bottom_up = build_bottom_up(cfg, torch.float32)
        out_ch = cfg.MODEL.FPN.OUT_CHANNELS
        self.backbone = FPN(bottom_up, bottom_up.out_channels,
                            tuple(cfg.MODEL.FPN.IN_FEATURES), out_ch,
                            cfg.MODEL.FPN.FUSE_TYPE, dtype=torch.float32)
        ag = cfg.MODEL.ANCHOR_GENERATOR
        num_anchors = len(ag.ASPECT_RATIOS[0]) * len(ag.SIZES[0])
        self.proposal_generator = nn.ModuleDict(
            {"rpn_head": RPNHead(num_anchors, out_ch, dtype=torch.float32)})
        self.roi_heads = ROIHeads(cfg, out_ch, dtype=torch.float32)
        self.checkpoint_trunk = False

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and not self.cfg.MODEL.USE_BN:
            for m in self.modules():
                if isinstance(m, BatchNorm2d):
                    m.eval()
        return self

    def _features(self, images):
        feats = self.backbone(images.permute(0, 3, 1, 2).to(self.dtype))
        return feats, [feats[f].permute(0, 2, 3, 1).contiguous() for f in FEATURE_NAMES]

    def features(self, images):
        """The p2..p6 maps (NCHW) and their NHWC copies. With
        `checkpoint_trunk` the trunk's activations are recomputed in the
        backward (the same values; only the memory differs)."""
        if self.checkpoint_trunk and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(self._features, images,
                                                     use_reentrant=False)
        return self._features(images)

    def anchors(self, feat_shapes, device):
        ag = self.cfg.MODEL.ANCHOR_GENERATOR
        return [torch.from_numpy(a).to(device) for a in anchor_lib.pyramid_anchors(
            feat_shapes, FEATURE_STRIDES, ag.SIZES, ag.ASPECT_RATIOS, ag.OFFSET)]


def build(cfg: dict, device, dtype=torch.float32, train: bool = False) -> CubeRCNN:
    """The reference model of a configuration file's `cfg` dict, channels
    last, in eval or train mode."""
    with torch.device(device):   # made where it runs: no host-side init
        model = CubeRCNN(Cfg(cfg), dtype)
    model = model.to(memory_format=torch.channels_last)
    return model.train() if train else model.eval()


def set_fp8(model: nn.Module, on: bool = True) -> nn.Module:
    """Round every convolution's and linear layer's inputs and weights to
    float8_e4m3fn (the control)."""
    for m in model.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.fp8 = on
    return model


def inference_kwargs(cfg) -> dict:
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


def preprocess(images_bgr, pixel_mean, pixel_std):
    mean = torch.as_tensor(pixel_mean, dtype=torch.float32, device=images_bgr.device)
    std = torch.as_tensor(pixel_std, dtype=torch.float32, device=images_bgr.device)
    return (images_bgr.float() - mean) / std


@torch.no_grad()
def rpn_stage(model, images) -> dict:
    """Features and the RPN head's outputs: flist (the NHWC maps), logits
    and deltas per level (float32) and the anchors per level."""
    feats, flist = model.features(images)
    logits, deltas = model.proposal_generator["rpn_head"]([feats[f] for f in FEATURE_NAMES])
    return {"flist": flist, "logits": [l.float() for l in logits],
            "deltas": [d.float() for d in deltas],
            "anchors": model.anchors([(f.shape[1], f.shape[2]) for f in flist], images.device)}


@torch.no_grad()
def proposal_stage(model, images, hw, rpn: dict | None = None):
    """features and the RPN's proposals: (flist, boxes (B, P, 4), valid)."""
    kw = inference_kwargs(model.cfg)
    rpn = rpn_stage(model, images) if rpn is None else rpn
    boxes, _, valid = select_proposals(rpn["anchors"], rpn["logits"], rpn["deltas"], hw.float(),
                                       kw["pre_nms_topk"], kw["post_nms_topk"],
                                       kw["rpn_nms_thresh"])
    return rpn["flist"], boxes, valid


@torch.no_grad()
def box_stage(model, flist, prop_boxes):
    """The box head on given proposals: class probabilities (B, P, C) and
    the per-class decoded boxes (B, P, C, 4), before clipping."""
    from . import boxes as box_ops
    cfg = model.cfg
    B, P = prop_boxes.shape[:2]
    C = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    heads = model.roi_heads
    pooled = multilevel_roi_align(flist, prop_boxes, FEATURE_STRIDES,
                                  cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
                                  cfg.TPU.ROI_SAMPLING_RATIO)
    scores, deltas = heads.box_predictor(heads.box_head(pooled.reshape(B * P, *pooled.shape[2:])))
    probs = torch.softmax(scores.float().reshape(B, P, C + 1), -1)[..., :C]
    boxes = box_ops.decode_deltas(deltas.float().reshape(B, P, C, 4), prop_boxes[:, :, None, :],
                                  tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS))
    return probs, boxes


@torch.no_grad()
def cube_stage(model, flist, det_boxes, classes, Ks, im_scales_ratio):
    """The cube head and `decode_cube` on given detections: center_cam,
    the projected center xy (network resolution), dims, pose (rotation),
    corners and the confidence exp(-uncertainty)."""
    cfg = model.cfg
    ch_cfg = cfg.MODEL.ROI_CUBE_HEAD
    heads = model.roi_heads
    B, K = det_boxes.shape[:2]
    cube_boxes = scale_proposals(det_boxes, ch_cfg.SCALE_ROI_BOXES)
    pooled = multilevel_roi_align(flist, cube_boxes, FEATURE_STRIDES,
                                  ch_cfg.POOLER_RESOLUTION, cfg.TPU.ROI_SAMPLING_RATIO)
    out = heads.cube_head(pooled.reshape(B * K, *pooled.shape[2:]))
    out = tuple(t.float() if t is not None else None for t in out)
    Ks_scaled = Ks / im_scales_ratio[:, None, None]
    Ks_scaled[:, 2, 2] = 1.0
    Ks_per_box = Ks_scaled[:, None].expand(B, K, 3, 3).reshape(-1, 3, 3)
    cube = decode_cube(
        out, classes.reshape(-1), det_boxes.reshape(-1, 4), Ks_per_box, Ks_per_box[:, 1, 1],
        heads.priors_dims_per_cat, z_type=ch_cfg.Z_TYPE, virtual_depth=ch_cfg.VIRTUAL_DEPTH,
        virtual_focal=ch_cfg.VIRTUAL_FOCAL, dims_priors_enabled=ch_cfg.DIMS_PRIORS_ENABLED,
        dims_priors_func=ch_cfg.DIMS_PRIORS_FUNC, allocentric=ch_cfg.ALLOCENTRIC_POSE,
        priors_z_stats=heads.priors_z_stats, priors_z_scales=heads.priors_z_scales,
        cluster_bins=ch_cfg.CLUSTER_BINS)
    conf = (torch.exp(-cube["uncert"]) if cube["uncert"] is not None
            else torch.ones(B * K, device=det_boxes.device))
    return {"center_cam": cube["center"].reshape(B, K, 3), "xy": cube["xy"].reshape(B, K, 2),
            "dims": cube["dims"].reshape(B, K, 3),
            "pose": cube["pose"].reshape(B, K, 3, 3), "corners": cube["corners"].reshape(B, K, 8, 3),
            "conf": conf.reshape(B, K)}


@torch.no_grad()
def detect(model, flist, prop_boxes, prop_valid, hw):
    """fast_rcnn_inference on given proposals (the reference's own
    detections, for the pooler's work count)."""
    cfg = model.cfg
    kw = inference_kwargs(cfg)
    B, P = prop_boxes.shape[:2]
    C = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    heads = model.roi_heads
    pooled = multilevel_roi_align(flist, prop_boxes, FEATURE_STRIDES,
                                  cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION, kw["sampling_ratio"])
    scores, deltas = heads.box_predictor(heads.box_head(pooled.reshape(B * P, *pooled.shape[2:])))
    return fast_rcnn_inference(
        scores.reshape(B, P, C + 1).float(), deltas.reshape(B, P, C * 4).float(),
        prop_boxes, prop_valid, hw.float(), C, kw["score_thresh"], kw["nms_thresh"],
        kw["topk"], kw["nms_candidates"], tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS))


# ------------------------------- training -------------------------------

def sampling_noise(generator, B: int, num_anchors: int, num_candidates: int, device,
                   img_offset: int = 0) -> dict:
    """The four samplers' uniforms of a step, drawn as
    engine.train.sampling_noise draws them: a base seed from the CPU
    `generator`, then one device generator per image seeded by the base and
    the image's global index."""
    base = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))
    draws = {k: [] for k in NOISE_KEYS}
    sizes = (num_anchors, num_anchors, num_candidates, num_candidates)
    for i in range(B):
        g = torch.Generator(device=device).manual_seed(base * 1_000_003 + img_offset + i)
        for k, n in zip(NOISE_KEYS, sizes):
            draws[k].append(torch.rand(n, generator=g, device=device))
    return {k: torch.stack(v) for k, v in draws.items()}


def compute_losses(model: CubeRCNN, batch: dict, generator=None):
    """Every loss of one batch: (total, losses)."""
    cfg = model.cfg
    rpn_cfg, rh = cfg.MODEL.RPN, cfg.MODEL.ROI_HEADS
    ch = cfg.MODEL.ROI_CUBE_HEAD
    images = batch["images"]
    B = images.shape[0]
    C = rh.NUM_CLASSES
    gt_boxes, gt_classes, gt_valid = batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"]

    feats, flist = model.features(images)
    logits, deltas = model.proposal_generator["rpn_head"]([feats[f] for f in FEATURE_NAMES])
    logits = [l.float() for l in logits]
    deltas = [d.float() for d in deltas]
    anchors = model.anchors([(f.shape[1], f.shape[2]) for f in flist], images.device)
    anchors_cat = torch.cat(anchors, 0)

    S = rh.BATCH_SIZE_PER_IMAGE
    F = int(S * rh.POSITIVE_FRACTION)
    num_cand = rpn_cfg.POST_NMS_TOPK_TRAIN + (gt_boxes.shape[1] if rh.PROPOSAL_APPEND_GT else 0)
    noise = sampling_noise(generator, B, anchors_cat.shape[0], num_cand, images.device)

    lab = label_and_sample_anchors(
        anchors_cat, gt_boxes, gt_classes, gt_valid, noise["anchor_pos"], noise["anchor_neg"],
        batch_size=rpn_cfg.BATCH_SIZE_PER_IMAGE, positive_fraction=rpn_cfg.POSITIVE_FRACTION,
        fg_thresh=rpn_cfg.IOU_THRESHOLDS[0], ignore_thresh=rpn_cfg.IGNORE_THRESHOLD)
    losses = rpn_losses(anchors_cat, lab["labels"], lab["matched_gt"], torch.cat(logits, 1),
                        torch.cat(deltas, 1), batch_size=rpn_cfg.BATCH_SIZE_PER_IMAGE,
                        objectness=rpn_cfg.OBJECTNESS_UNCERTAINTY)
    if rpn_cfg.LOSS_WEIGHT != 1.0:
        losses = {k: v * rpn_cfg.LOSS_WEIGHT for k, v in losses.items()}

    with torch.no_grad():
        prop_boxes, _, prop_valid = select_proposals(
            anchors, [l.detach() for l in logits], [d.detach() for d in deltas],
            batch["hw"].float(), rpn_cfg.PRE_NMS_TOPK_TRAIN, rpn_cfg.POST_NMS_TOPK_TRAIN,
            rpn_cfg.NMS_THRESH)

    sampled = label_and_sample_proposals(
        prop_boxes, prop_valid, gt_boxes, gt_classes, gt_valid, C,
        noise["prop_pos"], noise["prop_neg"], batch_size=S,
        positive_fraction=rh.POSITIVE_FRACTION, iou_thresh=rh.IOU_THRESHOLDS[0],
        ignore_thresh=rpn_cfg.IGNORE_THRESHOLD, append_gt=rh.PROPOSAL_APPEND_GT)

    P = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
    with_cube = ch.LOSS_W_3D > 0
    fg_boxes = sampled["boxes"][:, :F]
    rois = sampled["boxes"]
    if with_cube:
        rois = torch.cat([rois, scale_proposals(fg_boxes, ch.SCALE_ROI_BOXES)], 1)
    pooled_all = multilevel_roi_align(flist, rois, FEATURE_STRIDES, P, cfg.TPU.ROI_SAMPLING_RATIO)
    pooled = pooled_all[:, :S]

    heads = model.roi_heads
    scores2d, deltas2d = heads.box_predictor(heads.box_head(pooled.reshape(B * S, *pooled.shape[2:])))
    gt_matched = torch.gather(gt_boxes, 1, sampled["gt_idx"][..., None].expand(-1, -1, 4))
    losses.update(fast_rcnn_losses(
        scores2d.float(), deltas2d.float(), sampled["boxes"].reshape(B * S, 4),
        sampled["classes"].reshape(B * S), sampled["valid"].reshape(B * S),
        gt_matched.reshape(B * S, 4), C, tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS)))

    if with_cube:
        pooled_cube = pooled_all[:, S:]
        fg_classes = sampled["classes"][:, :F].clamp(0, C - 1)
        cube_out = heads.cube_head(pooled_cube.reshape(B * F, *pooled_cube.shape[2:]))
        cube_out = tuple(t.float() if t is not None else None for t in cube_out)
        Ks_scaled = batch["Ks"] / batch["ratios"][:, None, None]
        Ks_scaled[:, 2, 2] = 1.0
        Ks_per_box = Ks_scaled[:, None].expand(B, F, 3, 3).reshape(-1, 3, 3)
        cube = decode_cube(
            cube_out, fg_classes.reshape(-1), fg_boxes.reshape(-1, 4), Ks_per_box,
            Ks_per_box[:, 1, 1], heads.priors_dims_per_cat, z_type=ch.Z_TYPE,
            virtual_depth=ch.VIRTUAL_DEPTH, virtual_focal=ch.VIRTUAL_FOCAL,
            dims_priors_enabled=ch.DIMS_PRIORS_ENABLED, dims_priors_func=ch.DIMS_PRIORS_FUNC,
            allocentric=ch.ALLOCENTRIC_POSE, priors_z_stats=heads.priors_z_stats,
            priors_z_scales=heads.priors_z_scales, cluster_bins=ch.CLUSTER_BINS)
        gt_idx = sampled["gt_idx"][:, :F]
        gt_b3d = torch.gather(batch["gt_boxes3D"], 1, gt_idx[..., None].expand(-1, -1, 6))
        gt_pose = torch.gather(batch["gt_poses"], 1, gt_idx[..., None, None].expand(-1, -1, 3, 3))
        closs, _ = cube_losses(cube, sampled["fg"][:, :F].reshape(-1), gt_b3d.reshape(-1, 6),
                               gt_pose.reshape(-1, 3, 3), Ks_per_box, ch, fg_boxes.reshape(-1, 4))
        losses.update(closs)
    return sum(losses.values()), losses


class Trainer:
    """The single-device training step of engine.train.make_train_step:
    zero the gradients, the losses, the backward, zero gradients for
    parameters the forward never reached, the stabilizer's skip decision,
    gradient clipping and SGD with the warm-up schedule."""

    def __init__(self, model: CubeRCNN):
        cfg = model.cfg
        self.model = model
        self.optimizer = build_optimizer(cfg, model)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda step: lr_factor(cfg, step))
        self.params = [p for g in self.optimizer.param_groups for p in g["params"]]
        self.stabilize = cfg.MODEL.STABILIZE > 0
        self.bn_stats = [b for m in model.modules() if isinstance(m, BatchNorm2d) and m.training
                         for b in (m.running_mean, m.running_var)]
        self.recent = torch.full((), -1.0, device=self.params[0].device)
        self.skipped = 0

    def step(self, batch, generator) -> float:
        """One step; returns its total loss."""
        saved = [b.clone() for b in self.bn_stats]
        self.optimizer.zero_grad(set_to_none=False)
        total, _ = compute_losses(self.model, batch, generator)
        total.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        ok = True
        if self.stabilize:
            grad_finite = torch.isfinite(torch.stack(
                torch._foreach_norm([p.grad for p in self.params], float("inf")))).all()
            t = total.detach()
            finite = torch.isfinite(t)
            has = self.recent >= 0
            diverging = (has & (t > TOLERANCE * self.recent)) | ~finite
            self.recent = torch.where(diverging, self.recent,
                                      torch.where(has, (1 - GAMMA) * self.recent + GAMMA * t,
                                                  2.0 * t))
            ok = not bool(diverging | ~grad_finite)
        if ok:
            clip_gradients(self.model.cfg, self.params)
            self.optimizer.step()
            self.scheduler.step()
        else:
            for b, s in zip(self.bn_stats, saved):
                b.copy_(s)
            self.skipped += 1
        return float(total.detach())
