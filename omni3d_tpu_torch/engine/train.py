"""The Cube R-CNN training step (port of `omni3d_tpu.engine.train`:
`compute_losses` and `make_train_step`, on one device or data-parallel
across the processes of a process group).

`compute_losses` runs the whole training forward: features, the RPN head,
anchor labelling and the RPN losses, detached proposal selection, proposal
sampling, ONE pooler call over the concatenated box and cube RoIs (so one
forward and one backward kernel launch per step), the box branch with the
FastRCNN losses, and the cube branch with `decode_cube` and the cube losses.
`make_train_step` adds the backward, the stabilizer and the optimizer;
under a process group it follows the JAX step's shard_map (train.py:284-398)
through `DistributedDataParallel`.

Stages (`utils.trace.stage`, marked on the device while a profiler records):
the step's step.forward, step.backward and step.optimizer, and inside the
forward step.trunk, step.rpn_head, step.anchor_labelling, step.proposals,
step.roi_sampling, step.pooler, step.box and step.cube; the host span
step.skip_decision holds the step's one synchronise; under a process
group step.rank_means holds the step's own two all-reduces (the logs' mean
and the BN running statistics' mean).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch.nn.parallel import DistributedDataParallel

from ..models.heads import decode_cube, scale_proposals
from ..models.layers import BatchNorm2d, running_stats_frozen
from ..models.rcnn3d import FEATURE_NAMES, FEATURE_STRIDES, CubeRCNN
from ..models.roi_training import cube_losses, fast_rcnn_losses, label_and_sample_proposals
from ..models.rpn import label_and_sample_anchors, rpn_losses, select_proposals
from ..ops.roi_align_cuda import multilevel_roi_align
from ..parallel import dist as dist_lib
from ..solver.build import clip_gradients, lr_factor
from ..utils import trace

TOLERANCE = 4.0  # loss-spike skip threshold (reference train_net.py:164)
GAMMA = 0.02     # rolling-mean gain (train_net.py:166)
NOISE_KEYS = ("anchor_pos", "anchor_neg", "prop_pos", "prop_neg")


def sampling_noise(generator: torch.Generator | None, B: int, num_anchors: int,
                   num_candidates: int, device, img_offset: int = 0) -> dict:
    """The uniforms of the four Gumbel-top-k samplers of a step: anchor
    positives and negatives (B, num_anchors), proposal positives and
    negatives (B, num_candidates).

    Image i draws from its own generator on `device`, seeded by a base seed
    taken from `generator` (a CPU generator; the default one when None) and
    its GLOBAL index img_offset + i, as the JAX package folds the global
    index into the step key (train.py:127-129): an image draws the same
    numbers under any split of the batch across devices.
    """
    base = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))
    draws = {k: [] for k in NOISE_KEYS}
    sizes = (num_anchors, num_anchors, num_candidates, num_candidates)
    for i in range(B):
        g = torch.Generator(device=device).manual_seed(base * 1_000_003 + img_offset + i)
        for k, n in zip(NOISE_KEYS, sizes):
            draws[k].append(torch.rand(n, generator=g, device=device))
    return {k: torch.stack(v) for k, v in draws.items()}


def _remat_features(model: CubeRCNN, images):
    """`model.features` under `torch.utils.checkpoint` (TPU.REMAT_BACKBONE,
    the JAX package's jax.checkpoint of the features, train.py:101-104):
    the backbone's activations are recomputed in the backward instead of
    kept. The recomputing forward leaves the BN running statistics where
    the first one put them, so they move once per step, as under
    jax.checkpoint."""
    ran = []

    def features(im):
        if ran:
            with running_stats_frozen(model):
                return model.features(im)
        ran.append(True)
        return model.features(im)
    return torch.utils.checkpoint.checkpoint(features, images, use_reentrant=False)


def compute_losses(model: CubeRCNN, batch: dict, generator: torch.Generator | None = None,
                   noise: dict | None = None, img_offset: int = 0):
    """All Cube R-CNN losses of one batch.

    batch: images (B, H, W, 3) normalized, hw (B, 2), Ks (B, 3, 3), ratios
      (B,), gt_boxes (B, G, 4) network-res XYXY, gt_classes (B, G) (-1 rows
      = ignore regions), gt_valid (B, G) bool, gt_boxes3D (B, G, 6),
      gt_poses (B, G, 3, 3); all on the model's device.
    noise: the sampling uniforms (`sampling_noise`'s keys); drawn from
      `generator` when None. Tests inject the JAX package's draws here.
    img_offset: global index of batch image 0 (see `sampling_noise`).

    In train mode the BN layers update their running statistics, once also
    under TPU.REMAT_BACKBONE. Returns
    (total, losses, metrics) with the JAX package's key names.
    """
    cfg = model.cfg
    rpn_cfg, rh = cfg.MODEL.RPN, cfg.MODEL.ROI_HEADS
    ch = cfg.MODEL.ROI_CUBE_HEAD
    images = batch["images"]
    B = images.shape[0]
    C = rh.NUM_CLASSES
    gt_boxes, gt_classes, gt_valid = batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"]

    device = images.device
    with trace.stage("step.trunk", device):
        feats, flist = (_remat_features(model, images) if cfg.TPU.REMAT_BACKBONE
                        else model.features(images))
    with trace.stage("step.rpn_head", device):
        logits, deltas = model.proposal_generator["rpn_head"]([feats[f] for f in FEATURE_NAMES])
        logits = [l.float() for l in logits]
        deltas = [d.float() for d in deltas]
        anchors = model.anchors([(f.shape[1], f.shape[2]) for f in flist], device)
        anchors_cat = torch.cat(anchors, 0)

    S = rh.BATCH_SIZE_PER_IMAGE
    F = int(S * rh.POSITIVE_FRACTION)
    # ---- the sampling noise, RPN labels + losses ----
    with trace.stage("step.anchor_labelling", device):
        if noise is None:
            num_cand = rpn_cfg.POST_NMS_TOPK_TRAIN + (gt_boxes.shape[1] if rh.PROPOSAL_APPEND_GT
                                                      else 0)
            noise = sampling_noise(generator, B, anchors_cat.shape[0], num_cand, device,
                                   img_offset)
        lab = label_and_sample_anchors(
            anchors_cat, gt_boxes, gt_classes, gt_valid, noise["anchor_pos"],
            noise["anchor_neg"], batch_size=rpn_cfg.BATCH_SIZE_PER_IMAGE,
            positive_fraction=rpn_cfg.POSITIVE_FRACTION, fg_thresh=rpn_cfg.IOU_THRESHOLDS[0],
            ignore_thresh=rpn_cfg.IGNORE_THRESHOLD)
        losses = rpn_losses(anchors_cat, lab["labels"], lab["matched_gt"], torch.cat(logits, 1),
                            torch.cat(deltas, 1), batch_size=rpn_cfg.BATCH_SIZE_PER_IMAGE,
                            objectness=rpn_cfg.OBJECTNESS_UNCERTAINTY)
        if rpn_cfg.LOSS_WEIGHT != 1.0:
            losses = {k: v * rpn_cfg.LOSS_WEIGHT for k, v in losses.items()}

    # ---- proposals (detached, reference RPN.predict_proposals no_grad) ----
    with torch.no_grad(), trace.stage("step.proposals", device):
        prop_boxes, _, prop_valid = select_proposals(
            anchors, [l.detach() for l in logits], [d.detach() for d in deltas],
            batch["hw"].float(), rpn_cfg.PRE_NMS_TOPK_TRAIN, rpn_cfg.POST_NMS_TOPK_TRAIN,
            rpn_cfg.NMS_THRESH)

    # ---- sample proposals for the ROI heads ----
    with trace.stage("step.roi_sampling", device):
        sampled = label_and_sample_proposals(
            prop_boxes, prop_valid, gt_boxes, gt_classes, gt_valid, C,
            noise["prop_pos"], noise["prop_neg"], batch_size=S,
            positive_fraction=rh.POSITIVE_FRACTION, iou_thresh=rh.IOU_THRESHOLDS[0],
            ignore_thresh=rpn_cfg.IGNORE_THRESHOLD, append_gt=rh.PROPOSAL_APPEND_GT)

    # ---- one pooler call over the box RoIs and (when on) the cube RoIs:
    # one forward and one backward kernel launch per step ----
    P = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
    with_cube = ch.LOSS_W_3D > 0
    fg_boxes = sampled["boxes"][:, :F]
    with trace.stage("step.pooler", device):
        rois = sampled["boxes"]
        if with_cube:
            rois = torch.cat([rois, scale_proposals(fg_boxes, ch.SCALE_ROI_BOXES)], 1)
        pooled_all = multilevel_roi_align(flist, rois, FEATURE_STRIDES, P,
                                          cfg.TPU.ROI_SAMPLING_RATIO)
    pooled = pooled_all[:, :S]

    # ---- box branch ----
    heads = model.roi_heads
    with trace.stage("step.box", device):
        scores2d, deltas2d = heads.box_predictor(heads.box_head(pooled.reshape(B * S, *pooled.shape[2:])))
        gt_matched = torch.gather(gt_boxes, 1, sampled["gt_idx"][..., None].expand(-1, -1, 4))
        losses.update(fast_rcnn_losses(
            scores2d.float(), deltas2d.float(), sampled["boxes"].reshape(B * S, 4),
            sampled["classes"].reshape(B * S), sampled["valid"].reshape(B * S),
            gt_matched.reshape(B * S, 4), C, tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS)))

        metrics = {
            "roi/num_fg": sampled["num_fg"].float().mean(),
            "rpn/num_pos_anchors": (lab["labels"] == 1).sum(1).float().mean(),
            "rpn/num_neg_anchors": (lab["labels"] == 0).sum(1).float().mean(),
        }

    # ---- cube branch on the foreground slots ----
    if with_cube:
        with trace.stage("step.cube", device):
            pooled_cube = pooled_all[:, S:]
            fg_classes = sampled["classes"][:, :F].clamp(0, C - 1)
            cube_out = heads.cube_head(pooled_cube.reshape(B * F, *pooled_cube.shape[2:]))
            cube_out = tuple(t.float() if t is not None else None for t in cube_out)
            Ks_scaled = batch["Ks"] / batch["ratios"][:, None, None]
            Ks_scaled[:, 2, 2] = 1.0
            Ks_per_box = Ks_scaled[:, None].expand(B, F, 3, 3).reshape(-1, 3, 3)
            # the priors are buffers: no gradient (stop_gradient in the JAX package)
            cube = decode_cube(
                cube_out, fg_classes.reshape(-1), fg_boxes.reshape(-1, 4), Ks_per_box,
                Ks_per_box[:, 1, 1], heads.priors_dims_per_cat, z_type=ch.Z_TYPE,
                virtual_depth=ch.VIRTUAL_DEPTH, virtual_focal=ch.VIRTUAL_FOCAL,
                dims_priors_enabled=ch.DIMS_PRIORS_ENABLED,
                dims_priors_func=ch.DIMS_PRIORS_FUNC, allocentric=ch.ALLOCENTRIC_POSE,
                priors_z_stats=heads.priors_z_stats, priors_z_scales=heads.priors_z_scales,
                cluster_bins=ch.CLUSTER_BINS)
            gt_idx = sampled["gt_idx"][:, :F]
            gt_b3d = torch.gather(batch["gt_boxes3D"], 1, gt_idx[..., None].expand(-1, -1, 6))
            gt_pose = torch.gather(batch["gt_poses"], 1,
                                   gt_idx[..., None, None].expand(-1, -1, 3, 3))
            closs, cmetrics = cube_losses(cube, sampled["fg"][:, :F].reshape(-1),
                                          gt_b3d.reshape(-1, 6), gt_pose.reshape(-1, 3, 3),
                                          Ks_per_box, ch, fg_boxes.reshape(-1, 4))
            losses.update(closs)
            metrics.update(cmetrics)

    total = sum(losses.values())
    return total, losses, metrics


def _stabilizer(total, recent_loss, grad_finite):
    """The JAX package's in-graph stabilizer (train.py:340-363): skip on a
    loss spike (> TOLERANCE x the rolling mean), a non-finite loss or a
    non-finite gradient; the rolling mean moves by GAMMA when the loss is
    neither spiking nor non-finite, and starts at 2x the first finite loss.
    Tensors in, tensors out: (diverging, new recent_loss)."""
    finite_loss = torch.isfinite(total)
    has_recent = recent_loss >= 0
    loss_diverging = (has_recent & (total > TOLERANCE * recent_loss)) | ~finite_loss
    new_recent = torch.where(
        loss_diverging, recent_loss,
        torch.where(has_recent, (1 - GAMMA) * recent_loss + GAMMA * total, 2.0 * total))
    return loss_diverging | ~grad_finite, new_recent


class LossModule(torch.nn.Module):
    """`compute_losses` as a module's forward. DistributedDataParallel
    prepares its gradient reduction in `forward`, and `compute_losses`
    calls the model's parts directly, never `model.forward`: so DDP wraps
    this module, not the model."""

    def __init__(self, model: CubeRCNN):
        super().__init__()
        self.model = model

    def forward(self, batch, generator=None, noise=None, img_offset: int = 0):
        return compute_losses(self.model, batch, generator, noise, img_offset)


def make_train_step(cfg, model: CubeRCNN, optimizer: torch.optim.Optimizer,
                    scheduler, stabilize: bool = True):
    """Build step(batch, generator=None, noise=None) -> logs, updating the
    model and the optimizer in place, with state (step, skipped,
    recent_loss) on `step.state`.

    A skipped step leaves the parameters, the BN running statistics (which
    the forward updates in train mode, so they are saved before it and put
    back) and the optimizer state (including the LR schedule's count, as
    optax's schedule count stays with the restored state) exactly as they
    were; the step count and `skipped` advance.

    Under a process group (the JAX step with a mesh) each rank runs the step
    on its local batch, whose image i is global image rank x B + i for the
    sampling noise. The losses go through `DistributedDataParallel`
    (`broadcast_buffers=False`: train-mode BN normalises by the rank-local
    batch, as in shard_map; `static_graph=True`: the same parameters, the
    DLA trees' unused projections among them, go without a gradient every
    step, and DDP learns which from the first step instead of searching the
    graph after every forward). DDP averages the gradients; the loss dict,
    the metrics and the total are averaged in one fused all-reduce before
    the stabilizer, so every rank takes the same skip decision; an accepted
    step averages the BN running statistics over the ranks (the JAX step's
    pmean of the new batch statistics). Without a process group: no
    wrapper and no collective.
    """
    stabilize_on = stabilize and cfg.MODEL.STABILIZE > 0
    params = [p for group in optimizer.param_groups for p in group["params"]]
    device = params[0].device
    bn_stats = [b for m in model.modules() if isinstance(m, BatchNorm2d) and m.training
                for b in (m.running_mean, m.running_var)]
    state = {"step": 0, "skipped": 0,
             "recent_loss": torch.full((), -1.0, device=device)}   # < 0: not yet set
    distributed = dist_lib.process_group_active()
    rank = dist_lib.process_index()
    if distributed:
        losses_fn = DistributedDataParallel(
            LossModule(model), device_ids=[device] if device.type == "cuda" else None,
            broadcast_buffers=False, static_graph=True)
    else:
        def losses_fn(*args):   # looked up per call: tools/profile_train.py wraps it
            return compute_losses(model, *args)

    def step(batch, generator=None, noise=None):
        trace.set_call(state["step"])
        saved = [b.clone() for b in bn_stats] if stabilize_on else []
        optimizer.zero_grad(set_to_none=False)
        with trace.stage("step.forward", device):
            total, losses, metrics = losses_fn(batch, generator, noise,
                                               rank * batch["images"].shape[0])
        with trace.stage("step.backward", device):
            total.backward()
            for p in params:   # parameters the forward never reached (e.g. the DLA
                if p.grad is None:   # trees' unused projections): zero, as JAX's grads
                    p.grad = torch.zeros_like(p)
        if distributed:   # one fused all-reduce of the logs (JAX train.py:323-329)
            names = list(losses) + list(metrics)
            with trace.stage("step.rank_means", device):
                means = dist_lib.mean_across_ranks(
                    [total.detach()] + [v.detach() for v in losses.values()]
                    + list(metrics.values()))
            total = means[0]
            losses = dict(zip(names[:len(losses)], means[1:1 + len(losses)]))
            metrics = dict(zip(names[len(losses):], means[1 + len(losses):]))
        ok = True
        if stabilize_on:
            with trace.span("step.skip_decision"):
                # max-abs norms: inf or NaN exactly when an element is (no overflow)
                grad_finite = torch.isfinite(torch.stack(
                    torch._foreach_norm([p.grad for p in params], float("inf")))).all()
                diverging, state["recent_loss"] = _stabilizer(
                    total.detach(), state["recent_loss"], grad_finite)
                ok = not bool(diverging)   # the step's one host sync: the skip decision
        lr = cfg.SOLVER.BASE_LR * lr_factor(cfg, state["step"])
        if ok:
            if distributed:
                with trace.stage("step.rank_means", device):
                    for b, m in zip(bn_stats, dist_lib.mean_across_ranks(bn_stats)):
                        b.copy_(m)
            with trace.stage("step.optimizer", device):
                clip_gradients(cfg, params)
                optimizer.step()
                scheduler.step()
        else:
            for b, s in zip(bn_stats, saved):
                b.copy_(s)
            state["skipped"] += 1
        state["step"] += 1
        logs = dict(losses)
        logs.update(metrics)
        logs.update(total_loss=total.detach(), lr=lr, finite=float(ok))
        return logs

    step.state = state
    return step
