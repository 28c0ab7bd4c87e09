"""The numbers that decide `correct`: the program's outputs against the
plain reference (`reference/`, float32 with TF32 off), each with its limit
from the cell's workload file.

Inference (stage by stage; each later stage is judged from the program's
own choices at the stage before, which the reference reads only to judge):
  proposal_miss  trunk, FPN, RPN head, decoding, top-k and NMS: the share
                 of valid proposals of one side with no proposal of the
                 other at IoU >= MATCH_IOU (the larger direction), worst
                 image. Where the logits are large against bf16's step,
                 rounding ties reorder the selection and NMS keeps other
                 boxes, so the next two judge the program's own selection:
  rpn_box_err    each valid proposal against the reference's decoded and
                 clipped box of its anchor (the anchor whose box is nearest):
                 the norm of the coordinate gaps over the norm of the boxes'
                 sizes, worst image.
  rpn_rank_gap   how far below the reference's own top-k cut of its level
                 the reference's logit of each proposal's anchor lies, over
                 the spread (standard deviation) of that level's logits,
                 of the anchors whose boxes lie within twice the nearest's
                 distance and NEAR, the least; worst proposal of the worst image. A sound
                 selection reads rounding only.
  det_box_err    box pooler, box head and decoding, on the program's
                 proposals: each valid detection is matched to the
                 reference's decoded box of its class nearest to it; the
                 norm of the coordinate gaps over the norm of the boxes'
                 sizes, worst image.
  det_score_err  the class probabilities of the matched proposals
                 (scores_full) against the reference's, relative norm,
                 worst image.
  det_miss       score threshold, per-class NMS and the top-k cut, on the
                 program's proposals: the reference's `fast_rcnn_inference`
                 on them; the share of one side's detections with no
                 detection of the same class on the other at IoU above the
                 configuration's NMS threshold (the larger direction; an
                 empty side reads 1), worst image. Kept boxes of one class
                 overlap by no more than that threshold, so a box kept on one
                 side in place of its overlapping twin on the other (rounding
                 reorders near-equal scores) is matched, and a dropped one is
                 not. Where a side holds the full top-k, its last
                 DET_RANK_SHARE of them need no partner (the cut reorders).
  det_nms_iou    the per-class NMS's guarantee: the largest IoU between two
                 valid detections of one class in the program's output (its
                 network-resolution boxes, in the NMS's own arithmetic: float32
                 on class-shifted boxes), worst image. Its limit is the
                 configuration's NMS threshold (a config key, as in `judged`).
  cube_xy_err    cube pooler, cube head and decode_cube on the program's
                 detections: the program's center_cam projected with the
                 reference's network-resolution intrinsics against the
                 reference's projected center, the norm of the gaps over the
                 norm of the boxes' sizes, worst image (detections whose
                 reference depth is under Z_FLOOR of the image's median |z|
                 are left out: their projection is ill-conditioned).
  cube_z_err     the depth (center_cam's z), relative norm, worst image;
  cube_z_scale   |<z, z_ref> / <z_ref, z_ref> - 1| over the call's
                 detections: a scale error of the depth decoding, with the
                 per-detection rounding averaged out. The random heads' depths
                 are ~1e-3 and every detection's moves by a few % in bf16
                 (PERF.md), so the center itself (depth times the ray) reads
                 that and not the decoding.
  cube_dims_err, cube_pose_err
                 dims and pose (the rotation), relative norm, worst image.
  cube_score_err the fused score sqrt(score x exp(-uncertainty)) as a log:
                 the largest gap, worst image.
Training (the first steps of the one step object the window drives, on the
same batches and sampling noise):
  loss_gap       |program loss - reference loss| / |reference loss|, worst
                 step.
  grad_gap       the first gradient as the optimizer holds it (SGD's
                 momentum buffer after one step): per leaf, the gap of the
                 norms over the larger of the reference leaf's norm and the
                 median leaf's; the median over the leaves.
  update_gap     the parameters' change over the compared steps, by the same
                 measure, over the leaves whose reference gradient is at least
                 GRAD_FLOOR of the median leaf's (the others move by round-off
                 alone); the median over the leaves.
  grad_gap.<group>, update_gap.<group>
                 the same, worst leaf of each group of GROUPS (trunk, FPN,
                 RPN, box head, cube head), so a fault confined to a few
                 leaves shows. The trunk's norm leaves (BN's weight and bias)
                 are left to the medians and reported as `.trunk_norm`: their
                 gradients are sums over every pixel of a stride-1 to 8 map
                 that nearly cancel, so bf16 moves them by tens of % in sound
                 runs (PERF.md).
"""
from __future__ import annotations

import statistics

import torch

from .reference import boxes as box_ops
from .reference import model as ref

MATCH_IOU = 0.9
DET_RANK_SHARE = 0.2
Z_FLOOR = 1e-3
GRAD_FLOOR = 1e-3
GROUPS = {"trunk": "backbone.bottom_up.", "fpn": "backbone.fpn_", "rpn": "proposal_generator.",
          "box_head": ("roi_heads.box_head.", "roi_heads.box_predictor."),
          "cube_head": "roi_heads.cube_head."}
NEAR = (1.0, 0.02)   # px, and share of the box size
CUBE_KEYS = {"cube_dims_err": "dims", "cube_pose_err": "pose"}


def _rel(a, b) -> float:
    """||a - b|| / ||b|| over all elements (0 where both are 0)."""
    num = float(torch.linalg.vector_norm((a - b).double()))
    den = float(torch.linalg.vector_norm(b.double()))
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def _miss(a, b) -> float:
    """Share of the boxes `a` with no box of `b` at IoU >= MATCH_IOU."""
    if a.shape[0] == 0:
        return 0.0 if b.shape[0] == 0 else 1.0
    if b.shape[0] == 0:
        return 1.0
    iou = box_ops.pairwise_iou(a.double(), b.double())
    return float((iou.max(1).values < MATCH_IOU).double().mean())


def inference_numbers(model, images, Ks, ratios, hw, out: dict) -> dict:
    """The inference numbers of one batch of the program's outputs
    `out` (the dict `inference_step` returned, with `boxes_orig`,
    `classes`, `scores`, `valid`, `center_cam`, `dims`, `pose` as they
    were copied to the host), on the reference `model`'s computation from
    the same normalized `images` (B, H, W, 3), Ks, ratios and hw."""
    B = images.shape[0]
    rpn = ref.rpn_stage(model, images)
    flist, r_boxes, r_valid = ref.proposal_stage(model, images, hw, rpn)
    p_boxes = out["proposal_boxes"].float()
    p_valid = out["proposal_valid"].bool()
    miss = max(max(_miss(p_boxes[b][p_valid[b]], r_boxes[b][r_valid[b]]),
                   _miss(r_boxes[b][r_valid[b]], p_boxes[b][p_valid[b]])) for b in range(B))
    rpn_nums = _rpn_numbers(model, rpn, p_boxes, p_valid, hw)

    probs, dec = ref.box_stage(model, flist, p_boxes)
    dec = box_ops.clip_boxes(dec, hw[:, 0, None, None].float(), hw[:, 1, None, None].float())
    det_valid = out["valid"].bool()
    classes = out["classes"].long()
    det_boxes = out["boxes_orig"].float() / ratios[:, None, None]
    box_err = score_err = 0.0
    matched_prob = torch.zeros(det_valid.shape, device=images.device)
    for b in range(B):
        v = det_valid[b]
        if not bool(v.any()):
            continue
        d, c = det_boxes[b][v], classes[b][v]
        cand = dec[b][:, c].transpose(0, 1)                       # (K, P, 4) of each class
        gap = (cand - d[:, None]).abs().amax(-1)
        gap = torch.where(p_valid[b][None], gap, torch.full_like(gap, float("inf")))
        p_star = gap.argmin(1)
        best = cand[torch.arange(len(c)), p_star]
        size = torch.maximum(best[:, 2] - best[:, 0], best[:, 3] - best[:, 1]).clamp(min=1.0)
        box_err = max(box_err, float(torch.linalg.vector_norm((d - best).double()))
                      / float(torch.linalg.vector_norm(size.double())))
        score_err = max(score_err, _rel(out["scores_full"][b][v].float(), probs[b][p_star]))
        matched_prob[b][v] = probs[b][p_star, c]
    dets = ref.detect(model, flist, p_boxes, p_valid, hw)
    sides = [(det_boxes[b], classes[b], out["scores_2d"][b].float(), det_valid[b],
              dets["boxes"][b], dets["classes"][b].long(), dets["scores"][b], dets["valid"][b])
             for b in range(B)]
    nms_iou = ref.inference_kwargs(model.cfg)["nms_thresh"]
    det_miss = max(_det_miss(*s, nms_iou) for s in sides)
    det_nms_iou = max(_nms_iou(out["boxes"][b][det_valid[b]], classes[b][det_valid[b]],
                               float(hw[b].max())) for b in range(B))

    cube = ref.cube_stage(model, flist, det_boxes, classes.clamp(min=0), Ks, ratios)
    fused = torch.sqrt((matched_prob * cube["conf"]).clamp(min=0.0))
    Ks_net = Ks / ratios[:, None, None]
    nums = dict.fromkeys(("cube_xy_err", "cube_z_err", *CUBE_KEYS, "cube_score_err"), 0.0)
    z_p = out["center_cam"][..., 2][det_valid].double()
    z_r = cube["center_cam"][..., 2][det_valid].double()
    nums["cube_z_scale"] = (abs(float((z_p * z_r).sum() / (z_r * z_r).sum()) - 1.0)
                            if bool(det_valid.any()) else 0.0)
    for b in range(B):
        v = det_valid[b]
        if not bool(v.any()):
            continue
        for k, name in CUBE_KEYS.items():
            nums[k] = max(nums[k], _rel(out[name][b][v].float(), cube[name][b][v]))
        c = out["center_cam"][b][v].double()
        z_ref = cube["center_cam"][b][v][:, 2].double()
        nums["cube_z_err"] = max(nums["cube_z_err"], _rel(c[:, 2], z_ref))
        K = Ks_net[b].double()
        uv = torch.stack([K[0, 0] * c[:, 0] / c[:, 2] + K[0, 2],
                          K[1, 1] * c[:, 1] / c[:, 2] + K[1, 2]], -1)
        ok = z_ref.abs() >= Z_FLOOR * z_ref.abs().median()
        d = det_boxes[b][v].double()
        size = torch.maximum(d[:, 2] - d[:, 0], d[:, 3] - d[:, 1]).clamp(min=1.0)
        gap = torch.linalg.vector_norm((uv - cube["xy"][b][v].double())[ok])
        nums["cube_xy_err"] = max(nums["cube_xy_err"],
                                  float(gap) / float(torch.linalg.vector_norm(size[ok])))
        log_gap = (torch.log(out["scores"][b][v].double().clamp(min=1e-30))
                   - torch.log(fused[b][v].double().clamp(min=1e-30))).abs()
        nums["cube_score_err"] = max(nums["cube_score_err"], float(log_gap.max()))
    return {"proposal_miss": miss, **rpn_nums, "det_box_err": box_err,
            "det_score_err": score_err, "det_miss": det_miss, "det_nms_iou": det_nms_iou,
            **nums}


def _nms_iou(boxes, classes, bound: float) -> float:
    """The largest IoU between two of `boxes` of one class (0 for none), as
    the program's per-class NMS computes it: float32, each box shifted by
    its class x (the largest coordinate a clipped box can take + 1)."""
    if boxes.shape[0] < 2:
        return 0.0
    shifted = boxes.float() + (classes.float() * (bound + 1.0))[:, None]
    iou = box_ops.pairwise_iou(shifted, shifted)
    same = (classes[:, None] == classes[None]) & ~torch.eye(len(classes), dtype=torch.bool,
                                                            device=boxes.device)
    return float(torch.where(same, iou, torch.zeros_like(iou)).max())


def _det_miss(a_boxes, a_cls, a_scores, a_valid, b_boxes, b_cls, b_scores, b_valid,
              nms_iou: float) -> float:
    """det_miss of one image (module docstring): the larger direction."""
    def sides(boxes, cls, scores, valid):
        order = torch.argsort(scores.masked_fill(~valid, float("-inf")), descending=True)
        n = int(valid.sum())
        top = order[:n - int(DET_RANK_SHARE * n) if n == valid.shape[0] else n]
        return (boxes[top].double(), cls[top]), (boxes[valid].double(), cls[valid])

    def miss(top, other) -> float:
        if top[0].shape[0] == 0:
            return 0.0
        if other[0].shape[0] == 0:
            return 1.0
        iou = box_ops.pairwise_iou(top[0], other[0])
        iou = torch.where(top[1][:, None] == other[1][None], iou, torch.zeros_like(iou))
        return float((iou.max(1).values <= nms_iou).double().mean())

    a_top, a_all = sides(a_boxes, a_cls, a_scores, a_valid)
    b_top, b_all = sides(b_boxes, b_cls, b_scores, b_valid)
    return max(miss(a_top, b_all), miss(b_top, a_all))


def _rpn_numbers(model, rpn, p_boxes, p_valid, hw, chunk: int = 64) -> dict:
    """rpn_box_err and rpn_rank_gap (module docstring)."""
    k = ref.inference_kwargs(model.cfg)["pre_nms_topk"]
    anchors = torch.cat(rpn["anchors"], 0)
    level = torch.cat([torch.full((a.shape[0],), i, device=anchors.device)
                       for i, a in enumerate(rpn["anchors"])])
    box_err = rank_gap = 0.0
    for b in range(p_boxes.shape[0]):
        logits = torch.cat([l[b] for l in rpn["logits"]])
        cut = torch.stack([torch.topk(l[b], min(k, l.shape[1])).values[-1] for l in rpn["logits"]])
        spread = torch.stack([l[b].std() for l in rpn["logits"]])
        dec = box_ops.clip_boxes(box_ops.decode_deltas(torch.cat([d[b] for d in rpn["deltas"]]),
                                                       anchors), hw[b, 0], hw[b, 1])
        below = (cut[level] - logits) / spread[level]
        props = p_boxes[b][p_valid[b]]
        gaps, dists, sizes = [], [], []
        for s in range(0, props.shape[0], chunk):
            p = props[s:s + chunk]
            dist = (p[:, None, :] - dec[None]).abs().amax(-1)
            nearest = dist.min(1).values
            size = torch.maximum(p[:, 2] - p[:, 0], p[:, 3] - p[:, 1]).clamp(min=1.0)
            near = dist <= (2 * nearest + torch.clamp(NEAR[1] * size, min=NEAR[0]))[:, None]
            inf = torch.full_like(dist, float("inf"))
            gaps.append(torch.where(near, below[None], inf).min(1).values.clamp(min=0))
            dists.append(nearest)
            sizes.append(size)
        if not sizes:
            continue
        dist, size = torch.cat(dists), torch.cat(sizes)
        box_err = max(box_err, float(torch.linalg.vector_norm(dist.double()))
                      / float(torch.linalg.vector_norm(size.double())))
        rank_gap = max(rank_gap, float(torch.cat(gaps).max()))
    return {"rpn_box_err": box_err, "rpn_rank_gap": rank_gap}


def worst(rows: list) -> dict:
    """The largest reading of each number over rows of them."""
    return {k: max(r[k] for r in rows) for k in rows[0]}


def leaf_gaps(prog: dict, refs: dict, keep=None) -> dict:
    """Per leaf |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf ‖ref‖)."""
    names = [n for n in refs if keep is None or n in keep]
    rn = {n: float(torch.linalg.vector_norm(refs[n].double())) for n in names}
    med = statistics.median(rn.values())
    return {n: abs(float(torch.linalg.vector_norm(prog[n].double())) - rn[n]) / max(rn[n], med)
            for n in names}


def group_worst(number: str, gaps: dict, refs: dict) -> dict:
    """The worst leaf gap of each group of GROUPS (0 for a group with no
    leaf), the trunk's norm leaves (1-D: BN's weight and bias) apart under
    `<number>.trunk_norm`."""
    def worst(prefix, keep):
        return max((v for n, v in gaps.items() if n.startswith(prefix) and keep(refs[n])),
                   default=0.0)
    out = {f"{number}.{g}": worst(prefix, lambda t, g=g: g != "trunk" or t.dim() > 1)
           for g, prefix in GROUPS.items()}
    out[f"{number}.trunk_norm"] = worst(GROUPS["trunk"], lambda t: t.dim() == 1)
    return out


def moving_leaves(grad_norms: dict) -> set:
    """Leaves whose reference gradient norm is at least GRAD_FLOOR of the
    median leaf's."""
    med = statistics.median(grad_norms.values())
    return {n for n, g in grad_norms.items() if g >= GRAD_FLOOR * med}


def judged(numbers: dict, limits: dict, cfg: dict) -> tuple[bool, list]:
    """(every number within its limit, [(name, number, limit)]). A limit
    given as a string is a dotted key of the configuration's `cfg`, which
    states it."""
    def limit(lim):
        if not isinstance(lim, str):
            return lim
        node = cfg
        for part in lim.split("."):
            node = node[part]
        return node
    rows = [(k, numbers[k], limit(lim)) for k, lim in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows
