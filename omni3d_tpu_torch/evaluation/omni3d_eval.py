"""Omni3D evaluation: COCO-style AP2D / AP3D without pycocotools (port of
`omni3d_tpu.evaluation.omni3d_eval`; the reference is
cubercnn/evaluation/omni3d_evaluation.py).

  * `Omni3DParams`: 2D AP @ IoU .5:.95 with COCO area ranges, 3D AP @ IoU3D
    .05:.5 with depth ranges near/medium/far [0,10)/[10,35)/[35,inf)
    (reference :1029-1064);
  * `Omni3DEval`: greedy per-image matching (evaluateImg, :1433-1551, in
    C++: `evaluation.native`), PR-curve accumulation (:1172-1313),
    summarize; proximity evaluation for non-exhaustively annotated datasets
    (in_prox gating, :1417-1431);
  * IoU3D (`ops.iou3d`) as torch tensors on an explicit `device`, the CUDA
    card unless the caller asks for the CPU, behind the reference's
    coplanarity / zero-volume guards (:65-166). A 3D evaluation sends every
    (detection, GT) pair of every (image, category) group through a few
    batched calls;
  * `Omni3DEvaluationHelper`: per-dataset evaluations plus the cross-dataset
    "Concat" / Omni3D / Omni3D_In / Omni3D_Out summaries by re-accumulating
    the cached per-image evaluations (:378-519).

Matching and accumulation are the public COCO protocol in numpy on the host.
"""
from __future__ import annotations

import copy
import json
import os
import pickle
from collections import defaultdict

import numpy as np
import torch

from ..data.builtin import get_omni3d_categories
from ..ops import iou3d as iou3d_ops
from ..utils.boxes import iou_np
from ..utils.geometry import CUBOID_FACES
from . import native

# (detection, GT) pairs per batched IoU3D call: 12 lanes of (10, 3) polygon
# slots per pair, so a call's largest intermediates stay near 50 MB
PAIRS_PER_CALL = 16384


def _plain(v):
    """json-serializable copy of a results dict (numpy scalars -> python)."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("IoU3D runs on the CUDA card, and torch.cuda.is_available() is "
                           "false; pass device='cpu' to evaluate on the CPU")
    return device


# ------------------------------ IoU3D ------------------------------

def _check_coplanar_np(verts: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """(B, 8, 3) -> (B,) True if every face quad is planar (reference :65-86)."""
    v = verts[:, np.asarray(iou3d_ops._QUADS_OUT)]   # (B, 6, 4, 3); winding irrelevant
    v0, v1, v2, v3 = v[:, :, 0], v[:, :, 1], v[:, :, 2], v[:, :, 3]

    def norm(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

    n = norm(np.cross(norm(v1 - v0), norm(v2 - v0)))
    d = np.abs(np.sum((v3 - v0) * n, axis=-1))
    return (d < eps).all(axis=1)


def _check_nonzero_np(verts: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """(B, 8, 3) -> (B,) True if all 12 triangle faces have area > eps."""
    t = verts[:, np.asarray(CUBOID_FACES)]   # (B, 12, 3, 3)
    areas = np.linalg.norm(
        np.cross(t[:, :, 1] - t[:, :, 0], t[:, :, 2] - t[:, :, 0]), axis=-1) / 2
    return (areas > eps).all(axis=1)


def _guard(ious: np.ndarray, dt_verts: np.ndarray) -> np.ndarray:
    """Zero the rows of degenerate detection boxes (reference :106-166)."""
    invalid = ~(_check_coplanar_np(dt_verts) & _check_nonzero_np(dt_verts))
    ious[invalid] = 0
    return ious


def paired_iou3d(dt_verts: np.ndarray, gt_verts: np.ndarray, device="cuda") -> np.ndarray:
    """IoU3D of pair i = (dt_verts[i], gt_verts[i]), (P, 8, 3) each -> (P,),
    unguarded: `ops.iou3d.box3d_overlap_tiled` with one-box tiles,
    PAIRS_PER_CALL pairs per call on `device`, one copy to the host."""
    device = _device(device)
    d = torch.from_numpy(np.ascontiguousarray(dt_verts, np.float32)).to(device)
    g = torch.from_numpy(np.ascontiguousarray(gt_verts, np.float32)).to(device)
    out = [iou3d_ops.box3d_overlap_tiled(d[s:s + PAIRS_PER_CALL, None],
                                         g[s:s + PAIRS_PER_CALL, None])[1].reshape(-1)
           for s in range(0, len(d), PAIRS_PER_CALL)]
    return torch.cat(out).cpu().numpy() if out else np.zeros(0, np.float32)


# ------------------------------ params ------------------------------

class Omni3DParams:
    """reference :1016-1086."""

    def __init__(self, mode: str = "2D"):
        assert mode in ("2D", "3D")
        self.mode = mode
        self.imgIds: list = []
        self.catIds: list = []
        self.recThrs = np.linspace(0.0, 1.00, 101, endpoint=True)
        self.maxDets = [1, 10, 100]
        self.useCats = 1
        self.proximity_thresh = 0.3
        if mode == "2D":
            self.iouThrs = np.linspace(0.5, 0.95, 10, endpoint=True)
            self.areaRng = [[0, 1e10], [0, 32**2], [32**2, 96**2], [96**2, 1e10]]
            self.areaRngLbl = ["all", "small", "medium", "large"]
        else:
            self.iouThrs = np.linspace(0.05, 0.5, 10, endpoint=True)
            self.areaRng = [[0, 1e5], [0, 10], [10, 35], [35, 1e5]]
            self.areaRngLbl = ["all", "near", "medium", "far"]


# ------------------------------ core eval ------------------------------

class Omni3DEval:
    """Greedy-matching COCO-protocol evaluation over plain dict lists.

    gts/dts: lists of dicts. GT needs: id, image_id, category_id, bbox (XYWH),
    area, depth, ignore2D, ignore3D, bbox3D (8x3 verts, 3D mode). DT needs:
    id, image_id, category_id, bbox (XYWH), score, depth, bbox3D.
    device: where the 3D mode computes IoU3D (the CUDA card by default).
    """

    def __init__(self, gts, dts, mode: str = "2D", eval_prox: bool = False, device="cuda"):
        self.mode = mode
        self.eval_prox = eval_prox
        self.device = device
        self.params = Omni3DParams(mode)
        self.params.imgIds = sorted({g["image_id"] for g in gts})
        self.params.catIds = sorted({g["category_id"] for g in gts})
        self._gts_all = gts
        self._dts_all = dts
        self.evalImgs = None
        self.eval = {}
        self.evals_per_cat_area = None
        self.stats = {}

    def _prepare(self):
        ignore_flag = "ignore2D" if self.mode == "2D" else "ignore3D"
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for g in self._gts_all:
            g.setdefault(ignore_flag, 0)
            self._gts[g["image_id"], g["category_id"]].append(g)
        for d in self._dts_all:
            self._dts[d["image_id"], d["category_id"]].append(d)

    def _sorted_dts(self, imgId, catId):
        """The group's detections in score order, cut to maxDets[-1]."""
        dt = self._dts[imgId, catId]
        inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
        return [dt[i] for i in inds][: self.params.maxDets[-1]]

    def iou3d_pairs(self):
        """Every (detection, GT) pair of the 3D evaluation: (groups, detection
        verts (P, 8, 3), GT verts (P, 8, 3)). groups lists (key, D, G) per
        (image, category) with detections and GTs, its detections in score
        order cut to maxDets[-1]; pair (i, j) of a group sits at the group's
        offset + i * G + j."""
        p = self.params
        self._prepare()
        groups, dvs, gvs = [], [], []
        for imgId in p.imgIds:
            for catId in p.catIds:
                gt = self._gts[imgId, catId]
                if not (len(gt) and len(self._dts[imgId, catId])):
                    continue
                dv = np.asarray([x["bbox3D"] for x in self._sorted_dts(imgId, catId)], np.float32)
                gv = np.asarray([x["bbox3D"] for x in gt], np.float32)
                groups.append(((imgId, catId), len(dv), len(gv)))
                dvs.append(np.repeat(dv, len(gv), 0))
                gvs.append(np.tile(gv, (len(dv), 1, 1)))
        if not groups:
            return groups, np.zeros((0, 8, 3), np.float32), np.zeros((0, 8, 3), np.float32)
        return groups, np.concatenate(dvs), np.concatenate(gvs)

    def _precompute_iou3d(self):
        """Every (image, category) group's IoU3D matrix from one flat batch
        of its (detection, GT) pairs (`paired_iou3d`), instead of one
        device round trip per group (reference computeIoU,
        omni3d_evaluation.py:1359-1431)."""
        groups, dv, gv = self.iou3d_pairs()
        ious = paired_iou3d(dv, gv, self.device) if groups else None
        self._iou3d_pre = {}
        off = 0
        for key, D, G in groups:
            self._iou3d_pre[key] = _guard(ious[off:off + D * G].reshape(D, G).copy(),
                                          dv[off:off + D * G:G])
            off += D * G

    def _compute_iou(self, imgId, catId):
        """reference computeIoU (:1359-1431)."""
        p = self.params
        gt = self._gts[imgId, catId]
        if len(gt) == 0 and len(self._dts[imgId, catId]) == 0:
            return [], None
        dt = self._sorted_dts(imgId, catId)

        if self.mode == "2D":
            g = np.asarray([self._xywh_to_xyxy(x["bbox"]) for x in gt], np.float64).reshape(-1, 4)
            d = np.asarray([self._xywh_to_xyxy(x["bbox"]) for x in dt], np.float64).reshape(-1, 4)
            ious = iou_np(d, g) if len(d) and len(g) else np.zeros((len(d), len(g)))
        else:
            if len(dt) and len(gt):
                ious = self._iou3d_pre[imgId, catId]   # filled by _precompute_iou3d
            else:
                ious = np.zeros((len(dt), len(gt)))

        in_prox = None
        if self.eval_prox:
            g2 = np.asarray([self._xywh_to_xyxy(x["bbox"]) for x in gt], np.float64).reshape(-1, 4)
            d2 = np.asarray([self._xywh_to_xyxy(x["bbox"]) for x in dt], np.float64).reshape(-1, 4)
            ious2d = iou_np(d2, g2) if len(d2) and len(g2) else np.zeros((len(d2), len(g2)))
            in_prox = ious2d > p.proximity_thresh
        return ious, in_prox

    @staticmethod
    def _xywh_to_xyxy(b):
        return [b[0], b[1], b[0] + b[2], b[1] + b[3]]

    def evaluate(self):
        p = self.params
        self._prepare()
        if self.mode == "3D":
            self._precompute_iou3d()
        self.ious = {
            (imgId, catId): self._compute_iou(imgId, catId)
            for imgId in p.imgIds
            for catId in p.catIds
        }
        maxDet = p.maxDets[-1]
        self.evalImgs = [
            self._evaluate_img(imgId, catId, areaRng, maxDet)
            for catId in p.catIds
            for areaRng in p.areaRng
            for imgId in p.imgIds
        ]
        self._paramsEval = copy.deepcopy(p)

    def _evaluate_img(self, imgId, catId, aRng, maxDet):
        """Greedy matching per (image, category, range) (reference :1433-1551)."""
        p = self.params
        gt = self._gts[imgId, catId]
        dt = self._dts[imgId, catId]
        if len(gt) == 0 and len(dt) == 0:
            return None

        flag_range = "area" if self.mode == "2D" else "depth"
        flag_ignore = "ignore2D" if self.mode == "2D" else "ignore3D"

        for g in gt:
            out_rng = g[flag_range] < aRng[0] or g[flag_range] > aRng[1]
            g["_ignore"] = 1 if (g[flag_ignore] or out_rng) else 0

        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[:maxDet]]

        ious = self.ious[imgId, catId][0]
        ious = ious[:, gtind] if len(ious) > 0 else ious
        in_prox = None
        if self.eval_prox:
            in_prox = self.ious[imgId, catId][1]
            in_prox = in_prox[:, gtind] if len(in_prox) > 0 else in_prox

        T, G, D = len(p.iouThrs), len(gt), len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gtIg = np.array([g["_ignore"] for g in gt])
        dtIg = np.zeros((T, D))

        if len(ious):
            dtm, gtm, dt_ig8 = native.greedy_match(
                np.asarray(ious, np.float32)[:D], np.asarray(p.iouThrs),
                gtIg.astype(np.uint8),
                np.asarray(in_prox, bool)[:D] if self.eval_prox else None,
                np.asarray([d["id"] for d in dt], np.int64),
                np.asarray([g["id"] for g in gt], np.int64),
            )
            dtIg = dt_ig8.astype(np.float64)

        a = np.array(
            [d[flag_range] < aRng[0] or d[flag_range] > aRng[1] for d in dt]
        ).reshape(1, D)
        dtIg = np.logical_or(dtIg, np.logical_and(dtm == 0, np.repeat(a, T, 0)))
        if self.eval_prox and len(in_prox) > 0:
            dt_far = in_prox.any(1) == 0
            dtIg = np.logical_or(dtIg, np.repeat(dt_far.reshape(1, D), T, 0))

        return {
            "image_id": imgId,
            "category_id": catId,
            "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gtIg,
            "dtIgnore": dtIg,
        }

    def accumulate(self):
        """PR accumulation (reference :1172-1313), supports injected
        `evals_per_cat_area` for cross-dataset re-accumulation."""
        assert self.evalImgs is not None or self.evals_per_cat_area is not None
        p = self.params
        T, R = len(p.iouThrs), len(p.recThrs)
        K, A, M = len(p.catIds), len(p.areaRng), len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        has_pre = self.evals_per_cat_area is not None
        evals_per_cat_area = self.evals_per_cat_area if has_pre else {}

        if not has_pre:
            pe = self._paramsEval
            I0, A0 = len(pe.imgIds), len(pe.areaRng)

        for k, catId in enumerate(p.catIds):
            for a in range(A):
                if has_pre:
                    E = evals_per_cat_area.get((catId, a), [])
                else:
                    Nk, Na = k * A0 * I0, a * I0
                    E = [self.evalImgs[Nk + Na + i] for i in range(I0)]
                    E = [e for e in E if e is not None]
                    evals_per_cat_area[(catId, a)] = E
                if len(E) == 0:
                    continue
                for m, maxDet in enumerate(p.maxDets):
                    dtScores = np.concatenate([np.asarray(e["dtScores"][:maxDet]) for e in E])
                    inds = np.argsort(-dtScores, kind="mergesort")
                    dtScoresSorted = dtScores[inds]
                    dtm = np.concatenate([e["dtMatches"][:, :maxDet] for e in E], axis=1)[:, inds]
                    dtIg = np.concatenate([e["dtIgnore"][:, :maxDet] for e in E], axis=1)[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(np.logical_not(dtm), np.logical_not(dtIg))
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds_r = np.searchsorted(rc, p.recThrs, side="left")
                        for ri, pi in enumerate(inds_r):
                            if pi < nd:
                                q[ri] = pr[pi]
                                ss[ri] = dtScoresSorted[pi]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss

        self.evals_per_cat_area = evals_per_cat_area
        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }

    # ------------------------------ summaries ------------------------------

    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=100):
        p = self.params
        aind = [i for i, a in enumerate(p.areaRngLbl) if a == areaRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                s = s[np.where(np.isclose(p.iouThrs, iouThr))[0]]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                s = s[np.where(np.isclose(p.iouThrs, iouThr))[0]]
            s = s[:, :, aind, mind]
        if len(s[s > -1]) == 0:
            return -1.0
        return float(np.mean(s[s > -1]))

    def summarize(self):
        """Headline metrics (reference :1553-1705): values are percentages;
        -1 marks metrics with nothing evaluable."""

        def S(*a, **k):
            v = self._summarize(*a, **k)
            return v * 100 if v > -1 else -1.0
        if self.mode == "2D":
            self.stats = {
                "AP2D": S(1),
                "AP2D@50": S(1, 0.5),
                "AP2D@75": S(1, 0.75),
                "AP2D-small": S(1, areaRng="small"),
                "AP2D-med": S(1, areaRng="medium"),
                "AP2D-large": S(1, areaRng="large"),
                "AR2D@1": S(0, maxDets=1),
                "AR2D@10": S(0, maxDets=10),
                "AR2D@100": S(0, maxDets=100),
            }
        else:
            self.stats = {
                "AP3D": S(1),
                "AP3D@15": S(1, 0.15),
                "AP3D@25": S(1, 0.25),
                "AP3D@50": S(1, 0.50),
                "AP3D-near": S(1, areaRng="near"),
                "AP3D-med": S(1, areaRng="medium"),
                "AP3D-far": S(1, areaRng="far"),
                "AR3D@1": S(0, maxDets=1),
                "AR3D@10": S(0, maxDets=10),
                "AR3D@100": S(0, maxDets=100),
            }
        return self.stats

    def per_category_ap(self) -> dict:
        """catId -> AP (mean over IoU thresholds, all range, maxDets=100)."""
        prec = self.eval["precision"]
        out = {}
        for k, catId in enumerate(self.params.catIds):
            s = prec[:, :, k, 0, -1]
            valid = s[s > -1]
            # no valid precision entry -> NaN, matching the reference
            # (omni3d_evaluation.py:444-446); NaN propagates visibly into
            # the Concat/Omni3D means instead of dragging them down
            out[catId] = (float(np.mean(valid) * 100) if len(valid)
                          else float("nan"))
        return out


# ------------------------------ dataset orchestration ------------------------------

def instances_to_predictions(det: dict, image_id, contig_to_dataset_id: dict,
                             start_id: int = 0) -> list:
    """One image's padded inference output -> prediction dicts (reference
    instances_to_coco_json, :970-1013).

    det: one image's slice of `models.rcnn3d.inference`'s output on the
    host, numpy: boxes_orig, classes, scores, valid, center_cam, dims, pose,
    corners, center_2D.
    """
    out = []
    next_id = start_id
    for i in np.where(det["valid"])[0]:
        x1, y1, x2, y2 = [float(v) for v in det["boxes_orig"][i]]
        out.append({
            "id": next_id,
            "image_id": int(image_id),
            "category_id": contig_to_dataset_id[int(det["classes"][i])],
            "bbox": [x1, y1, x2 - x1, y2 - y1],
            "score": float(det["scores"][i]),
            "depth": float(det["center_cam"][i][2]),
            "bbox3D": np.asarray(det["corners"][i], np.float64).tolist(),
            "center_cam": np.asarray(det["center_cam"][i], np.float64).tolist(),
            "center_2D": np.asarray(det["center_2D"][i], np.float64).tolist(),
            "dimensions": np.asarray(det["dims"][i], np.float64).tolist(),
            "pose": np.asarray(det["pose"][i], np.float64).tolist(),
            "area": float(max(x2 - x1, 0) * max(y2 - y1, 0)),
        })
        next_id += 1
    return out


def gts_from_api(api, category_ids=None) -> list:
    """Omni3D index -> GT dicts for Omni3DEval."""
    gts = []
    for ann in api.dataset["annotations"]:
        if category_ids is not None and ann["category_id"] not in category_ids:
            continue
        gts.append({
            "id": ann["id"],
            "image_id": ann["image_id"],
            "category_id": ann["category_id"],
            "bbox": ann["bbox"],
            "area": ann["area"],
            "depth": ann["center_cam"][2],
            "ignore2D": ann["ignore"],
            "ignore3D": ann["ignore"],
            "bbox3D": ann["bbox3D_cam"],
        })
    return gts


class Omni3DEvaluationHelper:
    """Per-dataset evaluation + cross-dataset summaries (reference :168-519).

    Usage: add_predictions(dataset, preds, gt_api) per dataset,
    evaluate(dataset), then summarize_all() for the Concat / Omni3D_In /
    Omni3D_Out tables. `device` is where IoU3D runs.
    """

    def __init__(self, dataset_names, filter_settings, output_folder=None, device="cuda"):
        self.dataset_names = list(dataset_names)
        self.filter_settings = filter_settings
        self.output_folder = output_folder
        self.device = device
        self.results = {}
        self.evals = {}          # (dataset, mode) -> Omni3DEval
        self._predictions = {}
        self._gt_apis = {}

    @staticmethod
    def eval_prox_for(dataset_name: str) -> bool:
        """Objectron/SUNRGBD are non-exhaustively annotated (reference
        :236-239)."""
        return "Objectron" in dataset_name or "SUNRGBD" in dataset_name

    def add_predictions(self, dataset_name, predictions, gt_api):
        self._predictions[dataset_name] = predictions
        self._gt_apis[dataset_name] = gt_api

    def save_predictions(self, dataset_name):
        """Write the raw predictions for offline re-evaluation to
        <output>/<dataset>/instances_predictions.pkl (reference
        save_predictions, omni3d_evaluation.py:278-296, torch.saves a .pth;
        here a pickle of the same COCO-style dicts). No-op without an
        output_folder."""
        if self.output_folder is None:
            return None
        folder = os.path.join(self.output_folder, dataset_name)
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, "instances_predictions.pkl")
        with open(path, "wb") as f:
            pickle.dump(self._predictions[dataset_name], f)
        return path

    @staticmethod
    def load_predictions(path):
        """Reload predictions written by save_predictions."""
        with open(path, "rb") as f:
            return pickle.load(f)

    def save_results(self):
        """Write the accumulated per-dataset + summary AP tables as json
        under output_folder (the reference keeps these only in logs)."""
        if self.output_folder is None:
            return None
        os.makedirs(self.output_folder, exist_ok=True)
        path = os.path.join(self.output_folder, "omni3d_results.json")
        with open(path, "w") as f:
            json.dump({k: _plain(v) for k, v in self.results.items()}, f,
                      indent=2, default=float)
        return path

    def evaluate(self, dataset_name):
        preds = self._predictions[dataset_name]
        gts = gts_from_api(self._gt_apis[dataset_name])
        prox = self.eval_prox_for(dataset_name)
        res = {}
        for mode in ("2D", "3D"):
            ev = Omni3DEval(gts, preds, mode=mode, eval_prox=prox, device=self.device)
            ev.evaluate()
            ev.accumulate()
            res.update(ev.summarize())
            self.evals[(dataset_name, mode)] = ev
        self.results[dataset_name] = res
        return res

    def _reaccumulate(self, datasets, mode):
        """Concat cached per-image evals across datasets into ONE combined
        Omni3DEval (reference :396-430) and accumulate it."""
        per_cat_area = defaultdict(list)
        cat_ids = set()
        img_count = 0
        any_ev = None
        for name in datasets:
            ev = self.evals.get((name, mode))
            if ev is None:
                continue
            any_ev = ev
            for (catId, a), E in ev.evals_per_cat_area.items():
                per_cat_area[(catId, a)].extend(E)
                cat_ids.add(catId)
            img_count += len(ev.params.imgIds)
        if any_ev is None:
            return None
        combined = Omni3DEval([], [], mode=mode, device=self.device)
        combined.params.catIds = sorted(cat_ids)
        combined.params.imgIds = list(range(img_count))
        combined.evals_per_cat_area = dict(per_cat_area)
        combined.evalImgs = []
        combined.accumulate()
        return combined

    def _cat_id_to_name(self) -> dict:
        """catId -> category name from the registered GT APIs."""
        out = {}
        for api in self._gt_apis.values():
            for c in api.dataset.get("categories", []):
                out[c["id"]] = c["name"]
        return out

    def summarize_all(self):
        """Cross-dataset summary with reference semantics (:378-519):

          * ONE overall re-accumulation of every dataset's cached per-image
            evals (not per-subset re-accumulations),
          * per-category APs from the combined precision tensor
            (area range 'all', maxDets -1) emitted as `Concat/AP2D-{name}` /
            `Concat/AP3D-{name}` (reference results2D/3D "AP-{name}", :418-424),
          * Concat AP2D/AP3D = mean of per-category APs over ALL categories
            (:455-459 general_2D/3D),
          * Omni3D / Omni3D_In / Omni3D_Out AP2D/AP3D = mean of per-category
            APs over the builtin category sets, only when the evaluated
            category set covers them (:477-497),
          * the analysis extras (AP3D@15/25/50, near/med/far) stay the
            combined accumulation's stats (:460-468).
        """
        out = {}
        id2name = self._cat_id_to_name()
        per_cat = {}  # mode -> {name: ap}
        for mode in ("2D", "3D"):
            ev = self._reaccumulate(self.dataset_names, mode)
            if ev is None:
                continue
            stats = ev.summarize()
            out.update({f"Concat/{k}": v for k, v in stats.items()})
            tag = "AP2D" if mode == "2D" else "AP3D"
            pc = {}
            for cid, ap in ev.per_category_ap().items():
                name = id2name.get(cid, str(cid))
                pc[name] = ap
                out[f"Concat/{tag}-{name}"] = ap
            per_cat[mode] = pc
        if not per_cat:
            return out

        categories = set(per_cat.get("2D", per_cat.get("3D", {})))

        def mean_over(names, mode):
            vals = [per_cat[mode][n] for n in names]
            return float(np.mean(vals)) if vals else float("nan")

        # Concat headline = mean per-category AP (overrides the raw stat)
        for mode, tag in (("2D", "AP2D"), ("3D", "AP3D")):
            if mode in per_cat:
                out[f"Concat/{tag}"] = mean_over(categories, mode)

        for label, split in (("Omni3D", "omni3d"), ("Omni3D_In", "omni3d_in"),
                             ("Omni3D_Out", "omni3d_out")):
            split_cats = get_omni3d_categories(split)
            covered = not (split_cats - categories)
            for mode, tag in (("2D", "AP2D"), ("3D", "AP3D")):
                if mode not in per_cat:
                    continue
                out[f"{label}/{tag}"] = (
                    mean_over(split_cats, mode) if covered else float("nan")
                )
        return out
