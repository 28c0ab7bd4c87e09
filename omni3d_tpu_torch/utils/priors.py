"""Per-category 3D priors from training annotations (host, numpy).

Port of `omni3d_tpu.utils.priors` (a pandas-free re-implementation of the
reference compute_priors, cubercnn/util/math_util.py:292-496): per-category
dims mean/std, z/y stats, and (when CLUSTER_BINS > 1) a 1-D k-means over 2D
scales with per-bin z stats. `load_priors_` writes the result into the
model's prior buffers, as the JAX package's `create_train_state(priors=)`
writes them into its parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from .geometry import approx_eval_resolution, virtual_scale


def compute_priors(cfg, datasets, category_names, max_cluster_rounds: int = 1000,
                   min_points_for_std: int = 5) -> dict:
    anns = datasets.loadAnns(datasets.getAnnIds())

    virtual_depth = cfg.MODEL.ROI_CUBE_HEAD.VIRTUAL_DEPTH
    virtual_focal = cfg.MODEL.ROI_CUBE_HEAD.VIRTUAL_FOCAL
    test_min = cfg.INPUT.MIN_SIZE_TEST
    test_max = cfg.INPUT.MAX_SIZE_TEST

    rows = {c: [] for c in category_names}
    z_all, y_all = [], []

    for ann in anns:
        name = ann["category_name"].lower()
        if ann.get("ignore", False) or name not in rows:
            continue
        img = datasets.imgs[ann["image_id"]]
        fy = img["K"][1][1]
        im_h, im_w = img["height"], img["width"]

        # 2D box source priority (reference math_util.py:327-337)
        if (cfg.DATASETS.MODAL_2D_BOXES and "bbox2D_tight" in ann
                and ann["bbox2D_tight"][0] != -1):
            x1, y1, x2, y2 = ann["bbox2D_tight"]
        elif (cfg.DATASETS.TRUNC_2D_BOXES and "bbox2D_trunc" in ann
                and not all(v == -1 for v in ann["bbox2D_trunc"])):
            x1, y1, x2, y2 = ann["bbox2D_trunc"]
        elif "bbox2D_proj" in ann:
            x1, y1, x2, y2 = ann["bbox2D_proj"]
        else:
            continue
        w, h = x2 - x1, y2 - y1

        x3d, y3d, z3d = ann["center_cam"]
        w3d, h3d, l3d = ann["dimensions"]

        test_h, _, sf = approx_eval_resolution(im_h, im_w, test_min, test_max)
        w, h = w * sf, h * sf
        if virtual_depth:
            v2r = float(virtual_scale(fy, im_h, virtual_focal, test_h))
            z3d = z3d / v2r
        scale = float(np.sqrt(h**2 + w**2))
        rows[name].append([w, h, y3d, z3d, w3d, h3d, l3d, scale])
        z_all.append(z3d)
        y_all.append(y3d)

    priors_dims, priors_z, priors_y, priors_bins = [], [], [], []
    n_bins = cfg.MODEL.ROI_CUBE_HEAD.CLUSTER_BINS

    for cat in category_names:
        data = np.asarray(rows[cat], np.float64).reshape(-1, 8)
        n = len(data)
        if n > 0:
            dims = data[:, 4:7]
            priors_dims.append([dims.mean(0).tolist(), dims.std(0, ddof=1).tolist()])
            priors_z.append([float(data[:, 3].mean()), float(data[:, 3].std(ddof=1))])
            priors_y.append([float(data[:, 2].mean()), float(data[:, 2].std(ddof=1))])
        else:
            priors_dims.append([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]])
            priors_z.append([50.0, 50.0])
            priors_y.append([1.0, 10.0])

        if n_bins > 1:
            scales = data[:, 7] if n else np.zeros(0)
            if n < min_points_for_std:
                max_s = cfg.MODEL.ANCHOR_GENERATOR.SIZES[-1][-1]
                min_s = cfg.MODEL.ANCHOR_GENERATOR.SIZES[0][0]
                base = (max_s / min_s) ** (1 / (n_bins - 1))
                cluster_scales = [min_s * base**i for i in range(n_bins)]
                bin_z = [[b, 15.0] for b in np.arange(100, 1, -(100 - 1) / n_bins)][:n_bins]
                priors_bins.append((cat, cluster_scales, bin_z))
            else:
                # 1-D k-means seeded geometrically (math_util.py:440-485)
                base = (scales.max() / max(scales.min(), 1e-6)) ** (1 / (n_bins - 1))
                centers = scales.min() * base ** np.arange(n_bins)
                best = -np.inf
                assign = None
                for _ in range(max_cluster_rounds):
                    quality = -np.abs(centers[None, :] - scales[:, None])
                    a = quality.argmax(1)
                    score = quality.max(1).mean()
                    if np.round(score, 5) > best:
                        best = score
                        assign = a
                        new = []
                        for b in range(n_bins):
                            mask = assign == b
                            if mask.sum() < min_points_for_std:
                                top = np.argsort(-quality[:, b])[:min_points_for_std]
                                mask = mask.copy()
                                mask[top] = True
                            new.append(scales[mask].mean())
                        centers = np.asarray(new)
                    else:
                        break
                bin_z = []
                for b in range(n_bins):
                    mask = assign == b
                    if mask.sum() < min_points_for_std:
                        quality = -np.abs(centers[None, :] - scales[:, None])
                        top = np.argsort(-quality[:, b])[:min_points_for_std]
                        mask = mask.copy()
                        mask[top] = True
                    zs = data[mask, 3]
                    bin_z.append([float(zs.mean()), float(zs.std(ddof=1))])
                priors_bins.append((cat, centers.tolist(), bin_z))

    z_all = np.asarray(z_all) if z_all else np.zeros(1)
    y_all = np.asarray(y_all) if y_all else np.zeros(1)
    return {
        "priors_dims_per_cat": priors_dims,
        "priors_z3d_per_cat": priors_z,
        "priors_y3d_per_cat": priors_y,
        "priors_bins": priors_bins,
        "priors_z3d": [float(z_all.mean()), float(z_all.std(ddof=1) if len(z_all) > 1 else 0)],
        "priors_y3d": [float(y_all.mean()), float(y_all.std(ddof=1) if len(y_all) > 1 else 0)],
    }


def priors_to_params(priors: dict, num_classes: int, cluster_bins: int = 1) -> dict:
    """Prior dict -> model prior arrays (reference roi_heads.py:117-143)."""
    out = {"priors_dims_per_cat": np.asarray(priors["priors_dims_per_cat"], np.float32)}
    if cluster_bins > 1 and priors.get("priors_bins"):
        out["priors_z_scales"] = np.asarray(
            [p[1] for p in priors["priors_bins"]], np.float32
        )
        out["priors_z_stats"] = np.asarray(
            [p[2] for p in priors["priors_bins"]], np.float32
        )
    return out


@torch.no_grad()
def load_priors_(model, params: dict) -> None:
    """Write `priors_to_params`' arrays into the model's
    `roi_heads.priors_*` buffers, in place; a buffer without an entry keeps
    its value (omni3d_tpu/engine/train.py:51-62)."""
    heads = model.roi_heads
    for name, value in params.items():
        buf = getattr(heads, name)
        value = torch.as_tensor(np.asarray(value, np.float32))
        if value.shape != buf.shape:
            raise ValueError(f"roi_heads.{name}: priors of shape {tuple(value.shape)}, "
                             f"buffer of shape {tuple(buf.shape)}")
        buf.copy_(value)
