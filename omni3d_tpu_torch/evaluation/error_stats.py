"""Per-dataset prediction-vs-GT error statistics (port of
`omni3d_tpu.evaluation.error_stats`; the reference's eval-time error
logging, cubercnn/vis/vis.py:76-196 visualize_from_instances, called from
tools/train_net.py:102-107): match confident predictions to GTs by 2D IoU
and report mean absolute errors of the 3D variables (projected 2D center,
depth, per-axis dimensions, rotation angle); `visualize_from_predictions`
writes the same reference function's sample images (PNG, where the JAX
package writes JPEG).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..data.image import read_image_bgr, write_png
from ..utils.boxes import iou_np
from ..utils.geometry import so3_relative_angle


def compute_error_stats(predictions: list, gts: list, iou_thresh: float = 0.5,
                        score_thresh: float = 0.5, Ks: dict | None = None) -> dict:
    """Args are Omni3DEval-style dict lists (predictions need center_cam /
    dimensions / pose; gts need the matching raw annotation fields).

    Ks: optional {image_id: 3x3 K}. When given, the xy error is measured in
    projected PIXEL space between the prediction's center_2D and the GT
    center projected through K (reference vis.py:131-152,168); without it,
    xy falls back to camera-space meters on center_cam[:2].
    """
    by_img: dict = {}
    for g in gts:
        by_img.setdefault(g["image_id"], []).append(g)

    errs = {"xy": [], "z": [], "w": [], "h": [], "l": [], "whl": [],
            "rot_deg": []}
    n_matched = 0
    for p in predictions:
        if p["score"] < score_thresh:
            continue
        cands = [g for g in by_img.get(p["image_id"], [])
                 if g["category_id"] == p["category_id"] and not g.get("ignore", False)]
        if not cands:
            continue
        pb = np.asarray(p["bbox"], np.float64)
        pb = np.array([[pb[0], pb[1], pb[0] + pb[2], pb[1] + pb[3]]])
        gb = np.array([[g["bbox"][0], g["bbox"][1],
                        g["bbox"][0] + g["bbox"][2], g["bbox"][1] + g["bbox"][3]]
                       for g in cands])
        ious = iou_np(pb, gb)[0]
        j = int(np.argmax(ious))
        if ious[j] < iou_thresh:
            continue
        g = cands[j]
        n_matched += 1
        pc = np.asarray(p["center_cam"], np.float64)
        gc = np.asarray(g["center_cam"], np.float64)
        K = None if Ks is None else Ks.get(p["image_id"])
        if K is not None and "center_2D" in p:
            # projected-pixel center error (reference vis.py:131,148-152,168)
            gcp = np.asarray(K, np.float64) @ gc
            gcp = gcp[:2] / gcp[2]
            errs["xy"].append(float(np.linalg.norm(
                np.asarray(p["center_2D"], np.float64)[:2] - gcp)))
        else:
            errs["xy"].append(float(np.linalg.norm(pc[:2] - gc[:2])))
        errs["z"].append(abs(float(pc[2] - gc[2])))
        pd = np.asarray(p["dimensions"], np.float64)
        gd = np.asarray(g["dimensions"], np.float64)
        for i, k in enumerate(("w", "h", "l")):
            errs[k].append(abs(float(pd[i] - gd[i])))
        errs["whl"].append(float(np.abs(pd - gd).mean()))
        ang = so3_relative_angle(torch.tensor(p["pose"], dtype=torch.float32)[None],
                                 torch.tensor(g["pose"], dtype=torch.float32)[None])
        errs["rot_deg"].append(float(np.degrees(ang.numpy()[0])))

    out = {"n_matched": n_matched}
    for k, v in errs.items():
        out[f"mean_{k}_error"] = float(np.mean(v)) if v else float("nan")
    return out


def error_log_string(dataset_name: str, stats: dict, iteration="final") -> str:
    """Reference-format per-dataset error line (vis.py:185-191); ry reported
    in radians like the reference's raw so3_relative_angle mean."""
    ry_rad = np.radians(stats["mean_rot_deg_error"])
    return ("{} iter={}, xy({:.2f}), z({:.2f}), whl({:.2f}, {:.2f}, {:.2f}), "
            "ry({:.2f})".format(
                dataset_name, iteration,
                stats["mean_xy_error"], stats["mean_z_error"],
                stats["mean_w_error"], stats["mean_h_error"],
                stats["mean_l_error"], ry_rad))


def visualize_from_predictions(predictions: list, gt_api, output_folder: str,
                               thing_classes: list, datasets_root: str = "",
                               every: int = 50, score_thresh: float | None = None,
                               max_images: int = 20) -> int:
    """Write every `every`-th image of `gt_api` with its confident
    detections drawn (3D wireframe, 2D box and label) as
    <output_folder>/vis/<image index:06d>.png (reference
    visualize_from_instances sample dumps, vis.py:96-98,170-181: one sample
    per 50 images, detections above sqrt(1/n_cats), on the ORIGINAL image).
    Image paths are relative to `datasets_root`; images missing on disk are
    skipped. Returns the number of images written."""
    from ..vis.vis import draw_2d_box, draw_3d_box, get_color

    if score_thresh is None:
        score_thresh = float(np.sqrt(1.0 / max(len(thing_classes), 1)))
    by_img: dict = {}
    for p in predictions:
        by_img.setdefault(p["image_id"], []).append(p)
    cat_name = {c["id"]: c["name"] for c in gt_api.dataset.get("categories", [])}

    vis_folder = os.path.join(output_folder, "vis")
    written = 0
    for imind, img in enumerate(gt_api.dataset.get("images", [])):
        if imind % every or written >= max_images:
            continue
        path = img.get("file_path") or img.get("file_name") or ""
        if datasets_root and not os.path.isabs(path):
            path = os.path.join(datasets_root, path)
        if not os.path.isfile(path):
            continue
        im = read_image_bgr(path)
        K = np.asarray(img["K"], np.float64)
        thickness = max(int(round(3 * im.shape[0] / 500)), 1)
        drew = False
        for p in by_img.get(img["id"], []):
            if p["score"] < score_thresh:
                continue
            color = get_color(int(p["category_id"]))
            c, d = p["center_cam"], p["dimensions"]
            draw_3d_box(im, K, [c[0], c[1], c[2], d[0], d[1], d[2]],
                        np.asarray(p["pose"], np.float64), color=color, thickness=thickness)
            label = "{}, z={:.1f}, s={:.2f}".format(
                cat_name.get(p["category_id"], str(p["category_id"])), c[2], p["score"])
            x, y, w, h = p["bbox"]
            draw_2d_box(im, [x, y, x + w, y + h], color=color, thickness=1, label=label)
            drew = True
        if drew:
            os.makedirs(vis_folder, exist_ok=True)
            write_png(os.path.join(vis_folder, f"{imind:06d}.png"), im)
            written += 1
    return written
