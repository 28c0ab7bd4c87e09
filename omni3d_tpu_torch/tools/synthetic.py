"""Synthetic training data made from a seed (nothing is downloaded): padded
training batches, and Omni3D-format datasets on disk (jsons, stats.json and
PPM / PNG images) that `tools.train_net` reads."""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..data.builtin import get_omni3d_categories
from ..data.image import write_png, write_ppm
from ..models.rcnn3d import preprocess
from ..utils.geometry import cuboid_verts

OMNI3D_CATEGORIES = tuple(sorted(get_omni3d_categories("omni3d")))

GT_SLOTS = 64   # padded GT rows per image


def train_batch(cfg, bs: int, device, img: int = 512, seed: int = 0) -> dict:
    """A training batch shaped as the JAX package's training bench makes
    them (tools/bench_train.py:34-57): random BGR images at `img` px,
    GT_SLOTS padded GT rows per image with about 30% valid, boxes of 16-120
    px, depths 2-40, unit rotations, one pinhole intrinsic."""
    rng = np.random.default_rng(seed)
    G = GT_SLOTS
    raw = torch.from_numpy(rng.integers(0, 255, (bs, img, img, 3), dtype=np.uint8))
    lim = img - 132
    xy = rng.uniform(0, lim, (bs, G, 2)).astype(np.float32)
    wh = rng.uniform(16, 120, (bs, G, 2)).astype(np.float32)
    b3d = np.concatenate([xy + wh / 2, rng.uniform(2, 40, (bs, G, 1)),
                          rng.uniform(0.2, 3, (bs, G, 3))], -1).astype(np.float32)
    K = torch.tensor([[500.0, 0, img / 2], [0, 500.0, img / 2], [0, 0, 1]])
    batch = {
        "images": preprocess(raw.to(device), cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD),
        "Ks": K.expand(bs, 3, 3).contiguous(),
        "ratios": torch.ones(bs),
        "hw": torch.full((bs, 2), float(img)),
        "gt_boxes": torch.from_numpy(np.concatenate([xy, xy + wh], -1)),
        "gt_classes": torch.from_numpy(
            rng.integers(0, cfg.MODEL.ROI_HEADS.NUM_CLASSES, (bs, G)).astype(np.int32)),
        "gt_valid": torch.from_numpy(rng.random((bs, G)) < 0.3),
        "gt_boxes3D": torch.from_numpy(b3d),
        "gt_poses": torch.eye(3).expand(bs, G, 3, 3).contiguous(),
    }
    return {k: v.to(device) for k, v in batch.items()}


def condition_pose_bias_(model) -> None:
    """Set the cube head's 6D pose bias to the identity rotation. Random
    weights leave some RoIs with all-zero head features; with the init's
    zero bias their 6D pose is 0 / 1e-12 and its gradient ~1e8, which blows
    up the first steps of a run from random weights. Trained weights do not
    need this."""
    pose = model.roi_heads.cube_head.bbox_3D_pose
    with torch.no_grad():
        pose.bias.copy_(torch.tensor([1.0, 0, 0, 0, 1, 0]).repeat(pose.bias.numel() // 6))


def synthetic_trainer(cfg, dtype: torch.dtype, bs: int, device, img: int = 512, seed: int = 0):
    """The training setup that `chip_smoke.py` and `tools/profile_train.py`
    drive: a train-mode model with seeded random weights (f32 parameters,
    `dtype` compute, pose bias at the identity), the config's optimizer and
    LR schedule, the stabilized train step and one synthetic batch.
    Returns (model, optimizer, step, batch)."""
    from ..engine.train import make_train_step
    from ..models.rcnn3d import build_model
    from ..solver.build import build_lr_schedule, build_optimizer
    model = build_model(cfg, device=device, dtype=dtype, seed=seed, train=True)
    condition_pose_bias_(model)
    opt = build_optimizer(cfg, model)
    step = make_train_step(cfg, model, opt, build_lr_schedule(cfg, opt))
    return model, opt, step, train_batch(cfg, bs, device, img=img, seed=seed)


def write_omni3d_stats(root: str, categories=OMNI3D_CATEGORIES) -> str:
    """<root>/Omni3D/stats.json: the category names and ids (id = index in
    `categories`), which `register_and_store_model_metadata` reads."""
    os.makedirs(os.path.join(root, "Omni3D"), exist_ok=True)
    cats = [{"id": i, "name": c, "supercategory": ""} for i, c in enumerate(categories)]
    path = os.path.join(root, "Omni3D", "stats.json")
    with open(path, "w") as f:
        json.dump({"category_names": list(categories), "categories": cats}, f)
    return path


def write_omni3d_dataset(root: str, name: str, n_images: int, height: int, width: int,
                         image_format: str = "ppm", seed: int = 0, dataset_id: int = 0,
                         focal: float | None = None, objects=(1, 20),
                         categories=OMNI3D_CATEGORIES) -> str:
    """Write <root>/Omni3D/<name>.json and its images under <root>/<name>/
    (PPM, or PNG whose rows cycle through the five PNG filters); returns
    the json's path.

    Each image has one pinhole K (focal `focal`, default the image height,
    principal point at the centre) and objects[0]..objects[1] cuboids of
    random categories (ids as `write_omni3d_stats` numbers them) with
    category-typical dimensions, yaw rotations and depths that keep the
    projected box at least 8% of the image height. The 2D boxes are the
    cuboids' projections through K clipped to the image, as
    tests/fixtures.py makes them, so the annotations pass the configs'
    filters."""
    rng = np.random.default_rng(seed)
    f = float(focal or height)
    K = [[f, 0.0, width / 2], [0.0, f, height / 2], [0.0, 0.0, 1.0]]
    Kn = np.asarray(K)
    # a dimension prior per category (w, h, l in metres), fixed by its name
    base = {c: np.exp(np.random.default_rng(sum(map(ord, c))).normal(-0.2, 0.5, 3))
            for c in categories}
    ids = {c: OMNI3D_CATEGORIES.index(c) if c in OMNI3D_CATEGORIES else i
           for i, c in enumerate(categories)}
    img_dir = os.path.join(root, name)
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    for i in range(n_images):
        file_path = f"{name}/{i:05d}.{image_format}"
        pixels = rng.integers(0, 256, (height, width, 3), np.uint8)
        if image_format == "png":
            write_png(os.path.join(root, file_path), pixels, filters=(0, 1, 2, 3, 4))
        else:
            write_ppm(os.path.join(root, file_path), pixels)
        img_id = dataset_id * 1_000_000 + i
        images.append({"id": img_id, "dataset_id": dataset_id, "width": width,
                       "height": height, "file_path": file_path, "K": K,
                       "src_90_rotate": 0, "src_flagged": 0})
        for _ in range(int(rng.integers(objects[0], objects[1] + 1))):
            cat = categories[int(rng.integers(len(categories)))]
            w3d, h3d, l3d = (base[cat] * rng.uniform(0.8, 1.2, 3)).tolist()
            z_far = f * h3d / (0.08 * height)
            z = float(rng.uniform(min(1.0 + l3d, z_far), z_far))
            u, v = rng.uniform(0.15, 0.85) * width, rng.uniform(0.25, 0.75) * height
            center = [(u - width / 2) * z / f, (v - height / 2) * z / f, z]
            yaw = float(rng.uniform(-np.pi, np.pi))
            R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                          [-np.sin(yaw), 0, np.cos(yaw)]])
            verts = cuboid_verts(torch.tensor([*center, w3d, h3d, l3d], dtype=torch.float64),
                                 torch.from_numpy(R)).numpy()
            proj = verts @ Kn.T
            uv = proj[:, :2] / proj[:, 2:3]
            x1, y1 = np.clip(uv.min(0), 0, [width - 1, height - 1]).tolist()
            x2, y2 = np.clip(uv.max(0), 0, [width - 1, height - 1]).tolist()
            annotations.append({
                "id": len(annotations) + 1 + dataset_id * 100_000_000, "image_id": img_id,
                "dataset_id": dataset_id, "category_id": ids[cat], "category_name": cat,
                "valid3D": True, "behind_camera": False,
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "bbox2D_proj": [x1, y1, x2, y2], "bbox2D_trunc": [x1, y1, x2, y2],
                "bbox2D_tight": [-1, -1, -1, -1], "bbox3D_cam": verts.tolist(),
                "center_cam": center, "dimensions": [w3d, h3d, l3d],
                "pose": R.tolist(), "R_cam": R.tolist(),
                "truncation": 0.0, "visibility": 1.0, "segmentation_pts": 100,
                "lidar_pts": 100, "depth_error": 0.0,
            })
    data = {
        "info": {"id": dataset_id, "source": name.split("_")[0], "name": name,
                 "split": name.split("_")[-1], "version": "0.1", "url": ""},
        "images": images,
        "categories": [{"id": ids[c], "name": c, "supercategory": ""} for c in categories],
        "annotations": annotations,
    }
    os.makedirs(os.path.join(root, "Omni3D"), exist_ok=True)
    path = os.path.join(root, "Omni3D", f"{name}.json")
    with open(path, "w") as fh:
        json.dump(data, fh)
    return path
