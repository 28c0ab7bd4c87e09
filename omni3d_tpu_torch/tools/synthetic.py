"""Synthetic training batches made from a seed (nothing is downloaded)."""
from __future__ import annotations

import numpy as np
import torch

from ..models.rcnn3d import preprocess

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
