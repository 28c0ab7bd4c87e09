"""Synthetic ground truth, frozen from the draw of
omni3d_tpu_torch/tools/synthetic.py `train_batch` (commit 5a24e3a) and made
on the device from a torch.Generator: GT_SLOTS padded rows per image with
about 30% valid, 2D boxes of 16-120 px inside the image, depths 2-40,
dimensions 0.2-3, identity rotations, classes uniform over the
categories."""
from __future__ import annotations

import torch

GT_SLOTS = 64


def ground_truth(B: int, H: int, W: int, num_classes: int, generator, device) -> dict:
    """GT of B images of H x W network pixels (the draw above)."""
    G = GT_SLOTS

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo

    lim = torch.tensor([W - 132.0, H - 132.0], device=device)
    xy = torch.rand((B, G, 2), generator=generator, device=device) * lim
    wh = uniform((B, G, 2), 16.0, 120.0)
    b3d = torch.cat([xy + wh / 2, uniform((B, G, 1), 2.0, 40.0), uniform((B, G, 3), 0.2, 3.0)], -1)
    return {
        "gt_boxes": torch.cat([xy, xy + wh], -1),
        "gt_classes": torch.randint(0, num_classes, (B, G), generator=generator, device=device,
                                    dtype=torch.int32),
        "gt_valid": torch.rand((B, G), generator=generator, device=device) < 0.3,
        "gt_boxes3D": b3d,
        "gt_poses": torch.eye(3, device=device).expand(B, G, 3, 3).contiguous(),
    }
