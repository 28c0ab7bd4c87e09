"""Per-sample mapping: image IO, resize/flip augmentation, 3D-aware targets.

Port of `omni3d_tpu.data.mapper` (the reference DatasetMapper3D,
cubercnn/data/dataset_mapper.py:17-155), producing padded numpy tensors:

  * ResizeShortestEdge multi-scale (choice) + horizontal flip,
  * projecting the 3D center through K and transforming it with the 2D aug,
  * the mirror fix-up `R <- M1 @ R @ M2` on horizontal flip
    (dataset_mapper.py:63-72,121-128),
  * gt_boxes3D = [u, v, z, w3d, h3d, l3d] at network resolution.

Images are read and resized by `data.image` (no cv2, no PIL): the resize is
PIL's BILINEAR bit for bit, as detectron2's ResizeTransform applies it.

`collate_batch` makes the JAX package's float32 batch; with normalize=False
it ships the padded uint8 images instead (a quarter of the bytes), and
`batch_to_device` normalises them on the device to the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.rcnn3d import preprocess
from .image import read_image_bgr, resize_bilinear_uint8

# pose mirror matrices (reference dataset_mapper.py:63-72)
_M1 = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)
_M2 = np.array([[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]], np.float64)


def resize_shortest_edge(h, w, short, max_size):
    """Target (new_h, new_w) with shortest edge `short`, long edge capped."""
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(round(h * scale)), int(round(w * scale))


class DatasetMapper3D:
    """Callable record -> sample dict of numpy arrays."""

    def __init__(self, cfg, is_train: bool = True, rng: np.random.Generator | None = None):
        self.is_train = is_train
        self.min_sizes = tuple(cfg.INPUT.MIN_SIZE_TRAIN) if is_train else (cfg.INPUT.MIN_SIZE_TEST,)
        self.max_size = cfg.INPUT.MAX_SIZE_TRAIN if is_train else cfg.INPUT.MAX_SIZE_TEST
        self.hflip = is_train and cfg.INPUT.RANDOM_FLIP == "horizontal"
        self.rng = rng or np.random.default_rng()

    def draw_flip(self) -> bool:
        """The flip of one image: draws from `rng` only when flipping is on."""
        return bool(self.hflip and self.rng.random() < 0.5)

    def __call__(self, record: dict, image: np.ndarray | None = None,
                 short: int | None = None, flip: bool | None = None) -> dict:
        """`short` and `flip` drawn by the caller, or here from `rng` when
        None (the short side first, then the flip, as the JAX package
        draws them)."""
        if image is None:
            image = read_image_bgr(record["file_name"])
        orig_h, orig_w = image.shape[:2]

        if short is None:
            short = self.min_sizes[self.rng.integers(len(self.min_sizes))] \
                if self.is_train else self.min_sizes[0]
        net_h, net_w = resize_shortest_edge(orig_h, orig_w, short, self.max_size)
        sx, sy = net_w / orig_w, net_h / orig_h
        image = resize_bilinear_uint8(image, net_w, net_h)

        if flip is None:
            flip = self.draw_flip()
        if flip:
            image = image[:, ::-1]

        out = {
            "image": np.ascontiguousarray(image),
            "height": orig_h,
            "width": orig_w,
            "net_h": net_h,
            "net_w": net_w,
            "K": np.asarray(record["K"], np.float64),
            "image_id": record.get("image_id", -1),
            "dataset_id": record.get("dataset_id", -1),
        }
        if not self.is_train:
            return out

        K = np.asarray(record["K"], np.float64)
        boxes, classes, boxes3d, poses = [], [], [], []
        for anno in record.get("annotations", []):
            x1, y1, x2, y2 = anno["bbox"]
            bx = [x1 * sx, y1 * sy, x2 * sx, y2 * sy]
            if flip:
                bx = [net_w - bx[2], bx[1], net_w - bx[0], bx[3]]

            cx, cy, cz = anno["center_cam"]
            if cz != 0:
                p = K @ np.array([cx, cy, cz])
                u, v = p[0] / p[2], p[1] / p[2]
            else:
                u = v = 0.0
            u, v = u * sx, v * sy
            if flip:
                u = net_w - u

            R = np.asarray(anno["pose"], np.float64)
            if flip:
                R = _M1 @ R @ _M2

            # drop boxes that became empty under the transforms
            if bx[2] - bx[0] <= 0 or bx[3] - bx[1] <= 0:
                continue
            boxes.append(bx)
            classes.append(anno["category_id"])
            w3d, h3d, l3d = anno["dimensions"]
            boxes3d.append([u, v, cz, w3d, h3d, l3d])
            poses.append(R)

        n = len(boxes)
        out["gt_boxes"] = np.asarray(boxes, np.float32).reshape(n, 4)
        out["gt_classes"] = np.asarray(classes, np.int32).reshape(n)
        out["gt_boxes3D"] = np.asarray(boxes3d, np.float32).reshape(n, 6)
        out["gt_poses"] = np.asarray(poses, np.float32).reshape(n, 3, 3)
        return out


def pad_to_bucket(h: int, w: int, multiple: int = 128) -> tuple[int, int]:
    """Snap the padded shape up to a multiple, bounding the distinct batch
    shapes across the 25 training scales."""
    return (-(-h // multiple) * multiple, -(-w // multiple) * multiple)


def collate_batch(samples: list, pixel_mean, pixel_std, max_gt: int = 128,
                  pad_multiple: int = 128, pad_shape=None, normalize: bool = True) -> dict:
    """Samples -> one padded batch of numpy arrays (images padded to a
    shared shape, GT padded to max_gt rows with a gt_valid mask).
    `pad_shape` pins the padded (H, W) to a precomputed bucket
    (data/build.py shape bucketing).

    normalize=True: float32 images, (x - mean) / std, 0 in the padding (the
    JAX package's batch). normalize=False: the uint8 images, 0 in the
    padding; `batch_to_device` turns them into the same float32 values.
    """
    B = len(samples)
    hb = max(s["net_h"] for s in samples)
    wb = max(s["net_w"] for s in samples)
    Hp, Wp = pad_shape or pad_to_bucket(hb, wb, pad_multiple)
    assert Hp >= hb and Wp >= wb, (
        f"bucket {pad_shape} smaller than batch extent {(hb, wb)}")

    mean = np.asarray(pixel_mean, np.float32)
    std = np.asarray(pixel_std, np.float32)

    images = np.zeros((B, Hp, Wp, 3), np.float32 if normalize else np.uint8)
    hw = np.zeros((B, 2), np.float32)
    Ks = np.zeros((B, 3, 3), np.float32)
    ratios = np.zeros(B, np.float32)
    train = "gt_boxes" in samples[0]
    if train:
        gt_boxes = np.zeros((B, max_gt, 4), np.float32)
        gt_classes = np.zeros((B, max_gt), np.int32)
        gt_valid = np.zeros((B, max_gt), bool)
        gt_boxes3d = np.zeros((B, max_gt, 6), np.float32)
        gt_poses = np.tile(np.eye(3, dtype=np.float32), (B, max_gt, 1, 1))

    for i, s in enumerate(samples):
        h, w = s["net_h"], s["net_w"]
        if normalize:
            images[i, :h, :w] = (s["image"].astype(np.float32) - mean) / std
        else:
            images[i, :h, :w] = s["image"]
        hw[i] = (h, w)
        Ks[i] = s["K"]
        ratios[i] = s["height"] / h
        if train:
            n = min(len(s["gt_boxes"]), max_gt)
            gt_boxes[i, :n] = s["gt_boxes"][:n]
            gt_classes[i, :n] = s["gt_classes"][:n]
            gt_valid[i, :n] = True
            gt_boxes3d[i, :n] = s["gt_boxes3D"][:n]
            gt_poses[i, :n] = s["gt_poses"][:n]

    batch = {
        "images": images,
        "hw": hw,
        "Ks": Ks,
        "ratios": ratios,
        "image_ids": np.asarray([s["image_id"] for s in samples], np.int64),
        "heights": np.asarray([s["height"] for s in samples], np.int64),
        "widths": np.asarray([s["width"] for s in samples], np.int64),
    }
    if train:
        batch.update(
            gt_boxes=gt_boxes, gt_classes=gt_classes, gt_valid=gt_valid,
            gt_boxes3D=gt_boxes3d, gt_poses=gt_poses,
        )
    return batch


def batch_to_device(batch: dict, device, pixel_mean=None, pixel_std=None) -> dict:
    """A collated numpy batch as tensors on `device`. uint8 images (from
    collate_batch(normalize=False)) are copied as uint8 (pinned and
    non-blocking to a CUDA device) and normalised there, tensor by tensor
    as `models.rcnn3d.preprocess` does, with every pixel outside each
    image's `hw` set to 0 (the JAX package pads after normalising):
    bit-equal to the float32 batch of collate_batch(normalize=True)."""
    device = torch.device(device)
    pin = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if pin:
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=pin)
    images = out["images"]
    if images.dtype == torch.uint8:
        _, H, W, _ = images.shape
        hw = out["hw"]
        rows = torch.arange(H, device=device, dtype=torch.float32)
        cols = torch.arange(W, device=device, dtype=torch.float32)
        inside = ((rows[None, :, None] < hw[:, 0, None, None])
                  & (cols[None, None, :] < hw[:, 1, None, None]))
        out["images"] = torch.where(inside[..., None], preprocess(images, pixel_mean, pixel_std),
                                    torch.zeros((), device=device))
    return out
