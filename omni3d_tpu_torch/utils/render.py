"""Cuboid z-buffer rasterizer and the visibility / truncation estimators
(port of `omni3d_tpu.utils.render`; reference cubercnn/util/math_util.py:
707-758 render_depth_map / estimate_visibility / estimate_truncation).

`render_depth_map` projects the 12 triangles of each cuboid on the host
(float32 numpy, with the fused multiply-adds XLA's CPU backend uses for the
JAX package's einsums: the same vertices and projections), then runs the
JAX package's barycentric inside test and perspective-correct depth
against every pixel centre in torch on an explicit device (the CUDA card by
default), over chunks of pixels sized so that each (triangles x pixels)
temporary holds at most CHUNK_ELEMENTS floats (32 MiB) whatever the number
of boxes (100 boxes on 640 x 480 would be 1.5 GB each at once). The
per-pixel arithmetic does not depend on the chunking, and it is written as
separate elementwise operations, so the card and the CPU round alike and
give the same silhouettes and nearest-instance indices.
"""
from __future__ import annotations

import numpy as np
import torch

from . import geometry as G
from .boxes import iou_np

CHUNK_ELEMENTS = 1 << 23


def render_depth_map(K, boxes3d, poses, width: int, height: int, device="cuda"):
    """Per-instance silhouettes and the joint depth map.

    Args:
      K: (3, 3) intrinsics; boxes3d: (N, 6) [x, y, z, w, h, l]; poses:
        (N, 3, 3); arrays (or CPU tensors), projected in float32 on the
        host, rasterised on `device`.
    Returns (on `device`):
      silhouettes (N, H, W) bool, depth_map (H, W) float32 (inf = empty),
      depth_inds (H, W) int32, the nearest instance per pixel (the
      reference's zbuf argmin, math_util.py:722-726; 0 where empty).
    """
    device = torch.device(device)
    f32 = dict(dtype=torch.float32, device=device)
    boxes3d = np.asarray(boxes3d, np.float32).reshape(-1, 6)
    K = np.asarray(K, np.float32)
    N = boxes3d.shape[0]
    tris = G.cuboid_verts_np(boxes3d, np.asarray(poses, np.float32).reshape(-1, 3, 3))[
        :, np.asarray(G.CUBOID_FACES)].reshape(N * 12, 3, 3)
    X, Y, Z = tris[..., 0], tris[..., 1], tris[..., 2]
    proj = [G.fma32(K[i, 2], Z, G.fma32(K[i, 1], Y, K[i, 0] * X)) for i in range(3)]
    z = proj[2]
    zs = np.where(np.abs(z) < 1e-8, np.where(z < 0, np.float32(-1e-8), np.float32(1e-8)), z)
    u, v = (torch.as_tensor(p / zs, **f32) for p in proj[:2])              # (T, 3)
    zc = torch.as_tensor(np.maximum(z, np.float32(1e-6)), **f32)
    inv = [1.0 / zc[:, k:k + 1] for k in range(3)]
    front = (zc > 1e-5).all(1)[:, None]
    a, b, c = (u[:, 0:1], v[:, 0:1]), (u[:, 1:2], v[:, 1:2]), (u[:, 2:3], v[:, 2:3])

    P = width * height
    pixels_per_chunk = max(1, CHUNK_ELEMENTS // (N * 12))
    depth_map = torch.empty(P, **f32)
    inds = torch.empty(P, dtype=torch.int64, device=device)
    sil = torch.empty((N, P), dtype=torch.bool, device=device)
    for s in range(0, P, pixels_per_chunk):
        idx = torch.arange(s, min(s + pixels_per_chunk, P), device=device)
        px = ((idx % width).to(torch.float32) + 0.5)[None]
        py = ((idx // width).to(torch.float32) + 0.5)[None]

        def edge(p0, p1):
            return (p1[0] - p0[0]) * (py - p0[1]) - (p1[1] - p0[1]) * (px - p0[0])

        w0, w1, w2 = edge(b, c), edge(c, a), edge(a, b)
        area = w0 + w1 + w2            # 2 x the signed triangle area, per pixel
        inside = (((w0 >= 0) & (w1 >= 0) & (w2 >= 0))
                  | ((w0 <= 0) & (w1 <= 0) & (w2 <= 0)))
        safe = torch.where(area.abs() < 1e-9, torch.full_like(area, 1e-9), area)
        inv_z = w0 / safe * inv[0] + w1 / safe * inv[1] + w2 / safe * inv[2]
        depth = 1.0 / torch.clamp(inv_z, min=1e-9)
        depth = torch.where(inside & front, depth, torch.full_like(depth, float("inf")))
        inst = depth.reshape(N, 12, -1).amin(1)                            # (N, chunk)
        sil[:, s:s + idx.numel()] = torch.isfinite(inst)
        depth_map[s:s + idx.numel()] = inst.amin(0)
        inds[s:s + idx.numel()] = inst.argmin(0)
    return (sil.reshape(N, height, width), depth_map.reshape(height, width),
            inds.to(torch.int32).reshape(height, width))


def estimate_visibility(K, boxes3d, poses, width: int, height: int, device="cuda"):
    """Fraction of each instance's silhouette it wins in the z-buffer
    (reference math_util.py:728-743)."""
    sil, _, inds = render_depth_map(K, boxes3d, poses, width, height, device)
    sil, inds = sil.cpu().numpy(), inds.cpu().numpy()
    out = []
    for i in range(sil.shape[0]):
        area = sil[i].sum()
        visible = ((inds == i) & sil[i]).sum()
        out.append(float(visible / area) if area > 0 else 0.0)
    return out


def estimate_truncation(K, box3d, R, imW: int, imH: int) -> float:
    """1 - IoA of the projected box with the image window (reference
    math_util.py:745-758); host float32 projection."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
    box2d, _, fully_behind = G.box3d_to_box2d(t(K), t(box3d), t(R), clipw=imW, cliph=imH,
                                              xywh=False)
    if bool(fully_behind):
        return 1.0
    image_box = np.array([[0, 0, imW - 1, imH - 1]], np.float64)
    iou = iou_np(box2d.numpy().astype(np.float64)[None], image_box, ign_area_b=True)
    return float(1.0 - iou[0, 0])
