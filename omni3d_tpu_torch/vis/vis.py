"""Visualization: 2D boxes, 3D wireframes, shaded scene renders, BEV (host
numpy; port of `omni3d_tpu.vis.vis`).

The reference visualization (cubercnn/vis/vis.py): `draw_3d_box` wireframes
with near-plane clipping (:571-645), `draw_scene_view` front + auto-zoom
novel top-down view with ground grid (:210-538), `draw_bev` (:26-55), and
the flat-shaded z-buffer rasterizer `rasterize_cuboids` that stands in for
pytorch3d's mesh renderer. The JAX package draws with cv2; the port draws
with `vis.draw` (lines, rectangles and polygons as cv2 draws them; text in
the port's own bitmap font, where cv2 uses its Hershey font with
anti-aliasing). Cuboid vertices come from the port's
`utils.geometry.cuboid_verts_np`, equal to the JAX package's.
"""
from __future__ import annotations

import numpy as np

from ..utils import geometry as G
from . import draw

# edges of the canonical cuboid (pairs of vertex indices)
_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def get_color(idx: int) -> tuple:
    """Deterministic distinct colors (reference util.get_color equivalent)."""
    rng = np.random.default_rng(idx * 9781 + 3)
    return tuple(int(v) for v in rng.integers(60, 255, 3))


def _project_clip_segment(K, p0, p1, min_z=0.05):
    """Clip a 3D segment against z=min_z then project; returns None if fully
    behind (reference draw_3d_box clipping, vis.py:571-645)."""
    z0, z1 = p0[2], p1[2]
    if z0 < min_z and z1 < min_z:
        return None
    if z0 < min_z or z1 < min_z:
        t = (min_z - z0) / (z1 - z0)
        pc = p0 + t * (p1 - p0)
        if z0 < min_z:
            p0 = pc
        else:
            p1 = pc
    a = K @ p0
    b = K @ p1
    return (a[:2] / a[2]).astype(int), (b[:2] / b[2]).astype(int)


def draw_3d_box(image, K, box3d, R=None, color=(0, 200, 255), thickness=2):
    """Draw a cuboid wireframe; box3d [x,y,z,w,h,l] + rotation."""
    verts = G.cuboid_verts_np(box3d, np.eye(3) if R is None else R)
    K = np.asarray(K, np.float64)
    for i, j in _EDGES:
        seg = _project_clip_segment(K, verts[i].astype(np.float64), verts[j].astype(np.float64))
        if seg is None:
            continue
        draw.line(image, tuple(seg[0]), tuple(seg[1]), color, thickness)
    return image


def draw_2d_box(image, box, color=(0, 255, 0), thickness=2, label=None):
    x1, y1, x2, y2 = [int(v) for v in box]
    draw.rectangle(image, (x1, y1), (x2, y2), color, thickness)
    if label:
        draw.put_text(image, label, (x1, max(y1 - 4, 10)), 0.4, color, 1)
    return image


def draw_scene_view(image, K, centers, dims, poses, labels=None, colors=None,
                    thickness=2):
    """Front-view wireframe overlay of detections sorted far-to-near."""
    img = image.copy()
    n = len(centers)
    order = np.argsort([-c[2] for c in centers])
    for rank, i in enumerate(order):
        color = colors[i] if colors is not None else get_color(int(i))
        box3d = list(centers[i]) + list(dims[i])
        draw_3d_box(img, K, box3d, poses[i], color, thickness)
        if labels is not None:
            p = np.asarray(K) @ np.asarray(centers[i], np.float64)
            if p[2] > 0.05:
                draw.put_text(img, str(labels[i]), (int(p[0] / p[2]), int(p[1] / p[2])),
                              0.5, color, 1)
    return img


def visualize_training_sample(batch, det, pixel_mean, pixel_std, thing_classes,
                              max_vis: int = 20, score_thresh: float = 0.25):
    """GT-vs-prediction panels for one training image (host side).

    Reimplements the reference's training-time visualization
    (meta_arch/rcnn3d.py:114-245): a 2D panel (GT boxes | predicted boxes,
    standing in for RPN proposals) and a 3D panel (GT cuboids | predicted
    cuboids). `batch` is the collated training batch (numpy), `det` the
    inference outputs for image 0. Returns {"2d": img, "3d": img} in RGB.

    Unlike the reference (which pulls proposals/instances out of the
    training-mode forward), predictions come from a separate eval-mode
    inference pass — the jitted train step only returns losses.
    """
    h, w = (int(v) for v in batch["hw"][0])
    mean = np.asarray(pixel_mean, np.float32)
    std = np.asarray(pixel_std, np.float32)
    img = np.clip(batch["images"][0, :h, :w] * std + mean, 0, 255).astype(np.uint8)
    img = np.ascontiguousarray(img[..., ::-1])  # stored BGR-normalized -> RGB

    ratio = float(batch["ratios"][0])
    K_net = np.asarray(batch["Ks"][0], np.float64) / ratio
    K_net[2, 2] = 1.0
    fx, sx = K_net[0, 0], K_net[0, 2]
    fy, sy = K_net[1, 1], K_net[1, 2]

    # ---- GT: back-project (u, v, z) to camera XYZ (rcnn3d.py:188-199) ----
    gvalid = batch["gt_valid"][0].astype(bool)
    g3d = batch["gt_boxes3D"][0][gvalid]
    gz = g3d[:, 2]
    gt_centers = np.stack([gz * (g3d[:, 0] - sx) / fx,
                           gz * (g3d[:, 1] - sy) / fy, gz], axis=1)
    gt_dims = g3d[:, 3:6]
    gt_poses = batch["gt_poses"][0][gvalid]
    gt_classes = batch["gt_classes"][0][gvalid]
    gt_labels = [thing_classes[int(c)] if 0 <= int(c) < len(thing_classes)
                 else str(int(c)) for c in gt_classes]

    # ---- predictions: top-scoring valid detections ----
    keep = np.asarray(det["valid"], bool) & (np.asarray(det["scores"]) > score_thresh)
    order = np.argsort(-np.asarray(det["scores"]))[:max_vis]
    order = order[keep[order]]
    pr_centers = np.asarray(det["center_cam"])[order]
    pr_dims = np.asarray(det["dims"])[order]
    pr_poses = np.asarray(det["pose"])[order]
    pr_labels = [
        f"{thing_classes[int(c)] if 0 <= int(c) < len(thing_classes) else int(c)}"
        f" {s:.2f}"
        for c, s in zip(np.asarray(det["classes"])[order],
                        np.asarray(det["scores"])[order])
    ]

    img_gt2d = img.copy()
    for b in batch["gt_boxes"][0][gvalid]:
        draw_2d_box(img_gt2d, b, color=(0, 255, 0))
    img_pr2d = img.copy()
    for b in np.asarray(det["boxes"])[order]:
        draw_2d_box(img_pr2d, b, color=(0, 200, 255))
    vis2d = np.concatenate([img_gt2d, img_pr2d], axis=1)

    img_gt3d = draw_scene_view(img, K_net, gt_centers, gt_dims, gt_poses,
                               labels=gt_labels)
    img_pr3d = draw_scene_view(img, K_net, pr_centers, pr_dims, pr_poses,
                               labels=pr_labels)
    vis3d = np.concatenate([img_gt3d, img_pr3d], axis=1)
    return {"2d": vis2d, "3d": vis3d}


def _cuboid_verts_np(centers, dims, poses):
    """(N, 8, 3) cuboid vertices in camera space (host numpy)."""
    boxes = np.concatenate([np.asarray(centers, np.float32).reshape(-1, 3),
                            np.asarray(dims, np.float32).reshape(-1, 3)], axis=1)
    R = np.asarray(poses, np.float32).reshape(-1, 3, 3)
    return G.cuboid_verts_np(boxes, R).astype(np.float64)


def rasterize_cuboids(K, verts_all, colors, width, height, zplane=0.05):
    """Flat-shaded z-buffer raster of cuboid meshes (host numpy).

    Stands in for the reference's pytorch3d SoftPhong renderer
    (reference vis.py:262-287, util get_basic_renderer). Per-triangle
    bounding-box scanline with perspective-correct depth; diffuse-ish
    shading from the face normal vs the viewing ray.

    Returns (img float64 (H, W, 3) BGR, sil bool (H, W)).
    """
    K = np.asarray(K, np.float64)
    img = np.zeros((height, width, 3), np.float64)
    zbuf = np.full((height, width), np.inf)
    for n, verts in enumerate(np.asarray(verts_all, np.float64)):
        color = np.asarray(colors[n], np.float64)
        tris = verts[np.asarray(G.CUBOID_FACES)]  # (12, 3, 3)
        for tri in tris:
            z = tri[:, 2]
            if (z < zplane).any():
                continue  # edges handle near-plane clipping visually
            uvw = (K @ tri.T).T
            uv = uvw[:, :2] / z[:, None]
            x0 = max(int(np.floor(uv[:, 0].min())), 0)
            x1 = min(int(np.ceil(uv[:, 0].max())) + 1, width)
            y0 = max(int(np.floor(uv[:, 1].min())), 0)
            y1 = min(int(np.ceil(uv[:, 1].max())) + 1, height)
            if x0 >= x1 or y0 >= y1:
                continue
            px, py = np.meshgrid(np.arange(x0, x1) + 0.5, np.arange(y0, y1) + 0.5)
            a, b, c = uv

            def edge(p0, p1):
                return ((p1[0] - p0[0]) * (py - p0[1])
                        - (p1[1] - p0[1]) * (px - p0[0]))

            w0, w1, w2 = edge(b, c), edge(c, a), edge(a, b)
            area = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
            if abs(area) < 1e-9:
                continue
            inside = (((w0 >= 0) & (w1 >= 0) & (w2 >= 0))
                      if area > 0 else ((w0 <= 0) & (w1 <= 0) & (w2 <= 0)))
            if not inside.any():
                continue
            l0, l1, l2 = w0 / area, w1 / area, w2 / area
            inv_z = l0 / z[0] + l1 / z[1] + l2 / z[2]
            depth = 1.0 / np.maximum(inv_z, 1e-9)
            # flat shading: face normal vs ray to the triangle centroid
            nrm = np.cross(tri[1] - tri[0], tri[2] - tri[0])
            nn = np.linalg.norm(nrm)
            view = tri.mean(0)
            vn = np.linalg.norm(view)
            shade = 0.45 + 0.55 * abs(nrm @ view) / max(nn * vn, 1e-9)
            win = inside & (depth < zbuf[y0:y1, x0:x1])
            zbuf[y0:y1, x0:x1][win] = depth[win]
            img[y0:y1, x0:x1][win] = color * shade
    return img, np.isfinite(zbuf)


def _draw_verts_wireframe(image, K, verts, color, thickness=2, min_z=0.05):
    K = np.asarray(K, np.float64)
    for i, j in _EDGES:
        seg = _project_clip_segment(K, verts[i], verts[j], min_z)
        if seg is not None:
            draw.line(image, tuple(seg[0]), tuple(seg[1]), color, thickness)


def render_scene_view(image, K, centers, dims, poses, colors=None, labels=None,
                      mode="front_and_novel", scale=512, view_R=None,
                      view_T=None, zoom_factor=1.0, blend_weight=0.80,
                      ground_bounds=None, zplane=0.05):
    """Full scene render: shaded front view and/or auto-zoom novel view.

    Reference-equivalent of draw_scene_view (vis.py:210-538): the front view
    blends the shaded cuboids over the RGB (blend_weight, :277-284) and
    overlays wireframe edges; the novel view tilts the scene by `view_R`
    (default rot_x(pi/3), :234) about the scene-bbox center (:330-334),
    auto-zooms until every vertex is in frame (:350-381), and composites the
    render over a 1 m ground grid at the scene's max-y plane (:395-489).

    Returns {"front": img?, "novel": img?} (BGR uint8) per `mode`.
    """
    n = len(centers)
    if n == 0:
        out = {}
        if mode in ("front", "front_and_novel"):
            out["front"] = image.copy()
        if mode in ("novel", "front_and_novel"):
            out["novel"] = np.full((scale, scale, 3), 225, np.uint8)
        return out
    if colors is None:
        colors = [get_color(i) for i in range(n)]
    verts_all = _cuboid_verts_np(centers, dims, poses)  # (N, 8, 3)
    thick = max(2, int(round(3 * image.shape[0] / 1250)))
    out = {}

    if mode in ("front", "front_and_novel"):
        h, w = image.shape[:2]
        render, sil = rasterize_cuboids(K, verts_all, colors, w, h, zplane)
        front = image.astype(np.float64).copy()
        front[sil] = (render[sil] * blend_weight
                      + front[sil] * (1 - blend_weight))
        front = front.astype(np.uint8)
        order = np.argsort(-verts_all.mean(1)[:, 2])
        for i in order:
            _draw_verts_wireframe(front, K, verts_all[i], colors[i], thick, zplane)
            if labels is not None:
                uvw = np.asarray(K, np.float64) @ verts_all[i].T
                vis_pts = uvw[:, uvw[2] > zplane]
                if vis_pts.size:
                    uv = vis_pts[:2] / vis_pts[2]
                    draw.put_text(front, str(labels[i]),
                                  (int(uv[0].min()), max(int(uv[1].min()), 12)),
                                  0.5 * image.shape[0] / 500, colors[i], 1)
        out["front"] = front

    if mode in ("novel", "front_and_novel"):
        all_verts = verts_all.reshape(-1, 3)
        if view_R is None:
            a = np.pi / 3  # tilt down 60 deg (reference default, vis.py:234)
            view_R = np.array([[1, 0, 0],
                               [0, np.cos(a), -np.sin(a)],
                               [0, np.sin(a), np.cos(a)]])
        if view_T is None:
            center = (all_verts.min(0) + all_verts.max(0)) / 2
        else:
            center = np.asarray(view_T, np.float64)
        verts_rot = (view_R @ (verts_all - center).reshape(-1, 3).T).T.reshape(
            verts_all.shape)
        h, w = image.shape[:2]
        K_nv = np.asarray(K, np.float64).copy()
        K_nv[0, 2] *= scale / w
        K_nv[1, 2] *= scale / h

        # auto-zoom (reference vis.py:350-381): shrink the dolly-out until a
        # vertex would leave the margin or come closer than 0.25 m
        margin = 0.01
        if view_T is None:
            zoom = 100.0
            z_in = zoom
            flat = verts_rot.reshape(-1, 3)
            for _ in range(10000):
                z_in *= 0.95
                zs = flat[:, 2] + center[2] * z_in
                if (zs < 0.25).any():
                    break
                proj = (K_nv @ np.c_[flat[:, :2], zs].T) / zs
                if (proj[:2] < scale * margin).any() or \
                        (proj[:2] > scale * (1 - margin)).any():
                    break
                zoom = z_in
            zoom_bias = center[2]
        else:
            zoom, zoom_bias = zoom_factor, 1.0
        verts_nv = verts_rot.copy()
        verts_nv[:, :, 2] += zoom_bias * zoom

        render, sil = rasterize_cuboids(K_nv, verts_nv, colors, scale, scale,
                                        zplane)
        canvas = np.full((scale, scale, 3), 225, np.float64)

        # ground grid at the scene's max-y plane, 1 m cells (vis.py:395-489)
        if ground_bounds is None:
            max_y = all_verts[:, 1].max()
            x0g, x1g = np.floor(all_verts[:, 0].min() - 10), np.ceil(all_verts[:, 0].max() + 10)
            z0g, z1g = np.floor(all_verts[:, 2].min() - 10), np.ceil(all_verts[:, 2].max() + 10)
        else:
            max_y, x0g, x1g, z0g, z1g = ground_bounds
        gx = np.arange(x0g, x1g + 1)
        gz = np.arange(z0g, z1g + 1)
        xs, zs = np.meshgrid(gx, gz)
        pts = np.stack([xs, np.full_like(xs, max_y), zs], -1).reshape(-1, 3)
        p = (view_R @ (pts - center).T)
        p[2] = np.clip(p[2] + zoom_bias * zoom, 0.25, None)
        p2 = (K_nv @ p) / p[2]
        p2 = p2[:2].T.reshape(len(gz), len(gx), 2)
        gthick = max(1, int(round(3 * scale / 1250)))
        for r in range(len(gz)):
            for c in range(len(gx)):
                q = tuple(p2[r, c].astype(int))
                if c + 1 < len(gx):
                    draw.line(canvas, q, tuple(p2[r, c + 1].astype(int)),
                              (175,) * 3, gthick)
                if r + 1 < len(gz):
                    draw.line(canvas, q, tuple(p2[r + 1, c].astype(int)),
                              (175,) * 3, gthick)

        novel = canvas
        novel[sil] = render[sil]
        novel = novel.astype(np.uint8)
        nthick = max(2, int(round(3 * scale / 1250)))
        order = np.argsort(-verts_nv.mean(1)[:, 2])
        for i in order:
            _draw_verts_wireframe(novel, K_nv, verts_nv[i], colors[i], nthick,
                                  zplane)
            if labels is not None:
                uvw = K_nv @ verts_nv[i].T
                vis_pts = uvw[:, uvw[2] > zplane]
                if vis_pts.size:
                    uv = vis_pts[:2] / vis_pts[2]
                    draw.put_text(novel, str(labels[i]),
                                  (int(uv[0].min()), max(int(uv[1].min()), 12)),
                                  0.5 * scale / 500, colors[i], 1)
        out["novel"] = novel
    return out


def draw_bev(centers, dims, poses, canvas_hw=(400, 400), max_range=40.0,
             colors=None):
    """Bird's-eye-view footprint plot (reference vis.py:26-55)."""
    H, W = canvas_hw
    canvas = np.full((H, W, 3), 32, np.uint8)
    scale = H / max_range

    def to_px(x, z):
        return int(W / 2 + x * scale), int(H - z * scale)

    for i, (c, d, R) in enumerate(zip(centers, dims, poses)):
        w3d, _, l3d = d
        # footprint corners in object frame (x spans l, z spans w)
        corners = np.array([
            [-l3d / 2, 0, -w3d / 2], [l3d / 2, 0, -w3d / 2],
            [l3d / 2, 0, w3d / 2], [-l3d / 2, 0, w3d / 2],
        ])
        world = corners @ np.asarray(R).T + np.asarray(c)
        pts = np.asarray([to_px(p[0], p[2]) for p in world], np.int32)
        color = colors[i] if colors is not None else get_color(int(i))
        draw.polylines(canvas, pts, True, color, 2)
    return canvas
