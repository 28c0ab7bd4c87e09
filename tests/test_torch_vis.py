"""The port's drawing (`omni3d_tpu_torch.vis.draw`) against cv2 and its
visualisation (`omni3d_tpu_torch.vis.vis`) against the JAX package's, on the
same seeded inputs.

Tolerances: colours, clipped segments, raster images and silhouettes
bit-equal; thickness-1 lines, rectangles and closed polylines bit-equal to
cv2; thick lines IoU >= 0.97 with cv2's pixel set and no pixel more than
1 px from it; text inside `cv2.getTextSize`'s box at the same origin
+- 2 px (the port draws its own font); whole images with labels off
>= 98% of pixels equal."""
import cv2
import numpy as np
import pytest
from scipy import ndimage

from omni3d_tpu.vis import vis as JV
from omni3d_tpu_torch.vis import draw as D
from omni3d_tpu_torch.vis import vis as TV


def _scene(rng, n, zmin=0.3):
    c = np.stack([rng.uniform(-3, 3, n), rng.uniform(-1, 1, n), rng.uniform(zmin, 12, n)], 1)
    d = rng.uniform(0.5, 2.5, (n, 3))
    a = rng.uniform(-np.pi, np.pi, n)
    R = np.stack([np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0], [-np.sin(t), 0, np.cos(t)]])
                  for t in a])
    return c.astype(np.float32), d.astype(np.float32), R.astype(np.float32)


K = np.array([[200, 0, 80], [0, 200, 60], [0, 0, 1]], np.float64)


def _segments(rng, n, lo=-40, hi=120):
    for _ in range(n):
        w, h = int(rng.integers(5, 80)), int(rng.integers(5, 80))
        yield (w, h, tuple(int(v) for v in rng.integers(lo, hi, 2)),
               tuple(int(v) for v in rng.integers(lo, hi, 2)))


def test_get_color_equal():
    assert [TV.get_color(i) for i in range(64)] == [JV.get_color(i) for i in range(64)]


def test_clip_line_as_cv2():
    for w, h, p1, p2 in _segments(np.random.default_rng(0), 500, -200, 300):
        ok, a, b = cv2.clipLine((0, 0, w, h), p1, p2)
        got = D.clip_line(w, h, p1, p2)
        assert got[0] == ok
        if ok:
            assert (got[1], got[2]) == (tuple(a), tuple(b)), (w, h, p1, p2)


@pytest.mark.parametrize("dtype", [np.uint8, np.float64])
def test_thin_primitives_bit_equal(dtype):
    """Random segments (many leave the canvas), rectangles and closed
    polylines, thickness 1."""
    rng = np.random.default_rng(1)
    for w, h, p1, p2 in _segments(rng, 300):
        want = np.zeros((h, w, 3), dtype)
        got = np.zeros((h, w, 3), dtype)
        cv2.line(want, p1, p2, (175, 20, 3), 1)
        D.line(got, p1, p2, (175, 20, 3), 1)
        np.testing.assert_array_equal(got, want, err_msg=f"line {w}x{h} {p1} {p2}")
        cv2.rectangle(want, p1, p2, (1, 2, 3), 1)
        D.rectangle(got, p1, p2, (1, 2, 3), 1)
        np.testing.assert_array_equal(got, want, err_msg=f"rectangle {p1} {p2}")
        pts = rng.integers(-30, 110, (int(rng.integers(2, 7)), 2)).astype(np.int32)
        cv2.polylines(want, [pts], True, (9, 8, 7), 1)
        D.polylines(got, pts, True, (9, 8, 7), 1)
        np.testing.assert_array_equal(got, want, err_msg=f"polylines {pts.tolist()}")


def test_thick_lines_close_to_cv2():
    rng = np.random.default_rng(2)
    for w, h, p1, p2 in _segments(rng, 300):
        t = int(rng.integers(2, 6))
        want = np.zeros((h, w), np.uint8)
        cv2.line(want, p1, p2, 1, t)
        got = np.zeros((h, w, 1), np.uint8)
        D.line(got, p1, p2, (1,), t)
        a, b = want > 0, got[..., 0] > 0
        if not (a | b).any():
            continue
        assert (a & b).sum() / (a | b).sum() >= 0.97, (w, h, p1, p2, t)
        if (a ^ b).any():
            assert a.any() and b.any()
            assert ndimage.distance_transform_edt(~a)[b].max() <= 1.0
            assert ndimage.distance_transform_edt(~b)[a].max() <= 1.0
    for thick in (2, 3):                 # the box and BEV thicknesses, whole shapes
        pts = rng.integers(-20, 100, (4, 2)).astype(np.int32)
        want = np.zeros((80, 90, 3), np.uint8)
        got = np.zeros((80, 90, 3), np.uint8)
        cv2.polylines(want, [pts], True, (5, 6, 7), thick)
        D.polylines(got, pts, True, (5, 6, 7), thick)
        assert (want == got).all(-1).mean() >= 0.98


def test_text_inside_cv2_text_box():
    rng = np.random.default_rng(3)
    for _ in range(100):
        text = "".join(chr(c) for c in rng.integers(32, 127, int(rng.integers(1, 25))))
        scale = float(rng.uniform(0.3, 1.5))
        org = (int(rng.integers(0, 50)), int(rng.integers(20, 60)))
        (w, h), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, 1)
        img = np.zeros((100, 700, 3), np.uint8)
        D.put_text(img, text, org, scale, (255, 255, 255), 1)
        ys, xs = np.nonzero(img[..., 0])
        if len(xs):
            assert xs.min() >= org[0] - 2 and xs.max() <= org[0] + w + 2, text
            assert ys.min() >= org[1] - h - 2 and ys.max() <= org[1] + base + 2, text
    img = np.zeros((30, 200, 3), np.uint8)
    D.put_text(img, "chair 0.95", (5, 20), 0.5, (0, 255, 0))
    assert img[..., 1].any()


def test_segments_and_raster_bit_equal():
    """draw_3d_box's clipped projected segments (boxes in front of, across
    and behind the near plane) and rasterize_cuboids' image and silhouette."""
    rng = np.random.default_rng(4)
    c, d, R = _scene(rng, 12)
    c[0, 2], c[1, 2] = -5.0, 0.3          # one box behind the camera, one across the near plane
    boxes = np.concatenate([c, d], 1)
    tv = TV._cuboid_verts_np(c, d, R)
    np.testing.assert_array_equal(tv, JV._cuboid_verts_np(c, d, R))
    n_seg = 0
    for verts in tv:
        for i, j in TV._EDGES:
            got = TV._project_clip_segment(K, verts[i], verts[j])
            want = JV._project_clip_segment(K, verts[i], verts[j])
            assert (got is None) == (want is None)
            if got is not None:
                n_seg += 1
                np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert 0 < n_seg < 12 * 12
    for b, r in zip(boxes, R):
        want = JV.draw_3d_box(np.zeros((120, 160, 3), np.uint8), K, b, r, (9, 99, 199), 1)
        got = TV.draw_3d_box(np.zeros((120, 160, 3), np.uint8), K, b, r, (9, 99, 199), 1)
        np.testing.assert_array_equal(got, want)
    colors = [TV.get_color(i) for i in range(len(c))]
    ti, ts = TV.rasterize_cuboids(K, tv, colors, 160, 120)
    ji, js = JV.rasterize_cuboids(K, tv, colors, 160, 120)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(ti, ji)
    assert ts.any()


def _frac_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    return (a == b).all(-1).mean()


@pytest.mark.parametrize("seed", [5, 6])
def test_whole_images_match_jax(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (120, 160, 3)).astype(np.uint8)
    c, d, R = _scene(rng, 5)
    want = JV.render_scene_view(img, K, c, d, R)
    got = TV.render_scene_view(img, K, c, d, R)
    assert set(got) == {"front", "novel"} and got["novel"].shape == (512, 512, 3)
    for k in ("front", "novel"):
        assert _frac_equal(got[k], want[k]) >= 0.98, k
    assert _frac_equal(TV.draw_scene_view(img, K, c, d, R), JV.draw_scene_view(img, K, c, d, R)) \
        >= 0.98
    assert _frac_equal(TV.draw_bev(c, d, R), JV.draw_bev(c, d, R)) >= 0.98
    assert _frac_equal(TV.render_scene_view(img, K, c[:0], d[:0], R[:0])["novel"],
                       JV.render_scene_view(img, K, c[:0], d[:0], R[:0])["novel"]) == 1.0

    # the training panels, labels off in both packages
    monkeypatch.setattr(JV.cv2, "putText", lambda *a, **k: None)
    monkeypatch.setattr(TV.draw, "put_text", lambda *a, **k: None)
    mean, std = np.array([103.53, 116.28, 123.675]), np.array([57.375, 57.12, 58.395])
    norm = ((img.astype(np.float32) - mean) / std).astype(np.float32)
    Kb = np.array([[200, 0, 80], [0, 200, 60], [0, 0, 1]], np.float32)
    uvz = np.concatenate([(Kb @ c.T).T[:, :2] / c[:, 2:], c[:, 2:], d], 1)
    batch = {"images": norm[None], "hw": np.array([[120, 160]]), "ratios": np.array([1.0]),
             "Ks": Kb[None], "gt_valid": np.array([[1, 1, 1, 0, 1]]),
             "gt_boxes3D": uvz[None].astype(np.float32), "gt_poses": R[None],
             "gt_classes": np.array([[0, 1, 2, 0, 5]]),
             "gt_boxes": rng.uniform(0, 120, (1, 5, 4)).astype(np.float32)}
    det = {"valid": np.array([1, 1, 0, 1, 1.0]), "scores": rng.uniform(0, 1, 5),
           "center_cam": c, "dims": d, "pose": R, "classes": np.array([0, 1, 2, 3, 4.0]),
           "boxes": rng.uniform(0, 120, (5, 4)).astype(np.float32)}
    names = ["car", "chair", "table"]
    want = JV.visualize_training_sample(batch, det, mean, std, names)
    got = TV.visualize_training_sample(batch, det, mean, std, names)
    for k in ("2d", "3d"):
        assert _frac_equal(got[k], want[k]) >= 0.98, k
