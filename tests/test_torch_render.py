"""The port's rasterizer and estimators (`omni3d_tpu_torch.utils.render`) and
its projection / rotation helpers (`utils.geometry`) against the JAX
package's, on the same seeded inputs, on the CPU.

Tolerances: silhouettes and nearest-instance indices equal, depth within
1e-5 relative; visibility and truncation within 1e-6; the geometry helpers
within 1e-6 (absolute, on values of order 1-100)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from omni3d_tpu.utils import geometry as JG
from omni3d_tpu.utils import render as JR
from omni3d_tpu_torch.utils import geometry as TG
from omni3d_tpu_torch.utils import render as TR

K = np.array([[60, 0, 32], [0, 60, 24], [0, 0, 1]], np.float32)


def _scene(rng, n):
    c = np.stack([rng.uniform(-3, 3, n), rng.uniform(-1, 1, n), rng.uniform(2, 12, n)], 1)
    d = rng.uniform(0.5, 2.5, (n, 3))
    R = TG.euler_angles_to_matrix(torch.tensor(rng.uniform(-np.pi, np.pi, (n, 3)),
                                               dtype=torch.float32)).numpy()
    return np.concatenate([c, d], 1).astype(np.float32), R


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_depth_map_matches_jax(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    boxes, R = _scene(rng, 6)
    boxes[0, 2] = -5.0                       # a box fully behind the camera
    boxes[1, 2] = 0.4                        # one across the image plane
    js, jd, ji = (np.asarray(a) for a in JR.render_depth_map(K, boxes, R, 64, 48))
    monkeypatch.setattr(TR, "CHUNK_ELEMENTS", 6 * 12 * 1000)      # chunks of 1000 pixels
    ts, td, ti = (a.numpy() for a in TR.render_depth_map(K, boxes, R, 64, 48, device="cpu"))
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(ti, ji)
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    assert fin.any() and not ts[0].any()
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=0)
    # the chunking does not change a bit
    monkeypatch.setattr(TR, "CHUNK_ELEMENTS", 6 * 12 * 64 * 48)   # one chunk
    whole = TR.render_depth_map(K, boxes, R, 64, 48, device="cpu")
    for a, b in zip(whole, (ts, td, ti)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_visibility_and_truncation_match_jax():
    rng = np.random.default_rng(3)
    boxes, R = _scene(rng, 5)
    boxes[0, 2] = -6.0
    boxes[2, :3] = (1.5, 0.0, 3.0)           # across the right edge: truncated
    got = TR.estimate_visibility(K, boxes, R, 64, 48, device="cpu")
    want = JR.estimate_visibility(K, boxes, R, 64, 48)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[0] == 0.0
    truncs = []
    for b, r in zip(boxes, R):
        t = TR.estimate_truncation(K, b, r, 64, 48)
        assert abs(t - JR.estimate_truncation(K, b, r, 64, 48)) <= 1e-6
        truncs.append(t)
    assert truncs[0] == 1.0 and 0 < truncs[2] < 1


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(4)
    boxes, R = _scene(rng, 7)
    boxes[0, 2] = -3.0
    Kb = np.broadcast_to(K, (7, 3, 3)).copy()
    t, j = torch.tensor, jnp.asarray

    def close(a, b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-6 * max(
            1.0, float(np.abs(np.asarray(b)).max())))

    v, f = TG.cuboid_verts_faces(t(boxes), t(R))
    jv, jf = JG.cuboid_verts_faces(j(boxes), j(R))
    close(v, jv)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(TG.UNIT_CUBE, JG.UNIT_CUBE)
    pts = t(rng.normal(0, 3, (7, 9, 3)).astype(np.float32))
    pts[0, 0, 2] = 0.0                        # the |z| < 1e-8 guard
    close(TG.project_points(t(Kb), pts), JG.project_points(j(Kb), j(pts.numpy())))
    for a, b in zip(TG.cuboid_verts_2d(t(Kb), t(boxes), t(R)),
                    JG.cuboid_verts_2d(j(Kb), j(boxes), j(R))):
        close(a, b)
    for xywh in (True, False):
        got = TG.box3d_to_box2d(t(Kb), t(boxes), t(R), clipw=64, cliph=48, xywh=xywh)
        want = JG.box3d_to_box2d(j(Kb), j(boxes), j(R), clipw=64, cliph=48, xywh=xywh)
        close(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    close(TG.matrix_to_axis_angle(t(R)), JG.matrix_to_axis_angle(j(R)))
    close(TG.matrix_to_axis_angle(torch.eye(3)[None]), JG.matrix_to_axis_angle(jnp.eye(3)[None]))
    close(TG.matrix_to_rotation_6d(t(R)), JG.matrix_to_rotation_6d(j(R)))
    for r in R[:3]:
        np.testing.assert_allclose(TG.mat2euler(r), JG.mat2euler(r), rtol=0, atol=1e-12)
        e = rng.uniform(-1, 1, 3)
        np.testing.assert_allclose(TG.euler2mat(e), JG.euler2mat(e), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(TG.cuboid_verts_np(boxes, R), np.asarray(JG.cuboid_verts(
        j(boxes), j(R))))
