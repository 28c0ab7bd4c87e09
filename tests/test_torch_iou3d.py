"""The port's IoU3D (`omni3d_tpu_torch.ops.iou3d`) against the JAX package's
on the CPU, as the JAX package's evaluation runs it (jitted through XLA):
`box3d_overlap` and `box3d_overlap_tiled`, IoU within 1e-5 absolute and
volume within 1e-5 absolute and 1e-5 relative, on identity, nested,
disjoint and partial overlaps, boxes rotated about random axes, boxes 50 m
from the origin (the scale-relative coplanarity eps), a zero-height box,
two boxes touching on a face (the construction's known 1/6 edge case) and
near-coplanar faces inside the eps window (a fault both packages share).
The port mirrors XLA's fused multiply-adds and summation order, so these
agree to the last bit; the tolerance is the one the evaluation needs."""
import jax
import numpy as np
import pytest
import torch

from omni3d_tpu.ops import iou3d as jiou
from omni3d_tpu_torch.ops import iou3d as tiou
from omni3d_tpu_torch.utils.geometry import axis_angle_to_matrix, cuboid_verts

TOL = 1e-5
jax_overlap = jax.jit(jiou.box3d_overlap)
jax_overlap_tiled = jax.jit(jiou.box3d_overlap_tiled)


def verts(boxes, rotvecs=None):
    """(N, 8, 3) float32 corners of [x, y, z, w, h, l] boxes rotated by
    axis-angle vectors."""
    b = torch.tensor(np.asarray(boxes, np.float32))
    R = (None if rotvecs is None
         else axis_angle_to_matrix(torch.tensor(np.asarray(rotvecs, np.float32))))
    return cuboid_verts(b, R).numpy()


def random_boxes(rng, n, z=(2.0, 10.0), xy=3.0):
    """Boxes rotated about random axes, 0.3-3 m, centres at the given depth."""
    centre = np.c_[rng.uniform(-xy, xy, (n, 2)), rng.uniform(*z, n)]
    axis = rng.standard_normal((n, 3))
    rot = axis / np.linalg.norm(axis, axis=1, keepdims=True) * rng.uniform(0, np.pi, (n, 1))
    return verts(np.c_[centre, rng.uniform(0.3, 3.0, (n, 3))], rot)


def check(a, b):
    """Port vs JAX on (N, 8, 3) x (M, 8, 3); returns the port's (vol, iou)."""
    vol, iou = (t.numpy() for t in tiou.box3d_overlap(torch.from_numpy(a), torch.from_numpy(b)))
    jvol, jiou_ = (np.asarray(t) for t in jax_overlap(a, b))
    assert vol.shape == iou.shape == (len(a), len(b))
    np.testing.assert_allclose(iou, jiou_, rtol=0, atol=TOL)
    np.testing.assert_allclose(vol, jvol, rtol=TOL, atol=TOL)
    return vol, iou


def test_identity_nested_disjoint_partial():
    a = verts([[0, 0, 5, 2, 3, 4], [0, 0, 0, 4, 4, 4], [0, 0, 0, 1, 1, 1]])
    b = verts([[0, 0, 5, 2, 3, 4],      # identity with a[0]
               [0, 0, 0, 2, 2, 2],      # nested in a[1]
               [10, 0, 0, 1, 1, 1],     # disjoint from all
               [0.5, 0, 0, 1, 1, 1]])   # a[2] shifted half a side
    vol, iou = check(a, b)
    np.testing.assert_allclose(iou[0, 0], 1.0, atol=1e-4)
    np.testing.assert_allclose(vol[1, 1], 8.0, rtol=1e-4)
    np.testing.assert_allclose(iou[1, 1], 8 / 64, rtol=1e-4)
    np.testing.assert_allclose(vol[:, 2], 0.0, atol=1e-5)
    np.testing.assert_allclose(iou[2, 3], 1 / 3, atol=1e-4)


def test_rotated_about_random_axes():
    rng = np.random.default_rng(0)
    a = random_boxes(rng, 24)
    b = np.concatenate([a[:12] + rng.normal(0, 0.3, (12, 1, 3)).astype(np.float32),
                        random_boxes(rng, 12)])
    _, iou = check(a, b)
    assert (iou > 0.05).sum() >= 12     # the jittered copies overlap


@pytest.mark.parametrize("pairs", ["self", "jittered"])
def test_fifty_metres_from_the_origin(pairs):
    """50 m out, an absolute eps would misread the coplanar faces of a
    self-pair (IoU 0); the scale-relative eps keeps them at 1."""
    rng = np.random.default_rng(1)
    a = random_boxes(rng, 16, z=(49.0, 51.0))
    b = a if pairs == "self" else a + rng.normal(0, 0.2, (16, 1, 3)).astype(np.float32)
    _, iou = check(a, b)
    if pairs == "self":
        np.testing.assert_allclose(np.diag(iou), 1.0, atol=1e-3)


def test_zero_height_box():
    a = verts([[0, 0, 5, 1, 0, 1], [0, 0, 5, 1, 1, 1]])
    vol, iou = check(a, a)
    assert vol[0, 0] == 0 and iou[0, 1] == 0 and iou[1, 0] == 0


def test_face_touching_edge_case():
    """Unit cubes sharing a full face: the construction reports the flux of
    the one open quad, 1/6 (the JAX package's documented edge case); the
    port gives the same value."""
    a = verts([[0, 0, 0, 1, 1, 1]])
    b = verts([[1, 0, 0, 1, 1, 1]])
    vol, _ = check(a, b)
    np.testing.assert_allclose(vol[0, 0], 1 / 6, rtol=1e-4)


def test_tiled_matches_jax_and_the_pairwise_grid():
    rng = np.random.default_rng(2)
    a = random_boxes(rng, 4 * 8, z=(2.0, 45.0)).reshape(4, 8, 8, 3)
    b = (a[:, :5] + rng.normal(0, 0.3, (4, 5, 1, 3))).astype(np.float32)
    vol, iou = (t.numpy() for t in tiou.box3d_overlap_tiled(torch.from_numpy(a),
                                                             torch.from_numpy(b)))
    jvol, jiou_ = (np.asarray(t) for t in jax_overlap_tiled(a, b))
    assert iou.shape == (4, 8, 5)
    np.testing.assert_allclose(iou, jiou_, rtol=0, atol=TOL)
    np.testing.assert_allclose(vol, jvol, rtol=TOL, atol=TOL)
    for t in range(4):   # each tile is the pairwise grid of its boxes
        _, grid = tiou.box3d_overlap(torch.from_numpy(a[t]), torch.from_numpy(b[t]))
        np.testing.assert_array_equal(grid.numpy(), iou[t])


def _aabb(lo, hi):
    """(8, 3) float32 corners of an axis-aligned box in the canonical order."""
    c = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                  for z in (lo[2], hi[2])], np.float32)
    return c[[0, 1, 3, 2, 4, 5, 7, 6]]


def test_near_coplanar_faces_collapse_in_both_packages():
    """A fault of the construction, shared on purpose: two boxes 40 m out
    whose z- faces are 8.1e-4 m apart, inside the scale-relative eps window
    (1e-5 x (1 + |vertex| + |offset|) ~ 8.1e-4 here), so one pass counts a
    face as coplanar and the other does not: IoU 0 one way round and the
    true 0.770 the other. The port gives the JAX package's values."""
    a = _aabb([-0.3722671866416931, 2.6444621086120605, 39.70182418823242],
              [0.787221372127533, 4.928680419921875, 40.8416633605957])
    b = _aabb([-0.5317074656486511, 2.6108603477478027, 39.70263671875],
              [0.8561310172080994, 4.832375526428223, 40.877559661865234])
    _, ab = check(a[None], b[None])
    _, ba = check(b[None], a[None])
    assert ab[0, 0] == 0.0
    np.testing.assert_allclose(ba[0, 0], 0.770, atol=1e-3)
