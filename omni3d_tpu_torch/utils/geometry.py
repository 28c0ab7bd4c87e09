"""3D geometry of the port (port of `omni3d_tpu.utils.geometry`): what the
cube head and `decode_cube` need, and the projection, 2D-box and rotation
helpers of rendering and visualisation. Batched over leading dims, on any
device; `virtual_scale` and `approx_eval_resolution` also serve the priors
on the host, on Python floats, and `mat2euler` / `euler2mat` are numpy host
helpers as in the JAX package."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

# Vertex layout of the canonical unit cube (reference math_util.py:37-46).
UNIT_CUBE = np.array(
    [[-0.5, -0.5, -0.5], [0.5, -0.5, -0.5], [0.5, 0.5, -0.5], [-0.5, 0.5, -0.5],
     [-0.5, -0.5, 0.5], [0.5, -0.5, 0.5], [0.5, 0.5, 0.5], [-0.5, 0.5, 0.5]],
    dtype=np.float32)

# Per-vertex sign multipliers (l, h, w), in the reference's vertex order
# (reference math_util.py:151-181).
_VERT_SIGNS = (
    (-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
    (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1),
)

# Triangle faces of a cuboid in that vertex order, with the reference's
# winding (reference math_util.py:195-213).
CUBOID_FACES = (
    (0, 1, 2), (2, 3, 0),  # front
    (1, 5, 6), (6, 2, 1),  # right
    (4, 0, 3), (3, 7, 4),  # left
    (5, 4, 7), (7, 6, 5),  # back
    (4, 5, 1), (1, 0, 4),  # top
    (3, 2, 6), (6, 7, 3),  # bottom
)


@functools.lru_cache(maxsize=None)
def _vert_signs(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`_VERT_SIGNS` as an (8, 3) tensor, made once per dtype and device:
    the host-to-device copy blocks, and a CUDA graph cannot capture it.
    Callers only read it."""
    return torch.tensor(_VERT_SIGNS, dtype=dtype, device=device)


def cuboid_verts(box3d: torch.Tensor, R: torch.Tensor | None = None) -> torch.Tensor:
    """(..., 8, 3) camera-space vertices of [x, y, z, w, h, l] cuboids,
    rotated by R (..., 3, 3) about their centers."""
    ctr = box3d[..., :3]
    w, h, l = box3d[..., 3], box3d[..., 4], box3d[..., 5]
    half = torch.stack([l, h, w], dim=-1) * 0.5
    local = _vert_signs(box3d.dtype, box3d.device) * half[..., None, :]
    if R is not None:
        local = torch.einsum("...ij,...vj->...vi", R, local)
    return local + ctr[..., None, :]


def fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (a float64 product and sum, rounded to
    float32): the fused multiply-add of XLA's CPU backend."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def cuboid_verts_np(box3d, R) -> np.ndarray:
    """`cuboid_verts` on the host in float32 numpy, for drawing: (..., 8, 3)
    from (..., 6) boxes and (..., 3, 3) rotations. The rotation's sums are
    the fused multiply-add chain fma(R2, l2, fma(R1, l1, R0 l0)) that XLA's
    CPU backend emits for the JAX package's einsum (each fma as a float64
    product and sum rounded once to float32), so the vertices, and the
    pixels drawn from them, equal the JAX package's."""
    box3d = np.asarray(box3d, np.float32)
    R = np.asarray(R, np.float32)[..., None, :, :]
    half = np.stack([box3d[..., 5], box3d[..., 4], box3d[..., 3]], -1) * np.float32(0.5)
    local = (np.asarray(_VERT_SIGNS, np.float32) * half[..., None, :])[..., None, :]
    rot = fma32(R[..., 2], local[..., 2],
                fma32(R[..., 1], local[..., 1], R[..., 0] * local[..., 0]))
    return rot + box3d[..., None, :3]


def cuboid_verts_faces(box3d: torch.Tensor, R: torch.Tensor | None = None):
    """Vertices plus the shared (12, 3) face index table (reference
    math_util.py:116-219)."""
    return cuboid_verts(box3d, R), torch.tensor(CUBOID_FACES, dtype=torch.int32,
                                                device=box3d.device)


def project_points(K: torch.Tensor, pts3d: torch.Tensor) -> torch.Tensor:
    """(..., P, 3) camera-space points through (..., 3, 3) intrinsics ->
    (..., P, 3) [u, v, z] with z the raw depth (reference
    math_util.py:251-253); |z| < 1e-8 divides by +-1e-8."""
    proj = torch.einsum("...ij,...pj->...pi", K, pts3d)
    z = proj[..., 2:3]
    tiny = torch.where(z < 0, torch.full_like(z, -1e-8), torch.full_like(z, 1e-8))
    uv = proj[..., :2] / torch.where(z.abs() < 1e-8, tiny, z)
    return torch.cat([uv, z], dim=-1)


def cuboid_verts_2d(K: torch.Tensor, box3d: torch.Tensor, R: torch.Tensor | None = None):
    """Projected cuboid corners: ((..., 8, 3) [u, v, z], (..., 8, 3) 3D
    vertices) (reference get_cuboid_verts, math_util.py:221-259)."""
    corners3d = cuboid_verts(box3d, R)
    return project_points(K, corners3d), corners3d


def box3d_to_box2d(K, box3d, R=None, clipw: float = 0.0, cliph: float = 0.0,
                   xywh: bool = True, min_z: float = 0.20):
    """Projected 2D box of 3D cuboids, vertices at depth <= min_z snapped to
    the image corner their 3D signs point to (reference
    convert_3d_box_to_2d, math_util.py:498-577). Returns (box2d (..., 4),
    behind_camera (...,), fully_behind (...,))."""
    verts2d, verts3d = cuboid_verts_2d(K, box3d, R)
    behind = verts2d[..., 2] <= min_z
    sx, sy = torch.sign(verts3d[..., 0]), torch.sign(verts3d[..., 1])
    u0, v0 = verts2d[..., 0], verts2d[..., 1]
    bx = torch.where(sx < 0, torch.zeros_like(u0),
                     torch.where(sx > 0, torch.full_like(u0, clipw - 1.0), u0))
    by = torch.where(sy < 0, torch.zeros_like(v0),
                     torch.where(sy > 0, torch.full_like(v0, cliph - 1.0), v0))
    snap = behind & (sx != 0) & (sy != 0)
    u, v = torch.where(snap, bx, u0), torch.where(snap, by, v0)
    x1, y1 = u.amin(-1), v.amin(-1)
    x2, y2 = u.amax(-1), v.amax(-1)
    box2d = torch.stack([x1, y1, x2 - x1, y2 - y1] if xywh else [x1, y1, x2, y2], dim=-1)
    return box2d, behind.any(-1), behind.all(-1)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula; axis_angle (..., 3) whose norm is the angle."""
    angle = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    small = angle < 1e-12
    axis = axis_angle / torch.where(small, torch.ones_like(angle), angle)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    a = angle[..., 0]
    c, s = torch.cos(a), torch.sin(a)
    C = 1.0 - c
    R = torch.stack(
        [
            torch.stack([c + x * x * C, x * y * C - z * s, x * z * C + y * s], -1),
            torch.stack([y * x * C + z * s, c + y * y * C, y * z * C - x * s], -1),
            torch.stack([z * x * C - y * s, z * y * C + x * s, c + z * z * C], -1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    return torch.where(small[..., None], eye, R)


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues; (..., 3, 3) -> (..., 3) axis * angle."""
    cos = ((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) * 0.5).clamp(-1.0, 1.0)
    angle = torch.arccos(cos)
    ax = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                      R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin = torch.sin(angle)
    small = sin.abs() < 1e-8
    scale = torch.where(small, torch.full_like(angle, 0.5),
                        angle / (2.0 * torch.where(small, torch.ones_like(sin), sin)))
    return ax * scale[..., None]


def _allocentric_M(K: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Rotation aligning the camera +z axis with the viewing ray of (u, v),
    and the ray's angle (reference math_util.py:595-705)."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    sx, sy = K[..., 0, 2], K[..., 1, 2]
    ox = (u - sx) / fx
    oy = (v - sy) / fy
    oray = torch.stack([ox, oy, torch.ones_like(ox)], dim=-1)
    oray = oray / torch.linalg.norm(oray, dim=-1, keepdim=True)
    angle = torch.arccos(oray[..., 2].clamp(-1.0, 1.0))
    axis = torch.stack([-oray[..., 1], oray[..., 0], torch.zeros_like(ox)], dim=-1)
    norm = torch.linalg.norm(axis, dim=-1, keepdim=True)
    axis = axis / torch.where(norm < 1e-12, torch.ones_like(norm), norm)
    return axis_angle_to_matrix(angle[..., None] * axis), angle


def R_to_allocentric(K, R, u, v):
    """Egocentric -> allocentric pose about the (u, v) viewing ray
    (reference math_util.py:595-648): M^T @ R when the ray angle is > 0."""
    M, angle = _allocentric_M(K, u, v)
    R_view = torch.einsum("...ji,...jk->...ik", M, R)
    return torch.where(angle[..., None, None] > 0, R_view, R)


def R_from_allocentric(K, R_view, u, v):
    """Allocentric -> egocentric pose (reference math_util.py:651-705)."""
    M, angle = _allocentric_M(K, u, v)
    R = torch.einsum("...ij,...jk->...ik", M, R_view)
    return torch.where(angle[..., None, None] > 0, R, R_view)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D rotation (Zhou et al. CVPR'19) -> matrix by Gram-Schmidt, rows
    b1, b2, b1 x b2 (pytorch3d rotation_6d_to_matrix)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp(min=1e-12)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p / torch.linalg.norm(a2p, dim=-1, keepdim=True).clamp(min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(R: torch.Tensor) -> torch.Tensor:
    """Matrix -> 6D parametrization (its first two rows, flattened)."""
    return torch.cat([R[..., 0, :], R[..., 1, :]], dim=-1)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix (pytorch3d convention)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / (q * q).sum(-1)
    return torch.stack(
        [
            torch.stack([1 - two_s * (y * y + z * z), two_s * (x * y - z * w), two_s * (x * z + y * w)], -1),
            torch.stack([two_s * (x * y + z * w), 1 - two_s * (x * x + z * z), two_s * (y * z - x * w)], -1),
            torch.stack([two_s * (x * z - y * w), two_s * (y * z + x * w), 1 - two_s * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def normalize_quaternion(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize with the scale's sign copied from q_w (reference
    cube_head.py:179-181 via pytorch3d _copysign)."""
    scale = torch.sqrt((q * q).sum(-1))
    scale = torch.where(q[..., 0] < 0, -scale, scale)
    scale = torch.where(scale.abs() < eps, torch.full_like(scale, eps), scale)
    return q / scale[..., None]


def euler_angles_to_matrix(euler: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """Euler angles -> matrix, pytorch3d convention R = Rx @ Ry @ Rz for 'XYZ'."""

    def axis_R(axis, a):
        c, s, o, z = torch.cos(a), torch.sin(a), torch.ones_like(a), torch.zeros_like(a)
        if axis == "X":
            rows = [o, z, z, z, c, -s, z, s, c]
        elif axis == "Y":
            rows = [c, z, s, z, o, z, -s, z, c]
        else:
            rows = [c, -s, z, s, c, z, z, z, o]
        return torch.stack(rows, dim=-1).reshape(a.shape + (3, 3))

    R = axis_R(convention[0], euler[..., 0])
    for i, ax in enumerate(convention[1:], start=1):
        R = R @ axis_R(ax, euler[..., i])
    return R


def scaled_sigmoid(vals, lo=0.0, hi=1.0):
    """Sigmoid rescaled to (lo, hi) (reference math_util.py:969-978)."""
    return lo + (hi - lo) * torch.sigmoid(vals)


def so3_relative_angle(R1, R2, eps: float = 1e-4, cos_angle: bool = False):
    """Relative rotation angle between two rotations (pytorch3d
    so3_relative_angle); cos(theta) with cos_angle=True."""
    trace = torch.einsum("...ij,...ij->...", R1, R2)   # trace(R1 @ R2^T)
    cos = ((trace - 1.0) * 0.5).clamp(-1.0 + eps, 1.0 - eps)
    return cos if cos_angle else torch.arccos(cos)


def mat2euler(R) -> np.ndarray:
    """Rotation matrix -> euler angles (x, y, z), host numpy helper
    (reference math_util.py:72-82)."""
    R = np.asarray(R)
    sy = math.sqrt(R[0, 0] * R[0, 0] + R[1, 0] * R[1, 0])
    return np.array([math.atan2(R[2, 1], R[2, 2]), math.atan2(-R[2, 0], sy),
                     math.atan2(R[1, 0], R[0, 0])])


def euler2mat(euler) -> np.ndarray:
    """Euler angles -> rotation matrix R = Rz @ Ry @ Rx, host numpy helper
    (reference math_util.py:86-105)."""
    cx, cy, cz = (math.cos(v) for v in euler)
    sx, sy, sz = (math.sin(v) for v in euler)
    R_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    R_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    R_z = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return R_z @ R_y @ R_x


def virtual_scale(f, H, f0, H0):
    """Depth scaling factor between focal spaces (f0, H0) -> (f, H):
    (H0 * f) / (f0 * H) (reference compute_virtual_scale_from_focal_spaces,
    math_util.py:581-592). Python floats or tensors."""
    return (H0 * f) / (f0 * H)


def approx_eval_resolution(h, w, scale_min=0, scale_max=1e10):
    """Resolution an (h, w) image runs through the model at, and its scale
    factor (reference math_util.py:262-289). Host helper on Python floats."""
    orig_h = h
    sf = scale_min / min(h, w)
    h, w = h * sf, w * sf
    sf = min(scale_max / max(h, w), 1.0)
    h, w = h * sf, w * sf
    return h, w, h / orig_h
