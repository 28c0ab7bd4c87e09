"""3D geometry the cube head and `decode_cube` need (port of the matching
functions of `omni3d_tpu.utils.geometry`). Batched over leading dims, f32;
`virtual_scale` and `approx_eval_resolution` also serve the priors on the
host, on Python floats."""
from __future__ import annotations

import torch

# Per-vertex sign multipliers (l, h, w), in the reference's vertex order
# (reference math_util.py:151-181).
_VERT_SIGNS = (
    (-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
    (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1),
)


def cuboid_verts(box3d: torch.Tensor, R: torch.Tensor | None = None) -> torch.Tensor:
    """(..., 8, 3) camera-space vertices of [x, y, z, w, h, l] cuboids,
    rotated by R (..., 3, 3) about their centers."""
    ctr = box3d[..., :3]
    w, h, l = box3d[..., 3], box3d[..., 4], box3d[..., 5]
    half = torch.stack([l, h, w], dim=-1) * 0.5
    signs = torch.tensor(_VERT_SIGNS, dtype=box3d.dtype, device=box3d.device)
    local = signs * half[..., None, :]
    if R is not None:
        local = torch.einsum("...ij,...vj->...vi", R, local)
    return local + ctr[..., None, :]


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
