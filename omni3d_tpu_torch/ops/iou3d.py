"""Exact oriented-3D-box overlap (IoU3D) as torch tensors (port of
`omni3d_tpu.ops.iou3d`).

The replacement for pytorch3d's `_C.iou_box3d`, the eval hot loop of the
reference (binding: cubercnn/evaluation/omni3d_evaluation.py:37
`box3d_overlap`, guards at :65-166). The construction is the JAX package's:
clip each box's quad faces against the other box's 6 half-spaces
(Sutherland-Hodgman) and integrate the closed intersection boundary with the
divergence theorem, laid out structure-of-arrays with every (pair, face) in
the last (lane) axis, so each clip step is a few elementwise tensor ops over
the whole batch on any device.

  * quad faces (6 per box), wound outward (`_QUADS_OUT`), so the summed
    origin flux of the clipped boundary is consistently signed;
  * at most `_K` polygon vertices (the quad's 4 plus one per clip plane);
    slots >= m replicate vertex 0, so the wrap edge is a roll along the
    slot axis;
  * clip survivors are scattered to their cumsum positions (the JAX
    package's one-hot matmul is a TPU workaround; both select the same
    values);
  * coplanar faces are counted once: the A-faces-in-B pass keeps them
    (+eps), the B-faces-in-A pass drops them (-eps), both in one batch; the
    tolerance is scale-relative, since the f32 rounding of a plane distance
    grows with the coordinates (an absolute eps dropped self-pair IoU to 0
    a few metres from the origin).

Known edge case (shared with the JAX package and the reference's CUDA
construction): two boxes touching exactly on a full face report the flux of
that single open quad (unit cubes -> vol 1/6) instead of 0. It is
measure-zero for real detections.

Arithmetic. Every result is a sequence of single IEEE float32 operations,
so it is the same bit for bit on the CPU and the CUDA card: sums over the
small axes (vertices, slots, faces, xyz) are explicit left-to-right adds,
not reductions whose order depends on the device; divisions are tensor by
tensor (on CUDA, PyTorch divides by a Python scalar as a multiply by its
reciprocal). Where XLA's CPU backend contracts a * b + c into one fused
multiply-add, `_fma` does the same (the product and the sum in float64,
rounded once to float32), so results track the JAX package's to the last
bits: the coplanar test is a step at |dist| = eps, where a one-ulp
difference in a plane offset can add or drop a whole face.

Pure functions in float32, no gradient.
"""
from __future__ import annotations

import torch

# max polygon vertices: quad (4) + one per clip plane (6)
_K = 10
# scale-relative coplanarity tolerance, ~100x accumulated f32 rounding
_REL_EPS = 1e-5

# Quad faces of the canonical box (the reference's vertex layout), wound so
# the cross-product normal of each face points OUTWARD.
_QUADS_OUT = (
    (0, 3, 2, 1),  # z-
    (4, 5, 6, 7),  # z+
    (0, 4, 7, 3),  # x-
    (1, 2, 6, 5),  # x+
    (0, 1, 5, 4),  # y-
    (3, 7, 6, 2),  # y+
)


def _quads(verts: torch.Tensor) -> torch.Tensor:
    """(..., 8, 3) -> (..., 6, 4, 3) outward-wound faces."""
    return verts[..., torch.tensor(_QUADS_OUT, device=verts.device), :]


def _fma(a, b, c):
    """a * b + c rounded once to float32 (a float32 product is exact in
    float64)."""
    return (a.double() * b.double() + c.double()).float()


def _sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim` from left to right."""
    x = x.movedim(dim, 0)
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def _dot3(a, b):
    """a . b over the last axis (3) as XLA evaluates it: fma(a2, b2,
    fma(a1, b1, a0 * b0))."""
    return _fma(a[..., 2], b[..., 2], _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _cross(a, b):
    """a x b over the last axis, each component fma(a_i, b_j, -(a_j * b_i))."""
    return torch.stack([_fma(a[..., 1], b[..., 2], -(a[..., 2] * b[..., 1])),
                        _fma(a[..., 2], b[..., 0], -(a[..., 0] * b[..., 2])),
                        _fma(a[..., 0], b[..., 1], -(a[..., 1] * b[..., 0]))], -1)


def box_planes(verts: torch.Tensor):
    """Outward half-space (normal, offset) per face of a box.

    verts: (..., 8, 3). Returns normals (..., 6, 3) unit, offsets (..., 6)
    with inside(x) := dot(n, x) - d <= 0. Exact for parallelepipeds: the
    outward normal of a face is the direction face-center - box-center.
    """
    center = _sum(verts, -2) * 0.125            # the mean: 1/8 and 1/4 are exact
    fc = _sum(_quads(verts), -2) * 0.25
    n = fc - center[..., None, :]
    norm = torch.sqrt(_dot3(n, n).double()).float()
    n = n / torch.where(norm < 1e-12, 1.0, norm)[..., None]
    return n, _dot3(n, fc)


def box_volume(verts: torch.Tensor) -> torch.Tensor:
    """Volume of a parallelepiped from its 8 vertices: |det(e1, e2, e3)|
    using the edges at vertex 0 (neighbors 1, 3, 4 in the canonical layout)."""
    e1 = verts[..., 1, :] - verts[..., 0, :]
    e2 = verts[..., 3, :] - verts[..., 0, :]
    e3 = verts[..., 4, :] - verts[..., 0, :]
    return _dot3(e1, _cross(e2, e3)).abs()


def _flux_soa(v, nrm, off, eps):
    """Sutherland-Hodgman clip + divergence flux over a flat lane batch.

    v: (4, 3, B) quad vertices; nrm: (P, 3, B), off: (P, B) clip half-spaces
    dot(n, x) <= d; eps: (B,) signed coplanarity tolerance (+ keeps coplanar
    faces, - drops them). Returns (B,) signed origin-flux contributions.
    """
    B = v.shape[-1]
    P = nrm.shape[0]
    # Invariant: slots >= m hold a copy of vertex 0, so the wrap edge
    # (v_{m-1} -> v_0) is a plain roll along the slot axis.
    verts = torch.cat([v, v[0:1].expand(_K - 4, 3, B)], 0)   # (K, 3, B)
    m = torch.full((B,), 4, dtype=torch.int64, device=v.device)
    slot = torch.arange(_K, device=v.device)[:, None]       # (K, 1)
    for p in range(P):
        valid = slot < m
        dist = _fma(verts[:, 2], nrm[p, 2], _fma(verts[:, 0], nrm[p, 0],
                                                 verts[:, 1] * nrm[p, 1])) - off[p]   # (K, B)
        in_raw = dist <= eps   # unmasked: invalid slots hold v0 -> wrap flag
        nxt_v = torch.roll(verts, -1, 0)
        nxt_d = torch.roll(dist, -1, 0)
        nxt_in = torch.roll(in_raw, -1, 0)

        denom = dist - nxt_d
        t = dist / torch.where(denom.abs() < 1e-12, 1e-12, denom)
        ipt = _fma(t[:, None, :], nxt_v - verts, verts)      # (K, 3, B)

        emit_v = in_raw & valid
        emit_i = (in_raw != nxt_in) & valid

        # interleave [v_0, ipt_0, v_1, ipt_1, ...] to keep boundary order
        cand = torch.stack([verts, ipt], 1).reshape(2 * _K, 3, B)
        flags = torch.stack([emit_v, emit_i], 1).reshape(2 * _K, B)

        # stable compaction: each survivor to its cumsum position; what
        # lands past slot K - 1 goes to a spare row that is dropped
        pos = torch.cumsum(flags, 0) - 1                     # (2K, B)
        dest = torch.where(flags & (pos < _K), pos, _K)
        verts = torch.zeros((_K + 1, 3, B), dtype=v.dtype, device=v.device).scatter_(
            0, dest[:, None, :].expand(2 * _K, 3, B), cand)[:_K]
        m = flags.sum(0).clamp(max=_K)
        # restore the pad-with-v0 invariant
        verts = torch.where((slot < m)[:, None, :], verts, verts[0:1])

    # fan triangulation (v0, v_i, v_{i+1}), 1 <= i <= m-2: no wrap needed
    c = _cross(verts.movedim(1, -1), torch.roll(verts, -1, 0).movedim(1, -1))   # (K, B, 3)
    v0 = verts[0]
    contrib = _fma(v0[2], c[..., 2], _fma(v0[0], c[..., 0], v0[1] * c[..., 1]))  # (K, B)
    contrib = contrib * (1.0 / 6.0)   # XLA's division by a constant, and the same on CUDA
    tri_valid = (slot >= 1) & (slot + 1 < m)
    return _sum(torch.where(tri_valid, contrib, 0.0), 0)   # (B,)


def _rel_eps(v, off, eps_sign):
    """Scale-relative coplanarity tolerance per lane.

    dist = n.x - d is a true world distance (|n| = 1); its f32 rounding
    grows with the coordinate/offset magnitude, so an absolute eps
    mis-classifies coplanar faces for boxes a few metres from the origin.
    v: (4, 3, B), off: (P, B), eps_sign: (B,). Returns (B,).
    """
    vmax = v.abs().amax(dim=(0, 1))
    omax = off.abs().amax(dim=0)
    return eps_sign * _REL_EPS * (1.0 + vmax + omax)


def _pair_flux(quads1, quads2, n1, d1, n2, d2):
    """Both clip passes of the pairwise grid in ONE flat flux batch.

    quads*: (..., F, 4, 3) outward-wound faces; n*: (..., P, 3); d*: (..., P)
    where quads1/n1/d1 carry an N axis and quads2/n2/d2 an M axis arranged so
    broadcasting (..., N, M, ...) works (callers pre-insert singleton axes).
    Stacks [A-faces-in-B (+eps), B-faces-in-A (-eps)] along the lane axis.
    Returns summed flux with shape broadcast(...): (N, M) or (T, N, M).
    """
    F, P = quads1.shape[-3], n1.shape[-2]

    def lanes(quads, normals, offsets):
        # quads (..., F, 4, 3) x planes (..., P, 3)/(...) -> flat SoA lanes
        shape = torch.broadcast_shapes(quads.shape[:-3], normals.shape[:-2])
        v = quads.expand(shape + quads.shape[-3:]).reshape(-1, 4, 3).movedim(0, -1)
        nrm = normals[..., None, :, :].expand(shape + (F, P, 3))
        nrm = nrm.reshape(-1, P, 3).movedim(0, -1)
        off = offsets[..., None, :].expand(shape + (F, P)).reshape(-1, P).movedim(0, -1)
        return v, nrm, off, shape

    va, na, oa, sa = lanes(quads1, n2, d2)  # A faces in B half-spaces
    vb, nb, ob, sb = lanes(quads2, n1, d1)  # B faces in A half-spaces
    assert sa == sb
    v = torch.cat([va, vb], -1)
    nrm = torch.cat([na, nb], -1)
    off = torch.cat([oa, ob], -1)
    Bh = va.shape[-1]
    sign = torch.cat([torch.ones(Bh, device=v.device), -torch.ones(Bh, device=v.device)])
    flux = _flux_soa(v, nrm, off, _rel_eps(v, off, sign))   # (2 * Bh,)
    fa = _sum(flux[:Bh].reshape(sa + (F,)), -1)
    fb = _sum(flux[Bh:].reshape(sb + (F,)), -1)
    return fa + fb


def _iou(inter, vol1, vol2):
    union = vol1 + vol2 - inter
    iou = torch.where(union > 0, inter / torch.where(union > 0, union, 1.0), 0.0)
    return iou.clamp(0.0, 1.0)


def box3d_overlap(verts1: torch.Tensor, verts2: torch.Tensor):
    """Pairwise intersection volume and IoU of oriented 3D boxes.

    Args:
      verts1: (N, 8, 3) box corners in the canonical layout.
      verts2: (M, 8, 3), on the same device.

    Returns:
      (vol (N, M), iou (N, M)) float32, matching pytorch3d box3d_overlap
      (the evaluation wraps it with the reference's degeneracy guards).
    """
    vol, iou = box3d_overlap_tiled(torch.as_tensor(verts1)[None], torch.as_tensor(verts2)[None])
    return vol[0], iou[0]


def box3d_overlap_tiled(verts1: torch.Tensor, verts2: torch.Tensor):
    """Per-tile pairwise IoU3D: (T, N, 8, 3) x (T, M, 8, 3) -> (T, N, M).

    The block-diagonal batched form of `box3d_overlap`: tile t's N boxes are
    intersected with tile t's M boxes only, so many independent groups (or,
    at N = M = 1, a flat list of pairs) go through one call.

    Returns (vol (T, N, M), iou (T, N, M)) float32.
    """
    verts1 = torch.as_tensor(verts1, dtype=torch.float32)
    verts2 = torch.as_tensor(verts2, dtype=torch.float32)
    n1, d1 = box_planes(verts1)
    n2, d2 = box_planes(verts2)
    q1, q2 = _quads(verts1), _quads(verts2)   # (T, N, 6, 4, 3), (T, M, 6, 4, 3)
    inter = _pair_flux(q1[:, :, None], q2[:, None, :], n1[:, :, None], d1[:, :, None],
                       n2[:, None, :], d2[:, None, :]).abs()
    return inter, _iou(inter, box_volume(verts1)[:, :, None], box_volume(verts2)[:, None, :])
