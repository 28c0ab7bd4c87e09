"""The plain PyTorch ROIAlign backward (the CUDA backward kernel's reference)
vs the JAX package: canonical routing against `jax.vjp` of the XLA oracle
`multilevel_roi_align` (atol 2e-4, as tests/test_roi_align_bwd.py holds the
Pallas backward), "fit" routing against `roi_align_bwd_pallas` in interpret
mode, the transpose identity, and autograd through `MultilevelROIAlign`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni3d_tpu.ops import roi_align as jra
from omni3d_tpu.ops.roi_align_bwd_pallas import roi_align_bwd_pallas
from omni3d_tpu_torch.ops import roi_align as tra
from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
from torch_port_helpers import t

STRIDES = (4, 8, 16, 32, 64)
IMG = 128
C = 8


def _case(seed, B, n):
    """Pyramid, boxes (random plus edge cases: outside the image, degenerate,
    touching the border, past the SMAX clamp, every level) and a cotangent."""
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((B, IMG // s, IMG // s, C)).astype(np.float32)
             for s in STRIDES]
    xy = rng.uniform(0, IMG - 40, (B, n, 2))
    wh = rng.uniform(3, 40, (B, n, 2))
    edge = np.asarray([
        [-20, -12, -2, -3], [30, 30, 30, 50], [IMG - 5, IMG - 6, IMG, IMG],
        [1, 50, IMG - 1, 54],                  # 126 x 4 px: 31 p2 cells -> g 5
        [0, 0, IMG, IMG], [-200, -190, 300, 310], [-500, -480, 600, 620],
        [-80, -80, 220, 220],
    ], np.float32)
    boxes = np.concatenate([np.concatenate([xy, xy + wh], -1),
                            np.broadcast_to(edge, (B,) + edge.shape)], 1).astype(np.float32)
    g = rng.standard_normal((B, boxes.shape[1], 7, 7, C)).astype(np.float32)
    return feats, boxes, g


def _jax_vjp(feats, boxes, g, S):
    def pooled(fs):
        return jax.vmap(lambda fl, bx: jra.multilevel_roi_align(list(fl), bx, list(STRIDES),
                                                                7, S))(fs, jnp.asarray(boxes))
    _, vjp = jax.vjp(pooled, [jnp.asarray(f) for f in feats])
    return [np.asarray(d) for d in vjp(jnp.asarray(g))[0]]


def _plain_bwd(feats, boxes, g, S, routing="canonical"):
    levels = tra.route_levels(t(boxes), STRIDES, 2, routing)
    return tra.multilevel_roi_align_plain_bwd(
        t(g), t(boxes), levels, [f.shape[1:3] for f in feats], STRIDES, 7, S, torch.float32)


@pytest.mark.parametrize("sampling_ratio", [0, 2])
def test_plain_bwd_matches_jax_vjp(sampling_ratio):
    feats, boxes, g = _case(sampling_ratio, B=2, n=10)
    levels = tra.route_levels(t(boxes), STRIDES, 2, "canonical")
    assert set(levels.flatten().tolist()) == {0, 1, 2, 3, 4}
    got = _plain_bwd(feats, boxes, g, sampling_ratio)
    want = _jax_vjp(feats, boxes, g, sampling_ratio)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=2e-4, rtol=0)


@pytest.mark.parametrize("sampling_ratio", [0, 2])
def test_plain_bwd_fit_matches_pallas_interpret_and_is_a_transpose(sampling_ratio):
    """routing="fit" transposes the TPU kernel's plan: against the Pallas
    backward in interpret mode (atol 2e-4), on boxes inside its windows
    (no negative width, see test_torch_roi_align); and <g, fwd(f)> =
    <bwd(g), f> in float32 at rtol 1e-5."""
    feats, boxes, g = _case(7 + sampling_ratio, B=2, n=1)
    boxes = np.delete(boxes, [3, 4], axis=1)
    boxes = np.concatenate([boxes, np.broadcast_to(np.asarray(
        [[0, 0, 127, 20], [10, 0, 30, 125]], np.float32), (2, 2, 4))], 1)
    g = g[:, :boxes.shape[1]]
    assert boxes.shape[1] <= 9 and np.all(boxes[..., 2] >= boxes[..., 0])
    fit = tra.route_levels(t(boxes), STRIDES, 2, "fit")
    assert not torch.equal(fit, tra.route_levels(t(boxes), STRIDES, 2, "canonical"))
    got = _plain_bwd(feats, boxes, g, sampling_ratio, "fit")
    want = roi_align_bwd_pallas([jnp.asarray(f) for f in feats], jnp.asarray(boxes),
                                jnp.asarray(g), list(STRIDES), 7, sampling_ratio,
                                interpret=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4, rtol=0)

    fwd = tra.multilevel_roi_align_plain([t(f) for f in feats], t(boxes), fit, STRIDES, 7,
                                         sampling_ratio)
    lhs = float((t(g).double() * fwd.double()).sum())
    rhs = float(sum((d.double() * t(f).double()).sum() for d, f in zip(got, feats)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_autograd_function_on_cpu_takes_the_plain_backward(dtype):
    """loss.backward() through `multilevel_roi_align` gives the plain
    backward's gradients (f32: equal to the JAX vjp at atol 2e-4; bf16: the
    same float32 sum cast once), launches no kernel, and gives boxes none."""
    feats, boxes, g = _case(3, B=2, n=6)
    tf = [t(f).to(dtype).requires_grad_(True) for f in feats]
    tb = t(boxes).requires_grad_(True)
    fwd0, bwd0 = multilevel_roi_align.launches, multilevel_roi_align.bwd_launches
    out = multilevel_roi_align(tf, tb, STRIDES, 7, 0)
    (out.float() * t(g)).sum().backward()
    assert (multilevel_roi_align.launches, multilevel_roi_align.bwd_launches) == (fwd0, bwd0)
    assert tb.grad is None
    levels = tra.route_levels(t(boxes), STRIDES, 2, "canonical")
    want = tra.multilevel_roi_align_plain_bwd(
        t(g).to(dtype), t(boxes), levels, [f.shape[1:3] for f in feats], STRIDES, 7, 0, dtype)
    for f, w in zip(tf, want):
        assert f.grad.dtype == dtype
        assert torch.equal(f.grad, w)
    if dtype == torch.float32:
        for f, w in zip(tf, _jax_vjp(feats, boxes, g, 0)):
            np.testing.assert_allclose(f.grad.numpy(), w, atol=2e-4, rtol=0)


def test_backward_honours_fit_routing():
    feats, boxes, g = _case(5, B=1, n=3)
    boxes = np.concatenate([boxes, np.asarray([[[0, 0, 127, 20]]], np.float32)], 1)
    g = np.concatenate([g, g[:, :1]], 1)
    tf = [t(f).requires_grad_(True) for f in feats]
    (multilevel_roi_align(tf, t(boxes), STRIDES, 7, 2, routing="fit") * t(g)).sum().backward()
    want = _plain_bwd(feats, boxes, g, 2, "fit")
    other = _plain_bwd(feats, boxes, g, 2, "canonical")
    assert any(not torch.equal(a, b) for a, b in zip(want, other))
    for f, w in zip(tf, want):
        assert torch.equal(f.grad, w)
