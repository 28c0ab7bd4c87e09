"""The plain PyTorch pooler (the CUDA kernel's reference) vs the JAX package:
canonical routing against the XLA oracle `multilevel_roi_align` (atol 1e-5,
f32 sums in another order), "fit" routing against the Pallas kernels run in
interpret mode (atol 2e-4, as tests/test_roi_align_pallas.py holds them),
and the level routing itself."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni3d_tpu.ops import roi_align as jra
from omni3d_tpu.ops.roi_align_pallas import _plan, multilevel_roi_align_pallas_batched
from omni3d_tpu_torch.ops import roi_align as tra
from omni3d_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
from torch_port_helpers import t

STRIDES = [4, 8, 16, 32, 64]


def _pyramid(rng, B, img=256, C=8):
    return [rng.standard_normal((B, img // s, img // s, C)).astype(np.float32)
            for s in STRIDES]


def _boxes(rng, B, n, img=256):
    """Random boxes plus edge cases: outside the image, degenerate, touching
    the border, an elongated box past the SMAX clamp, and boxes that
    route to every level."""
    xy = rng.uniform(0, img - 60, (B, n, 2))
    wh = rng.uniform(4, 60, (B, n, 2))
    rand = np.concatenate([xy, xy + wh], -1)
    edge = np.asarray([
        [-20, -12, -2, -3],        # fully outside
        [30, 30, 30, 50],          # zero width
        [40, 40, 35, 60],          # negative width
        [img - 6, img - 6, img, img],
        [0, 0, img - 1, img - 1],  # whole image, coarse level
        [2, 100, img - 2, 106],    # 252 x 6 px: p2, 63 cells across -> g 10 > SMAX
        [10, 10, 50, 50], [10, 10, 90, 90], [10, 10, 170, 170],
        [-100, -90, 400, 410], [-400, -380, 600, 620],   # p5, p6: past the image
    ], np.float32)
    return np.concatenate([rand, np.broadcast_to(edge, (B,) + edge.shape)], 1).astype(np.float32)


@pytest.mark.parametrize("sampling_ratio", [0, 2])
def test_plain_canonical_matches_xla_oracle(sampling_ratio):
    rng = np.random.default_rng(sampling_ratio)
    B = 2
    feats = _pyramid(rng, B)
    boxes = _boxes(rng, B, 12)
    levels = tra.route_levels(t(boxes), STRIDES, 2, "canonical")
    assert set(levels.flatten().tolist()) == {0, 1, 2, 3, 4}
    got = tra.multilevel_roi_align_plain([t(f) for f in feats], t(boxes), levels,
                                         STRIDES, 7, sampling_ratio).numpy()
    for b in range(B):
        want = jra.multilevel_roi_align([jnp.asarray(f[b]) for f in feats],
                                        jnp.asarray(boxes[b]), STRIDES, 7, sampling_ratio)
        np.testing.assert_allclose(got[b], np.asarray(want), atol=1e-5, rtol=0)


def test_plain_bf16_rounds_once_like_the_oracle():
    """bf16 features: f32 accumulation, one final rounding, as the JAX main
    path's `out_dtype=feature dtype` does. Compared in f32; atol is one bf16
    ULP at the output's scale (sums in another order may round the other way)."""
    rng = np.random.default_rng(5)
    B = 2
    feats = [jnp.asarray(f).astype(jnp.bfloat16) for f in _pyramid(rng, B)]
    boxes = _boxes(rng, B, 8)
    want = jax.vmap(lambda fl, bx: jra.multilevel_roi_align(list(fl), bx, STRIDES, 7, 0)
                    )(feats, jnp.asarray(boxes)).astype(jnp.bfloat16)
    tf = [t(np.asarray(f.astype(jnp.float32))).to(torch.bfloat16) for f in feats]
    got = multilevel_roi_align(tf, t(boxes), STRIDES, 7, 0)
    assert got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), w, atol=ulp, rtol=0)


@pytest.mark.parametrize("mode", [None, "dma", "res"])
def test_plain_fit_matches_pallas_interpret(mode):
    """routing="fit" reproduces the TPU kernels' level bump: the values must
    match `multilevel_roi_align_pallas_batched` in interpret mode, for its
    default mode and both kernels (DMA `_pool_dma`, resident `_pool_resident`)."""
    rng = np.random.default_rng(11)
    B = 2
    feats = _pyramid(rng, B)
    # without the negative-width box: with a fixed grid its samples run
    # backwards, out of the TPU kernel's window (it drops those taps; the
    # XLA oracle and the port do not). The main path never makes one.
    edge = np.delete(_boxes(rng, B, 4), 6, axis=1)
    boxes = np.concatenate([edge, np.broadcast_to(np.asarray(
        [[0, 0, 255, 40], [20, 60, 220, 100], [10, 0, 40, 250]], np.float32), (B, 3, 4))], 1)
    assert np.all(boxes[..., 2] >= boxes[..., 0])
    fit = tra.route_levels(t(boxes), STRIDES, 2, "fit")
    assert not torch.equal(fit, tra.route_levels(t(boxes), STRIDES, 2, "canonical"))
    for S in (0, 2):
        want = multilevel_roi_align_pallas_batched(
            [jnp.asarray(f) for f in feats], jnp.asarray(boxes), STRIDES, 7, S,
            interpret=True, mode=mode)
        got = multilevel_roi_align([t(f) for f in feats], t(boxes), STRIDES, 7, S,
                                   routing="fit")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_fit_levels_equal_plan():
    rng = np.random.default_rng(3)
    boxes = _boxes(rng, 1, 200, img=512)[0]
    boxes = np.concatenate([boxes, np.asarray(
        [[0, 0, 511, 30], [0, 0, 30, 511], [5, 5, 300, 60], [0, 0, 200, 200]], np.float32)])
    shapes = [(512 // s, 512 // s) for s in STRIDES]
    plan = jax.jit(_plan, static_argnums=(1, 2, 3, 4, 5))
    lvl = plan(jnp.asarray(boxes), tuple(STRIDES), tuple(shapes), 7, 0, 2)[0]
    np.testing.assert_array_equal(tra.fit_levels(t(boxes), STRIDES, 2).numpy(), np.asarray(lvl))
    canon = np.asarray(jra.assign_fpn_levels(jnp.asarray(boxes)))
    np.testing.assert_array_equal(tra.assign_fpn_levels(t(boxes)).numpy(), canon)


def test_cpu_tensors_take_the_plain_path():
    rng = np.random.default_rng(4)
    feats = [t(f) for f in _pyramid(rng, 1, img=128)]
    boxes = t(_boxes(rng, 1, 5, img=128))
    before = multilevel_roi_align.launches
    got = multilevel_roi_align(feats, boxes, STRIDES, 7, 0)
    assert multilevel_roi_align.launches == before
    levels = tra.route_levels(boxes, STRIDES, 2, "canonical")
    assert torch.equal(got, tra.multilevel_roi_align_plain(feats, boxes, levels, STRIDES, 7, 0))
    with pytest.raises(ValueError):
        multilevel_roi_align(feats, boxes, STRIDES, 7, 0, routing="nearest")

