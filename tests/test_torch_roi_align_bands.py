"""The banded form of multilevel ROIAlign that the CUDA kernels compute
(per-axis weights Ay, Ax of each box: pooling Ay F Ax^T, the feature gradient
Ay^T G Ax), through `ops.roi_align.axis_bands`, the CPU mirror of the
kernels' geometry (`csrc/roi_align_common.cuh`).

The forward mirror pools each bin through its band rows, T[y, px] = sum_x
Ax[px, x] F[y, x], then out[py, px] += Ay[py, y] T[y, px], as
`csrc/roi_align_fwd.cu` does; the backward mirror accumulates each level's
gradient tile by tile (GRAD_TILE cells) over the boxes in index order, as
`csrc/roi_align_bwd.cu` does. Both are held against the plain PyTorch
versions (f32 rtol 1e-5) and the backward against the JAX package (atol
2e-4, as tests/test_torch_roi_align_bwd.py holds the plain backward)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni3d_tpu.ops.roi_align_bwd_pallas import roi_align_bwd_pallas
from omni3d_tpu_torch.ops import roi_align as tra
from test_torch_roi_align_bwd import _case as _jax_case, _jax_vjp
from torch_port_helpers import t

STRIDES = (4, 8, 16, 32, 64)
IMG = 512
C = 8
P = 7
WIN = tra.GRAD_TILE
NAN = float("nan")


def _case(seed, n=24):
    """(2, n + 14) boxes: chip_smoke.make_boxes' edge cases (outside the
    image, zero width and height, touching the border, 512 x 8 px = 128
    cells wide at p2, 6 x 512 px, the whole image at p5/p6), a box of
    negative width, a NaN box, and random boxes of log-uniform size; a
    pyramid and a cotangent."""
    rng = np.random.default_rng(seed)
    edge = np.asarray([
        [-40, -30, -4, -6], [100, 100, 100, 140], [200, 220, 230, 220],
        [IMG - 9, IMG - 7, IMG, IMG], [0, 0, IMG, IMG], [0, 200, IMG, 208],
        [300, 0, 306, IMG], [10, 10, 60, 60], [10, 10, 120, 120], [10, 10, 250, 250],
        [-100, -100, 500, 500], [-500, -400, 900, 1000],
        [90, 40, 30, 100], [NAN, NAN, NAN, NAN],
    ], np.float32)
    size = np.exp(rng.uniform(2.0, 6.0, (2, n, 2)))
    xy = rng.uniform(0, 1, (2, n, 2)) * (IMG - size)
    boxes = np.concatenate([np.broadcast_to(edge, (2,) + edge.shape),
                            np.concatenate([xy, xy + size], -1)], 1).astype(np.float32)
    feats = [torch.from_numpy(rng.standard_normal((2, IMG // s, IMG // s, C)).astype(np.float32))
             for s in STRIDES]
    g = torch.from_numpy(rng.standard_normal((2, boxes.shape[1], P, P, C)).astype(np.float32))
    return feats, torch.from_numpy(boxes), g


def _bands(boxes, levels, shapes, S):
    """Per flat box: (first, count, weights) along y and along x."""
    lv = levels.reshape(-1).long()
    H = torch.tensor([h for h, _ in shapes])[lv]
    W = torch.tensor([w for _, w in shapes])[lv]
    scale = torch.tensor([1.0 / s for s in STRIDES], dtype=torch.float32)[lv]
    b = boxes.reshape(-1, 4) * scale[:, None] - 0.5
    return (tra.axis_bands(b[:, 1], b[:, 3] - b[:, 1], H, P, S),
            tra.axis_bands(b[:, 0], b[:, 2] - b[:, 0], W, P, S))


def _window(band, i, w0, n):
    """(P, n) weights of box i's band over the cells [w0, w0 + n)."""
    first, count, A = band
    j = torch.arange(n) + w0 - int(first[i])
    ok = (j >= 0) & (j < int(count[i]))
    out = torch.zeros(P, n)
    out[:, ok] = A[i][:, j[ok]]
    return out


def _banded_pool(feats, boxes, levels, S):
    """Ay F Ax^T per box over its band: T = F Ax^T per band row, then Ay T."""
    B, N = boxes.shape[:2]
    by, bx = _bands(boxes, levels, [f.shape[1:3] for f in feats], S)
    lv = levels.reshape(-1)
    out = torch.zeros(B * N, P, P, C)
    for i in range(B * N):
        y0, ny = int(by[0][i]), int(by[1][i])
        x0, nx = int(bx[0][i]), int(bx[1][i])
        if ny and nx:
            f = feats[int(lv[i])][i // N, y0:y0 + ny, x0:x0 + nx]
            T = torch.einsum("qx,yxc->yqc", bx[2][i][:, :nx], f)
            out[i] = torch.einsum("py,yqc->pqc", by[2][i][:, :ny], T)
    return out.reshape(B, N, P, P, C)


def _banded_pool_bwd(g, boxes, levels, shapes, S):
    """Ay^T G Ax per box, accumulated into each level's gradient tile by tile
    (WIN x WIN cells), over the image's boxes of that level in index order."""
    B, N = boxes.shape[:2]
    by, bx = _bands(boxes, levels, shapes, S)
    lv = levels.reshape(-1)
    g = g.reshape(B * N, P, P, C)
    grads = []
    for level, (H, W) in enumerate(shapes):
        d = torch.zeros(B, H, W, C)
        for b in range(B):
            mine = [i for i in range(b * N, (b + 1) * N) if int(lv[i]) == level]
            for ty0 in range(0, H, WIN):
                for tx0 in range(0, W, WIN):
                    hy, hx = min(WIN, H - ty0), min(WIN, W - tx0)
                    for i in mine:
                        ay, ax = _window(by, i, ty0, hy), _window(bx, i, tx0, hx)
                        T = torch.einsum("qx,pqc->pxc", ax, g[i])
                        d[b, ty0:ty0 + hy, tx0:tx0 + hx] += torch.einsum("py,pxc->yxc", ay, T)
        grads.append(d)
    return grads


def _may_touch(lo, size, c0, n):
    """The kernels' skip test (roi_align_common.cuh::may_touch) in float32."""
    e = lo + size
    mn, mx = torch.minimum(lo, e), torch.maximum(lo, e)
    m = 2.0 + 1e-5 * (lo.abs() + e.abs())
    return (mx + m >= c0) & (mn - m < c0 + n)


@pytest.mark.parametrize("routing", ["canonical", "fit"])
@pytest.mark.parametrize("sampling_ratio", [0, 2])
def test_bands_hold_every_live_tap_and_no_more(sampling_ratio, routing):
    """Every tap of nonzero weight that `_chunk_taps` gives the plain version
    lies inside its box's bands, and each band ends at such taps; the band of
    a NaN box is empty; the kernels' skip test passes every box whose band
    reaches a tile."""
    feats, boxes, _ = _case(sampling_ratio)
    levels = tra.route_levels(boxes, STRIDES, 2, routing)
    shapes = [tuple(f.shape[1:3]) for f in feats]
    by, bx = _bands(boxes, levels, shapes, sampling_ratio)
    assert int(torch.cat([by[1], bx[1]]).max()) > 2 * WIN   # a band wider than a tile
    sizes, offsets, Hs, Ws, _ = tra._level_tables(shapes, 2, STRIDES, "cpu")
    lv = levels.reshape(-1).long()
    N = boxes.shape[1]
    img = torch.arange(2).repeat_interleave(N)
    lo_y = torch.full((2 * N,), 1 << 30)
    hi_y = torch.full((2 * N,), -1)
    lo_x, hi_x = lo_y.clone(), hi_y.clone()
    for s, e, taps, wy, wx in tra._chunk_taps(boxes, levels, shapes, STRIDES, P,
                                              sampling_ratio, C):
        base = offsets[lv[s:e]] + img[s:e] * Hs[lv[s:e]] * Ws[lv[s:e]]
        Wl = Ws[lv[s:e]][:, None, None]
        for idx, w in taps:
            live = (w * (wy[:, :, None] * wx[:, None, :])) != 0
            rel = idx - base[:, None, None]
            y, x = rel // Wl, rel % Wl
            big = torch.full_like(y, 1 << 30)
            lo_y[s:e] = torch.minimum(lo_y[s:e], torch.where(live, y, big).amin((1, 2)))
            hi_y[s:e] = torch.maximum(hi_y[s:e], torch.where(live, y, -1).amax((1, 2)))
            lo_x[s:e] = torch.minimum(lo_x[s:e], torch.where(live, x, big).amin((1, 2)))
            hi_x[s:e] = torch.maximum(hi_x[s:e], torch.where(live, x, -1).amax((1, 2)))
    any_live = hi_y >= 0
    both = (by[1] > 0) & (bx[1] > 0)
    assert torch.equal(any_live, both)
    for (first, count, _), lo, hi in ((by, lo_y, hi_y), (bx, lo_x, hi_x)):
        assert torch.equal(first[both], lo[both])
        assert torch.equal((first + count - 1)[both], hi[both])
    nan = torch.isnan(boxes.reshape(-1, 4)).any(-1)
    assert bool(nan.any()) and bool((by[1][nan] == 0).all() & (bx[1][nan] == 0).all())

    scale = torch.tensor([1.0 / s for s in STRIDES], dtype=torch.float32)[lv]
    b = boxes.reshape(-1, 4) * scale[:, None] - 0.5
    for (first, count, _), lo, size, limit in ((by, b[:, 1], b[:, 3] - b[:, 1], Hs[lv]),
                                               (bx, b[:, 0], b[:, 2] - b[:, 0], Ws[lv])):
        for c0 in range(0, int(limit.max()), WIN):
            reaches = (count > 0) & (first < c0 + WIN) & (first + count > c0) & (c0 < limit)
            assert bool(_may_touch(lo, size, c0, WIN)[reaches].all()), c0


@pytest.mark.parametrize("routing", ["canonical", "fit"])
@pytest.mark.parametrize("sampling_ratio", [0, 2])
def test_banded_pool_and_tiled_transpose_match_plain(sampling_ratio, routing):
    """Ay F Ax^T over each box's bands equals `multilevel_roi_align_plain`,
    and the tile-by-tile Ay^T G Ax equals `multilevel_roi_align_plain_bwd`,
    at f32 rtol 1e-5 (the same terms summed in another order)."""
    feats, boxes, g = _case(10 + sampling_ratio)
    levels = tra.route_levels(boxes, STRIDES, 2, routing)
    shapes = [tuple(f.shape[1:3]) for f in feats]
    want = tra.multilevel_roi_align_plain(feats, boxes, levels, STRIDES, P, sampling_ratio)
    got = _banded_pool(feats, boxes, levels, sampling_ratio)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    want = tra.multilevel_roi_align_plain_bwd(g, boxes, levels, shapes, STRIDES, P,
                                              sampling_ratio)
    got = _banded_pool_bwd(g, boxes, levels, shapes, sampling_ratio)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sampling_ratio", [0, 2])
def test_banded_bwd_matches_jax_vjp(sampling_ratio):
    """Canonical routing: the tiled banded backward against `jax.vjp` of the
    XLA oracle `omni3d_tpu.ops.roi_align.multilevel_roi_align`."""
    feats, boxes, g = _jax_case(sampling_ratio, B=2, n=6)
    levels = tra.route_levels(t(boxes), STRIDES, 2, "canonical")
    got = _banded_pool_bwd(t(g), t(boxes), levels, [f.shape[1:3] for f in feats],
                           sampling_ratio)
    for a, b in zip(got, _jax_vjp(feats, boxes, g, sampling_ratio)):
        np.testing.assert_allclose(a.numpy(), b, atol=2e-4, rtol=0)


@pytest.mark.parametrize("sampling_ratio", [2])
def test_banded_bwd_fit_matches_pallas_interpret(sampling_ratio):
    """routing="fit": the tiled banded backward against the TPU kernel
    `roi_align_bwd_pallas` in interpret mode, on boxes inside its windows
    (one sampling ratio: interpret mode compiles for seconds per case)."""
    feats, boxes, g = _jax_case(7 + sampling_ratio, B=1, n=1)
    boxes = np.delete(boxes, [3, 4], axis=1)
    boxes = np.concatenate([boxes, np.asarray(
        [[[0, 0, 127, 20], [10, 0, 30, 125]]], np.float32)], 1)
    g = g[:, :boxes.shape[1]]
    fit = tra.route_levels(t(boxes), STRIDES, 2, "fit")
    got = _banded_pool_bwd(t(g), t(boxes), fit, [f.shape[1:3] for f in feats],
                           sampling_ratio)
    want = roi_align_bwd_pallas([jnp.asarray(f) for f in feats], jnp.asarray(boxes),
                                jnp.asarray(g), list(STRIDES), 7, sampling_ratio,
                                interpret=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4, rtol=0)
