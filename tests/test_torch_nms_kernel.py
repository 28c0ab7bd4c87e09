"""The NMS kernels' CPU mirror (`ops.nms.suppression_words`,
`greedy_keep_from_words`) vs the plain fixpoint `ops.nms.nms_mask_plain`
vs the JAX package's `omni3d_tpu.ops.nms.nms_mask`: keep masks equal bit
for bit on seeded clusters with duplicates, exact score ties, zero-area
boxes, a NaN box and invalid rows, at row lengths around the 64-box word
(and 257, the JAX package's blocked path); rows whose valid boxes are not a
prefix; pairs within 4 ULP of the threshold; the words' layout against a
brute-force loop; the words kernel's fast IoU test, emulated, against the
division; and the dispatch (CPU tensors take the plain version; the
kernels' wrappers refuse CPU tensors)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni3d_tpu.ops import nms as jnms
from omni3d_tpu_torch.ops import nms as tnms
from omni3d_tpu_torch.ops import nms_cuda
from torch_port_helpers import t


def _clusters(rng, n, nan=True):
    """n boxes in clusters (heavy overlap), ~10% exact duplicates, ~5% of
    zero width, scores on 17 levels (exact ties), ~10% invalid, and one box
    with a NaN coordinate."""
    centers = rng.uniform(20, 400, (max(1, n // 8), 2))
    c = centers[rng.integers(0, len(centers), n)] + rng.normal(0, 6, (n, 2))
    wh = rng.uniform(8, 80, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    k = n // 10
    if k:
        boxes[rng.choice(n, k, replace=False)] = boxes[rng.integers(0, n, k)]
        z = rng.choice(n, max(1, n // 20), replace=False)
        boxes[z, 2] = boxes[z, 0]
    if nan and n >= 3:
        boxes[n // 2, 1] = np.nan
    scores = (np.round(rng.uniform(0, 1, n) * 16) / 16).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    return boxes, scores, valid


def _mirror_mask(boxes, scores, thresh, valid=None):
    """`nms_mask` through the kernels' CPU mirror: sort, words, greedy walk,
    back to input order."""
    boxes_s, valid_s, order = tnms._sorted(boxes, scores, valid)
    keep_s = tnms.greedy_keep_from_words(tnms.suppression_words(boxes_s, valid_s, thresh),
                                         valid_s)
    return torch.empty_like(keep_s).scatter_(-1, order, keep_s)


def _jax_mask(boxes, scores, thresh, valid):
    return np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), thresh,
                                    jnp.asarray(valid)))


@pytest.mark.parametrize("n", [1, 63, 64, 65, 257, 1000])
@pytest.mark.parametrize("thresh", [0.5, 0.7])
def test_mirror_equals_plain_equals_jax(n, thresh):
    rng = np.random.default_rng(n)
    boxes, scores, valid = _clusters(rng, n)
    want = _jax_mask(boxes, scores, thresh, valid)
    plain = tnms.nms_mask_plain(t(boxes), t(scores), thresh, t(valid)).numpy()
    mirror = _mirror_mask(t(boxes), t(scores), thresh, t(valid)).numpy()
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(mirror, want)
    assert not (want & ~valid).any()
    if n >= 63:   # the clusters suppress: some valid boxes go
        assert 0 < want.sum() < valid.sum()


def test_nan_box_neither_suppresses_nor_is_suppressed():
    """A valid box with a NaN coordinate has IoU 0 with every box (its area
    is NaN, so the union is not > 0): it is kept, and it removes nothing,
    even as an exact copy of a kept box with one coordinate NaN."""
    boxes = np.array([[0, 0, 10, 10], [0, np.nan, 10, 10], [0, 0, 10, 10], [1, 1, 10, 10]],
                     np.float32)
    scores = np.array([0.9, 0.95, 0.8, 0.7], np.float32)
    valid = np.ones(4, bool)
    want = _jax_mask(boxes, scores, 0.5, valid)
    assert want.tolist() == [True, True, False, False]
    for got in (tnms.nms_mask_plain(t(boxes), t(scores), 0.5, t(valid)),
                _mirror_mask(t(boxes), t(scores), 0.5, t(valid)),
                tnms.nms_mask(t(boxes), t(scores), 0.5, t(valid))):
        assert got.tolist() == want.tolist()


def test_words_layout_against_a_brute_force_loop():
    """Bit b of words[w, i] (sorted order) is IoU(i, 64 w + b) > t for j > i
    with i and j valid: (W, 64 W) words, a pair tile's 64 words contiguous,
    padding boxes i >= N all zero; bit 63 is the sign bit of the int64
    word."""
    rng = np.random.default_rng(3)
    boxes, scores, valid = _clusters(rng, 130, nan=False)
    boxes_s, valid_s, _ = tnms._sorted(t(boxes), t(scores), t(valid))
    words = tnms.suppression_words(boxes_s, valid_s, 0.5)
    assert words.shape == (3, 192) and words.dtype == torch.int64
    iou = tnms.box_ops.pairwise_iou(boxes_s, boxes_s).numpy()
    v = valid_s.numpy()
    u = words.numpy().view(np.uint64)
    for i in range(192):
        for j in range(192):
            bit = bool((u[j // 64, i] >> np.uint64(j % 64)) & np.uint64(1))
            want = (max(i, j) < 130 and bool(v[i] and v[j]) and j > i
                    and iou[i, j] > np.float32(0.5))
            assert bit == want, (i, j)
    assert (words < 0).any()   # some bit 63 is set


def test_valid_boxes_need_not_be_a_prefix():
    """A +NaN score sorts first and is invalid; an all-invalid tile in the
    middle of a sorted row: the mirror's words and walk give the plain and
    the JAX masks, and the invalid boxes' words are zero."""
    rng = np.random.default_rng(17)
    boxes, scores, valid = _clusters(rng, 257)
    scores[7] = np.nan
    want = _jax_mask(boxes, scores, 0.7, valid)
    np.testing.assert_array_equal(tnms.nms_mask_plain(t(boxes), t(scores), 0.7, t(valid)), want)
    np.testing.assert_array_equal(_mirror_mask(t(boxes), t(scores), 0.7, t(valid)), want)
    boxes_s, valid_s, _ = tnms._sorted(t(boxes), t(scores), t(valid))
    assert not valid_s[0] and valid_s[1:].any()

    # rows already in score order, the second 64-box tile all invalid
    order = np.argsort(-scores, kind="stable")
    bs, vs = boxes[order], valid[order].copy()
    vs[64:128] = False
    desc = np.linspace(1, 0.5, 257, dtype=np.float32)
    want = _jax_mask(bs, desc, 0.7, vs)
    words = tnms.suppression_words(t(bs), t(vs), 0.7)
    assert not words[:, 64:128].any()
    keep = tnms.greedy_keep_from_words(words, t(vs)).numpy()
    np.testing.assert_array_equal(keep, want)
    np.testing.assert_array_equal(tnms.nms_mask_plain(t(bs), t(desc), 0.7, t(vs)), want)
    assert keep[128:].any() and not keep[64:128].any()


def _fast_test(inter, uni, thresh):
    """The words kernel's IoU decision for t >= 0 in float32 numpy, as
    `csrc/nms.cu::iou_above<true>` makes it: (bit, slow)."""
    fast, lo, hi = nms_cuda.iou_band(thresh)
    assert fast
    lo, hi = np.float32(lo), np.float32(hi)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        exact = (inter / uni) > np.float32(thresh)
        overlap = (inter > 0) & (uni > 0)
        normal = overlap & (uni >= np.float32(2.0 ** -60))
        above = normal & (inter > hi * uni)
        below = normal & (inter < lo * uni)
    slow = overlap & ~above & ~below
    return np.where(slow, exact, above), slow


@pytest.mark.parametrize("thresh", [0.5, 0.7])
def test_fast_iou_test_decides_as_the_division(thresh):
    """The band of `nms_cuda.iou_band`: outside it the products decide as
    the IEEE quotient does, on pairs within 4 ULP of t and on clustered
    boxes; only pairs within about 3 ULP of the midpoint of t and the next
    float divide."""
    from omni3d_tpu_torch.tools import profile_nms
    boxes, _, _, off = profile_nms.near_threshold((2, 512), thresh, 5)
    a, b = boxes[:, 0::2, 2].numpy().ravel(), boxes[:, 1::2, 2].numpy().ravel()
    inter, uni = b, (a + b) - b
    bit, slow = _fast_test(inter, uni, thresh)
    iou = tnms.box_ops.pairwise_iou(boxes[:, :2], boxes[:, :2])   # pair 0 of each row
    assert iou[:, 0, 1].tolist() == (inter / uni)[[0, 256]].tolist()   # torch's own IoU
    np.testing.assert_array_equal(bit, (inter / uni) > np.float32(thresh))
    off = off.ravel()
    assert slow.any() and (~slow).any() and bit.any() and (~bit).any()
    assert not slow[np.abs(off - 0.5) > 3].any()
    assert np.abs(off - 0.5).min() < 1e-2 and (off < 0.5).any() and (off > 0.5).any()

    rng = np.random.default_rng(1)
    bx, _, _ = _clusters(rng, 400)
    x1, y1, x2, y2 = (bx[:, None, k] for k in range(4))
    X1, Y1, X2, Y2 = (bx[None, :, k] for k in range(4))
    with np.errstate(invalid="ignore"):
        iw = np.minimum(x2, X2) - np.maximum(x1, X1)
        ih = np.minimum(y2, Y2) - np.maximum(y1, Y1)
        inter = np.where(iw < 0, 0, iw) * np.where(ih < 0, 0, ih)
        area = np.where(x2 < x1, 0, x2 - x1) * np.where(y2 < y1, 0, y2 - y1)
        uni = (area + area.T) - inter
    bit, slow = _fast_test(inter, uni, thresh)
    want = tnms.box_ops.pairwise_iou(t(bx), t(bx)).numpy() > np.float32(thresh)
    np.testing.assert_array_equal(bit, want)
    assert slow.mean() < 1e-3


def test_iou_band_modes():
    """t < 0 or NaN divides every pair; t >= 0 outside [2^-30, 2^30] divides
    every overlapping pair; inside, the band brackets the midpoint within a
    few ULP of t."""
    assert nms_cuda.iou_band(-0.1) == (False, float("-inf"), float("inf"))
    assert nms_cuda.iou_band(float("nan"))[0] is False
    assert nms_cuda.iou_band(0.0) == (True, float("-inf"), float("inf"))
    for thresh in (0.5, 0.7, 1e-3, 1.0):
        fast, lo, hi = nms_cuda.iou_band(thresh)
        tt = np.float32(thresh)
        up = np.nextafter(tt, np.float32(np.inf))
        m = (float(tt) + float(up)) / 2
        ulp = float(up) - float(tt)
        assert fast and lo < m < hi and np.float32(lo) == lo and np.float32(hi) == hi
        assert hi >= m * (1 + 2.0 ** -23) and lo <= m * (1 - 2.0 ** -23)
        assert hi - m < 2.5 * ulp and m - lo < 3 * ulp


def test_near_threshold_pairs_through_the_mirror():
    """Pairs whose IoU lies within 4 ULP of t: each second box is dropped
    iff its pair's IoU > t, in the mirror, the plain fixpoint and the JAX
    nms_mask alike."""
    from omni3d_tpu_torch.tools import profile_nms
    for thresh in (0.5, 0.7):
        boxes, scores, valid, _ = profile_nms.near_threshold((1, 64), thresh, 9)
        iou = tnms.box_ops.pairwise_iou(boxes[0], boxes[0]).numpy()
        want = np.ones(64, bool)
        want[1::2] = ~(iou[np.arange(0, 64, 2), np.arange(1, 64, 2)] > np.float32(thresh))
        assert 0 < want[1::2].sum() < 32
        np.testing.assert_array_equal(tnms.nms_mask_plain(boxes, scores, thresh, valid)[0], want)
        np.testing.assert_array_equal(_mirror_mask(boxes, scores, thresh, valid)[0], want)
        np.testing.assert_array_equal(
            _jax_mask(boxes[0].numpy(), scores[0].numpy(), thresh, valid[0].numpy()), want)


def test_all_invalid_rows_keep_nothing():
    rng = np.random.default_rng(5)
    boxes = np.stack([_clusters(rng, 100)[0] for _ in range(2)])
    scores = rng.uniform(0, 1, (2, 100)).astype(np.float32)
    invalid = np.zeros((2, 100), bool)
    plain = tnms.nms_mask_plain(t(boxes), t(scores), 0.7, t(invalid))
    mirror = _mirror_mask(t(boxes), t(scores), 0.7, t(invalid))
    assert not plain.any() and not mirror.any()
    padded = np.full((2, 100), tnms.NEG_INF, np.float32)   # or padding scores alone
    assert not _mirror_mask(t(boxes), t(padded), 0.7).any()
    assert not tnms.nms_mask(t(boxes), t(padded), 0.7).any()


def test_batched_rows_as_select_proposals_pads_them():
    """(B, L, N) rows as `select_proposals` stacks the levels: each level's
    candidates padded to the longest with invalid rows and NEG_INF scores."""
    rng = np.random.default_rng(11)
    B, L, N = 2, 3, 130
    boxes = np.zeros((B, L, N, 4), np.float32)
    scores = np.full((B, L, N), tnms.NEG_INF, np.float32)
    valid = np.zeros((B, L, N), bool)
    for b in range(B):
        for lv, k in enumerate((130, 70, 9)):
            bx, sc, va = _clusters(rng, k)
            boxes[b, lv, :k], scores[b, lv, :k], valid[b, lv, :k] = bx, sc, va
    plain = tnms.nms_mask_plain(t(boxes), t(scores), 0.7, t(valid)).numpy()
    mirror = _mirror_mask(t(boxes), t(scores), 0.7, t(valid)).numpy()
    np.testing.assert_array_equal(mirror, plain)
    for b in range(B):
        for lv in range(L):
            np.testing.assert_array_equal(
                plain[b, lv], _jax_mask(boxes[b, lv], scores[b, lv], 0.7, valid[b, lv]))
    assert not plain[:, :, 70:][:, 1:].any()


@pytest.mark.parametrize("n,max_out", [(200, 100), (1024, 100)])
def test_class_offsets_through_the_mirror(n, max_out):
    """`batched_nms_indices`' coordinate offset ahead of the words: the
    mirror on the shifted boxes gives the plain and the JAX masks."""
    rng = np.random.default_rng(n)
    boxes, scores, valid = _clusters(rng, n, nan=False)
    classes = rng.integers(0, 5, n).astype(np.int32)
    shifted = tnms._offset_by_class(t(boxes), t(classes))
    mirror = _mirror_mask(shifted, t(scores), 0.5, t(valid)).numpy()
    plain = tnms.batched_nms_mask(t(boxes), t(scores), t(classes), 0.5, t(valid)).numpy()
    want = np.asarray(jnms.batched_nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                            jnp.asarray(classes), 0.5, jnp.asarray(valid)))
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(mirror, want)
    got_i, got_v = tnms.batched_nms_indices(t(boxes), t(scores), t(classes), 0.5, max_out,
                                            t(valid))
    want_i, want_v = jnms.batched_nms_indices(jnp.asarray(boxes), jnp.asarray(scores),
                                              jnp.asarray(classes), 0.5, max_out,
                                              jnp.asarray(valid))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    rng = np.random.default_rng(2)
    boxes, scores, valid = _clusters(rng, 100)
    launches = (nms_cuda.suppression_words.launches, nms_cuda.greedy_keep.launches)
    got = tnms.nms_mask(t(boxes), t(scores), 0.7, t(valid))
    assert torch.equal(got, tnms.nms_mask_plain(t(boxes), t(scores), 0.7, t(valid)))
    assert (nms_cuda.suppression_words.launches, nms_cuda.greedy_keep.launches) == launches
    with pytest.raises(ValueError):
        tnms.nms_mask(t(boxes).to("meta"), t(scores).to("meta"), 0.7)


def test_the_kernels_wrappers_refuse_cpu_tensors():
    """The wrappers take CUDA tensors only: a CPU tensor raises before any
    library is loaded (there is no fallback inside them)."""
    boxes = torch.zeros(2, 10, 4)
    valid = torch.ones(2, 10, dtype=torch.bool)
    with pytest.raises(ValueError):
        nms_cuda.suppression_words(boxes, valid, 0.5)
    with pytest.raises(ValueError):
        nms_cuda.greedy_keep(torch.zeros(2, 10, 1, dtype=torch.int64), valid)
