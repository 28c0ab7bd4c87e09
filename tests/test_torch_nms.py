"""Port NMS vs `omni3d_tpu.ops.nms`: kept sets must be equal, including the
JAX package's blocked path (N > 256) and tied scores."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni3d_tpu.ops import nms as jnms
from omni3d_tpu_torch.ops import nms as tnms
from torch_port_helpers import t


def _boxes(rng, n, spread=200.0):
    xy = rng.uniform(0, spread, (n, 2))
    wh = rng.uniform(5, 60, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("n", [64, 256, 300, 700])
@pytest.mark.parametrize("ties", [False, True])
def test_nms_mask_matches_jax(n, ties):
    rng = np.random.default_rng(n + ties)
    boxes = _boxes(rng, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if ties:   # a few score levels only: ordering among equals decides
        scores = np.round(scores * 4) / 4
    valid = rng.uniform(size=n) > 0.1
    want = np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                                    jnp.asarray(valid)))
    got = tnms.nms_mask(t(boxes), t(scores), 0.5, t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()


def test_nms_mask_batched_rows_are_independent():
    rng = np.random.default_rng(7)
    boxes = np.stack([_boxes(rng, 80) for _ in range(3)])
    scores = rng.uniform(0, 1, (3, 80)).astype(np.float32)
    got = tnms.nms_mask(t(boxes), t(scores), 0.7).numpy()
    for b in range(3):
        want = np.asarray(jnms.nms_mask(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), 0.7))
        np.testing.assert_array_equal(got[b], want)


@pytest.mark.parametrize("n,max_out", [(120, 50), (300, 400)])
def test_batched_nms_indices_matches_jax(n, max_out):
    rng = np.random.default_rng(n)
    boxes = _boxes(rng, n, spread=80.0)
    scores = np.round(rng.uniform(0, 1, n) * 8).astype(np.float32) / 8
    classes = rng.integers(0, 4, n).astype(np.int32)
    valid = rng.uniform(size=n) > 0.2
    want_i, want_v = jnms.batched_nms_indices(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), 0.5, max_out,
        jnp.asarray(valid))
    got_i, got_v = tnms.batched_nms_indices(t(boxes), t(scores), t(classes), 0.5, max_out,
                                            t(valid))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_sort_desc_matches_lax_top_k():
    """Ties in index order; -0.0 below +0.0 as in XLA's total order."""
    from jax import lax
    x = torch.tensor([[1.0, 3.0, 3.0, -0.0, 0.0, -1e10, 3.0, -0.0, 1.0, -1e10]])
    vals, idx = tnms.sort_desc(x, 8)
    want_v, want_i = lax.top_k(jnp.asarray(x.numpy()), 8)
    assert idx.tolist() == np.asarray(want_i).tolist() == [[1, 2, 6, 0, 8, 4, 3, 7]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
