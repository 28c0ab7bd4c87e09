"""RPN head and proposal selection of the port vs `omni3d_tpu.models.rpn`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni3d_tpu.models import anchors as janchors
from omni3d_tpu.models import rpn as jrpn
from omni3d_tpu.models.rcnn3d import CubeRCNN as JaxCubeRCNN
from omni3d_tpu_torch.models import anchors as tanchors
from omni3d_tpu_torch.models import rpn as trpn
from torch_port_helpers import FPN_CH, jax_model, port_model, random_variables, small_cfgs, t, to_jnp

STRIDES = (4, 8, 16, 32, 64)
SIZES = [[32], [64], [128], [256], [512]]
RATIOS = [[0.5, 1.0, 2.0]]


def test_anchors_equal_jax():
    shapes = [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]
    for a, b in zip(tanchors.pyramid_anchors(shapes, STRIDES, SIZES, RATIOS),
                    janchors.pyramid_anchors(shapes, STRIDES, SIZES, RATIOS)):
        np.testing.assert_array_equal(a, b)


def test_rpn_head_matches_jax():
    jcfg, tcfg = small_cfgs()
    jm = jax_model(jcfg)
    variables = random_variables(jm)
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((2, 64 // s, 64 // s, FPN_CH)).astype(np.float32)
             for s in STRIDES]
    want_l, want_d = jm.apply(to_jnp(variables), [jnp.asarray(f) for f in feats],
                              method=JaxCubeRCNN.rpn)
    model = port_model(tcfg, variables)
    with torch.no_grad():
        got_l, got_d = model.proposal_generator["rpn_head"](
            [t(f).permute(0, 3, 1, 2) for f in feats])
    for g, w in zip(got_l + got_d, list(want_l) + list(want_d)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0)


@pytest.mark.parametrize("post_nms_topk", [100, 256])
def test_select_proposals_matches_jax(post_nms_topk):
    """Logits rounded to a few levels, so top-k order among ties decides;
    post_nms_topk 256 exceeds the 191 candidates and exercises the padding."""
    rng = np.random.default_rng(post_nms_topk)
    B, H, W = 2, 64, 64
    anchors = janchors.pyramid_anchors([(H // s, W // s) for s in STRIDES], STRIDES,
                                       SIZES, RATIOS)
    logits = [np.round(rng.standard_normal((B, a.shape[0])) * 4).astype(np.float32) / 4
              for a in anchors]
    deltas = [(0.3 * rng.standard_normal((B, a.shape[0], 4))).astype(np.float32)
              for a in anchors]
    hw = np.asarray([[64.0, 64.0], [48.0, 56.0]], np.float32)
    pre, thresh = 64, 0.7

    want = jax.vmap(lambda lg, dl, ihw: jrpn.select_proposals(
        [jnp.asarray(a) for a in anchors], lg, dl, ihw, pre, post_nms_topk, thresh))(
        [jnp.asarray(x) for x in logits], [jnp.asarray(x) for x in deltas], jnp.asarray(hw))
    got = trpn.select_proposals([t(a) for a in anchors], [t(x) for x in logits],
                                [t(x) for x in deltas], t(hw), pre, post_nms_topk, thresh)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4, rtol=0)
    assert 0 < got[2].sum() < B * post_nms_topk
