"""The whole slice: the port's `inference` vs the JAX package's
`inference_impl` on the CPU, f32, same weights and inputs.

Discrete outputs (valid masks, classes) must be equal. Float tolerances:
boxes and centers in pixels at atol 2e-3 (the backbone differs by up to
3e-4, see test_torch_backbone, and box deltas scale it by the box size),
scores at 1e-4, 3D outputs at atol 2e-3 with rtol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omni3d_tpu.models.rcnn3d import inference_impl, preprocess as jax_preprocess
from omni3d_tpu_torch.models.rcnn3d import inference, preprocess
from torch_port_helpers import jax_model, port_model, random_variables, small_cfgs, t, to_jnp

B, H, W = 2, 96, 128
KW = dict(score_thresh=0.05, nms_thresh=0.5, topk=10, nms_candidates=128,
          pre_nms_topk=64, post_nms_topk=64, rpn_nms_thresh=0.7, sampling_ratio=0)
TOL = {"boxes": 2e-3, "boxes_orig": 2e-3, "proposal_boxes": 2e-3, "center_2D": 2e-3,
       "scores_2d": 1e-4, "scores": 1e-4, "scores_full": 1e-4, "center_cam": 2e-3,
       "dims": 2e-3, "pose": 2e-3, "corners": 2e-3}


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = small_cfgs()
    jm = jax_model(jcfg)
    variables = random_variables(jm, (H, W), seed=4)
    model = port_model(tcfg, variables)
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 255, (B, H, W, 3)).astype(np.uint8)
    K = np.asarray([[[250.0, 0, 70], [0, 250.0, 50], [0, 0, 1]],
                    [[400.0, 0, 60], [0, 380.0, 45], [0, 0, 1]]], np.float32)
    ratio = np.asarray([1.0, 1.5], np.float32)
    return jcfg, jm, variables, model, raw, K, ratio


def _compare(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, k
        if k in ("valid", "classes", "proposal_valid"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=TOL[k], rtol=1e-4, err_msg=k)


def test_inference_matches_jax(setup):
    jcfg, jm, variables, model, raw, K, ratio = setup
    hw = np.asarray([[96.0, 128.0], [80.0, 110.0]], np.float32)
    jimg = jax_preprocess(jnp.asarray(raw), jcfg.MODEL.PIXEL_MEAN, jcfg.MODEL.PIXEL_STD)
    want = jax.jit(lambda v, im: inference_impl(
        v, jm, im, jnp.asarray(K), jnp.asarray(ratio), hw=jnp.asarray(hw), **KW))(
        to_jnp(variables), jimg)
    img = preprocess(t(raw), jcfg.MODEL.PIXEL_MEAN, jcfg.MODEL.PIXEL_STD)
    np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
    Kt = t(K)
    got = inference(model, img, Kt, t(ratio), hw=t(hw), **KW)
    np.testing.assert_array_equal(Kt.numpy(), K)   # the caller's Ks stay untouched
    assert got["valid"].sum() > 5 and got["proposal_valid"].sum() > 20
    _compare(got, want)


def test_oracle_inference_matches_jax(setup):
    jcfg, jm, variables, model, raw, K, ratio = setup
    o_boxes = np.asarray([[[10.0, 10.0, 60.0, 60.0], [30.0, 40.0, 90.0, 90.0],
                           [0.0, 0.0, 128.0, 96.0]],
                          [[5.0, 20.0, 40.0, 70.0], [50.0, 10.0, 120.0, 30.0],
                           [0.0, 0.0, 1.0, 1.0]]], np.float32)
    o_classes = np.asarray([[1, 3, 0], [4, 2, 0]], np.int32)
    o_valid = np.asarray([[True, True, True], [True, True, False]])
    jimg = jax_preprocess(jnp.asarray(raw), jcfg.MODEL.PIXEL_MEAN, jcfg.MODEL.PIXEL_STD)
    want = jax.jit(lambda v, im: inference_impl(
        v, jm, im, jnp.asarray(K), jnp.asarray(ratio),
        oracle=tuple(map(jnp.asarray, (o_boxes, o_classes, o_valid))), sampling_ratio=0))(
        to_jnp(variables), jimg)
    img = preprocess(t(raw), jcfg.MODEL.PIXEL_MEAN, jcfg.MODEL.PIXEL_STD)
    got = inference(model, img, t(K), t(ratio),
                    oracle=(t(o_boxes), t(o_classes), t(o_valid)), sampling_ratio=0)
    _compare(got, want)
