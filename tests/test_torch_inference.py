"""The whole slice: the port's `inference` and `inference_step` vs the JAX
package's `inference_step` (`jax.jit` of `inference_impl`) on the CPU, f32,
same weights and inputs. `inference_step` on CPU tensors is `inference`
itself; its graph key, its storage check and that it leaves `torch.cuda`
alone are tested here, its CUDA graphs in tests/test_torch_cuda.py.

Discrete outputs (valid masks, classes) must be equal. Float tolerances:
boxes and centers in pixels at atol 2e-3 (the backbone differs by up to
3e-4, see test_torch_backbone, and box deltas scale it by the box size),
scores at 1e-4, 3D outputs at atol 2e-3 with rtol 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni3d_tpu.models.rcnn3d import inference_step as jax_inference_step
from omni3d_tpu.models.rcnn3d import preprocess as jax_preprocess
from omni3d_tpu_torch.models import rcnn3d
from omni3d_tpu_torch.models.rcnn3d import inference, inference_step, preprocess
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


HW = np.asarray([[96.0, 128.0], [80.0, 110.0]], np.float32)
ORACLE = (np.asarray([[[10.0, 10.0, 60.0, 60.0], [30.0, 40.0, 90.0, 90.0],
                       [0.0, 0.0, 128.0, 96.0]],
                      [[5.0, 20.0, 40.0, 70.0], [50.0, 10.0, 120.0, 30.0],
                       [0.0, 0.0, 1.0, 1.0]]], np.float32),
          np.asarray([[1, 3, 0], [4, 2, 0]], np.int32),
          np.asarray([[True, True, True], [True, True, False]]))
PORT = pytest.mark.parametrize("port_fn", [inference, inference_step],
                               ids=["inference", "inference_step"])


@pytest.fixture(scope="module")
def jax_images(setup):
    jcfg, _, _, _, raw, _, _ = setup
    return jax_preprocess(jnp.asarray(raw), jcfg.MODEL.PIXEL_MEAN, jcfg.MODEL.PIXEL_STD)


@pytest.fixture(scope="module")
def jax_want(setup, jax_images):
    _, jm, variables, _, _, K, ratio = setup
    return jax_inference_step(to_jnp(variables), jm, jax_images, jnp.asarray(K),
                              jnp.asarray(ratio), hw=jnp.asarray(HW), **KW)


@pytest.fixture(scope="module")
def jax_oracle_want(setup, jax_images):
    _, jm, variables, _, _, K, ratio = setup
    return jax_inference_step(to_jnp(variables), jm, jax_images, jnp.asarray(K),
                              jnp.asarray(ratio), oracle=tuple(map(jnp.asarray, ORACLE)),
                              sampling_ratio=0)


@PORT
def test_inference_matches_jax(setup, jax_images, jax_want, port_fn):
    jcfg, jm, variables, model, raw, K, ratio = setup
    img = preprocess(t(raw), jcfg.MODEL.PIXEL_MEAN, jcfg.MODEL.PIXEL_STD)
    np.testing.assert_array_equal(img.numpy(), np.asarray(jax_images))
    Kt = t(K)
    got = port_fn(model, img, Kt, t(ratio), hw=t(HW), **KW)
    np.testing.assert_array_equal(Kt.numpy(), K)   # the caller's Ks stay untouched
    assert got["valid"].sum() > 5 and got["proposal_valid"].sum() > 20
    _compare(got, jax_want)


@PORT
def test_oracle_inference_matches_jax(setup, jax_oracle_want, port_fn):
    jcfg, jm, variables, model, raw, K, ratio = setup
    img = preprocess(t(raw), jcfg.MODEL.PIXEL_MEAN, jcfg.MODEL.PIXEL_STD)
    got = port_fn(model, img, t(K), t(ratio), oracle=tuple(map(t, ORACLE)), sampling_ratio=0)
    _compare(got, jax_oracle_want)


def test_graph_key_tells_graphs_apart(setup):
    """Equal inputs give equal keys; a keyword (given or defaulted), hw or
    oracle given or not, a dtype, a shape or a module's training flag makes
    another key; unknown keywords raise."""
    _, _, _, model, raw, K, ratio = setup
    img, Kt, r = torch.zeros(raw.shape), t(K), t(ratio)

    def key(images=img, **kw):
        return rcnn3d.graph_key(model, images, Kt, r, **kw)
    base = key(**KW)
    assert key(**KW) == base == key(images=torch.ones(raw.shape), **KW)
    assert key() == key(score_thresh=0.01)          # defaults filled in
    others = [key(**dict(KW, score_thresh=0.06)), key(**dict(KW, topk=11)),
              key(hw=t(HW), **KW), key(oracle=tuple(map(t, ORACLE)), **KW),
              key(images=img.double(), **KW), key(images=img[:1], **KW),
              key(images=torch.zeros(2, 64, 128, 3), **KW)]
    model.roi_heads.train()
    try:
        others.append(key(**KW))
    finally:
        model.roi_heads.eval()
    assert key(**KW) == base
    assert len({base, *others}) == len(others) + 1
    with pytest.raises(TypeError):
        key(score_threshold=0.1)


def test_parameter_storage_sees_rebinding_not_in_place_writes(setup):
    """`parameter_storage` (the graphs' staleness check) is unchanged by
    in-place writes (`load_state_dict`, an optimizer-style `add_`) and
    changed by a parameter or buffer rebound to new storage."""
    model = setup[3]
    state = {k: v.clone() for k, v in model.state_dict().items()}
    base = rcnn3d.parameter_storage(model)
    w = model.roi_heads.box_predictor.cls_score.weight
    try:
        with torch.no_grad():
            w.add_(1.0)
        model.load_state_dict(state)
        assert rcnn3d.parameter_storage(model) == base
        old = w.data
        w.data = w.data.clone()
        assert rcnn3d.parameter_storage(model) != base
        w.data = old
        assert rcnn3d.parameter_storage(model) == base
        mean = model.roi_heads.priors_z_scales
        model.roi_heads.priors_z_scales = mean.clone()
        assert rcnn3d.parameter_storage(model) != base
        model.roi_heads.priors_z_scales = mean
    finally:
        model.load_state_dict(state)
    assert rcnn3d.parameter_storage(model) == base


def test_inference_step_on_cpu_leaves_cuda_alone(setup, monkeypatch):
    """CPU tensors run `inference` with no capture: no `torch.cuda` call,
    no graph cache on the model, and the same outputs as `inference`."""
    jcfg, _, _, model, raw, K, ratio = setup

    def refuse(*args, **kwargs):
        raise AssertionError("inference_step touched torch.cuda on CPU tensors")
    for name in ("CUDAGraph", "graph", "graph_pool_handle", "Stream", "stream",
                 "current_stream", "synchronize", "is_available", "device", "init"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    img = preprocess(t(raw), jcfg.MODEL.PIXEL_MEAN, jcfg.MODEL.PIXEL_STD)
    got = inference_step(model, img, t(K), t(ratio), hw=t(HW), **KW)
    monkeypatch.undo()
    want = inference(model, img, t(K), t(ratio), hw=t(HW), **KW)
    assert model.inference_graphs is None
    for k, v in want.items():
        assert torch.equal(got[k], v), k
