"""Box head, predictor, fast_rcnn_inference, cube head and decode_cube of the
port vs `omni3d_tpu.models.heads` (f32; dense layers at atol 1e-4 since the
flatten order differs, decoded geometry at atol 1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni3d_tpu.models import heads as jh
from omni3d_tpu.models.rcnn3d import CubeRCNN as JaxCubeRCNN
from omni3d_tpu_torch.models import heads as th
from torch_port_helpers import FPN_CH, NUM_CLASSES, jax_model, port_model, random_variables, small_cfgs, t, to_jnp

CUBE_OPTIONS = [
    {},
    {"MODEL.ROI_CUBE_HEAD.SHARED_FC": False, "MODEL.ROI_CUBE_HEAD.POSE_TYPE": "quaternion",
     "MODEL.ROI_CUBE_HEAD.CLUSTER_BINS": 3},
    {"MODEL.ROI_CUBE_HEAD.POSE_TYPE": "euler", "MODEL.ROI_CUBE_HEAD.USE_CONFIDENCE": 0.0},
]


def _close(a, b, atol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=atol, rtol=1e-5)


@pytest.fixture(scope="module")
def default_models():
    jcfg, tcfg = small_cfgs()
    jm = jax_model(jcfg)
    variables = random_variables(jm)
    return jm, variables, port_model(tcfg, variables)


def test_box_branch_matches_jax(default_models):
    jm, variables, model = default_models
    pooled = np.random.default_rng(0).standard_normal((6, 7, 7, FPN_CH)).astype(np.float32)
    ws, wd = jm.apply(to_jnp(variables), jnp.asarray(pooled), method=JaxCubeRCNN.box_branch)
    with torch.no_grad():
        gs, gd = model.roi_heads.box_predictor(model.roi_heads.box_head(t(pooled)))
    _close(gs, ws)
    _close(gd, wd)


@pytest.mark.parametrize("opts", CUBE_OPTIONS, ids=["default", "branches-quat-bins", "euler-noconf"])
def test_cube_head_matches_jax(opts):
    jcfg, tcfg = small_cfgs(**opts)
    jm = jax_model(jcfg)
    variables = random_variables(jm, seed=1)
    model = port_model(tcfg, variables)
    pooled = np.random.default_rng(1).standard_normal((6, 7, 7, FPN_CH)).astype(np.float32)
    want = jm.apply(to_jnp(variables), jnp.asarray(pooled), method=JaxCubeRCNN.cube_branch)
    with torch.no_grad():
        got = model.roi_heads.cube_head(t(pooled))
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("score_thresh,nms_candidates", [(0.05, 1024), (0.0, 64)])
def test_fast_rcnn_inference_matches_jax(score_thresh, nms_candidates):
    rng = np.random.default_rng(2)
    B, P, C = 2, 64, NUM_CLASSES
    scores = (np.round(rng.standard_normal((B, P, C + 1)) * 4) / 4).astype(np.float32)
    deltas = (0.5 * rng.standard_normal((B, P, C * 4))).astype(np.float32)
    xy = rng.uniform(0, 90, (B, P, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 40, (B, P, 2))], -1).astype(np.float32)
    valid = rng.uniform(size=(B, P)) > 0.2
    hw = np.asarray([[128.0, 128.0], [100.0, 120.0]], np.float32)
    args = (scores, deltas, boxes, valid, hw)
    want = jax.vmap(lambda s, d, b, v, ihw: jh.fast_rcnn_inference(
        s, d, b, v, ihw, C, score_thresh, 0.5, 20, nms_candidates))(*map(jnp.asarray, args))
    got = th.fast_rcnn_inference(*map(t, args), C, score_thresh, 0.5, 20, nms_candidates)
    for k in ("valid", "classes"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("boxes", "scores", "scores_full"):
        _close(got[k], want[k], atol=1e-5)
    assert got["valid"].any()


DECODE_OPTIONS = [
    dict(),
    dict(z_type="clusters", dims_priors_func="sigmoid", cluster_bins=3),
    dict(z_type="sigmoid", virtual_depth=False, allocentric=False, dims_priors_enabled=False),
    dict(z_type="log"),
]


@pytest.mark.parametrize("opts", DECODE_OPTIONS, ids=["default", "clusters", "sigmoid", "log"])
def test_decode_cube_matches_jax(opts):
    rng = np.random.default_rng(3)
    N, C = 12, NUM_CLASSES
    bins = opts.get("cluster_bins", 1)
    q = rng.standard_normal((N * C, 6)).astype(np.float32)
    R = np.asarray(jax.vmap(lambda v: jnp.stack(
        [v[:3] / jnp.linalg.norm(v[:3]), v[3:] / jnp.linalg.norm(v[3:]),
         jnp.cross(v[:3] / jnp.linalg.norm(v[:3]), v[3:] / jnp.linalg.norm(v[3:]))]))(q))
    outputs = [
        0.1 * rng.standard_normal((N, C, 2)),
        rng.standard_normal((N, bins, C) if bins > 1 else (N, C)),
        0.5 * rng.standard_normal((N, C, 3)),
        R.reshape(N, C, 3, 3),
        rng.uniform(0.01, 2.0, (N, C)),
    ]
    outputs = [np.asarray(o, np.float32) for o in outputs]
    classes = rng.integers(0, C, N).astype(np.int32)
    xy = rng.uniform(0, 100, (N, 2))
    src = np.concatenate([xy, xy + rng.uniform(5, 50, (N, 2))], -1).astype(np.float32)
    K = np.asarray([[300.0, 0, 64], [0, 310.0, 60], [0, 0, 1]], np.float32)
    Ks = np.broadcast_to(K, (N, 3, 3)).copy()
    fy = Ks[:, 1, 1].copy()
    priors_dims = rng.uniform(0.5, 2.0, (C, 2, 3)).astype(np.float32)
    z_stats = rng.uniform(1.0, 5.0, (C, bins, 2)).astype(np.float32)
    z_scales = rng.uniform(10.0, 80.0, (C, bins)).astype(np.float32)
    args = (classes, src, Ks, fy, priors_dims)
    kw = dict(opts)
    want = jh.decode_cube(tuple(map(jnp.asarray, outputs)), *map(jnp.asarray, args),
                          priors_z_stats=jnp.asarray(z_stats),
                          priors_z_scales=jnp.asarray(z_scales), **kw)
    got = th.decode_cube(tuple(map(t, outputs)), *map(t, args), priors_z_stats=t(z_stats),
                         priors_z_scales=t(z_scales), **kw)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
        elif k == "bin_assign":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))
        else:
            _close(got[k], w)
