"""The port's training path vs the JAX package on the CPU, f32: anchor and
proposal sampling with the JAX uniforms injected, the RPN, FastRCNN and
cube losses in every config branch, train-mode BN, the whole
`compute_losses` (every loss, metric, batch statistic and parameter
gradient against `jax.value_and_grad`), the stabilizer, and `build_model`
targeting the card.

Tolerances: losses of the whole slice rtol 1e-4; gradients max|d| <=
1e-3 * max|g_jax| + 1e-6 per tensor (f32 convolutions sum in another order
through the whole backbone and its backward); single loss functions rtol
1e-5; discrete sampling results exactly equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni3d_tpu.config.cfg import StaticCfg
from omni3d_tpu.engine import train as jtrain
from omni3d_tpu.models import anchors as janchors
from omni3d_tpu.models import heads as jheads
from omni3d_tpu.models import layers as jlayers
from omni3d_tpu.models import roi_training as jroi
from omni3d_tpu.models import rpn as jrpn
from omni3d_tpu.models.rcnn3d import CubeRCNN as JaxCubeRCNN
from omni3d_tpu_torch.engine import train as ttrain
from omni3d_tpu_torch.models import heads as theads
from omni3d_tpu_torch.models import layers as tlayers
from omni3d_tpu_torch.models import rcnn3d
from omni3d_tpu_torch.models import roi_training as troi
from omni3d_tpu_torch.models import rpn as trpn
from omni3d_tpu_torch.solver.build import build_lr_schedule, build_optimizer
from omni3d_tpu_torch.utils.checkpoint import state_dict_from_flax
from test_train import synthetic_batch
from torch_port_helpers import NUM_CLASSES, pooled_shape, random_variables, small_cfgs, t

# the tiny_cfg settings of tests/test_train.py at the narrow port-test widths,
# with anchor sizes scaled to the 64 px images: a 512 px anchor turns the f32
# noise of its deltas into proposal coordinates off by ~1e-2 px (exp(dw) x w)
TINY = {"MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 32, "MODEL.RPN.BATCH_SIZE_PER_IMAGE": 32,
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 64, "MODEL.RPN.POST_NMS_TOPK_TRAIN": 32,
        "SOLVER.BASE_LR": 0.01, "SOLVER.WARMUP_ITERS": 10, "SOLVER.STEPS": (100, 200),
        "MODEL.ANCHOR_GENERATOR.SIZES": [[8], [16], [32], [64], [128]]}
STRIDES = (4, 8, 16, 32, 64)


def jax_noise(rng, B, num_anchors, num_candidates, img_offset=0):
    """The uniforms the JAX package's `compute_losses` draws for its four
    samplers (train.py:127-129, rpn.py:204, roi_training.py:75, rpn.py:113),
    as numpy arrays keyed like `sampling_noise`."""
    _, rng_anchor, rng_prop = jax.random.split(rng, 3)
    out = {}
    for name, base, n in (("anchor", rng_anchor, num_anchors), ("prop", rng_prop, num_candidates)):
        pos, neg = [], []
        for i in range(B):
            r_pos, r_neg = jax.random.split(jax.random.fold_in(base, img_offset + i))
            pos.append(np.asarray(jax.random.uniform(r_pos, (n,))))
            neg.append(np.asarray(jax.random.uniform(r_neg, (n,))))
        out[f"{name}_pos"], out[f"{name}_neg"] = np.stack(pos), np.stack(neg)
    return out


def _torch_batch(batch):
    return {k: t(np.asarray(v)) for k, v in batch.items()}


def _anchors(hw=(64, 64)):
    shapes = [(hw[0] // s, hw[1] // s) for s in STRIDES]
    cfg = small_cfgs()[0].MODEL.ANCHOR_GENERATOR
    return np.concatenate(janchors.pyramid_anchors(shapes, STRIDES, cfg.SIZES,
                                                   cfg.ASPECT_RATIOS, cfg.OFFSET), 0)


# ------------------------------ (d) sampling ------------------------------

def test_label_and_sample_anchors_matches_jax():
    batch = synthetic_batch(np.random.default_rng(0), num_classes=NUM_CLASSES)
    anchors = _anchors()
    B, R = 2, anchors.shape[0]
    noise = jax_noise(jax.random.PRNGKey(3), B, R, 1)
    kw = dict(batch_size=32, positive_fraction=0.5, fg_thresh=0.3, ignore_thresh=0.5)
    want = jax.vmap(lambda r, gb, gc, gv: jrpn.label_and_sample_anchors(
        r, jnp.asarray(anchors), gb, gc, gv, **kw))(
        jax.vmap(lambda i: jax.random.fold_in(jax.random.split(jax.random.PRNGKey(3), 3)[1], i))(
            jnp.arange(B)), batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"])
    got = trpn.label_and_sample_anchors(
        t(anchors), t(batch["gt_boxes"]), t(batch["gt_classes"]), t(batch["gt_valid"]),
        t(noise["anchor_pos"]), t(noise["anchor_neg"]), **kw)
    labels = np.asarray(want["labels"])
    assert (labels == 1).sum() > 4 and (labels == 0).sum() > 4 and (labels == -1).sum() > 4
    np.testing.assert_array_equal(got["labels"].numpy(), labels)
    np.testing.assert_allclose(got["matched_gt"].numpy(), np.asarray(want["matched_gt"]),
                               rtol=0, atol=0)
    np.testing.assert_allclose(got["matched_iou"].numpy(), np.asarray(want["matched_iou"]),
                               rtol=1e-6, atol=1e-7)


def test_match_anchors_matches_jax():
    batch = synthetic_batch(np.random.default_rng(2), num_classes=NUM_CLASSES)
    anchors = _anchors()
    want = jax.vmap(lambda gb, gv: jrpn.match_anchors(jnp.asarray(anchors), gb, gv, 0.3))(
        batch["gt_boxes"], batch["gt_valid"])
    got = trpn.match_anchors(t(anchors), t(batch["gt_boxes"]), t(batch["gt_valid"]), 0.3)
    assert bool(np.asarray(want[2]).any())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_label_and_sample_proposals_matches_jax():
    rng = np.random.default_rng(1)
    batch = synthetic_batch(rng, num_classes=NUM_CLASSES)
    B, P, G = 2, 40, batch["gt_boxes"].shape[1]
    gt = np.asarray(batch["gt_boxes"])
    jitter = rng.normal(0, 2.0, (B, P // 2, 4)).astype(np.float32)
    near = gt[:, rng.integers(0, 3, P // 2)] + jitter
    xy = rng.uniform(0, 50, (B, P // 2, 2))
    far = np.concatenate([xy, xy + rng.uniform(4, 20, (B, P // 2, 2))], -1)
    props = np.concatenate([near, far], 1).astype(np.float32)
    valid = rng.random((B, P)) < 0.9
    noise = jax_noise(jax.random.PRNGKey(5), B, 1, P + G)
    kw = dict(batch_size=16, positive_fraction=0.25, iou_thresh=0.5, ignore_thresh=0.5,
              append_gt=True)
    prop_rng = jax.random.split(jax.random.PRNGKey(5), 3)[2]
    want = jax.vmap(lambda i, pb, pv, gb, gc, gv: jroi.label_and_sample_proposals(
        jax.random.fold_in(prop_rng, i), pb, pv, gb, gc, gv, NUM_CLASSES, **kw))(
        jnp.arange(B), jnp.asarray(props), jnp.asarray(valid), batch["gt_boxes"],
        batch["gt_classes"], batch["gt_valid"])
    got = troi.label_and_sample_proposals(
        t(props), t(valid), t(batch["gt_boxes"]), t(batch["gt_classes"]), t(batch["gt_valid"]),
        NUM_CLASSES, t(noise["prop_pos"]), t(noise["prop_neg"]), **kw)
    assert int(np.asarray(want["num_fg"]).min()) > 0
    for k in ("idx", "classes", "gt_idx", "fg", "valid", "num_fg"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["boxes"].numpy(), np.asarray(want["boxes"]))


# ------------------------------ (e) losses ------------------------------

def test_rpn_losses_match_jax():
    rng = np.random.default_rng(2)
    anchors = _anchors()
    B, R = 2, anchors.shape[0]
    labels = rng.integers(-1, 2, (B, R)).astype(np.int32)
    matched = anchors[None] + rng.normal(0, 3, (B, R, 4)).astype(np.float32)
    logits = rng.normal(0, 2, (B, R)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (B, R, 4)).astype(np.float32)
    for objectness in ("IoUness", "BCE"):
        want = jrpn.rpn_losses(jnp.asarray(anchors), jnp.asarray(labels), jnp.asarray(matched),
                               jnp.asarray(logits), jnp.asarray(deltas), 32, objectness)
        got = trpn.rpn_losses(t(anchors), t(labels), t(matched), t(logits), t(deltas), 32,
                              objectness)
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, err_msg=k)


def test_fast_rcnn_losses_match_jax():
    rng = np.random.default_rng(3)
    S, C = 48, NUM_CLASSES
    scores = rng.normal(0, 2, (S, C + 1)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (S, C * 4)).astype(np.float32)
    xy = rng.uniform(0, 40, (S, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 20, (S, 2))], -1).astype(np.float32)
    gt = (boxes + rng.normal(0, 2, (S, 4))).astype(np.float32)
    classes = rng.integers(0, C + 1, S).astype(np.int32)
    valid = rng.random(S) < 0.8
    want = jroi.fast_rcnn_losses(*map(jnp.asarray, (scores, deltas, boxes, classes, valid, gt)), C)
    got = troi.fast_rcnn_losses(*map(t, (scores, deltas, boxes, classes, valid, gt)), C)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, err_msg=k)


CUBE_BRANCHES = {
    "default": {},
    "l1_pose_invz_sigmoid_dims": {"CHAMFER_POSE": False, "INVERSE_Z_WEIGHT": True,
                                  "DIMS_PRIORS_FUNC": "sigmoid"},
    "entangled_direct_allo": {"DISENTANGLED_LOSS": False},
    "entangled_sigmoid_ego_noprior_noconf": {
        "DISENTANGLED_LOSS": False, "Z_TYPE": "sigmoid", "ALLOCENTRIC_POSE": False,
        "DIMS_PRIORS_ENABLED": False, "USE_CONFIDENCE": 0.0},
    "entangled_log_invz_nojoint": {"DISENTANGLED_LOSS": False, "Z_TYPE": "log",
                                   "INVERSE_Z_WEIGHT": True, "LOSS_W_JOINT": 0.0},
    "entangled_clusters": {"DISENTANGLED_LOSS": False, "Z_TYPE": "clusters",
                           "CLUSTER_BINS": 3, "VIRTUAL_DEPTH": False},
}


@pytest.mark.parametrize("branch", sorted(CUBE_BRANCHES))
def test_cube_losses_match_jax_in_every_branch(branch):
    """decode_cube + cube_losses from the same raw head outputs, both
    packages, rtol 1e-5 on every loss and metric."""
    over = {f"MODEL.ROI_CUBE_HEAD.{k}": v for k, v in CUBE_BRANCHES[branch].items()}
    jcfg, _ = small_cfgs(**over)
    ch = StaticCfg(jcfg).MODEL.ROI_CUBE_HEAD
    rng = np.random.default_rng(4)
    n, C, bins = 24, NUM_CLASSES, max(ch.CLUSTER_BINS, 1)
    d6 = rng.normal(0, 1, (n, C, 6)).astype(np.float32)
    outs = [rng.normal(0, 0.3, (n, C, 2)).astype(np.float32),
            (rng.normal(0, 1, (n, bins, C) if bins > 1 else (n, C)) + 2.0).astype(np.float32),
            rng.normal(0, 0.3, (n, C, 3)).astype(np.float32), None,
            rng.uniform(0.05, 1.0, (n, C)).astype(np.float32) if ch.USE_CONFIDENCE else None]
    classes = rng.integers(0, C, n).astype(np.int32)
    xy = rng.uniform(0, 50, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 30, (n, 2))], -1).astype(np.float32)
    K = np.tile(np.asarray([[[120.0, 0, 32], [0, 110.0, 30], [0, 0, 1]]], np.float32), (n, 1, 1))
    priors = rng.uniform(0.5, 2.0, (C, 2, 3)).astype(np.float32)
    z_stats = rng.uniform(1.0, 5.0, (C, bins, 2)).astype(np.float32)
    z_scales = rng.uniform(5.0, 40.0, (C, bins)).astype(np.float32)
    gt_b3d = np.concatenate([(boxes[:, :2] + boxes[:, 2:]) / 2, rng.uniform(1, 12, (n, 1)),
                             rng.uniform(0.3, 2.5, (n, 3))], -1).astype(np.float32)
    ang = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    gt_pose = np.asarray(jax.vmap(lambda a: jax.scipy.linalg.expm(jnp.asarray(
        [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])))(jnp.asarray(ang)))
    fg = rng.random(n) < 0.8
    kw = dict(z_type=ch.Z_TYPE, virtual_depth=ch.VIRTUAL_DEPTH, virtual_focal=ch.VIRTUAL_FOCAL,
              dims_priors_enabled=ch.DIMS_PRIORS_ENABLED, dims_priors_func=ch.DIMS_PRIORS_FUNC,
              allocentric=ch.ALLOCENTRIC_POSE, cluster_bins=ch.CLUSTER_BINS)

    def run(lib, heads, roi, conv, pose_fn):
        o = [None if x is None else conv(x) for x in outs]
        o[3] = pose_fn(conv(d6).reshape(n * C, 6)).reshape(n, C, 3, 3)
        cube = heads.decode_cube(tuple(o), conv(classes), conv(boxes), conv(K),
                                 conv(K)[:, 1, 1], conv(priors), priors_z_stats=conv(z_stats),
                                 priors_z_scales=conv(z_scales), **kw)
        return roi.cube_losses(cube, conv(fg), conv(gt_b3d), conv(gt_pose), conv(K), ch,
                               conv(boxes))

    from omni3d_tpu.utils import geometry as jG
    from omni3d_tpu_torch.utils import geometry as tG
    want = run(jnp, jheads, jroi, jnp.asarray, jG.rotation_6d_to_matrix)
    got = run(torch, theads, troi, t, tG.rotation_6d_to_matrix)
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k, v in w.items():
            np.testing.assert_allclose(float(g[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)


# ------------------------------ (f) train-mode BN ------------------------------

def test_train_bn_matches_flax_and_eval_is_frozen_bn():
    """Batch statistics in f32 with the biased variance, for the output and
    the running update (momentum 0.1); eval mode bit-equal to
    FrozenBatchNorm2d in f32 and bf16."""
    rng = np.random.default_rng(6)
    x = (rng.normal(0.5, 2.0, (3, 5, 6, 8))).astype(np.float32)            # NHWC
    scale, bias = rng.uniform(0.5, 1.5, 8).astype(np.float32), rng.normal(0, 1, 8).astype(np.float32)
    mean0, var0 = rng.normal(0, 1, 8).astype(np.float32), rng.uniform(0.5, 2, 8).astype(np.float32)
    bn = jlayers.BatchNorm(use_running_average=False)
    variables = {"params": {"bn": {"scale": scale, "bias": bias}},
                 "batch_stats": {"bn": {"mean": mean0, "var": var0}}}
    y, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    tbn = tlayers.BatchNorm2d(8)
    tbn.load_state_dict({"weight": t(scale), "bias": t(bias), "running_mean": t(mean0),
                         "running_var": t(var0)})
    got = tbn.train()(t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    xf = x.reshape(-1, 8).astype(np.float64)
    np.testing.assert_allclose(tbn.running_var.numpy(), 0.9 * var0 + 0.1 * xf.var(0), rtol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(), 0.9 * mean0 + 0.1 * xf.mean(0),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(upd["batch_stats"]["bn"]["var"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["bn"]["mean"]), rtol=1e-6, atol=1e-7)
    assert isinstance(tbn.weight, torch.nn.Parameter) and isinstance(tbn.bias, torch.nn.Parameter)

    frozen = tlayers.FrozenBatchNorm2d(8)
    frozen.load_state_dict(tbn.state_dict(), strict=True)
    tbn.eval()
    for dtype in (torch.float32, torch.bfloat16):
        xi = t(x).permute(0, 3, 1, 2).to(dtype)
        assert torch.equal(tbn(xi), frozen(xi))
    with torch.no_grad():
        assert tbn.train()(t(x).permute(0, 3, 1, 2).bfloat16()).dtype == torch.bfloat16


# ------------------------------ (g) the whole slice ------------------------------

@pytest.fixture(scope="module")
def slice_setup():
    jcfg, tcfg = small_cfgs(**TINY)
    scfg = StaticCfg(jcfg)
    jm = JaxCubeRCNN(cfg=scfg, train_mode=True)
    variables = random_variables(jm, (64, 64), seed=2)
    batch = synthetic_batch(np.random.default_rng(7), num_classes=NUM_CLASSES)
    return jcfg, tcfg, scfg, jm, variables, batch


def _port_train_model(tcfg, variables):
    model = rcnn3d.build_model(tcfg, device="cpu", train=True)
    model.load_state_dict(state_dict_from_flax(variables["params"], variables["batch_stats"],
                                               pooled_shape(tcfg)), strict=True)
    return model


def test_compute_losses_and_grads_match_jax(slice_setup):
    jcfg, tcfg, scfg, jm, variables, batch = slice_setup
    rng = jax.random.PRNGKey(11)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, bs, b, r: jtrain.compute_losses(p, bs, b, r, jm, scfg), has_aux=True))
    (jtotal, (jlosses, jmetrics, jnew_bs)), jgrads = grad_fn(
        variables["params"], variables["batch_stats"], batch, rng)

    model = _port_train_model(tcfg, variables)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    R = sum(3 * (64 // s) ** 2 for s in STRIDES)
    noise = {k: t(v) for k, v in jax_noise(rng, 2, R, 32 + batch["gt_boxes"].shape[1]).items()}
    total, losses, metrics = ttrain.compute_losses(model, _torch_batch(batch), noise=noise)
    total.backward()

    assert set(losses) == set(jlosses) and set(metrics) == set(jmetrics)
    assert float(jmetrics["roi/num_fg"]) > 0
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-4)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)

    # new batch statistics, through the bridge's key names
    want_bs = state_dict_from_flax({}, jax.tree.map(np.asarray, jnew_bs))
    got_sd = model.state_dict()
    assert len(want_bs) > 0
    for k, v in want_bs.items():
        np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)

    # every parameter gradient (the bridge's layout maps are linear, so they
    # carry gradients as they carry weights); the priors get none
    want_g = state_dict_from_flax(jax.tree.map(np.asarray, jgrads), None, pooled_shape(tcfg))
    params = dict(model.named_parameters())
    assert set(want_g) - set(params) == {k for k in want_g if ".priors_" in k}
    for k in set(want_g) - set(params):
        assert float(want_g[k].abs().max()) == 0.0, k
    for k, p in params.items():
        w = want_g[k].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        tol = 1e-3 * np.abs(w).max() + 1e-6
        assert np.abs(g - w).max() <= tol, (k, float(np.abs(g - w).max()), tol)


def test_one_pooler_call_per_step(slice_setup, monkeypatch):
    """Box and cube RoIs go through one pooler call (one forward and one
    backward kernel launch on the card)."""
    _, tcfg, _, _, variables, batch = slice_setup
    model = _port_train_model(tcfg, variables)
    calls = []
    real = ttrain.multilevel_roi_align
    monkeypatch.setattr(ttrain, "multilevel_roi_align",
                        lambda f, b, *a, **k: calls.append(b.shape) or real(f, b, *a, **k))
    total, _, _ = ttrain.compute_losses(model, _torch_batch(batch),
                                        torch.Generator().manual_seed(0))
    total.backward()
    S = tcfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
    assert calls == [torch.Size([2, S + int(S * tcfg.MODEL.ROI_HEADS.POSITIVE_FRACTION), 4])]


def test_frozen_bn_training_keeps_statistics_and_trains_the_affine(slice_setup):
    """MODEL.USE_BN False: BN normalises with its running statistics, which
    stay, while its weight and bias get gradients (the JAX package's
    `_EvalBN` parameters)."""
    _, tcfg, _, _, variables, batch = slice_setup
    tcfg.MODEL.USE_BN = False
    try:
        model = _port_train_model(tcfg, variables)
    finally:
        tcfg.MODEL.USE_BN = True
    bns = [m for m in model.modules() if isinstance(m, tlayers.BatchNorm2d)]
    assert model.training and bns and not any(m.training for m in bns)
    before = [m.running_var.clone() for m in bns]
    total, _, _ = ttrain.compute_losses(model, _torch_batch(batch),
                                        torch.Generator().manual_seed(0))
    total.backward()
    assert all(torch.equal(m.running_var, b) for m, b in zip(bns, before))
    assert bns[0].weight.grad is not None and float(bns[0].weight.grad.abs().sum()) > 0


def test_sampling_noise_is_keyed_by_global_image_index():
    a = ttrain.sampling_noise(torch.Generator().manual_seed(3), 4, 50, 20, "cpu")
    b = ttrain.sampling_noise(torch.Generator().manual_seed(3), 2, 50, 20, "cpu", img_offset=2)
    for k in ttrain.NOISE_KEYS:
        assert a[k].shape[0] == 4 and torch.equal(a[k][2:], b[k])
        assert 0.0 <= float(a[k].min()) and float(a[k].max()) < 1.0


# ------------------------------ (i) the stabilizer ------------------------------

def test_stabilizer_rule_matches_jax():
    """Spike, non-finite loss, non-finite grad; the rolling mean's rule."""
    def case(total, recent, grad_ok):
        d, r = ttrain._stabilizer(torch.tensor(total), torch.tensor(recent), torch.tensor(grad_ok))
        return bool(d), float(r)
    assert case(3.0, -1.0, True) == (False, 6.0)                    # first finite: 2x
    assert case(5.0, 1.0, True) == (True, 1.0)                      # spike > 4x
    d, r = case(3.0, 1.0, True)
    assert not d and r == pytest.approx(0.98 + 0.02 * 3.0, rel=1e-7)
    assert case(float("nan"), 1.0, True) == (True, 1.0)
    d, r = case(2.0, 1.0, False)                                    # bad grad: skip,
    assert d and r == pytest.approx(0.98 + 0.02 * 2.0, rel=1e-7)    # mean still moves


def test_skipped_step_leaves_params_bn_and_optimizer_state(slice_setup):
    _, tcfg, _, _, variables, batch = slice_setup
    model = _port_train_model(tcfg, variables)
    opt = build_optimizer(tcfg, model)
    sched = build_lr_schedule(tcfg, opt)
    step = ttrain.make_train_step(tcfg, model, opt, sched)
    tb = _torch_batch(batch)
    logs = step(tb, torch.Generator().manual_seed(0))
    assert logs["finite"] == 1.0 and step.state["skipped"] == 0
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    opt_sd = {i: {k: v.clone() for k, v in s.items()} for i, s in opt.state_dict()["state"].items()}
    lr, recent = sched.get_last_lr(), float(step.state["recent_loss"])
    bad = dict(tb, images=tb["images"].clone())
    bad["images"][0, 0, 0, 0] = float("nan")
    logs = step(bad, torch.Generator().manual_seed(1))
    assert logs["finite"] == 0.0
    assert step.state["skipped"] == 1 and step.state["step"] == 2
    assert float(step.state["recent_loss"]) == recent and sched.get_last_lr() == lr
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    for i, s in opt.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v, opt_sd[i][k]), (i, k)
    logs = step(tb, torch.Generator().manual_seed(2))
    assert logs["finite"] == 1.0
    assert any(not torch.equal(v, sd[k]) for k, v in model.state_dict().items())


# ------------------------------ repair: the card by default ------------------------------

def test_build_model_targets_the_card_by_default():
    _, tcfg = small_cfgs()
    if torch.cuda.is_available():
        assert next(rcnn3d.build_model(tcfg).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rcnn3d.build_model(tcfg)
    assert next(rcnn3d.build_model(tcfg, device="cpu").parameters()).device.type == "cpu"
