"""ResNet-18/34/50/101 of the port vs `omni3d_tpu.models.resnet`, the
torchvision ResNet-34 namespace, and ResNet34-FPN as a whole model, on the
CPU in f32.

Trunks: the same numpy-seeded weights through `state_dict_from_flax`, two
random 128 px images. Eval mode: p2..p6 within 1e-5 of each map's largest
magnitude (no space-to-depth stem here, so no summation-order drift of
DLA-34's 3e-4). Train mode (batch statistics at p5's 4 x 4 extent): p2..p6
and the updated BN running statistics within 5e-3 of each tensor's largest;
one-pass batch variances of deep random-weight layers cancel badly, and a
float64 forward of the port puts the JAX package's float32 features
farther from it than the port's own (test_train_mode_differences_are_the_
jax_packages_float32).

The whole model (narrow FPN / FC widths): `inference` against the JAX
`inference_impl` with test_torch_inference's tolerances; `compute_losses`
against `jax.value_and_grad` with MODEL.USE_BN False (BN on its running
statistics, affine trained), where the gradients are well-conditioned,
with test_torch_train's tolerances (losses rtol 1e-4, gradients 1e-3 of
each tensor's largest)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni3d_tpu.config.cfg import StaticCfg
from omni3d_tpu.engine import train as jtrain
from omni3d_tpu.models.rcnn3d import CubeRCNN as JaxCubeRCNN
from omni3d_tpu.models.rcnn3d import inference_impl, preprocess as jax_preprocess
from omni3d_tpu.models.resnet import ResNet as JaxResNet
from omni3d_tpu.utils import checkpoint as jckpt
from omni3d_tpu_torch.engine import train as ttrain
from omni3d_tpu_torch.models import layers as tlayers
from omni3d_tpu_torch.models import rcnn3d
from omni3d_tpu_torch.models.resnet import ResNet, resnet_out_channels
from omni3d_tpu_torch.utils import checkpoint as tckpt
from omni3d_tpu_torch.utils.checkpoint import state_dict_from_flax
from test_torch_inference import KW, _compare
from test_torch_train import STRIDES, TINY, _torch_batch, jax_noise
from test_train import synthetic_batch
from torch_port_helpers import (BOTTOM_UP, NUM_CLASSES, jax_model, pooled_shape, port_model,
                                port_trunk, random_variables, small_cfgs, t, to_jnp,
                                trunk_parity)
import torch_resnet

RESNET = "build_resnet_from_vision_fpn_backbone"
R34 = {"MODEL.BACKBONE.NAME": RESNET, "MODEL.RESNETS.DEPTH": 34}


@pytest.mark.parametrize("depth", [18, 34, 50, 101])
def test_trunk_matches_jax(depth):
    port = ResNet(depth)
    assert port.out_channels == resnet_out_channels(depth)
    # downsample only where the JAX package makes one: layer1 at 50 / 101
    assert (port.layer1[0].downsample is None) == (depth in (18, 34))
    assert all(getattr(port, f"layer{i}")[0].downsample is not None for i in (2, 3, 4))
    trunk_parity(JaxResNet(depth=depth), JaxResNet(depth=depth, train=True), port, (128, 128))


@pytest.mark.parametrize("depth", [18, 34, 50, 101])
def test_every_depth_builds_from_the_config(depth):
    """`build_model` builds ResNet34-FPN's config at every MODEL.RESNETS.DEPTH
    (narrow heads) in eval mode, the FPN's laterals as wide as the trunk's
    taps."""
    _, tcfg = small_cfgs(**{**R34, "MODEL.RESNETS.DEPTH": depth})
    model = rcnn3d.build_model(tcfg, device="cpu", seed=0)
    assert not model.training and isinstance(model.backbone.bottom_up, ResNet)
    ch = resnet_out_channels(depth)
    assert [getattr(model.backbone, f"fpn_lateral{i}").in_channels for i in (2, 3, 4, 5, 6)] \
        == [ch[f"p{i}"] for i in (2, 3, 4, 5, 6)]


def _bn_float64(self, x):
    """Train-mode BN in float64 with the two-pass variance (the reference
    the float32 forwards are measured against)."""
    mean = x.mean(dim=(0, 2, 3))
    var = ((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
    a = self.weight.double() * torch.rsqrt(var + tlayers.BN_EPS)
    return x * a[:, None, None] + (self.bias.double() - mean * a)[:, None, None]


def test_train_mode_differences_are_the_jax_packages_float32(monkeypatch):
    """Why train mode is held at 5e-3: on ResNet-50 at 128 px the port's
    float32 train-mode p4 / p5 sit at least 2x closer to a float64 forward
    (two-pass variances) than the JAX package's float32 ones do (6x on this
    input), so the gap between the packages is float32 rounding in the
    batch statistics, amplified through depth, not a difference of the
    port."""
    hw = (128, 128)
    jm = JaxResNet(depth=50, train=True)
    variables = random_variables(jm, hw, seed=0)
    x = np.random.default_rng(1).standard_normal((2,) + hw + (3,)).astype(np.float32)
    want, _ = jax.jit(lambda v, im: jm.apply(v, im, mutable=["batch_stats"]))(
        to_jnp(variables), jnp.asarray(x))
    port = port_trunk(ResNet(50), variables).train()
    with torch.no_grad():
        got32 = port(t(x).permute(0, 3, 1, 2))
        monkeypatch.setattr(tlayers.BatchNorm2d, "forward", _bn_float64)
        got64 = port.double()(t(x).double().permute(0, 3, 1, 2))
    for name in ("p4", "p5"):
        ref = got64[name].permute(0, 2, 3, 1).numpy()
        port_err = np.abs(got32[name].permute(0, 2, 3, 1).numpy() - ref).max()
        jax_err = np.abs(np.asarray(want[name]) - ref).max()
        assert jax_err >= 2 * port_err, (name, port_err, jax_err)


def _r34_model():
    _, tcfg = small_cfgs(**R34)
    return rcnn3d.build_model(tcfg, device="cpu", seed=0)


def test_torchvision_resnet34_loads_with_no_key_left_and_gives_its_features():
    """The torchvision ResNet-34 namespace (tests/torch_resnet.py,
    transcribed from the published layout) loads into the port's trunk
    through `convert_imagenet_backbone`: nothing missing, nothing unused
    beyond the dropped fc head; the features equal the fixture's forward in
    eval mode."""
    sd = torch_resnet.imagenet_state_dict(seed=3)
    model = _r34_model()
    rep = tckpt.convert_imagenet_backbone(sd, model, RESNET)
    assert rep["missing"] == [] and rep["unused"] == []
    assert rep["loaded"] == sum(1 for k in sd if not k.startswith("fc.")
                                and not k.endswith("num_batches_tracked"))
    fixture = torch_resnet.TorchResNet34()
    fixture.load_state_dict({k: v for k, v in sd.items() if not k.startswith("fc.")},
                            strict=True)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 3, 96, 128)).astype(
        np.float32))
    with torch.no_grad():
        want = fixture.eval()(x)
        got = model.backbone.bottom_up(x)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()), err_msg=name)


def test_imagenet_resnet34_loads_as_jax_converts_it(tmp_path):
    jcfg, tcfg = small_cfgs(**R34)
    variables = random_variables(jax_model(jcfg), seed=0)
    sd = torch_resnet.imagenet_state_dict(seed=4)
    params, stats, jrep = jckpt.convert_imagenet_backbone(
        sd, variables["params"], variables["batch_stats"], RESNET)
    want = state_dict_from_flax(params, stats, pooled_shape(tcfg))
    model = port_model(tcfg, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trep = tckpt.convert_imagenet_backbone(sd, model, RESNET)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        assert torch.equal(got[k], before[k]) != k.startswith(BOTTOM_UP), k   # only the trunk
    assert trep["loaded"] == jrep["loaded"] and not trep["missing"] and not trep["unused"]


# ------------------------------ the whole model ------------------------------

B, H, W = 2, 96, 128
# ResNet-34's trunk at these random weights (BN near identity, no trained
# small residual scales) puts out maps ~20x DLA-34's (max |p2| 77 against
# 4.4), and every float32 difference of the heads grows with them (boxes
# decoded to 6600 px before clipping). Scaling the FPN's lateral kernels by
# LATERAL_SCALE brings the FPN's outputs to DLA-34's magnitude, so the
# heads are held with test_torch_inference's and test_torch_train's
# tolerances; the trunk's own differences stay in (1e-6 of its largest
# output, test_trunk_matches_jax).
LATERAL_SCALE = 1 / 20


def _r34_variables(jm, hw, seed):
    variables = random_variables(jm, hw, seed=seed)
    for name, conv in variables["params"]["fpn"].items():
        if name.startswith("fpn_lateral"):
            conv["kernel"] = conv["kernel"] * np.float32(LATERAL_SCALE)
    return variables


def test_resnet34_inference_matches_jax():
    jcfg, tcfg = small_cfgs(**R34)
    jm = jax_model(jcfg)
    variables = _r34_variables(jm, (H, W), seed=4)
    model = port_model(tcfg, variables)
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 255, (B, H, W, 3)).astype(np.uint8)
    K = np.asarray([[[250.0, 0, 70], [0, 250.0, 50], [0, 0, 1]],
                    [[400.0, 0, 60], [0, 380.0, 45], [0, 0, 1]]], np.float32)
    ratio = np.asarray([1.0, 1.5], np.float32)
    hw = np.asarray([[96.0, 128.0], [80.0, 110.0]], np.float32)
    jimg = jax_preprocess(jnp.asarray(raw), jcfg.MODEL.PIXEL_MEAN, jcfg.MODEL.PIXEL_STD)
    want = jax.jit(lambda v, im: inference_impl(
        v, jm, im, jnp.asarray(K), jnp.asarray(ratio), hw=jnp.asarray(hw), **KW))(
        to_jnp(variables), jimg)
    img = rcnn3d.preprocess(t(raw), jcfg.MODEL.PIXEL_MEAN, jcfg.MODEL.PIXEL_STD)
    got = rcnn3d.inference(model, img, t(K), t(ratio), hw=t(hw), **KW)
    assert got["valid"].sum() > 5 and got["proposal_valid"].sum() > 10
    _compare(got, want)


def test_resnet34_losses_and_grads_match_jax():
    jcfg, tcfg = small_cfgs(**TINY, **R34, **{"MODEL.USE_BN": False})
    scfg = StaticCfg(jcfg)
    jm = JaxCubeRCNN(cfg=scfg, train_mode=True)
    variables = _r34_variables(jm, (64, 64), seed=2)
    batch = synthetic_batch(np.random.default_rng(7), num_classes=NUM_CLASSES)
    rng = jax.random.PRNGKey(11)
    (jtotal, (jlosses, _, jnew_bs)), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bs, b, r: jtrain.compute_losses(p, bs, b, r, jm, scfg), has_aux=True))(
        variables["params"], variables["batch_stats"], batch, rng)

    model = rcnn3d.build_model(tcfg, device="cpu", train=True)
    model.load_state_dict(state_dict_from_flax(variables["params"], variables["batch_stats"],
                                               pooled_shape(tcfg)), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    R = sum(3 * (64 // s) ** 2 for s in STRIDES)
    noise = {k: t(v) for k, v in jax_noise(rng, 2, R, 32 + batch["gt_boxes"].shape[1]).items()}
    total, losses, _ = ttrain.compute_losses(model, _torch_batch(batch), noise=noise)
    total.backward()

    assert set(losses) == set(jlosses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-4)
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in before.items())   # frozen statistics
    want_g = state_dict_from_flax(jax.tree.map(np.asarray, jgrads), None, pooled_shape(tcfg))
    params = dict(model.named_parameters())
    assert any(k.startswith(BOTTOM_UP + "layer4") for k in params)
    for k, p in params.items():
        w = want_g[k].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        tol = 1e-3 * np.abs(w).max() + 1e-6
        assert np.abs(g - w).max() <= tol, (k, float(np.abs(g - w).max()), tol)
