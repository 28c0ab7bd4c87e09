"""DLA-34 + FPN of the port vs `CubeRCNN.features`, and the layers under it.

f32 tolerance 3e-4: the JAX stem runs its convolutions in space-to-depth
form, which is exact but sums in another order than the port's plain
convolutions, and the difference grows through 30-odd layers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as flax_nn

from omni3d_tpu.models import layers as jl
from omni3d_tpu.models.rcnn3d import CubeRCNN as JaxCubeRCNN
from omni3d_tpu_torch.models import layers as tl
from omni3d_tpu_torch.utils.checkpoint import state_dict_from_flax
from torch_port_helpers import jax_model, port_model, random_variables, small_cfgs, t, to_jnp


@pytest.mark.parametrize("hw", [(64, 64), (96, 128)])
def test_features_match_jax(hw):
    jcfg, tcfg = small_cfgs()
    jm = jax_model(jcfg)
    variables = random_variables(jm, hw)
    x = np.random.default_rng(2).standard_normal((2,) + hw + (3,)).astype(np.float32)
    want = jax.jit(lambda v, im: jm.apply(v, im, method=JaxCubeRCNN.features))(
        to_jnp(variables), jnp.asarray(x))
    model = port_model(tcfg, variables)
    with torch.no_grad():
        got = model.backbone(t(x).permute(0, 3, 1, 2))
    for name in ("p2", "p3", "p4", "p5", "p6"):
        g = got[name].permute(0, 2, 3, 1).numpy()
        w = np.asarray(want[name])
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=3e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_bn_matches_eval_bn(dtype):
    """`BatchNorm2d` in eval mode (the inference model's BN) forms the
    affine in f32 and applies it in the activation dtype, as `_EvalBN` does:
    equal at f32 to rounding, and equal bit for bit at bf16."""
    rng = np.random.default_rng(3)
    C = 16
    x = rng.standard_normal((2, 5, 5, C)).astype(np.float32)
    stats = {k: rng.uniform(0.5, 1.5, C).astype(np.float32)
             for k in ("scale", "bias", "mean", "var")}
    jdt = jnp.dtype(dtype)
    bn = jl.BatchNorm(use_running_average=True, dtype=jdt)
    v = {"params": {"bn": {"scale": stats["scale"], "bias": stats["bias"]}},
         "batch_stats": {"bn": {"mean": stats["mean"], "var": stats["var"]}}}
    want = np.asarray(bn.apply(v, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    m = tl.BatchNorm2d(C).eval()
    m.load_state_dict({name: t(stats[key]) for name, key in (
        ("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var"))})
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got = m(t(x).permute(0, 3, 1, 2).to(tdt)).float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 if dtype == "float32" else 0, rtol=0)


class _BufferBN(torch.nn.Module):
    """The inference BN the port used before `BatchNorm2d` took its place
    (buffers only: x * a + b with a = weight * rsqrt(var + eps),
    b = bias - mean * a formed in f32, applied in x's dtype)."""

    def __init__(self, bn):
        super().__init__()
        for name in ("weight", "bias", "running_mean", "running_var"):
            self.register_buffer(name, getattr(bn, name).detach().clone())

    def forward(self, x):
        a = self.weight * torch.rsqrt(self.running_var + tl.BN_EPS)
        b = self.bias - self.running_mean * a
        return x * a.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


def _swap_bn(module):
    for name, child in module.named_children():
        if isinstance(child, tl.BatchNorm2d):
            setattr(module, name, _BufferBN(child))
        else:
            _swap_bn(child)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inference_outputs_unchanged_by_the_one_bn_class(dtype):
    """`build_model(train=False)` returns the model in eval mode with
    `BatchNorm2d` everywhere, and `inference` gives bit for bit what the
    same weights give with the buffer-only inference BN it replaced."""
    from omni3d_tpu_torch.models import rcnn3d
    _, tcfg = small_cfgs(**{"TPU.COMPUTE_DTYPE": dtype})
    model = rcnn3d.build_model(tcfg, device="cpu", seed=3)
    assert not any(m.training for m in model.modules())
    assert sum(isinstance(m, tl.BatchNorm2d) for m in model.modules()) > 0
    old = rcnn3d.build_model(tcfg, device="cpu", seed=3)
    _swap_bn(old)
    assert not any(isinstance(m, tl.BatchNorm2d) for m in old.modules())
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 255, (2, 96, 128, 3)).astype(np.uint8)
    img = rcnn3d.preprocess(t(raw), tcfg.MODEL.PIXEL_MEAN, tcfg.MODEL.PIXEL_STD)
    K = t(np.asarray([[[250.0, 0, 64], [0, 250.0, 48], [0, 0, 1]]] * 2, np.float32))
    kw = dict(score_thresh=0.01, topk=10, nms_candidates=128, pre_nms_topk=64,
              post_nms_topk=64)
    got = rcnn3d.inference(model, img, K, torch.ones(2), **kw)
    want = rcnn3d.inference(old, img, K, torch.ones(2), **kw)
    assert bool(got["valid"].any())
    for k, w in want.items():
        assert torch.equal(got[k], w), k


@pytest.mark.parametrize("groups", [1, 4, 16])
def test_grouped_conv_through_the_bridge_matches_flax(groups):
    """A flax grouped convolution (HWIO kernel (k, k, cin / groups, cout))
    through `state_dict_from_flax` gives torch's grouped OIHW layout
    (cout, cin / groups, k, k): the port's `conv_bn(groups=)` equals
    `ConvBN(groups=)`."""
    C = 16
    x = np.random.default_rng(7).standard_normal((2, 9, 9, C)).astype(np.float32)
    rng = np.random.default_rng(groups)
    variables = {
        "params": {"c": {"conv": {"kernel": rng.standard_normal((3, 3, C // groups, 32))
                                  .astype(np.float32)}},
                   "n": {"bn": {"scale": rng.uniform(0.5, 1.5, 32).astype(np.float32),
                                "bias": rng.standard_normal(32).astype(np.float32)}}},
        "batch_stats": {"n": {"bn": {"mean": rng.standard_normal(32).astype(np.float32),
                                     "var": rng.uniform(0.5, 1.5, 32).astype(np.float32)}}}}
    jm = jl.ConvBN(32, 3, 2, groups=groups)
    want = np.asarray(jax.jit(jm.apply)(to_jnp(variables), jnp.asarray(x)))
    sd = state_dict_from_flax({"backbone": {"level1": variables["params"]}},
                              {"backbone": {"level1": variables["batch_stats"]}})
    assert sd["backbone.bottom_up.level1.0.weight"].shape == (32, C // groups, 3, 3)
    m = tl.conv_bn(C, 32, 3, 2, groups=groups).eval()
    m.load_state_dict({k[len("backbone.bottom_up.level1."):]: v for k, v in sd.items()},
                      strict=True)
    with torch.no_grad():
        got = m(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_avg_pool_matches_flax():
    x = np.random.default_rng(8).standard_normal((2, 7, 6, 3)).astype(np.float32)
    want = np.asarray(flax_nn.avg_pool(jnp.asarray(x), (2, 2), strides=(2, 2)))
    got = tl.avg_pool(t(x).permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_pool_and_upsample_match_jax():
    x = np.random.default_rng(4).standard_normal((2, 6, 6, 3)).astype(np.float32)
    tx = t(x).permute(0, 3, 1, 2)
    for window, stride in ((2, 2), (1, 2)):
        want = np.asarray(jl.max_pool(jnp.asarray(x), window, stride))
        got = tl.max_pool(tx, window, stride).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jl.upsample_nearest_2x(jnp.asarray(x)))
    np.testing.assert_array_equal(tl.upsample_nearest_2x(tx).permute(0, 2, 3, 1).numpy(), want)
