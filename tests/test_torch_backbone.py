"""DLA-34 + FPN of the port vs `CubeRCNN.features`, and the layers under it.

f32 tolerance 3e-4: the JAX stem runs its convolutions in space-to-depth
form, which is exact but sums in another order than the port's plain
convolutions, and the difference grows through 30-odd layers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni3d_tpu.models import layers as jl
from omni3d_tpu.models.rcnn3d import CubeRCNN as JaxCubeRCNN
from omni3d_tpu_torch.models import layers as tl
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
    """The affine is formed in f32 and applied in the activation dtype, as
    `_EvalBN` does: equal at f32 to rounding, and equal bit for bit at bf16."""
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
    m = tl.FrozenBatchNorm2d(C)
    for name, key in (("weight", "scale"), ("bias", "bias"),
                      ("running_mean", "mean"), ("running_var", "var")):
        getattr(m, name).copy_(t(stats[key]))
    tdt = getattr(torch, dtype)
    got = m(t(x).permute(0, 3, 1, 2).to(tdt)).float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 if dtype == "float32" else 0, rtol=0)


def test_pool_and_upsample_match_jax():
    x = np.random.default_rng(4).standard_normal((2, 6, 6, 3)).astype(np.float32)
    tx = t(x).permute(0, 3, 1, 2)
    for window, stride in ((2, 2), (1, 2)):
        want = np.asarray(jl.max_pool(jnp.asarray(x), window, stride))
        got = tl.max_pool(tx, window, stride).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jl.upsample_nearest_2x(jnp.asarray(x)))
    np.testing.assert_array_equal(tl.upsample_nearest_2x(tx).permute(0, 2, 3, 1).numpy(), want)
