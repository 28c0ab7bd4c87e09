"""The train-mode BatchNorm kernels' arithmetic on the CPU: the plain-PyTorch
mirror of `ops.batch_norm_cuda` (tile partials, the fixed-order merge, the
affine, the running update, the backward's two sums and dx) against
autograd through `BatchNorm2d`'s formula in float64, the launch geometry,
and which path a train-mode call takes off the card.

The kernels themselves run only on a card: `tests/test_torch_cuda.py -k
batch_norm` holds them against this mirror bit for bit.
"""
import pytest
import torch

from omni3d_tpu_torch.models import layers as tl
from omni3d_tpu_torch.ops import batch_norm_cuda as bnc

EPS32 = 2.0 ** -23
HALF_ULP_BF16 = 2.0 ** -8


def _case(n, c, h, w, seed=0):
    """A channels-last input off zero (mean 3, spread 0.5: the merge's shift
    is exercised), affine parameters, running statistics and an output
    gradient."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, c, h, w, generator=g) * 0.5 + 3).to(memory_format=torch.channels_last)
    params = {"weight": torch.rand(c, generator=g) + 0.5, "bias": torch.randn(c, generator=g),
              "running_mean": torch.randn(c, generator=g),
              "running_var": torch.rand(c, generator=g) + 0.5}
    return x, params, torch.randn(n, c, h, w, generator=g)


def _reference(x, params, dy, update):
    """`BatchNorm2d`'s train-mode formula in float64 on x's values, through
    autograd: (y, dx, grad_weight, grad_bias, the running statistics)."""
    x64 = x.double().requires_grad_()
    weight = params["weight"].double().requires_grad_()
    bias = params["bias"].double().requires_grad_()
    mean = x64.mean(dim=(0, 2, 3))
    var = ((x64 * x64).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
    a = weight * torch.rsqrt(var + tl.BN_EPS)
    y = x64 * a[:, None, None] + (bias - mean * a)[:, None, None]
    y.backward(dy.double())
    running = {k: params[k].double() for k in ("running_mean", "running_var")}
    if update:
        running = {k: (1 - tl.BN_MOMENTUM) * v + tl.BN_MOMENTUM * stat.detach()
                   for (k, v), stat in zip(running.items(), (mean, var))}
    return y.detach(), x64.grad, weight.grad, bias.grad, running


def _close(got, want, rel, bf16=False):
    got, want = got.double(), want.double()
    scale = float(want.abs().max())
    tol = rel * scale + (HALF_ULP_BF16 * want.abs() if bf16 else 0.0)
    assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max()) / scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("update", [True, False], ids=["update", "frozen"])
@pytest.mark.parametrize("geometry", ["launch", "ragged"])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (2, 16, 9, 13), (3, 48, 4, 6), (2, 512, 3, 5)],
                         ids=lambda s: f"C{s[1]}")
def test_mirror_matches_float64_autograd(shape, geometry, update, dtype):
    """Forward (y, the running update or none) and backward (dx and the
    parameters' gradients) of the mirror within a few float32 roundings of
    the float64 plain formula (bf16: within half a bf16 ULP more, the one
    rounding of y and dx). `ragged`: 5 row lanes (a tree of 8), blocks of
    7 rows, the last one short."""
    x, params, dy = _case(*shape)
    x, dy = x.to(dtype), dy.to(dtype).contiguous(memory_format=torch.channels_last)
    m = shape[0] * shape[2] * shape[3]
    t = None if geometry == "launch" else bnc.Tiles(1, shape[1], 5, 8, 1, 7, -(-m // 7))
    want_y, want_dx, want_gw, want_gb, want_running = _reference(x, params, dy, update)
    running = {k: params[k].clone() for k in ("running_mean", "running_var")}
    y, stats = bnc.forward_mirror(x, params["weight"], params["bias"], running["running_mean"],
                                  running["running_var"], update, t)
    dx, grad_weight, grad_bias = bnc.backward_mirror(x, dy, stats, t)
    bf16 = dtype == torch.bfloat16
    assert y.dtype == dx.dtype == dtype and y.shape == dx.shape == x.shape
    _close(y, want_y, 16 * EPS32, bf16)
    _close(dx, want_dx, 32 * EPS32, bf16)
    _close(grad_weight, want_gw, 16 * EPS32)
    _close(grad_bias, want_gb, 16 * EPS32)
    for k, v in running.items():
        if update:
            _close(v, want_running[k], 8 * EPS32)
        else:
            assert torch.equal(v, params[k])


@pytest.mark.parametrize("m,c,itemsize,align", [
    (32 * 512 * 768, 16, 2, 16), (32 * 256 * 384, 32, 2, 16), (32 * 128 * 192, 64, 2, 16),
    (32 * 64 * 96, 128, 2, 16), (32 * 32 * 48, 256, 2, 16), (32 * 16 * 24, 512, 2, 16),
    (70, 3, 4, 16), (1000, 48, 4, 16), (1000, 20, 2, 16), (1000, 320, 2, 16),
    (1000, 64, 2, 4), (1, 1, 4, 16)])
def test_tiles_cover_every_row_and_channel(m, c, itemsize, align):
    """The geometry: the widest vector that C and the pointers' alignment
    allow, at most 256 threads and 32 groups a slab, slabs as even as they
    can be, every row in exactly one block, every block non-empty."""
    t = bnc.tiles(m, c, itemsize, align)
    assert c % t.vec == 0 and t.vec * itemsize <= min(16, align)
    assert t.vec * 2 * itemsize > 16 or c % (2 * t.vec) or align < 2 * t.vec * itemsize
    assert t.tx <= bnc.MAX_SLAB and t.tx * t.ty <= bnc.THREADS and t.ty == bnc.THREADS // t.tx
    assert t.slabs * t.tx * t.vec >= c > (t.slabs - 1) * t.tx * t.vec
    assert t.typ >= t.ty > t.typ // 2 and t.typ & (t.typ - 1) == 0
    assert t.blocks * t.rows >= m > (t.blocks - 1) * t.rows
    assert t.blocks * t.slabs <= bnc.TARGET_BLOCKS + t.slabs


def test_constants_are_the_plain_formulas():
    assert (bnc.EPS, bnc.MOMENTUM) == (tl.BN_EPS, tl.BN_MOMENTUM)


def test_off_the_card_train_mode_takes_the_plain_formula_and_counts_it():
    """A CPU input is never the kernels': the plain path runs and counts
    `plain`; eval mode counts nothing; the wrappers refuse CPU tensors."""
    x, params, _ = _case(2, 16, 4, 5)
    bn = tl.BatchNorm2d(16)
    bn.load_state_dict(params)
    before = dict(tl.bn_calls)
    bn.train()(x)
    bn.eval()(x)
    assert tl.bn_calls == {"fused": before["fused"], "plain": before["plain"] + 1}
    with pytest.raises(ValueError):
        bnc.forward(x, *params.values(), True)
