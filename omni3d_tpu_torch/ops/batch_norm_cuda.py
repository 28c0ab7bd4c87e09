"""Train-mode BatchNorm: the wrappers of the hand-written CUDA kernels, and
their arithmetic in plain PyTorch.

The kernels of `csrc/batch_norm.cu` compute `models.layers.BatchNorm2d`'s
train-mode formula (batch statistics in float32 with the biased variance,
the running update at momentum 0.1, the affine x a + b) on a channels-last
CUDA activation viewed as M = N H W rows of C channels, and its backward:
per direction a reduce over row blocks into float32 partials, a merge of
the partials in float64 in a fixed order, and an elementwise apply
(`forward`, `backward`; `TrainBatchNorm` is the autograd function over
them). The launch geometry is `tiles`, a function of M, C, the dtype and
the pointers' alignment alone, so two calls are bit-equal.

`forward_mirror` and `backward_mirror` repeat the kernels' arithmetic op
for op in plain PyTorch (`tile_partials`, `merged_sums`), on any device:
the CPU tests hold them against autograd through the plain formula in
float64, and the card tests hold the kernels against them bit for bit.

The wrappers take CUDA tensors only, check them and raise on anything else,
allocate with `torch.empty`, launch on the current stream without
synchronising, raise if a launch returned a CUDA error, and count their
calls (`forward.launches`, `backward.launches`: three kernels each).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..utils.cuda_build import library

EPS = 1e-5           # csrc/batch_norm.cu kEps; models.layers.BN_EPS
MOMENTUM = 0.1       # kMomentum; models.layers.BN_MOMENTUM
THREADS = 256        # threads of a reduce or apply block (kThreads)
LANES = 32           # partial rows a merge thread sums in turn (kLanes)
MAX_SLAB = 32        # channel groups of one slab: threads across a row
TARGET_BLOCKS = 528  # reduce and apply blocks aimed at: 4 on each of an H100's 132 SMs
MIN_ROUNDS = 4       # rows each thread of a block reads at the least
DTYPES = (torch.bfloat16, torch.float32)


class Tiles(NamedTuple):
    """The launch geometry of the reduce and apply kernels."""
    vec: int     # channels of one vector load (16 bytes where C and the pointers allow)
    tx: int      # channel groups of a slab: threads across a row
    ty: int      # row lanes of a block: THREADS // tx
    typ: int     # ty rounded up to a power of two (the width of the lanes' tree)
    slabs: int   # channel slabs: grid y
    rows: int    # rows of a row block
    blocks: int  # row blocks: grid x


def tiles(m: int, c: int, itemsize: int, align: int = 16) -> Tiles:
    """The geometry for m rows of c channels of `itemsize` bytes whose
    pointers are all `align`-byte aligned (a power of two). The vector is
    the widest of 16 / itemsize, ..., 1 channels that divides c and the
    alignment, so a ragged C takes narrower loads. Slabs cover at most 32
    groups each, as evenly as they can; row blocks aim at TARGET_BLOCKS in
    all, each thread reading MIN_ROUNDS rows or more."""
    vec = 16 // itemsize
    while vec > 1 and (c % vec or align % (vec * itemsize)):
        vec //= 2
    groups = c // vec
    slabs = -(-groups // MAX_SLAB)
    tx = -(-groups // slabs)
    ty = THREADS // tx
    typ = 1 << (ty - 1).bit_length()
    blocks = max(1, min(-(-m // (ty * MIN_ROUNDS)), -(-TARGET_BLOCKS // slabs)))
    rows = -(-m // blocks)
    return Tiles(vec, tx, ty, typ, slabs, rows, -(-m // rows))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """The (M, C) row view of an NCHW channels-last tensor."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n * h * w, c)


def _from_rows(r: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    n, c, h, w = like.shape
    return r.reshape(n, h, w, c).permute(0, 3, 1, 2)


# ---------------------------------------------------------------- the mirror

def _tree(acc: torch.Tensor, width: int, dim: int) -> torch.Tensor:
    """The kernels' tree over `width` (a power of two) lanes along `dim`:
    lane j takes lane j + stride, stride = width / 2, ..., 1."""
    stride = width // 2
    while stride:
        acc = acc.narrow(dim, 0, stride) + acc.narrow(dim, stride, stride)
        stride //= 2
    return acc.select(dim, 0)


def tile_partials(x: torch.Tensor, centre: torch.Tensor, dy: torch.Tensor | None,
                  t: Tiles) -> torch.Tensor:
    """The reduce kernel's partials, (blocks, 2, C) float32: per row block
    and channel, with d = x - centre, the sums of d and d^2 (dy None) or of
    dy and dy d. Thread lane j of a block sums the block's rows j, j + ty,
    ... in turn from +0, then the tree over the ty lanes. Rows and lanes
    that do not exist are -0.0 here, which adds as nothing.

    x, dy (M, C); centre (C,) float32."""
    m, c = x.shape
    d = x.float() - centre
    if dy is None:
        u, v = d, d * d
    else:
        g = dy.float()
        u, v = g, g * d
    rounds = -(-t.rows // t.ty)

    def lanes(z):
        z = torch.cat([z, z.new_full((t.blocks * t.rows - m, c), -0.0)])
        z = z.view(t.blocks, t.rows, c)
        z = torch.cat([z, z.new_full((t.blocks, rounds * t.ty - t.rows, c), -0.0)], 1)
        z = z.view(t.blocks, rounds, t.ty, c)
        acc = z.new_zeros((t.blocks, t.ty, c))
        for k in range(rounds):
            acc = acc + z[:, k]
        acc = torch.cat([acc, acc.new_full((t.blocks, t.typ - t.ty, c), -0.0)], 1)
        return _tree(acc, t.typ, 1)

    return torch.stack([lanes(u), lanes(v)], 1)


def merged_sums(part: torch.Tensor) -> torch.Tensor:
    """The merge kernels' two sums per channel, (2, C) float64: lane j of
    LANES sums partial rows j, j + LANES, ... in turn from +0, then the tree
    over the lanes."""
    p = part.double()
    blocks, _, c = p.shape
    rounds = -(-blocks // LANES)
    p = torch.cat([p, p.new_full((rounds * LANES - blocks, 2, c), -0.0)])
    p = p.view(rounds, LANES, 2, c)
    acc = p.new_zeros((LANES, 2, c))
    for k in range(rounds):
        acc = acc + p[k]
    return _tree(acc, LANES, 0)


def forward_mirror(x, weight, bias, running_mean, running_var, update: bool,
                   t: Tiles | None = None):
    """The forward kernels' arithmetic: (y, stats) as `forward` returns
    them, the running statistics updated in place when `update`. x is NCHW
    (bf16 or float32, any layout), the rest float32 (C,); t defaults to the
    geometry of aligned pointers."""
    rows = _rows(x)
    m, c = rows.shape
    t = t or tiles(m, c, x.element_size())
    centre = rows[0].float()
    s1, s2 = merged_sums(tile_partials(rows, centre, None, t))
    n = torch.tensor(float(m), dtype=torch.float64, device=x.device)
    shift = s1 / n
    var_d = s2 / n - shift * shift
    var_d = torch.where(var_d < 0, torch.zeros_like(var_d), var_d)
    mean = (centre.double() + shift).float()
    var = var_d.float()
    rstd = (torch.ones_like(var_d) / torch.sqrt((var + EPS).double())).float()
    weight, bias = weight.detach(), bias.detach()
    a = weight * rstd
    b = bias - mean * a
    if update:
        with torch.no_grad():
            running_mean.copy_((1 - MOMENTUM) * running_mean + MOMENTUM * mean)
            running_var.copy_((1 - MOMENTUM) * running_var + MOMENTUM * var)
    y = (rows.float() * a + b).to(x.dtype)
    return _from_rows(y, x), torch.stack([a, b, mean, rstd])


def backward_mirror(x, dy, stats, t: Tiles | None = None):
    """The backward kernels' arithmetic: (dx, grad_weight, grad_bias) as
    `backward` returns them, from x, dy (NCHW, x's dtype) and the forward's
    stats."""
    rows, grows = _rows(x), _rows(dy)
    m, c = rows.shape
    t = t or tiles(m, c, x.element_size())
    a, _, mean, rstd = stats
    s1, s2 = merged_sums(tile_partials(rows, mean, grows, t))
    n = torch.tensor(float(m), dtype=torch.float64, device=x.device)
    a_d, rstd_d = a.double(), rstd.double()
    sdx = s2 * rstd_d
    c0 = (a_d * s1 / n).float()
    k = (a_d * rstd_d * sdx / n).float()
    d = rows.float() - mean
    dx = ((a * grows.float() - c0) - k * d).to(x.dtype)
    return _from_rows(dx, x), sdx.float(), s1.float()


# ------------------------------------------------------------------- kernels

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = library()
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bn_forward.argtypes = [i, i, p, p, p, p, p, i, q, i, i, i, i, q, i, i, p, p, p, p]
        lib.bn_forward.restype = i
        lib.bn_backward.argtypes = [i, i, p, p, p, q, i, i, i, i, q, i, i, p, p, p, p, p, p]
        lib.bn_backward.restype = i
        _lib = lib
    return _lib


def _check_input(x):
    if not (x.is_cuda and x.dim() == 4 and x.dtype in DTYPES and x.numel() > 0
            and x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"x must be a non-empty 4-D bf16 or float32 channels-last CUDA "
                         f"tensor, got {tuple(x.shape)} {x.dtype} on {x.device}")


def _check_vector(what, v, c, device):
    if v.device != device or v.dtype != torch.float32 or v.shape != (c,) or not v.is_contiguous():
        raise ValueError(f"{what} must be a contiguous float32 ({c},) tensor on {device}, got "
                         f"{tuple(v.shape)} {v.dtype} on {v.device}")


def _geometry(x: torch.Tensor, *others: torch.Tensor) -> tuple[int, int, Tiles]:
    n, c, h, w = x.shape
    align = math.gcd(16, x.data_ptr(), *(o.data_ptr() for o in others))
    return n * h * w, c, tiles(n * h * w, c, x.element_size(), align)


def _launch(fn, device, *args):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def forward(x, weight, bias, running_mean, running_var, update: bool):
    """Train-mode BN forward on the card: (y, stats), y channels-last in
    x's dtype, stats (4, C) float32 = a, b, mean, rstd (the backward's
    input). The running statistics are updated in place, in the same
    tensors, when `update`."""
    _check_input(x)
    c = x.shape[1]
    for what, v in (("weight", weight), ("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        _check_vector(what, v, c, x.device)
    m, c, t = _geometry(x)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    part = torch.empty((t.blocks, 2, c), dtype=torch.float32, device=x.device)
    stats = torch.empty((4, c), dtype=torch.float32, device=x.device)
    _launch(_library().bn_forward, x.device, int(x.dtype == torch.bfloat16), t.vec,
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
            running_var.data_ptr(), int(update), m, c, t.tx, t.ty, t.typ, t.rows, t.blocks,
            t.slabs, part.data_ptr(), stats.data_ptr(), y.data_ptr())
    forward.launches += 1
    return y, stats


def backward(x, dy, stats):
    """Train-mode BN backward on the card: (dx, grad_weight, grad_bias), dx
    channels-last in x's dtype, the gradients float32 (C,). dy is made
    channels-last contiguous in x's dtype first if it is not."""
    _check_input(x)
    c = x.shape[1]
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy must be {tuple(x.shape)} on {x.device}, got {tuple(dy.shape)} on "
                         f"{dy.device}")
    dy = dy.to(x.dtype).contiguous(memory_format=torch.channels_last)
    if stats.shape != (4, c) or stats.dtype != torch.float32 or stats.device != x.device \
            or not stats.is_contiguous():
        raise ValueError(f"stats must be the forward's contiguous (4, {c}) float32 tensor")
    m, c, t = _geometry(x, dy)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    part = torch.empty((t.blocks, 2, c), dtype=torch.float32, device=x.device)
    out = torch.empty((4, c), dtype=torch.float32, device=x.device)   # c0, k, dweight, dbias
    _launch(_library().bn_backward, x.device, int(x.dtype == torch.bfloat16), t.vec,
            x.data_ptr(), dy.data_ptr(), stats.data_ptr(), m, c, t.tx, t.ty, t.typ, t.rows,
            t.blocks, t.slabs, part.data_ptr(), out.data_ptr(), out[2].data_ptr(),
            out[3].data_ptr(), dx.data_ptr())
    backward.launches += 1
    return dx, out[2], out[3]


forward.launches = 0
backward.launches = 0


class TrainBatchNorm(torch.autograd.Function):
    """Train-mode BN through the kernels, on a 4-D bf16 or float32 CUDA
    input of any layout: one that is not channels-last contiguous is made
    so first, any other raises. Autograd keeps that input and the (4, C)
    stats only."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, update):
        x = x.contiguous(memory_format=torch.channels_last)
        y, stats = forward(x, weight, bias, running_mean, running_var, update)
        ctx.save_for_backward(x, stats)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, stats = ctx.saved_tensors
        dx, grad_weight, grad_bias = backward(x, dy, stats)
        return dx, grad_weight, grad_bias, None, None, None
