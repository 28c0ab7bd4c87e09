"""Multilevel ROIAlignV2: the hand-written CUDA kernels and their wrapper.

The forward kernel (`csrc/roi_align_fwd.cu`) replaces the JAX package's
Pallas TPU kernels `roi_align_pallas.py::_pool_resident` and `::_pool_dma`;
the backward kernel (`csrc/roi_align_bwd.cu`) replaces
`roi_align_bwd_pallas.py::roi_align_bwd_pallas`. Both are bound by bytes on
the H100 and pool through per-axis banded weights that a block builds once
per box in shared memory (`csrc/roi_align_common.cuh`;
`ops.roi_align.axis_bands` is their CPU mirror). The forward is
box-stationary: each bin reads the cells of its band product once, with no
barrier after the bands are built. The backward is output-stationary: a
block owns a tile of one image-level's gradient, walks the boxes that touch
it and writes the tile once, with no atomics, so it is bit-reproducible run
to run and its outputs need no zeroing and no cast. The kernels are
compiled with nvcc for sm_90a at first use into the port's one kernel
library (`utils/cuda_build.py`: one nvcc per source started together, a
plain C interface loaded with ctypes).

`multilevel_roi_align` routes each box to a level in torch, then pools
through `MultilevelROIAlign`, a `torch.autograd.Function`: tensors on the
CPU take the plain PyTorch forward and backward (`ops/roi_align.py`); CUDA
tensors launch the kernels, or the wrapper raises. There is no fallback
from one to the other. `multilevel_roi_align.launches` and
`multilevel_roi_align.bwd_launches` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import library
from .roi_align import (ADAPTIVE_SMAX, multilevel_roi_align_plain,
                        multilevel_roi_align_plain_bwd, route_levels)

MAX_LEVELS = 8
MAX_BINS = 8                     # out_size bound of the kernels (kMaxBins)
_VEC = {torch.float32: 4, torch.bfloat16: 8}   # channels per 16-byte vector

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = library()
        p, i = ctypes.c_void_p, ctypes.c_int
        ints = ctypes.POINTER(i)
        floats = ctypes.POINTER(ctypes.c_float)
        lib.roi_align_fwd.argtypes = [
            ctypes.POINTER(p), ints, ints, floats, i, p, p, p, i, i, i, i, i, p, p]
        lib.roi_align_fwd.restype = i
        lib.roi_align_bwd.argtypes = [
            ctypes.POINTER(p), ints, ints, floats, i, p, p, i, i, p, i, i, i, i, p]
        lib.roi_align_bwd.restype = i
        _lib = lib
    return _lib


def _check(features, boxes, strides, out_size, sampling_ratio):
    if not 1 <= len(features) <= MAX_LEVELS or len(features) != len(strides):
        raise ValueError(f"need 1..{MAX_LEVELS} levels with one stride each, got "
                         f"{len(features)} levels and {len(strides)} strides")
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be (B, N, 4) float32, got {tuple(boxes.shape)} {boxes.dtype}")
    B = boxes.shape[0]
    f0 = features[0]
    if f0.dtype not in _VEC:
        raise ValueError(f"features must be float32 or bfloat16, got {f0.dtype}")
    C = f0.shape[-1]
    if C % _VEC[f0.dtype]:
        raise ValueError(f"channels must be a multiple of {_VEC[f0.dtype]} for {f0.dtype}, got {C}")
    for f in features:
        if f.ndim != 4 or f.shape[0] != B or f.shape[-1] != C or f.dtype != f0.dtype:
            raise ValueError("every level must be (B, H_l, W_l, C) with the boxes' B and "
                             f"one C and dtype; got {tuple(f.shape)} {f.dtype}")
        if f.device != boxes.device:
            raise ValueError(f"features on {f.device}, boxes on {boxes.device}")
        if not f.is_contiguous() or f.data_ptr() % 16:
            raise ValueError("every level must be contiguous NHWC and 16-byte aligned")
    if not 1 <= out_size <= MAX_BINS or not 0 <= sampling_ratio <= ADAPTIVE_SMAX:
        raise ValueError(f"out_size must be in 1..{MAX_BINS} and sampling_ratio in "
                         f"0..{ADAPTIVE_SMAX}, got {out_size} / {sampling_ratio}")


def _box_tables(boxes, levels):
    """Flat boxes, int32 levels and image indices of (B, N) boxes."""
    B, N = boxes.shape[:2]
    images = torch.arange(B, dtype=torch.int32, device=boxes.device).repeat_interleave(N)
    flat = boxes.reshape(B * N, 4)
    if not flat.is_contiguous() or flat.data_ptr() % 16:   # the kernels read 16-byte boxes
        flat = flat.clone(memory_format=torch.contiguous_format)
    return flat, levels.reshape(B * N).to(torch.int32).contiguous(), images


def _forward_kernel(features, boxes, levels, strides, out_size, sampling_ratio):
    B, N = boxes.shape[:2]
    C = features[0].shape[-1]
    dtype = features[0].dtype
    out = torch.empty((B, N, out_size, out_size, C), dtype=dtype, device=boxes.device)
    if B * N == 0:
        return out
    boxes_flat, levels_flat, images = _box_tables(boxes, levels)
    L = len(features)
    ptrs = (ctypes.c_void_p * L)(*[f.data_ptr() for f in features])
    hs = (ctypes.c_int * L)(*[f.shape[1] for f in features])
    ws = (ctypes.c_int * L)(*[f.shape[2] for f in features])
    scales = (ctypes.c_float * L)(*[1.0 / s for s in strides])
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().roi_align_fwd(
            ptrs, hs, ws, scales, L, boxes_flat.data_ptr(), levels_flat.data_ptr(),
            images.data_ptr(), B * N, C, out_size, sampling_ratio,
            int(dtype == torch.bfloat16), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"roi_align_fwd launch failed: CUDA error {err}")
    multilevel_roi_align.launches += 1
    return out


def _backward_kernel(grad, boxes, levels, level_shapes, strides, out_size,
                     sampling_ratio, dtype):
    """Per-level (B, H_l, W_l, C) feature gradients in the features' dtype.
    The kernel writes every element exactly once, so the outputs come from
    torch.empty: no zeroed accumulator and no cast pass."""
    B, N = boxes.shape[:2]
    C = grad.shape[-1]
    if grad.dtype != dtype or dtype not in _VEC or C % _VEC[dtype]:
        raise ValueError(f"grad must be float32 or bfloat16 in the features' dtype {dtype} "
                         f"with C a multiple of {_VEC.get(dtype)}, got {grad.dtype} C={C}")
    if B * N == 0:
        return [torch.zeros((B, h, w, C), dtype=dtype, device=boxes.device)
                for h, w in level_shapes]
    if not grad.is_contiguous() or grad.data_ptr() % 16:
        grad = grad.clone(memory_format=torch.contiguous_format)
    grads = [torch.empty((B, h, w, C), dtype=dtype, device=boxes.device)
             for h, w in level_shapes]
    boxes_flat, levels_flat, _ = _box_tables(boxes, levels)
    L = len(level_shapes)
    outs = (ctypes.c_void_p * L)(*[g.data_ptr() for g in grads])
    hs = (ctypes.c_int * L)(*[h for h, _ in level_shapes])
    ws = (ctypes.c_int * L)(*[w for _, w in level_shapes])
    scales = (ctypes.c_float * L)(*[1.0 / s for s in strides])
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().roi_align_bwd(
            outs, hs, ws, scales, L, boxes_flat.data_ptr(), levels_flat.data_ptr(), B, N,
            grad.data_ptr(), C, out_size, sampling_ratio, int(dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(f"roi_align_bwd launch failed: CUDA error {err}")
    multilevel_roi_align.bwd_launches += 1
    return grads


class MultilevelROIAlign(torch.autograd.Function):
    """Pooling with the kernels' (or, on the CPU, the plain versions')
    backward. Saves the boxes and the routed levels, so the backward
    transposes exactly the map the forward applied; boxes get no gradient,
    as in torchvision and the JAX package's `multilevel_roi_align_fast`."""

    @staticmethod
    def forward(ctx, boxes, levels, strides, out_size, sampling_ratio, *features):
        ctx.save_for_backward(boxes, levels)
        ctx.geom = (tuple(tuple(f.shape[1:3]) for f in features), tuple(strides),
                    out_size, sampling_ratio, features[0].dtype)
        if boxes.device.type == "cpu":
            return multilevel_roi_align_plain(features, boxes, levels, strides, out_size,
                                              sampling_ratio)
        return _forward_kernel(features, boxes, levels, strides, out_size, sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        boxes, levels = ctx.saved_tensors
        shapes, strides, out_size, sampling_ratio, dtype = ctx.geom
        none = (None,) * 5
        if not any(ctx.needs_input_grad[5:]):
            return none + (None,) * len(shapes)
        if boxes.device.type == "cpu":
            grads = multilevel_roi_align_plain_bwd(grad, boxes, levels, shapes, strides,
                                                   out_size, sampling_ratio, dtype)
        else:
            grads = _backward_kernel(grad, boxes, levels, shapes, strides, out_size,
                                     sampling_ratio, dtype)
        return none + tuple(grads)


def multilevel_roi_align(features, boxes, strides, out_size: int = 7,
                         sampling_ratio: int = 0, min_level: int = 2,
                         routing: str = "canonical") -> torch.Tensor:
    """ROIAlignV2 over an FPN pyramid with per-box level routing;
    differentiable in the features.

    Args:
      features: list of (B, H_l, W_l, C) contiguous NHWC maps, float32 or
        bfloat16, finest level (`min_level`) first.
      boxes: (B, N, 4) float32 XYXY in image coordinates.
      strides: per-level strides.
      routing: "canonical" (detectron2 levels) or "fit" (the JAX TPU
        kernel's bumped levels); see `ops.roi_align.route_levels`. The
        backward uses the levels the forward used.
    Returns (B, N, out_size, out_size, C) in the features' dtype.
    """
    levels = route_levels(boxes, strides, min_level, routing)
    if not (boxes.device.type == "cpu" and all(f.device.type == "cpu" for f in features)):
        if boxes.device.type != "cuda":
            raise ValueError(f"multilevel_roi_align runs on CPU or CUDA tensors, "
                             f"got {boxes.device}")
        _check(features, boxes, strides, out_size, sampling_ratio)
    return MultilevelROIAlign.apply(boxes, levels, tuple(strides), out_size,
                                    sampling_ratio, *features)


multilevel_roi_align.launches = 0
multilevel_roi_align.bwd_launches = 0
