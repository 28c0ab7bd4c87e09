"""Greedy NMS: the wrappers of the hand-written CUDA kernels.

The two kernels of `csrc/nms.cu` replace the JAX package's device loop
`omni3d_tpu/ops/nms.py::nms_mask` over rows of boxes already sorted by
score: `suppression_words` writes the 64-bit suppression words of every
pair tile (the layout of `ops.nms.suppression_words`, their CPU mirror) and
`greedy_keep` walks them in score order, one warp per row, and writes the
keep mask (the mirror is `ops.nms.greedy_keep_from_words`). They are
compiled into the port's one kernel library (`utils/cuda_build.py`) at
first use. Each wrapper takes CUDA tensors only, checks type, shape,
contiguity and device and raises on anything else, allocates its output
with `torch.empty`, launches on the current stream without synchronising,
raises if the launch returned a CUDA error, and counts its launches
(`suppression_words.launches`, `greedy_keep.launches`).
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import library

TILE = 64              # boxes per tile: the bits of a word
MAX_BOXES = 16384      # N bound of the kernels (kMaxBoxes)
MAX_ROWS = 65535       # rows bound of the words kernel's grid

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = library()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nms_suppression_words.argtypes = [p, p, i, i, ctypes.c_float, p, p]
        lib.nms_suppression_words.restype = i
        lib.nms_greedy_keep.argtypes = [p, p, p, i, i, p, p]
        lib.nms_greedy_keep.restype = i
        _lib = lib
    return _lib


def _check(what, x, dtype, shape, device):
    if x.device.type != "cuda" or (device is not None and x.device != device):
        raise ValueError(f"{what} must be a CUDA tensor on {device or 'the card'}, got {x.device}")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what} must be {tuple(shape)} {dtype}, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _launch(fn, device, *args):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def suppression_words(boxes_s: torch.Tensor, valid_s: torch.Tensor,
                      iou_threshold: float) -> torch.Tensor:
    """Suppression words of R rows of N score-sorted boxes: (R, N, ceil(N /
    64)) int64, bit b of word w of box i set iff valid_s[i], j = 64 w + b > i,
    j < N and IoU(i, j) > iou_threshold. Words w < i // 64 are not written.

    boxes_s (R, N, 4) float32 XYXY, contiguous; valid_s (R, N) bool."""
    if boxes_s.ndim != 3:
        raise ValueError(f"boxes_s must be (R, N, 4), got {tuple(boxes_s.shape)}")
    R, N = boxes_s.shape[:2]
    _check("boxes_s", boxes_s, torch.float32, (R, N, 4), None)
    _check("valid_s", valid_s, torch.bool, (R, N), boxes_s.device)
    if R > MAX_ROWS or N > MAX_BOXES:
        raise ValueError(f"at most {MAX_ROWS} rows of {MAX_BOXES} boxes, got {R} x {N}")
    words = torch.empty((R, N, -(-N // TILE)), dtype=torch.int64, device=boxes_s.device)
    if R * N == 0:
        return words
    if boxes_s.data_ptr() % 16:       # the kernel reads 16-byte boxes
        raise ValueError("boxes_s must be 16-byte aligned")
    _launch(_library().nms_suppression_words, boxes_s.device, boxes_s.data_ptr(),
            valid_s.data_ptr(), R, N, iou_threshold, words.data_ptr())
    suppression_words.launches += 1
    return words


def greedy_keep(words: torch.Tensor, valid_s: torch.Tensor,
                order: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy keep mask of R rows from their suppression words: (R, N) bool,
    box i (in score order) kept iff valid_s[i] and no kept box j < i has
    bit i in its words. With `order` ((R, N) int64, the sort's indices) the
    mask is written through it into input order, else in score order.

    words (R, N, ceil(N / 64)) int64 from `suppression_words`; valid_s (R, N)
    bool."""
    if words.ndim != 3:
        raise ValueError(f"words must be (R, N, W), got {tuple(words.shape)}")
    R, N = words.shape[:2]
    _check("words", words, torch.int64, (R, N, -(-N // TILE)), None)
    _check("valid_s", valid_s, torch.bool, (R, N), words.device)
    if order is not None:
        _check("order", order, torch.int64, (R, N), words.device)
    if N > MAX_BOXES:
        raise ValueError(f"at most {MAX_BOXES} boxes per row, got {N}")
    keep = torch.empty((R, N), dtype=torch.bool, device=words.device)
    if R * N == 0:
        return keep
    _launch(_library().nms_greedy_keep, words.device, words.data_ptr(), valid_s.data_ptr(),
            None if order is None else order.data_ptr(), R, N, keep.data_ptr())
    greedy_keep.launches += 1
    return keep


suppression_words.launches = 0
greedy_keep.launches = 0
