"""Greedy NMS: the wrappers of the hand-written CUDA kernels.

The two kernels of `csrc/nms.cu` replace the JAX package's device loop
`omni3d_tpu/ops/nms.py::nms_mask` over rows of boxes already sorted by
score: `suppression_words` writes the 64-bit suppression words of every
pair tile (the layout of `ops.nms.suppression_words`, their CPU mirror),
one warp per 64 x 64 tile, and `greedy_keep` walks them in score order, one
block per row, and writes the keep mask (the mirror is
`ops.nms.greedy_keep_from_words`). `iou_band` is the words kernel's fast
IoU test's band, computed here for the launch. They are
compiled into the port's one kernel library (`utils/cuda_build.py`) at
first use. Each wrapper takes CUDA tensors only, checks type, shape,
contiguity and device and raises on anything else, allocates its output
with `torch.empty`, launches on the current stream without synchronising,
raises if the launch returned a CUDA error, and counts its launches
(`suppression_words.launches`, `greedy_keep.launches`).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.cuda_build import library

TILE = 64              # boxes per tile: the bits of a word
MAX_BOXES = 16384      # N bound of the kernels (kMaxBoxes)
MAX_ROWS = 65535       # rows bound of the words kernel's grid
FAST_RANGE = (2.0 ** -30, 2.0 ** 30)   # thresholds with a band; others divide every pair

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = library()
        p, i = ctypes.c_void_p, ctypes.c_int
        f = ctypes.c_float
        lib.nms_suppression_words.argtypes = [p, p, i, i, f, i, f, f, p, p, p]
        lib.nms_suppression_words.restype = i
        lib.nms_greedy_keep.argtypes = [p, p, p, i, i, p, p]
        lib.nms_greedy_keep.restype = i
        lib.nms_launch_shapes.argtypes = [i, i, p]
        lib.nms_launch_shapes.restype = None
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


def iou_band(iou_threshold: float) -> tuple[bool, float, float]:
    """(fast, lo, hi) of the words kernel's IoU test at float32 t (see the
    note of `csrc/nms.cu`). fast is False for t < 0 or NaN: every pair is
    divided. Otherwise only pairs with inter > 0 and union > 0 can pass,
    and with m the midpoint of t and the next float, hi >= m (1 + 2^-23)
    and lo <= m (1 - 2^-23) (rounded outward from exact double arithmetic):
    inter > fl(hi * union) decides set, inter < fl(lo * union) clear, and
    only the pairs between divide. Outside FAST_RANGE, lo = -inf and hi =
    +inf: every overlapping pair divides."""
    t = np.float32(iou_threshold)
    if not t >= 0:
        return False, float("-inf"), float("inf")
    if not FAST_RANGE[0] <= t <= FAST_RANGE[1]:
        return True, float("-inf"), float("inf")
    m = (float(t) + float(np.nextafter(t, np.float32(np.inf)))) / 2   # exact in float64
    hi_d, lo_d = m * (1 + 2.0 ** -23), m * (1 - 2.0 ** -23)          # exact: <= 49 bits
    hi, lo = np.float32(hi_d), np.float32(lo_d)
    if float(hi) < hi_d:
        hi = np.nextafter(hi, np.float32(np.inf))
    if float(lo) > lo_d:
        lo = np.nextafter(lo, np.float32(-np.inf))
    return True, float(lo), float(hi)


def words_shape(rows: int, n: int) -> tuple[int, int, int]:
    """(R, W, 64 W): words[r, w, i] bit b is box i's suppression of box
    64 w + b; blocks w < i // 64 are not written."""
    n_words = -(-n // TILE)
    return rows, n_words, n_words * TILE


def suppression_words(boxes_s: torch.Tensor, valid_s: torch.Tensor, iou_threshold: float,
                      slow_pairs: torch.Tensor | None = None) -> torch.Tensor:
    """Suppression words of R rows of N score-sorted boxes: (R, W, 64 W)
    int64 with W = ceil(N / 64), bit b of words[r, w, i] set iff valid_s[i],
    valid_s[j], j = 64 w + b > i, j < N and IoU(i, j) > iou_threshold.
    Blocks w < i // 64 are not written. With `slow_pairs` (a one-element
    int64 CUDA tensor) the kernel adds to it the number of valid pairs j > i
    that its fast IoU test left to the division.

    boxes_s (R, N, 4) float32 XYXY, contiguous; valid_s (R, N) bool."""
    if boxes_s.ndim != 3:
        raise ValueError(f"boxes_s must be (R, N, 4), got {tuple(boxes_s.shape)}")
    R, N = boxes_s.shape[:2]
    _check("boxes_s", boxes_s, torch.float32, (R, N, 4), None)
    _check("valid_s", valid_s, torch.bool, (R, N), boxes_s.device)
    if slow_pairs is not None:
        _check("slow_pairs", slow_pairs, torch.int64, (1,), boxes_s.device)
    if R > MAX_ROWS or N > MAX_BOXES:
        raise ValueError(f"at most {MAX_ROWS} rows of {MAX_BOXES} boxes, got {R} x {N}")
    words = torch.empty(words_shape(R, N), dtype=torch.int64, device=boxes_s.device)
    if R * N == 0:
        return words
    if boxes_s.data_ptr() % 16:       # the kernel reads 16-byte boxes
        raise ValueError("boxes_s must be 16-byte aligned")
    fast, lo, hi = iou_band(iou_threshold)
    _launch(_library().nms_suppression_words, boxes_s.device, boxes_s.data_ptr(),
            valid_s.data_ptr(), R, N, iou_threshold, int(fast), lo, hi, words.data_ptr(),
            None if slow_pairs is None else slow_pairs.data_ptr())
    suppression_words.launches += 1
    return words


def greedy_keep(words: torch.Tensor, valid_s: torch.Tensor,
                order: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy keep mask of R rows from their suppression words: (R, N) bool,
    box i (in score order) kept iff valid_s[i] and no kept box j < i has
    bit i in its words. With `order` ((R, N) int64, the sort's indices) the
    mask is written through it into input order, else in score order.

    words (R, W, 64 W) int64 from `suppression_words`; valid_s (R, N)
    bool."""
    if words.ndim != 3 or valid_s.ndim != 2:
        raise ValueError(f"words must be (R, W, 64 W) and valid_s (R, N), got "
                         f"{tuple(words.shape)} and {tuple(valid_s.shape)}")
    R, N = valid_s.shape
    _check("words", words, torch.int64, words_shape(R, N), None)
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


def launch_shapes(rows: int, n: int) -> dict:
    """The kernels' launch configuration for R rows of N boxes, from the
    library itself: grid, block and dynamic shared bytes of each."""
    out = (ctypes.c_int * 6)()
    _library().nms_launch_shapes(rows, n, out)
    return {"nms_words_kernel": {"grid": [out[0], out[1]], "block": out[2], "dynamic_shared": 0},
            "nms_greedy_kernel": {"grid": [out[3]], "block": out[4], "dynamic_shared": out[5]}}


suppression_words.launches = 0
greedy_keep.launches = 0
