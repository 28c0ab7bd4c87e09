"""The greedy COCO matcher (`csrc/matcher.cc`) through ctypes, and the same
loop in Python (`greedy_match_plain`, the tests' reference).

The C++ source is compiled with g++ at first use into `_build/`
(`utils.cxx.build_library`). A failed build or load raises: evaluation has
no silent fallback to the Python loop.
"""
from __future__ import annotations

import ctypes
import pathlib

import numpy as np

from ..utils import cxx

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "matcher.cc"
BUILD_DIR = cxx.BUILD_DIR

_lib = None


def build() -> pathlib.Path:
    """Compile the matcher library unless a build of this source exists;
    returns its path."""
    return cxx.build_library(SOURCE, BUILD_DIR)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        f32, f64, u8, i64 = (ctypes.POINTER(t) for t in (
            ctypes.c_float, ctypes.c_double, ctypes.c_uint8, ctypes.c_int64))
        i = ctypes.c_int
        lib.greedy_match.argtypes = [f32, i, i, f64, i, u8, u8, i, i64, i64, f64, f64, u8]
        lib.greedy_match.restype = None
        _lib = lib
    return _lib


def _inputs(ious, iou_thrs, gt_ignore, in_prox, dt_ids, gt_ids):
    ious = np.ascontiguousarray(ious, np.float32)
    D, G = ious.shape
    thrs = np.ascontiguousarray(iou_thrs, np.float64).reshape(-1)
    gti = np.ascontiguousarray(gt_ignore, np.uint8).reshape(-1)
    dti = np.ascontiguousarray(dt_ids, np.int64).reshape(-1)
    gtid = np.ascontiguousarray(gt_ids, np.int64).reshape(-1)
    prox = None if in_prox is None else np.ascontiguousarray(in_prox, np.uint8)
    if gti.shape != (G,) or gtid.shape != (G,) or dti.shape != (D,) or (
            prox is not None and prox.shape != (D, G)):
        raise ValueError(f"greedy_match: ious {ious.shape}, gt_ignore {gti.shape}, "
                         f"dt_ids {dti.shape}, gt_ids {gtid.shape}, in_prox "
                         f"{None if prox is None else prox.shape}")
    return ious, thrs, gti, prox, dti, gtid


def greedy_match(ious: np.ndarray, iou_thrs: np.ndarray, gt_ignore: np.ndarray,
                 in_prox: np.ndarray | None, dt_ids, gt_ids):
    """The native matcher over one (image, category) group: ious (D, G) with
    the detections in score order and the GTs ignore-last, in_prox (D, G)
    or None. Returns (dtm (T, D), gtm (T, G), dt_ig (T, D) uint8)."""
    ious, thrs, gti, prox, dti, gtid = _inputs(ious, iou_thrs, gt_ignore, in_prox,
                                               dt_ids, gt_ids)
    D, G = ious.shape
    T = len(thrs)
    use_prox = prox is not None
    if not use_prox:
        prox = np.zeros((1, 1), np.uint8)
    dtm = np.zeros((T, D), np.float64)
    gtm = np.zeros((T, G), np.float64)
    dt_ig = np.zeros((T, D), np.uint8)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    _library().greedy_match(
        p(ious, ctypes.c_float), D, G, p(thrs, ctypes.c_double), T,
        p(gti, ctypes.c_uint8), p(prox, ctypes.c_uint8), int(use_prox),
        p(dti, ctypes.c_int64), p(gtid, ctypes.c_int64),
        p(dtm, ctypes.c_double), p(gtm, ctypes.c_double), p(dt_ig, ctypes.c_uint8))
    return dtm, gtm, dt_ig


def greedy_match_plain(ious: np.ndarray, iou_thrs: np.ndarray, gt_ignore: np.ndarray,
                       in_prox: np.ndarray | None, dt_ids, gt_ids):
    """`greedy_match` as the Python loop of the reference (the plain
    version the tests hold the native one against)."""
    ious, thrs, gti, prox, dti, gtid = _inputs(ious, iou_thrs, gt_ignore, in_prox,
                                               dt_ids, gt_ids)
    D, G = ious.shape
    T = len(thrs)
    dtm = np.zeros((T, D), np.float64)
    gtm = np.zeros((T, G), np.float64)
    dt_ig = np.zeros((T, D), np.uint8)
    for t in range(T):
        for d in range(D):
            best = min(float(thrs[t]), 1 - 1e-10)
            m = -1
            for g in range(G):
                if prox is not None and not prox[d, g]:
                    continue
                if gtm[t, g] > 0:
                    continue
                if m > -1 and gti[m] == 0 and gti[g] == 1:
                    break
                if float(ious[d, g]) < best:
                    continue
                best = float(ious[d, g])
                m = g
            if m == -1:
                continue
            dt_ig[t, d] = gti[m]
            dtm[t, d] = gtid[m]
            gtm[t, m] = dti[d]
    return dtm, gtm, dt_ig
