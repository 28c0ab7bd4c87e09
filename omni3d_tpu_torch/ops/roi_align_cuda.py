"""Multilevel ROIAlignV2 forward: the hand-written CUDA kernel and its wrapper.

The kernel (`csrc/roi_align_fwd.cu`) replaces the JAX package's Pallas TPU
kernels `roi_align_pallas.py::_pool_resident` and `::_pool_dma`. It is
compiled with nvcc for sm_90a into a shared library with a plain C
interface at first use, cached under `_build/` by a hash of the source and
flags, and loaded with ctypes.

`multilevel_roi_align` routes each box to a level in torch, then pools:
tensors on the CPU take the plain PyTorch version (`ops/roi_align.py`);
CUDA tensors launch the kernel, or the wrapper raises. There is no fallback
from one to the other. `multilevel_roi_align.launches` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from .roi_align import multilevel_roi_align_plain, route_levels

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "roi_align_fwd.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_LEVELS = 8
_VEC = {torch.float32: 4, torch.bfloat16: 8}   # channels per 16-byte vector

_lib = None


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build() -> tuple[pathlib.Path, float, str]:
    """Compile the kernel library unless a build of this source and these
    flags exists. Returns (library path, build seconds, compiler output)."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"roi_align_fwd-{tag}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)   # atomic: a concurrent process never loads a partial file
    return lib, seconds, log


def _library():
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.roi_align_fwd.argtypes = [
            ctypes.POINTER(p), ctypes.POINTER(i), ctypes.POINTER(i),
            ctypes.POINTER(ctypes.c_float), i, p, p, p, i, i, i, i, i, p, p]
        lib.roi_align_fwd.restype = i
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
    if out_size < 1 or sampling_ratio < 0:
        raise ValueError(f"bad out_size {out_size} / sampling_ratio {sampling_ratio}")


def multilevel_roi_align(features, boxes, strides, out_size: int = 7,
                         sampling_ratio: int = 0, min_level: int = 2,
                         routing: str = "canonical") -> torch.Tensor:
    """ROIAlignV2 over an FPN pyramid with per-box level routing.

    Args:
      features: list of (B, H_l, W_l, C) contiguous NHWC maps, float32 or
        bfloat16, finest level (`min_level`) first.
      boxes: (B, N, 4) float32 XYXY in image coordinates.
      strides: per-level strides.
      routing: "canonical" (detectron2 levels) or "fit" (the JAX TPU
        kernel's bumped levels); see `ops.roi_align.route_levels`.
    Returns (B, N, out_size, out_size, C) in the features' dtype.
    """
    levels = route_levels(boxes, strides, min_level, routing)
    if boxes.device.type == "cpu" and all(f.device.type == "cpu" for f in features):
        return multilevel_roi_align_plain(features, boxes, levels, strides, out_size,
                                          sampling_ratio)
    if boxes.device.type != "cuda":
        raise ValueError(f"multilevel_roi_align runs on CPU or CUDA tensors, got {boxes.device}")
    _check(features, boxes, strides, out_size, sampling_ratio)
    B, N = boxes.shape[:2]
    C = features[0].shape[-1]
    dtype = features[0].dtype
    out = torch.empty((B, N, out_size, out_size, C), dtype=dtype, device=boxes.device)
    if B * N == 0:
        return out
    boxes_flat = boxes.reshape(B * N, 4).contiguous()
    levels_flat = levels.reshape(B * N).to(torch.int32).contiguous()
    images = torch.arange(B, dtype=torch.int32, device=boxes.device).repeat_interleave(N)
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


multilevel_roi_align.launches = 0
