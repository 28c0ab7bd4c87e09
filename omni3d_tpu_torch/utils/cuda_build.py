"""Build the port's CUDA kernels into one shared library with nvcc.

Every `.cu` source under `csrc/` (`SOURCES`: the two ROIAlign kernels,
the NMS kernels, the train-mode BatchNorm kernels and the stage markers of
`utils/trace.py`) is compiled for sm_90a, one nvcc per source started
together, then linked into one library with a plain C interface that
`library()` loads with ctypes. The library is named by a hash of the
sources, the headers and the flags, under the package's `_build/`, so an
edited source builds anew and an unchanged one is reused; it is written
under a temporary name and renamed, so processes that build at once never
load a partial file. A missing nvcc or a failed build raises: the wrappers
have no fallback. The g++ builder of the host-side C++ sources is
`utils/cxx.py`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "roi_align_fwd.cu", CSRC / "roi_align_bwd.cu", CSRC / "nms.cu",
           CSRC / "batch_norm.cu", CSRC / "stage_mark.cu")
HEADERS = (CSRC / "roi_align_common.cuh",)
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
NVCC_FLAGS = ARCH_FLAGS + ("-Xptxas", "-v")

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
    """Compile the kernel library unless a build of these sources, headers
    and flags exists: one nvcc per source, started together, then one
    link. Returns (library path, build seconds, compiler output)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in SOURCES + HEADERS:
        digest.update(f.name.encode() + f.read_bytes())
    lib = BUILD_DIR / f"kernels-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, o in zip(SOURCES, objs)]
        log = "".join(p.communicate()[0] for p in procs)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        tmp = lib.with_name(f"{tag}.so.tmp")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, lib)   # atomic: a concurrent process never loads a partial file
    return lib, time.perf_counter() - t0, log


def library() -> ctypes.CDLL:
    """The kernel library, built at first use and loaded once per process.
    Each wrapper sets the argument types of the functions it calls."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        _lib = ctypes.CDLL(str(path))
    return _lib
