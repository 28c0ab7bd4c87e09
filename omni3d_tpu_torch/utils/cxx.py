"""Build a C++ source of the port into a shared library with g++.

The library is written into a build directory (the package's `_build/` by
default), named by the source's stem and a hash of the source and the
flags, so an edited source or new flags build anew and an unchanged one is
reused. It is written under a temporary name and renamed, so processes that
build at once never load a partial file. A missing g++ or a failed build
raises: the callers have no fallback.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess

BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC")


def build_library(source: pathlib.Path, build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Compile `source` with FLAGS unless a build of it exists in
    `build_dir`; returns the library's path."""
    source = pathlib.Path(source)
    digest = hashlib.sha256(" ".join(FLAGS).encode() + source.read_bytes()).hexdigest()[:16]
    lib = pathlib.Path(build_dir) / f"{source.stem}-{digest}.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.so.tmp")
    try:
        res = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(source)],
                             capture_output=True, text=True, check=False)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build {source.name}: g++ not found") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {source.name} ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent process never loads a partial file
    return lib
