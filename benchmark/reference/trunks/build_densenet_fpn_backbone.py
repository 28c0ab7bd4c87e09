"""The DenseNet-121 trunk of `densenet.py` (no variant key: the published
builder makes DenseNet-121 only)."""
from __future__ import annotations

from ..densenet import DenseNet121


def build(cfg, dtype):
    return DenseNet121(dtype=dtype)
