"""DLA trunks: the variant MODEL.DLA.TYPE of `dla.py`."""
from __future__ import annotations

from ..dla import DLA


def build(cfg, dtype):
    return DLA(cfg.MODEL.DLA.TYPE, dtype=dtype)
