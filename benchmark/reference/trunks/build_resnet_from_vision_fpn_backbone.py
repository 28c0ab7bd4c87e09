"""ResNet trunks: the depth MODEL.RESNETS.DEPTH of `resnet.py`."""
from __future__ import annotations

from ..resnet import ResNet


def build(cfg, dtype):
    return ResNet(cfg.MODEL.RESNETS.DEPTH, dtype=dtype)
