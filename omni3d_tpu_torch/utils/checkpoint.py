"""Bridge from the JAX package's variables to the port's state dict.

`state_dict_from_flax` is the inverse of
`omni3d_tpu.utils.checkpoint.convert_reference_checkpoint`: it maps the flax
parameter tree onto detectron2 key names (the names a reference `.pth`
uses), HWIO -> OIHW for convolutions, (in, out) -> (out, in) for linears,
the HWC -> CHW column permutation of the first FC after RoI pooling, and
BN scale/bias/mean/var -> weight/bias/running_mean/running_var.
"""
from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_LEAVES = ("kernel", "bias", "scale", "mean", "var")


def flax_path_to_torch(path: tuple[str, ...]) -> str | None:
    """detectron2 key prefix of a flax module path (port of
    `omni3d_tpu.utils.checkpoint.flax_path_to_torch` for the DLA, FPN, RPN,
    head and prior branches). Returns None for paths with no counterpart."""
    p = list(path)
    top = p[0]
    if top == "backbone":
        rest = p[1:]
        out = ["backbone", "bottom_up"]
        i = 0
        while i < len(rest):
            name = rest[i]
            if name in ("base_layer", "level0", "level1"):
                # Sequential [conv, bn, relu]
                out.append(f"{name}.0" if rest[i + 1] == "c" else f"{name}.1")
                i += 3
            elif re.fullmatch(r"conv\d", name):
                out.append(name if rest[i + 1] == "c" else "bn" + name[-1])
                i += 3
            elif name == "project":  # DLA tree projection Sequential
                out.append("project.0" if rest[i + 1] == "c" else "project.1")
                i += 3
            elif name == "root":  # flax Root nests conv/conv and bn/bn
                out.append("root." + rest[i + 1])
                i += 3
            else:  # levelK, tree1, tree2 pass through
                out.append(name)
                i += 1
        return ".".join(out)
    if top == "fpn":
        return "backbone." + p[1]
    if top == "rpn_head":
        return "proposal_generator.rpn_head." + p[1]
    if top == "box_head":
        return "roi_heads.box_head." + p[1]
    if top == "box_predictor":
        return "roi_heads.box_predictor." + p[1]
    if top == "cube_head":
        m = re.fullmatch(r"(feature_generator(?:_\w+?)?)_fc(\d)", p[1])
        if m:
            return f"roi_heads.cube_head.{m.group(1)}.fc{m.group(2)}"
        return "roi_heads.cube_head." + p[1]
    if top.startswith("priors"):
        return "roi_heads." + top
    return None


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (str(k),))
        else:
            yield path + (str(k),), np.asarray(v, np.float32)


def state_dict_from_flax(params, batch_stats=None, pooled_shape=(256, 7, 7)) -> dict:
    """{detectron2 key: f32 CPU tensor} from the JAX package's variables.

    Args:
      params, batch_stats: the flax `params` / `batch_stats` collections as
        nested mappings of arrays.
      pooled_shape: (C, H, W) of the RoI-pooled features, which fixes the
        column permutation of the first FC of the box and cube heads.
    """
    C, H, W = pooled_shape
    sd = {}

    def put(key, val):
        if key in sd:
            raise KeyError(f"two flax leaves map to {key}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(val))

    for path, val in _walk(params):
        leaf = path[-1]
        if leaf not in _LEAVES:  # prior tensors: the path is the key
            put(flax_path_to_torch(path), val)
            continue
        prefix = flax_path_to_torch(path[:-1])
        if prefix is None:
            raise KeyError(f"no torch key for flax path {'/'.join(path)}")
        if leaf == "kernel" and val.ndim == 4:        # HWIO -> OIHW
            val = val.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and val.ndim == 2:
            val = val.T                                # (in, out) -> (out, in)
            if path[-2].endswith("fc1") and val.shape[1] == C * H * W:
                out = val.shape[0]                     # HWC -> CHW columns
                val = val.reshape(out, H, W, C).transpose(0, 3, 1, 2).reshape(out, -1)
        put(prefix + (".bias" if leaf == "bias" else ".weight"), val)

    for path, val in _walk(batch_stats or {}):
        prefix = flax_path_to_torch(path[:-1])
        put(prefix + (".running_mean" if path[-1] == "mean" else ".running_var"), val)
    return sd
