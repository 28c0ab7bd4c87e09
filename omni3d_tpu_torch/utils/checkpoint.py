"""Weights and checkpoints of the port.

The bridge from the JAX package's variables to the port's state dict:

`state_dict_from_flax` is the inverse of
`omni3d_tpu.utils.checkpoint.convert_reference_checkpoint`: it maps the flax
parameter tree onto detectron2 key names (the names a reference `.pth`
uses), HWIO -> OIHW for convolutions, (in, out) -> (out, in) for linears,
the HWC -> CHW column permutation of the first FC after RoI pooling, and
BN scale/bias/mean/var -> weight/bias/running_mean/running_var.

The training checkpoints (port of the native save/load of
`omni3d_tpu.utils.checkpoint`: `save_checkpoint`, `load_checkpoint`,
`PeriodicCheckpointer`, `resume_or_load`, with torch.save), and the loaders
of reference and ImageNet weights (`convert_reference_checkpoint`,
`convert_imagenet_backbone`).
"""
from __future__ import annotations

import os
import pickle
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


# ------------------------------ native save/load ------------------------------
# The training state is a dict of state dicts: "model" (parameters, BN
# statistics and priors), "optimizer", "scheduler" and "step" (the train
# step's `state`: step, skipped, recent_loss); `extra` carries the iteration.

def save_checkpoint(path: str, state: dict, extra: dict | None = None):
    """torch.save {"state": state, "extra": extra} to a temporary file and
    rename it over `path`, so a reader never sees half a checkpoint."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"state": state, "extra": extra or {}}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu"):
    """(state, extra) of a checkpoint `save_checkpoint` wrote. The JAX
    package's .ckpt (a pickled flax dataclass) is not one: its weights reach
    the port through `state_dict_from_flax`."""
    try:
        payload = torch.load(path, map_location=map_location, weights_only=True)
    except (pickle.UnpicklingError, RuntimeError) as e:
        raise ValueError(f"{path} is not a checkpoint of the port ({e}); a JAX package "
                         "checkpoint converts with state_dict_from_flax") from None
    return payload["state"], payload["extra"]


class PeriodicCheckpointer:
    """Rolling single-file checkpointer (reference solver/checkpoint.py:5-27):
    overwrites `model_recent.ckpt` every `period` steps, writes
    `model_final.ckpt` at max_iter. `state_fn()` builds the state only when a
    file is written."""

    def __init__(self, output_dir: str, period: int, max_iter: int):
        self.output_dir = output_dir
        self.period = period
        self.max_iter = max_iter

    def step(self, iteration: int, state_fn, extra=None):
        if (iteration + 1) % self.period == 0:
            save_checkpoint(os.path.join(self.output_dir, "model_recent.ckpt"), state_fn(), extra)
        if iteration + 1 >= self.max_iter:
            save_checkpoint(os.path.join(self.output_dir, "model_final.ckpt"), state_fn(), extra)


def resume_or_load(output_dir: str, map_location="cpu"):
    """(state, extra) of model_recent if present, else None."""
    path = os.path.join(output_dir, "model_recent.ckpt")
    if os.path.exists(path):
        return load_checkpoint(path, map_location)
    return None


# ------------------------------ reference weights ------------------------------

# keys of a reference state dict that name no weight of the model
_NOT_WEIGHTS = ("num_batches_tracked", "pixel_mean", "pixel_std", "anchor_generator")

# The published ImageNet DLA weights use the bottom-up network's flat names
# (reference dla.py:300-309); the detector drops their classifier, fc.*
# (dla.py:306-308).
_DLA = "build_dla_from_vision_fpn_backbone"
_BOTTOM_UP = "backbone.bottom_up."


def _unwrap(state_dict: dict) -> dict:
    for key in ("model", "state_dict"):
        if key in state_dict and isinstance(state_dict[key], dict):
            state_dict = state_dict[key]
    return state_dict


def _load_matching(sd: dict, model: torch.nn.Module, prefix: str = "",
                   strict: bool = False) -> dict:
    """Copy the entries of `sd` onto the model's state-dict entries under
    `prefix` with the same name; report loaded / missing / unused."""
    own = {k: v for k, v in model.state_dict().items() if k.startswith(prefix)}
    new, missing = {}, []
    for k, cur in own.items():
        val = sd.get(k)
        if val is None:
            missing.append(k)
            continue
        val = (val.detach().cpu().float() if torch.is_tensor(val)
               else torch.from_numpy(np.asarray(val, np.float32)))
        if val.shape != cur.shape and val.shape[:1] == (1,):
            val = val[0]                      # priors stored with a batch dim
        if val.shape != cur.shape:
            raise ValueError(f"shape mismatch for {k}: checkpoint {tuple(val.shape)} vs "
                             f"model {tuple(cur.shape)}")
        new[k] = val
    if strict and missing:
        raise KeyError(f"missing keys: {missing[:10]} ({len(missing)} total)")
    model.load_state_dict(new, strict=False)
    unused = [k for k in sd if k not in new and not any(n in k for n in _NOT_WEIGHTS)]
    return {"missing": missing, "unused": unused, "loaded": len(new)}


def convert_reference_checkpoint(state_dict: dict, model: torch.nn.Module,
                                 strict: bool = False) -> dict:
    """Load a reference (detectron2-named) state dict into the model, in
    place; a {'model': ...} checkpoint is unwrapped. The port's keys are
    detectron2's, so names map one to one (the JAX package's
    `convert_reference_checkpoint` also transposes layouts). Returns the
    report {'loaded': n, 'missing': [...], 'unused': [...]}."""
    return _load_matching(_unwrap(state_dict), model, strict=strict)


def convert_imagenet_backbone(state_dict: dict, model: torch.nn.Module, backbone_name: str,
                              strict: bool = False) -> dict:
    """Load flat ImageNet backbone weights into the backbone's bottom-up
    network only (reference dla.py:494 `imagenet_pretrain` ->
    load_pretrained_model :300-309); the FPN and heads keep their weights.
    DLA only: the other backbones are not ported."""
    if backbone_name != _DLA:
        raise NotImplementedError(f"backbone {backbone_name} is not ported; DLA only")
    sd = {_BOTTOM_UP + k: v for k, v in _unwrap(state_dict).items() if not k.startswith("fc.")}
    return _load_matching(sd, model, prefix=_BOTTOM_UP, strict=strict)
