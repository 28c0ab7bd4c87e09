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
    `omni3d_tpu.utils.checkpoint.flax_path_to_torch`: the DLA, ResNet,
    DenseNet, MNASNet, ShuffleNet, FPN, RPN, head and prior branches).
    Returns None for paths with no counterpart."""
    p = list(path)
    top = p[0]
    if top == "backbone":
        rest = p[1:]
        if any(n.startswith(("denseblock", "transition")) or n in ("conv0", "norm0", "norm5")
               for n in rest):
            return _densenet_torch_key(rest)
        if any(n.startswith(("stack", "stem0", "stem_dw", "stem_pw")) for n in rest):
            return _mnasnet_torch_key(rest)
        if any(re.fullmatch(r"stage\d+_\d+", n) or n.startswith(("b1_", "b2_"))
               for n in rest) or (len(rest) >= 2 and rest[0] == "conv1" and rest[1] in ("c", "n")):
            return _shufflenet_torch_key(rest)
        out = ["backbone", "bottom_up"]
        i = 0
        while i < len(rest):
            name = rest[i]
            if name in ("base_layer", "level0", "level1"):
                # Sequential [conv, bn, relu]
                out.append(f"{name}.0" if rest[i + 1] == "c" else f"{name}.1")
                i += 3
            elif name == "stem":  # ResNet stem: conv1 + bn1
                out.append("conv1" if rest[i + 1] == "c" else "bn1")
                i += 3
            elif re.fullmatch(r"layer\d+_\d+", name):  # ResNet blocks
                stage, blk = name[5:].split("_")
                out.append(f"layer{stage}.{blk}")
                i += 1
            elif re.fullmatch(r"conv\d", name):
                out.append(name if rest[i + 1] == "c" else "bn" + name[-1])
                i += 3
            elif name in ("downsample", "project"):  # ResNet / DLA Sequential [conv, bn]
                out.append(f"{name}.0" if rest[i + 1] == "c" else f"{name}.1")
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


def _densenet_torch_key(rest):
    """DenseNet-121: the reference wraps torchvision `features` as `base`
    (reference densenet.py:16-19), so keys look like
    backbone.bottom_up.base.denseblock1.denselayer1.conv1.weight."""
    out = ["backbone", "bottom_up", "base"]
    for i, n in enumerate(rest):
        if n in ("conv", "bn") and i == len(rest) - 1:
            continue  # flax leaf-module wrapper (layers.Conv 'conv' / BN 'bn')
        out.append(n)
    return ".".join(out)


# MNASNet-1.0: flax module -> (conv index, BN index) in torchvision's flat
# `layers` Sequential (stems) or in an inverted residual's `layers`
_MNASNET_STEM = {"stem0": ("0", "1"), "stem_dw": ("3", "4"), "stem_pw": ("6", "7")}
_MNASNET_SUB = {"expand": ("0", "1"), "dw": ("3", "4"), "project": ("6", "7")}


def _mnasnet_torch_key(rest):
    """MNASNet-1.0: the reference keeps torchvision `model.layers` as `base`
    (reference mnasnet.py:16-19); stems are flat Sequential indices and each
    inverted residual is `<stack>.<block>.layers.<idx>`."""
    pick = 0 if ("c" in rest or rest[-1] == "conv") else 1
    if rest[0] in _MNASNET_STEM:
        return f"backbone.bottom_up.base.{_MNASNET_STEM[rest[0]][pick]}"
    m = re.fullmatch(r"stack(\d)_(\d+)", rest[0])
    if m:
        return (f"backbone.bottom_up.base.{7 + int(m.group(1))}.{m.group(2)}.layers."
                f"{_MNASNET_SUB[rest[1]][pick]}")
    return None


# ShuffleNetV2 unit: flax module -> (conv key, BN key) in torchvision's
# branch Sequentials
_SHUFFLENET_SUB = {
    "b1_dw": ("branch1.0", "branch1.1"),
    "b1_pw": ("branch1.2", "branch1.3"),
    "b2_pw1": ("branch2.0", "branch2.1"),
    "b2_dw": ("branch2.3", "branch2.4"),
    "b2_pw2": ("branch2.5", "branch2.6"),
}


def _shufflenet_torch_key(rest):
    """ShuffleNetV2-x1.0: torchvision attribute names (reference
    shufflenet.py:16-22): the conv1 Sequential and stage{2,3,4} of units
    with branch1 / branch2 Sequentials."""
    pick = 0 if "c" in rest else 1
    if rest[0] == "conv1":
        return f"backbone.bottom_up.conv1.{pick}"
    m = re.fullmatch(r"(stage\d+)_(\d+)", rest[0])
    if not m:
        return None
    return f"backbone.bottom_up.{m.group(1)}.{m.group(2)}.{_SHUFFLENET_SUB[rest[1]][pick]}"


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

# ImageNet (backbone-only) namespaces: the model's prefix of each family's
# trunk and the prefix the published ImageNet weights use for it (reference
# dla.py:300-309 flat DLA names; torchvision `models.*(pretrained=True)`
# namespaces for the others: resnet.py:66-96, densenet.py, mnasnet.py,
# shufflenet.py).
IMAGENET_PREFIXES = {
    "build_dla_from_vision_fpn_backbone": ("backbone.bottom_up.", ""),
    "build_resnet_from_vision_fpn_backbone": ("backbone.bottom_up.", ""),
    "build_densenet_fpn_backbone": ("backbone.bottom_up.base.", "features."),
    "build_mnasnet_fpn_backbone": ("backbone.bottom_up.base.", "layers."),
    "build_shufflenet_fpn_backbone": ("backbone.bottom_up.", ""),
}

# ImageNet classifier heads the detector drops (reference dla.py:306-308
# deletes fc.*; the torchvision families never run theirs: ShuffleNet's
# conv5 / fc and MNASNet's 1280-wide top convs layers.14 / 15, reference
# mnasnet.py:24-38 stopping at layers[0:14]).
_IMAGENET_HEAD_PREFIXES = ("fc.", "classifier.", "conv5.", "layers.14.", "layers.15.")
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
    """Load ImageNet backbone weights of any `IMAGENET_PREFIXES` family into
    the backbone's bottom-up network only, with the JAX package's prefix
    mapping and dropped classifier heads (reference dla.py:494
    `imagenet_pretrain` -> load_pretrained_model :300-309, torchvision
    `pretrained=True` in resnet.py:66-96 and the densenet / mnasnet /
    shufflenet builders); the FPN and heads keep their weights. Keys of the
    family's namespace that name no weight of the trunk are reported as
    unused."""
    model_prefix, imagenet_prefix = IMAGENET_PREFIXES[backbone_name]
    sd = {model_prefix + k[len(imagenet_prefix):]: v for k, v in _unwrap(state_dict).items()
          if not k.startswith(_IMAGENET_HEAD_PREFIXES) and k.startswith(imagenet_prefix)}
    return _load_matching(sd, model, prefix=_BOTTOM_UP, strict=strict)
