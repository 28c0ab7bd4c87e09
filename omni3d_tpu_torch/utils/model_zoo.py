"""Model zoo paths and ImageNet weights (port of `omni3d_tpu.utils.model_zoo`,
after the reference cubercnn/util/model_zoo.py:7-24).

`cubercnn://x/y.pth` names https://dl.fbaipublicfiles.com/cubercnn/x/y.pth.
The port downloads nothing: such a path resolves to its copy in the cache
directory the JAX package uses (~/.cache/omni3d_tpu), and is an error,
naming the URL, when no copy is there.
"""
from __future__ import annotations

import os

PREFIX = "cubercnn://"
BASE_URL = "https://dl.fbaipublicfiles.com/cubercnn/"
CACHE_DIR = os.path.expanduser("~/.cache/omni3d_tpu")


def resolve(path: str) -> str:
    if not path.startswith(PREFIX):
        return path
    rel = path[len(PREFIX):]
    local = os.path.join(CACHE_DIR, rel)
    if not os.path.exists(local):
        raise FileNotFoundError(f"{path}: no local copy at {local}; fetch {BASE_URL + rel} "
                                "there (this program downloads nothing)")
    return local


# file stems of the ImageNet weights each backbone family initializes from
# (reference dla.py:30-31 URL scheme `{name}-{hash}.pth`; torchvision's
# download names for the others)
_IMAGENET_STEMS = {
    "build_dla_from_vision_fpn_backbone": lambda cfg: [
        cfg.MODEL.DLA.TYPE + ("+tricks" if cfg.MODEL.DLA.TRICKS else ""),
        cfg.MODEL.DLA.TYPE,
    ],
    "build_resnet_from_vision_fpn_backbone": lambda cfg: [f"resnet{cfg.MODEL.RESNETS.DEPTH}"],
    "build_densenet_fpn_backbone": lambda cfg: ["densenet121"],
    "build_mnasnet_fpn_backbone": lambda cfg: ["mnasnet1.0", "mnasnet1_0"],
    "build_shufflenet_fpn_backbone": lambda cfg: ["shufflenetv2_x1.0", "shufflenetv2_x1"],
}


def find_imagenet_weights(cfg) -> str | None:
    """Locate a local ImageNet .pth for cfg's backbone (stand-in for the
    reference's model_zoo.load_url, dla.py:300-309): searches
    TPU.IMAGENET_WEIGHTS_DIR then ~/.cache/omni3d_tpu/imagenet for a file
    whose name starts with the family's stem."""
    stems = _IMAGENET_STEMS.get(cfg.MODEL.BACKBONE.NAME, lambda c: [])(cfg)
    dirs = [getattr(cfg.TPU, "IMAGENET_WEIGHTS_DIR", ""),
            os.path.join(CACHE_DIR, "imagenet")]
    for d in dirs:
        if not d or not os.path.isdir(d):
            continue
        files = sorted(os.listdir(d))
        for stem in stems:
            for f in files:
                if f.startswith(stem) and f.endswith((".pth", ".pkl")):
                    return os.path.join(d, f)
    return None


def load_reference_weights(path: str):
    """Load a reference .pth/.pkl checkpoint into a state dict (tensors or
    numpy arrays). A .pkl (detectron2's pickled numpy format) is unpickled:
    load only files from a source you trust."""
    path = resolve(path)
    if path.endswith(".pkl"):
        import pickle

        with open(path, "rb") as f:
            return pickle.load(f, encoding="latin1")
    import torch

    return torch.load(path, map_location="cpu", weights_only=False)
