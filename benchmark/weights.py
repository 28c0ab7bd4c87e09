"""Seeded random weights, made on the device in one draw.

The scheme is the program's `init_random_` (normal weights of variance
1/fan_in, zero biases, identity BN, unit priors, the cube head's output
layers at std 0.001 and its uncertainty bias at 5), with the cube head's 6D
pose bias at the identity rotation (`condition_pose_bias_`: with random
weights, all-zero head features otherwise give a 6D pose of 0 / 1e-12 and
gradients that blow up the first steps). Every weight matrix and kernel
comes from one normal draw of a generator on `device`, split in the order
of the sorted names, so the same seed and names give the same state dict
to the program and to the reference.

For inference a cell may ask `calibrated_state` to scale every BN layer,
as a trained model's running statistics do: with identity statistics a
random ResNet-34's activations grow block after block (|x| up to ~90 at
p2-p3) and its logits with them, and any bf16 computation of it, the
program's and a bf16 run of the reference alike, then departs from the
float32 reference by as much as the fp8 control does. DLA-34's stay below
~3 with identity statistics, so its cells keep them.
"""
from __future__ import annotations

import math

import torch

_CUBE_OUT = ("bbox_3D_center_deltas", "bbox_3D_dims", "bbox_3D_pose",
             "bbox_3D_center_depth", "bbox_3D_uncertainty")
_POSE_BIAS = "roi_heads.cube_head.bbox_3D_pose.bias"


def init_state(shapes: dict, seed: int, device) -> dict:
    """{name: float32 tensor on `device`} for {name: shape}."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    names = sorted(shapes)
    drawn = [n for n in names if n.endswith("weight") and len(shapes[n]) >= 2]
    sizes = [math.prod(shapes[n]) for n in drawn]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    state = {}
    for n, part in zip(drawn, torch.split(normal, sizes)):
        fan_in = math.prod(shapes[n][1:])
        std = 0.001 if any(k in n for k in _CUBE_OUT) else fan_in ** -0.5
        state[n] = (part * std).reshape(shapes[n])
    for n in names:
        if n in state:
            continue
        if n.endswith(("running_var", ".weight")) or n.startswith("roi_heads.priors"):
            fill = 1.0
        elif "bbox_3D_uncertainty" in n:
            fill = 5.0
        else:
            fill = 0.0
        state[n] = torch.full(tuple(shapes[n]), fill, device=device)
    if _POSE_BIAS in state:
        b = state[_POSE_BIAS]
        b.copy_(torch.tensor([1.0, 0, 0, 0, 1, 0], device=device).repeat(b.numel() // 6))
    return state


def shapes_of(module: torch.nn.Module) -> dict:
    """{name: shape} of a module's state dict (tracking counters left out)."""
    return {k: tuple(v.shape) for k, v in module.state_dict().items()
            if v.is_floating_point()}


@torch.no_grad()
def calibrate_bn(model: torch.nn.Module, images: torch.Tensor, rms: float) -> None:
    """Scale each BatchNorm2d so that its output has root mean square `rms`
    over `images` (a per-layer scale, the same for every channel, with
    zero running means: no channel is amplified alone), in one eval-mode
    forward of the trunk; each layer is set before it runs, so every later
    layer sees scaled inputs."""
    from .reference.layers import BatchNorm2d

    def pre(m, args):
        x = args[0].float()
        m.running_mean.zero_()
        m.running_var.fill_(float((x * x).mean()) / rms ** 2)

    hooks = [m.register_forward_pre_hook(pre) for m in model.modules()
             if isinstance(m, BatchNorm2d)]
    try:
        model.features(images)
    finally:
        for h in hooks:
            h.remove()


def calibrated_state(config: dict, seed: int, images, rms: float, device) -> dict:
    """`init_state` of the reference model, with its BN layers scaled by
    `calibrate_bn` on `images` (normalized frames) unless `images` is None;
    on the CPU."""
    from .reference import model as ref
    model = ref.build(config["cfg"], device)
    model.load_state_dict(init_state(shapes_of(model), seed, device))
    if images is not None:
        calibrate_bn(model, images, rms)
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}
