"""Model FLOPs, frozen from omni3d_tpu_torch/utils/benchtime.py
`model_flops` (commit 5a24e3a): the FLOPs of the model's convolutions and
linear layers in one call, by torch.utils.flop_counter's formulas. Forward
ops count when they run inside a submodule of the model; backward ops when
the autograd node running them is a convolution's or a linear product's.
Products outside the model's modules (the NMS fixpoint, the losses'
rotations) and the hand-written kernels (launched through ctypes) are not
counted."""
from __future__ import annotations

from dataclasses import dataclass

import torch

_LAYER_BACKWARD_NODES = frozenset({"ConvolutionBackward0", "AddmmBackward0", "MmBackward0"})


@dataclass
class FlopCount:
    forward: int
    backward: int

    @property
    def model(self) -> int:
        return self.forward + self.backward


def model_flops(model: torch.nn.Module, fn):
    """(FlopCount, fn's result) of one call of `fn()`."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    count = FlopCount(0, 0)
    inside = [0]

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                n = formula(*args, **kwargs, out_val=out)
                node = torch._C._current_autograd_node()
                if node is None:
                    if inside[0]:
                        count.forward += n
                elif node.name() in _LAYER_BACKWARD_NODES:
                    count.backward += n
            return out

    def enter(*_):
        inside[0] += 1

    def leave(*_):
        inside[0] -= 1

    hooks = []
    for m in model.modules():
        if m is not model:
            hooks.append(m.register_forward_pre_hook(enter))
            hooks.append(m.register_forward_hook(leave))
    try:
        with Counter():
            result = fn()
    finally:
        for h in hooks:
            h.remove()
    return count, result
