"""What the per-layer readers share: each reader in `metrics/` is one of
these applied to the run's facts, returning None where the run has
nothing to read (a CPU run has no device trace and no peak)."""
from __future__ import annotations


def idle_share(facts: dict):
    """% of the traced sub-window in which no kernel ran on the device."""
    tr = facts.get("trace")
    if tr is None or facts.get("peak") is None or tr.window_us <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)


def mfu(facts: dict):
    """% of the card's bf16 dense peak: the model's convolution and linear
    FLOPs per image times the window's images per second."""
    peak = facts.get("peak")
    if peak is None or "flops_per_image" not in facts:
        return None
    return 100.0 * facts["flops_per_image"] * facts["rate_img_per_s"] / peak["bfloat16"]


def roofline(facts: dict, kernel: str):
    """% of its roofline: the kernel's bound over its device ms, per call."""
    k = facts.get(kernel)
    if not k or not k.get("kernel_ms"):
        return None
    return 100.0 * k["bound_ms"] / k["kernel_ms"]


def fact(facts: dict, key: str):
    """A fact the generator measured itself, when the run is on the card."""
    return facts.get(key) if facts.get("peak") is not None else None
