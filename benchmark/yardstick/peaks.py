"""Datasheet peaks, frozen from omni3d_tpu_torch/utils/benchtime.py `PEAKS`
(commit 5a24e3a): NVIDIA H100 SXM5, dense rates without sparsity, at the
700 W limit, keyed by torch.cuda.get_device_name(). A card with no entry
has no peak: nothing is guessed."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.4e12, "tf32": 494.7e12,
                              "float32": 66.9e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(name: str) -> dict | None:
    """The card's peaks, or None for a card with no entry."""
    return PEAKS.get(name)
