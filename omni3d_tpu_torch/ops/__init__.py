"""Ops: NMS and multilevel ROIAlign (plain PyTorch and the CUDA kernel)."""
