"""PyTorch/CUDA port of `omni3d_tpu` (Cube R-CNN inference on NVIDIA Hopper).

Mirrors `omni3d_tpu`'s module paths. Imports torch, never jax or flax.
"""
