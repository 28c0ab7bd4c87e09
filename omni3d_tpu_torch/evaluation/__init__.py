"""Omni3D evaluation: AP2D / AP3D (port of `omni3d_tpu.evaluation`)."""
