"""The benchmark of the PyTorch port (`omni3d_tpu_torch`) on NVIDIA cards:
cells of a published configuration under one traffic mix, run one at a time
by `run.py`, each judged against the plain reference in `reference/`."""
