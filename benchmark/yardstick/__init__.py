"""The benchmark's yardstick: frozen copies of the arithmetic that turns
counts, shapes and traces into metrics (FLOPs, pooling work and its bound,
device busy time, datasheet peaks) and of the synthetic ground-truth draw.
Each module names the source it was copied from; later changes to the
program do not move them."""
