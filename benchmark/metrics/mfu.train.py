"""Model FLOPs utilisation of the whole train step, in % of the bf16
dense peak: the model's convolution and linear FLOPs per image (counted
after the window by the frozen counter, forward and backward) times the
images per second of the unprofiled window."""
from benchmark.readings import mfu as read  # noqa: F401
