"""Graph captures of `rcnn3d.inference_step` during the window (its
`captures` counter's difference); 0 when set-up captured every shape."""
from benchmark.readings import fact


def read(facts):
    return fact(facts, "captures_in_window")
