"""Device busy ms per call of `CubeRCNN.features` (trunk and FPN) alone,
eager, on one batch of the cell's frames, after the window."""
from benchmark.readings import fact


def read(facts):
    return fact(facts, "trunk_device_ms")
