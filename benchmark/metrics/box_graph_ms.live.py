"""Device ms per traced replay of the stage `inference.box` (the box
pooler, the box head and predictor, `fast_rcnn_inference` with the
per-class NMS): the busy time between its marker kernels in the replay's
kernel records."""
from benchmark.program_spans import device_ms_per_call


def read(facts):
    return device_ms_per_call(facts, "inference.box")
