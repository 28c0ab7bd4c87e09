"""Device ms per traced replay of the stage `inference.cube` (the cube
pooler, the cube head, `decode_outputs`): the busy time between its
marker kernels in the replay's kernel records."""
from benchmark.program_spans import device_ms_per_call


def read(facts):
    return device_ms_per_call(facts, "inference.cube")
