"""Device ms per traced replay of the stage `inference.proposals` (the
RPN head, the anchors, `select_proposals` with its NMS): the busy time
between its marker kernels in the replay's kernel records."""
from benchmark.program_spans import device_ms_per_call


def read(facts):
    return device_ms_per_call(facts, "inference.proposals")
