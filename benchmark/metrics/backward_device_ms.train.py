"""Device ms per traced training step of the stage `step.backward` (the
losses' backward): the busy time between its marker kernels in the
step's kernel records."""
from benchmark.program_spans import device_ms_per_call


def read(facts):
    return device_ms_per_call(facts, "step.backward")
