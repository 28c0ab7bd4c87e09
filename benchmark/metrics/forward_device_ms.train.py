"""Device ms per traced training step of the stage `step.forward`
(`compute_losses`: every loss of the batch): the busy time between its
marker kernels in the step's kernel records."""
from benchmark.program_spans import device_ms_per_call


def read(facts):
    return device_ms_per_call(facts, "step.forward")
