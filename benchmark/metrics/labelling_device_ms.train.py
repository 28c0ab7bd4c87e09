"""Device ms per traced training step of the stages
`step.anchor_labelling` (the sampling noise, the anchors' labels and
sample, the RPN losses) and `step.roi_sampling` (the proposals' labels
and sample), summed: the busy time between each one's marker kernels in
the step's kernel records."""
from benchmark.program_spans import device_ms_per_call


def read(facts):
    return device_ms_per_call(facts, "step.anchor_labelling", "step.roi_sampling")
