"""Host ms per traced call in `omni3d.inference_step.prepare` (the graph
key, the address check, the lookup and the input copies, up to the
replay's launch), on the profiler's clock."""
from benchmark.program_spans import host_ms_per_call


def read(facts):
    return host_ms_per_call(facts, "inference_step.prepare")
