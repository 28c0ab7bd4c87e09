"""Host-clock ms from entering `rcnn3d.inference_step` to its return (no
synchronise inside: the key, the address check, the copies into the
graph's inputs, the replay's launch and the output clones), mean over the
window's calls."""
from benchmark.readings import fact


def read(facts):
    return fact(facts, "host_ms_per_call")
