"""Device ms per traced training step spanned by the stage
`step.rank_means` (the step's own all-reduces under a process group: the
logs' mean before the stabilizer and the BN running statistics' mean
after an accepted step): from each start marker to its end marker, summed
over the step's intervals, so the idle time in which the stream waits for
the host, held up by the slowest rank, counts as well as the kernels.
None where the program has no such stage."""
from benchmark.stage_totals import stage_span_ms


def read(facts):
    return stage_span_ms(facts, "step.rank_means")
