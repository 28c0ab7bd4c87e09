"""Device ms per traced training step of the stage `trunk.dense_concat`
(DenseNet's train-mode concatenation of each dense layer's output onto its
block's tensor, 58 a forward): the busy time between its marker kernels,
summed over every interval of the step. None where the program has no
such stage."""
from benchmark.stage_totals import stage_total_ms


def read(facts):
    return stage_total_ms(facts, "trunk.dense_concat")
