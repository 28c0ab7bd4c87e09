"""The ROIAlign backward kernel's share of its roofline per training step,
in %: the bound from shapes alone (the bf16 pooled gradient read once, the
bf16 pyramid gradient written once) over the kernel's device ms per step
from the traced sub-window."""
from benchmark.readings import roofline


def read(facts):
    return roofline(facts, "roi_align_bwd")
