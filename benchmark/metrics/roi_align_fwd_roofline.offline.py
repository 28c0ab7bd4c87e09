"""The ROIAlign forward kernel's share of its roofline per inference call,
in %: the bound of both poolings (bf16 pyramid cells touched, read once;
pooled values written once; float32 operations of the frozen `pool_work`,
on the reference's own proposals and detections of the checked batches)
over the kernel's device ms per call from the traced sub-window."""
from benchmark.readings import roofline


def read(facts):
    return roofline(facts, "roi_align_fwd")
