"""The reader of `bn_device_ms.train`: the busy time of the BatchNorm
kernels' records per traced step, overlaps counted once, other kernels
left out; None off the card and where no such kernel ran."""
from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.trace import Trace

CARD = {"bfloat16": 1.0}


def _trace(kernels, calls=2) -> Trace:
    return Trace(calls, kernels, [("bench.step", 0.0, 10_000.0, True)])


def test_bn_device_ms_reads_the_kernels_busy_time_per_step():
    read = harness.reader("bn_device_ms.train")
    kernels = [("void omni3d_bn_reduce<__nv_bfloat16, 8, false>(...)", 0.0, 100.0),
               ("void omni3d_bn_merge_fwd<__nv_bfloat16>(...)", 100.0, 110.0),
               ("void omni3d_bn_apply<__nv_bfloat16, 8, false>(...)", 105.0, 205.0),  # overlaps
               ("sm90_xmma_fprop_implicit_gemm_bf16bf16", 205.0, 900.0),
               ("_Z15omni3d_bn_merge_bwdPKfixiS0_PfS1_S1_", 1000.0, 1090.0)]
    assert read({"trace": _trace(kernels), "peak": CARD}) == pytest.approx(0.295 / 2)
    assert read({"trace": _trace(kernels), "peak": None}) is None
    assert read({"trace": _trace(kernels[3:4]), "peak": CARD}) is None
    assert read({"trace": _trace(kernels, calls=0), "peak": CARD}) is None
