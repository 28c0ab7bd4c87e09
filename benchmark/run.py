"""One run of one cell of the benchmark of the PyTorch port on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout (`python3 -m benchmark.run ...` is the
same). It prints one JSON line last on standard output (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, and `checks` last) and the compared numbers with their limits
last on standard error. It exits non-zero, printing no result, without a
CUDA card (or with fewer than the cell asks for), or when JAX or the JAX
package was loaded. `--substitute control` puts the lower-precision
reference in the program's place, `--substitute <fault>` plants one of the
faults its traffic generator lists in FAULTS (the checks of the
comparison; never in the benchmark's own runs).
"""
from __future__ import annotations

import argparse
import os
import sys

if __package__ in (None, ""):   # run as a file: make the checkout importable
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--substitute", default=None)
    return ap.parse_args(argv)


if __name__ == "__main__":
    from benchmark import harness
    sys.exit(harness.main(parse()))
