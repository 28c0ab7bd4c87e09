"""Run one cell of the benchmark once and print its result line.

Everything a cell needs is found by name: the cell's entry in the root
`BENCHMARK.json` names its configuration and its traffic kind; the cell's
parameters are `benchmark/workloads/<cell>.json`, the configuration's
sizes the configuration's `file`, the generator `benchmark/traffic/<kind>.py`,
each per-layer metric's reader `benchmark/metrics/<metric>.py` and the
reference's trunk `benchmark/reference/trunks/<MODEL.BACKBONE.NAME>.py`. A
new cell, configuration, trunk family, traffic mix or metric is new files
and entries.

A run: set-up (process start to the first timed call: imports, the CUDA
context, the weights drawn on the card, the pools, the warm-up calls that
build the kernels, choose cuDNN's algorithms and capture the graphs), the
window of `--seconds`, then the peak memory, with `--trace 1` a traced
sub-window and the per-layer readings, and last the comparison with the
plain reference, once the program's state is freed. The numbers compared
are printed beside their limits as the last lines of standard error and
under `checks`, the last key of the result line.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

import torch

from . import checks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "omni3d_tpu")


class Refused(Exception):
    """A run that may print no result."""


def process_start() -> float:
    """time.time() of this process's start, from /proc (the interpreter's
    own start-up included); the first call's time elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    """The cell's entry, its configuration's entry and its metrics:
    (workload, config, end-to-end entries, per-layer entries)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return cell, config, e2e, layer


def reader(metric: str):
    """The `read(facts)` function of benchmark/metrics/<metric>.py."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Context:
    """What a traffic generator gets: the cell's parameters and
    configuration, the run's arguments and the device."""
    name: str
    spec: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    substitute: str | None = None
    started: float = field(default_factory=process_start)

    def port_cfg(self):
        """The program's config: its defaults merged with the configuration
        file's `cfg`."""
        from omni3d_tpu_torch.config import CfgNode, get_default_cfg
        cfg = get_default_cfg()
        cfg.merge_from_other(CfgNode(self.config["cfg"]))
        return cfg

    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def card_name(self) -> str:
        return torch.cuda.get_device_name(self.device)

    def sync(self):
        if self.on_card():
            torch.cuda.synchronize(self.device)

    def elapsed(self) -> float:
        return time.time() - self.started

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.on_card() else 0

    def note(self, line: str):
        """A line for the run's log (standard error)."""
        print(f"[{self.name}] {line}", file=sys.stderr, flush=True)

    def reset_peak(self):
        if self.on_card():
            torch.cuda.reset_peak_memory_stats(self.device)

    def free_memory(self):
        gc.collect()
        if self.on_card():
            torch.cuda.empty_cache()

    def reference_precision(self):
        """float32 without TF32 for the reference's convolutions and products."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             bench: dict | None = None, spec: dict | None = None, config: dict | None = None,
             substitute: str | None = None) -> dict:
    """One run of cell `name` -> the result dict (before printing). The
    cell's files are read unless given."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json")) if bench is None else bench
    cell, conf, e2e, layer = find_cell(bench, name)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false: this benchmark measures the card")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{name} needs {cell['chips']} cards, "
                          f"{torch.cuda.device_count()} present")
    spec = load_json(os.path.join(HERE, "workloads", name + ".json")) if spec is None else spec
    config = load_json(os.path.join(ROOT, conf["file"])) if config is None else config
    ctx = Context(name, spec, config, seed, seconds, trace, device, substitute)
    generator = importlib.import_module(f"benchmark.traffic.{cell['traffic']}")
    res = generator.run(ctx)

    correct, rows = checks.judged(res["numbers"], spec["limits"], config["cfg"])
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"]}
    metrics = {}
    if trace:
        for m in layer:
            v = reader(m["name"])(res["facts"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": res["e2e"][m["name"]], "unit": m["unit"]}
    out["metrics"] = metrics
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": res["memory_peak_bytes"]}
    if trace:
        dev.update(busy_s=res["busy_s"], window_s=res["window_s"])
        out["breakdown"] = res["breakdown"]
    out["device"] = dev
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v in res["numbers"].items():   # every number, compared or not
        print(f"reading {k} {v!r}", file=sys.stderr)
    return out


def loaded_forbidden() -> list:
    """Modules in sys.modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(args) -> int:
    os.environ.setdefault("USE_FLAX", "0")
    # one process on one core with one intra-op thread: the host work in
    # series with the card then runs where it ran in every other run
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    torch.set_num_threads(1)
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                       substitute=args.substitute)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    bad = loaded_forbidden()
    if bad:
        print(f"refused: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
