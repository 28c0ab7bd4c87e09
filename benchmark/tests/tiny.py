"""Tiny cells for the CPU tests: the committed cells' files with narrow
heads, few proposals and small frames, so a run takes seconds on the CPU."""
from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

NARROW = {
    "MODEL": {"FPN": {"OUT_CHANNELS": 16}, "ROI_HEADS": {"NUM_CLASSES": 5, "BATCH_SIZE_PER_IMAGE": 16},
              "ROI_BOX_HEAD": {"FC_DIM": 32}, "ROI_CUBE_HEAD": {"FC_DIM": 32},
              "RPN": {"PRE_NMS_TOPK_TEST": 100, "POST_NMS_TOPK_TEST": 40,
                      "PRE_NMS_TOPK_TRAIN": 100, "POST_NMS_TOPK_TRAIN": 40,
                      "BATCH_SIZE_PER_IMAGE": 32}},
    "TEST": {"DETECTIONS_PER_IMAGE": 10},
    "INPUT": {"MIN_SIZE_TEST": 96, "MIN_SIZE_TRAIN": [96]},
    "TPU": {"NMS_CANDIDATES": 64},
}


def _merge(dst: dict, src: dict):
    for k, v in src.items():
        if isinstance(v, dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def load(name: str) -> dict:
    with open(os.path.join(ROOT, name)) as f:
        return json.load(f)


def cell(name: str) -> tuple:
    """(BENCHMARK.json, workload spec, config) of a committed cell, cut to a
    CPU test's size."""
    bench = load("BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    spec = load(f"benchmark/workloads/{name}.json")
    config = copy.deepcopy(load(conf["file"]))
    _merge(config["cfg"], NARROW)
    batch = min(spec["batch"], 2)
    spec = dict(spec, source_hw=[96, 120], batch=batch,
                pool_frames=4 * batch, check_calls=2, trace_calls=2, warmup_calls=1,
                pool_batches=4, check_steps=2, trace_steps=1, episode_steps=4)
    return bench, spec, config
