"""The harness finds everything of a cell by name, and BENCHMARK.json keeps
to the contract's names, units and keys."""
from __future__ import annotations

import importlib
import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_are_the_contracts():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])


def test_names_and_units():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]] + [
            k for c in b["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_every_cell_finds_its_files():
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    for w in b["workloads"]:
        cell, conf, ends, layer = harness.find_cell(b, w["name"])
        assert os.path.isfile(os.path.join(ROOT, conf["file"]))
        assert os.path.isfile(os.path.join(harness.HERE, "workloads", w["name"] + ".json"))
        assert hasattr(importlib.import_module(f"benchmark.traffic.{w['traffic']}"), "run")
        names = {m["name"] for m in ends}
        assert "setup_s" in names and len(names) >= 2 and layer
        for m in layer:
            assert m["moves"] in names and m["moves"] in e2e
            assert callable(harness.reader(m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(harness.Refused):
        harness.find_cell(bench(), "no.such_cell")


def test_a_cuda_run_without_a_card_is_refused(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(harness.Refused):
        harness.run_cell(bench()["workloads"][0]["name"], 1, 1.0, False, device="cuda")


def test_paths_hold_the_files():
    b = bench()
    assert b["paths"] == ["benchmark"]
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/")
    assert b["command"][1].startswith("benchmark/")
