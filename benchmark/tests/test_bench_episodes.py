"""The training window repeats one fixed episode of steps from the set-up's
state: every episode's losses and accept flags equal the first's bit for
bit, each restore puts back exactly what the snapshot held, and a run
attempts a whole number of episodes. For the program and for the control
put in its place."""
from __future__ import annotations

import copy
import types

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny
from benchmark.traffic import train

NAME = "dla34.train_b32"


def _state(side) -> dict:
    """What a step carries to the next, copied: the model's state dict, the
    momentum, the schedule's state, the groups' LRs and the side's counters."""
    counters = {k: side.counters[k] for k in side.COUNTERS}
    return {"model": {k: v.clone() for k, v in side.model.state_dict().items()},
            "momentum": side.momentum(),
            "schedule": copy.deepcopy(side.scheduler.state_dict()),
            "lrs": [g["lr"] for g in side.optimizer.param_groups],
            "counters": {k: v.clone() if torch.is_tensor(v) else v for k, v in counters.items()}}


def _assert_equal(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}[{i}]")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


class _Clock:
    """perf_counter for the generator: one second more at each reading, so
    each episode (two readings) lasts a second and a window of `--seconds`
    n ends after exactly n episodes."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 1.0
        return self.now


@pytest.mark.parametrize("substitute", [None, "control"])
def test_episodes_repeat_from_the_snapshot(monkeypatch, substitute):
    bench, spec, config = tiny.cell(NAME)
    events, saved = [], {}
    side_call = (train.Reference if substitute else train.Program).__call__
    init, restore = train.Snapshot.__init__, train.Snapshot.restore

    def call(self, batch, generator):
        accepted = side_call(self, batch, generator)
        events.append((float(self.last_loss), bool(accepted)))
        return accepted

    def snapshot(self, side):
        init(self, side)
        saved["state"] = _state(side)
        events.append("snapshot")

    def restored(self, side, sync):
        seconds = restore(self, side, sync)
        _assert_equal(_state(side), saved["state"], "restored")
        events.append("restore")
        return seconds

    monkeypatch.setattr(train.Reference if substitute else train.Program, "__call__", call)
    monkeypatch.setattr(train.Snapshot, "__init__", snapshot)
    monkeypatch.setattr(train.Snapshot, "restore", restored)
    monkeypatch.setattr(train, "time", types.SimpleNamespace(perf_counter=_Clock().perf_counter))
    out = harness.run_cell(NAME, 2 ** 31 + 41, 3.0, False, device="cpu", bench=bench, spec=spec,
                           config=config, substitute=substitute)

    E = spec["episode_steps"]
    assert out["attempted"] == 3 * E and out["attempted"] % E == 0
    window = events[events.index("snapshot") + 1:]
    # the reference's own check steps follow the window when the control ran
    window = window[:3 * E + 2]
    assert window.count("restore") == 2
    episodes, current = [], []
    for e in window + ["restore"]:
        if e == "restore":
            episodes.append(current)
            current = []
        else:
            current.append(e)
    assert [len(ep) for ep in episodes] == [E, E, E]
    for ep in episodes[1:]:
        assert ep == episodes[0]     # losses and accept flags, bit for bit
