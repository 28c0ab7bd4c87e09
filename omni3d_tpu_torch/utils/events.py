"""Metrics logging: terminal + metrics.json lines + TensorBoard events.

Port of `omni3d_tpu.utils.events` (which replaces the reference's detectron2
writers, tools/train_net.py:130,174: CommonMetricPrinter + JSONWriter +
TensorboardXWriter) without `put_image`, which waits for the training
visualisation. The TensorBoard writer is optional: it activates when the
`tensorboard` package imports, and degrades silently to terminal + json
otherwise.
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque


def _make_tb_writer(output_dir: str):
    """SummaryWriter into <output_dir>/tb, or None if tensorboard is absent."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(os.path.join(output_dir, "tb"))


WINDOW = 20   # iterations the log line's medians cover


class EventStorage:
    def __init__(self, output_dir: str | None = None, start_iter: int = 0):
        self.iter = start_iter
        self._history = defaultdict(lambda: deque(maxlen=WINDOW))
        self._latest = {}
        self._written = set()
        self._file = None
        self._tb = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._file = open(os.path.join(output_dir, "metrics.json"), "a")
            self._tb = _make_tb_writer(output_dir)
        self._t0 = time.time()

    def put_scalar(self, name: str, value):
        value = float(value)
        self._history[name].append(value)
        self._latest[name] = value
        self._written.discard(name)

    def median(self, name):
        h = sorted(self._history[name])
        return h[len(h) // 2] if h else float("nan")

    def write(self):
        if self._file:
            rec = {"iteration": self.iter, **self._latest}
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self._tb is not None:
            for k, v in self._latest.items():
                if k not in self._written:
                    self._tb.add_scalar(k, v, self.iter)
                    self._written.add(k)

    def log_line(self, max_iter: int, lr=None) -> str:
        eta = ""
        if self.iter > 0:
            per_iter = (time.time() - self._t0) / max(self.iter, 1)
            rem = per_iter * (max_iter - self.iter)
            eta = f"eta: {rem / 3600:.2f}h  "
        parts = [f"iter: {self.iter}/{max_iter}", eta.strip()]
        for k in sorted(self._latest):
            if k.startswith(("rpn/", "BoxHead/", "Cube/", "total")):
                parts.append(f"{k}: {self.median(k):.4f}")
        if lr is not None:
            parts.append(f"lr: {lr:.6f}")
        return "  ".join(p for p in parts if p)

    def step(self):
        self.iter += 1

    def close(self):
        if self._file:
            self._file.close()
        if self._tb is not None:
            self._tb.close()
