"""No module of the benchmark imports JAX or the JAX package (by whole
top-level name), and the reference imports nothing of the program."""
from __future__ import annotations

import ast
import os

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "omni3d_tpu"}


def imported(path: str) -> set:
    """Top-level names of every module a file imports (relative imports
    left out)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def files(sub: str = ""):
    top = os.path.join(harness.HERE, sub)
    for d, _, fs in os.walk(top):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in files():
        assert not imported(path) & FORBIDDEN, path


def test_the_reference_is_plain():
    for path in files("reference"):
        assert not imported(path) & (FORBIDDEN | {"omni3d_tpu_torch", "benchmark"}), path


def test_the_check_names_whole_top_level_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "omni3d_tpu_torch_not_it", sys)
    assert "omni3d_tpu" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "omni3d_tpu.models", sys)
    assert "omni3d_tpu" in harness.loaded_forbidden()
