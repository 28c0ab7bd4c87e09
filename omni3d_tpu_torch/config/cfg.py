"""Minimal yacs-compatible config system.

Same `CfgNode` / `StaticCfg` surface as `omni3d_tpu.config.cfg`: attribute
access, YAML files with `_BASE_` inheritance, `merge_from_list` for CLI
`KEY VALUE` overrides, and freezing. YAML is read by `read_yaml`, a small
reader of the subset the repo's `configs/*.yaml` use, so the port does not
depend on PyYAML.
"""
from __future__ import annotations

import ast
import copy
import json
import os
import re
from typing import Any

_BASE_KEY = "_BASE_"


class CfgNode(dict):
    """A dict with attribute access, freezing, and yacs-style merging."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict=None):
        init_dict = init_dict or {}
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config key not found: {name}")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        self[name] = CfgNode(value) if isinstance(value, dict) and not isinstance(value, CfgNode) else value

    def __setitem__(self, key, value):
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set {key}")
        super().__setitem__(key, value)

    def freeze(self):
        object.__setattr__(self, CfgNode.IMMUTABLE, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self):
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        new = CfgNode()
        for k, v in self.items():
            dict.__setitem__(new, k, copy.deepcopy(v, memo))
        object.__setattr__(new, CfgNode.IMMUTABLE, False)
        return new

    def merge_from_other(self, other: "CfgNode", allow_new: bool = True):
        for k, v in other.items():
            if isinstance(v, (dict, CfgNode)) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_other(CfgNode(v) if not isinstance(v, CfgNode) else v, allow_new)
            else:
                if not allow_new and k not in self:
                    raise KeyError(f"Non-existent config key: {k}")
                self[k] = CfgNode(v) if isinstance(v, dict) else _coerce(v, self.get(k))

    def merge_from_file(self, filename: str, allow_new: bool = True):
        """Load a YAML file, resolving `_BASE_` chains relative to the file."""
        merged = _load_yaml_with_base(filename)
        self.merge_from_other(CfgNode(merged), allow_new)

    def merge_from_list(self, opts: list, allow_new: bool = False):
        """CLI `KEY VALUE ...` overrides (yacs merge_from_list semantics)."""
        if len(opts) % 2:
            raise ValueError(f"Override list has odd length: {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    if not allow_new:
                        raise KeyError(f"Non-existent config key: {key}")
                    node[p] = CfgNode()
                node = node[p]
            leaf = parts[-1]
            if leaf not in node and not allow_new:
                raise KeyError(f"Non-existent config key: {key}")
            node[leaf] = _coerce(_parse_value(value), node.get(leaf))


class StaticCfg:
    """Hashable, immutable attribute view of a CfgNode."""

    __slots__ = ("_node", "_key")

    def __init__(self, node):
        object.__setattr__(self, "_node", node)
        object.__setattr__(self, "_key", _freeze_key(node))

    def __getattr__(self, name):
        try:
            v = object.__getattribute__(self, "_node")[name]
        except KeyError:
            raise AttributeError(f"Config key not found: {name}") from None
        return StaticCfg(v) if isinstance(v, dict) else v

    def __getitem__(self, name):
        return self.__getattr__(name)

    def __contains__(self, name):
        return name in object.__getattribute__(self, "_node")

    def __setattr__(self, name, value):
        raise AttributeError("StaticCfg is immutable")

    def __hash__(self):
        return hash(object.__getattribute__(self, "_key"))

    def __eq__(self, other):
        return isinstance(other, StaticCfg) and object.__getattribute__(
            self, "_key"
        ) == object.__getattribute__(other, "_key")

    def node(self) -> "CfgNode":
        return object.__getattribute__(self, "_node")


def _freeze_key(node):
    if isinstance(node, dict):
        return tuple((k, _freeze_key(v)) for k, v in sorted(node.items()))
    if isinstance(node, (list, tuple)):
        return tuple(_freeze_key(v) for v in node)
    return node


def _parse_value(value):
    """Parse a CLI string into a python literal when possible."""
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce(new, old):
    """Coerce `new` toward the type of the existing value (yacs behavior):
    tuple<->list interchange, int->float promotion, str literal parsing."""
    if old is None:
        return new
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, (tuple, list)) and isinstance(new, str):
        parsed = _parse_value(new)
        if isinstance(parsed, (tuple, list)):
            return type(old)(parsed)
    return new


def _load_yaml_with_base(filename: str) -> dict:
    with open(filename) as f:
        data = read_yaml(f.read())
    base = data.pop(_BASE_KEY, None)
    if base:
        if not os.path.isabs(base):
            base = os.path.join(os.path.dirname(filename), base)
        merged = _load_yaml_with_base(base)
        _deep_update(merged, data)
        return merged
    return data


def _deep_update(dst: dict, src: dict):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v


# ------------------------------ YAML subset reader ------------------------------
# Resolves plain scalars as PyYAML's safe loader does (YAML 1.1): a float needs
# a '.', so "1e5" stays a string there and here.
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)(?:[eE][-+][0-9]+)?$")


def _plain_scalar(s: str):
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if s.lower() in (".inf", "+.inf"):
        return float("inf")
    if s.lower() == "-.inf":
        return float("-inf")
    if s.lower() == ".nan":
        return float("nan")
    return s


def _quoted(s: str, i: int):
    """Parse the quoted scalar starting at s[i]; returns (value, next index)."""
    q = s[i]
    j = i + 1
    while j < len(s):
        if q == "'" and s[j] == "'":
            if s[j + 1:j + 2] == "'":   # '' is an escaped quote
                j += 2
                continue
            return s[i + 1:j].replace("''", "'"), j + 1
        if q == '"' and s[j] == "\\":
            j += 2
            continue
        if q == '"' and s[j] == '"':
            return json.loads(s[i:j + 1]), j + 1
        j += 1
    raise ValueError(f"unterminated quoted scalar: {s!r}")


def _flow_list(s: str, i: int):
    """Parse the flow sequence starting at s[i] == '['."""
    out = []
    i += 1
    while True:
        while i < len(s) and s[i] == " ":
            i += 1
        if i >= len(s):
            raise ValueError(f"unterminated flow sequence: {s!r}")
        if s[i] == "]":
            return out, i + 1
        if s[i] == "[":
            val, i = _flow_list(s, i)
        elif s[i] in "'\"":
            val, i = _quoted(s, i)
        else:
            j = i
            while j < len(s) and s[j] not in ",]":
                j += 1
            val, i = _plain_scalar(s[i:j].strip()), j
        out.append(val)
        while i < len(s) and s[i] == " ":
            i += 1
        if i < len(s) and s[i] == ",":
            i += 1


def _value(s: str):
    if s[0] == "[":
        val, end = _flow_list(s, 0)
    elif s[0] in "'\"":
        val, end = _quoted(s, 0)
    elif s[0] in "{&*!|>%@`":
        raise ValueError(f"YAML construct not supported by this reader: {s!r}")
    else:
        return _plain_scalar(s)
    if s[end:].strip():
        raise ValueError(f"trailing characters after value: {s!r}")
    return val


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def read_yaml(text: str) -> dict:
    """Read the YAML subset of the repo's configs: nested block mappings
    (indentation by spaces), plain and quoted scalars, and flow sequences.
    A key with no value and no indented block under it is null."""
    root: dict = {}
    # frames: (indent, mapping, parent mapping, key in parent)
    stack = [(-1, root, None, None)]

    def pop():
        _, node, parent, key = stack.pop()
        if parent is not None and not node:
            parent[key] = None

    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line.lstrip().startswith("- ") or line.strip() == "-":
            raise ValueError(f"block sequences are not supported: {raw!r}")
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body[0] in "'\"":
            key, end = _quoted(body, 0)
            rest = body[end:].lstrip()
            if not rest.startswith(":"):
                raise ValueError(f"expected 'key: value': {raw!r}")
            rest = rest[1:]
        else:
            m = re.match(r"([^:]+?)\s*:(?:\s|$)", body + " ")
            if not m:
                raise ValueError(f"expected 'key: value': {raw!r}")
            key, rest = m.group(1), body[m.end():]
        while indent <= stack[-1][0]:
            pop()
        parent = stack[-1][1]
        rest = rest.strip()
        if rest:
            parent[key] = _value(rest)
        else:
            child: dict = {}
            parent[key] = child
            stack.append((indent, child, parent, key))
    while len(stack) > 1:
        pop()
    return root
