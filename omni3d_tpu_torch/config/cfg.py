"""Minimal yacs-compatible config system.

Same `CfgNode` / `StaticCfg` surface as `omni3d_tpu.config.cfg`: attribute
access, YAML files with `_BASE_` inheritance, `merge_from_list` for CLI
`KEY VALUE` overrides, freezing, and `dump` / `save`. YAML is read by
`read_yaml`, a small reader of the subset the repo's `configs/*.yaml` and
`dump` use, and written by `dump_yaml`, which gives the bytes of PyYAML's
`safe_dump(..., sort_keys=True)` for config trees, so the port does not
depend on PyYAML.
"""
from __future__ import annotations

import ast
import copy
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

    # ------------------------------ io ------------------------------
    def dump(self) -> str:
        """The config as YAML, byte-equal to the JAX package's
        `yaml.safe_dump(..., sort_keys=True)` (tuples as lists)."""
        return dump_yaml(_to_plain(self))

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.dump())


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


def _to_plain(node):
    if isinstance(node, dict):
        return {k: _to_plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_plain(v) for v in node]
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
            return _unescape_double(s[i + 1:j]), j + 1
        j += 1
    raise ValueError(f"unterminated quoted scalar: {s!r}")


def _unescape_double(body: str) -> str:
    """The characters of a double-quoted scalar's body (YAML escapes)."""
    out, i = [], 0
    unescape = {v: k for k, v in _ESCAPES.items()} | {"/": "/", " ": " "}
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        e = body[i + 1]
        width = {"x": 2, "u": 4, "U": 8}.get(e)
        if width:
            out.append(chr(int(body[i + 2:i + 2 + width], 16)))
            i += 2 + width
        elif e in unescape:
            out.append(unescape[e])
            i += 2
        else:
            raise ValueError(f"unknown escape in a double-quoted scalar: {body!r}")
    return "".join(out)


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
    elif s == "{}":
        return {}
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


def _is_seq_line(body: str) -> bool:
    return body == "-" or body.startswith("- ")


def _map_line(body: str):
    """(key, rest) of a 'key: value' line, or None where the line is not one."""
    if body[0] in "'\"":
        key, end = _quoted(body, 0)
        rest = body[end:].lstrip()
        return (key, rest[1:].strip()) if rest.startswith(":") else None
    m = re.match(r"([^:]+?)\s*:(?:\s|$)", body + " ")
    return (m.group(1), body[m.end():].strip()) if m else None


def _block(lines: list, i: int):
    """The node whose first line is lines[i] -> (value, next line)."""
    indent, body = lines[i]
    if _is_seq_line(body):
        return _block_seq(lines, i, indent)
    if _map_line(body) is not None:
        return _block_map(lines, i, indent)
    return _value(body), i + 1


def _block_seq(lines: list, i: int, indent: int):
    out = []
    while i < len(lines) and lines[i][0] == indent and _is_seq_line(lines[i][1]):
        after = lines[i][1][1:]
        rest = after.lstrip()
        if rest:   # the item starts on this line, at the column after "- "
            lines[i] = (indent + 1 + len(after) - len(rest), rest)
            val, i = _block(lines, i)
        elif i + 1 < len(lines) and lines[i + 1][0] > indent:
            val, i = _block(lines, i + 1)
        else:
            val, i = None, i + 1
        out.append(val)
    return out, i


def _block_map(lines: list, i: int, indent: int):
    out: dict = {}
    while i < len(lines) and lines[i][0] == indent and not _is_seq_line(lines[i][1]):
        kv = _map_line(lines[i][1])
        if kv is None:
            raise ValueError(f"expected 'key: value': {lines[i][1]!r}")
        key, rest = kv
        i += 1
        if rest:
            out[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent
                                 or (lines[i][0] == indent and _is_seq_line(lines[i][1]))):
            out[key], i = _block(lines, i)
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"bad indentation: {lines[i][1]!r}")
    return out, i


def read_yaml(text: str) -> dict:
    """Read the YAML subset of the repo's configs and of `dump_yaml`: block
    mappings and block sequences (indentation by spaces; sequences under a
    key may sit at the key's column), plain and quoted scalars, flow
    sequences and `{}`. A key with no value and no block under it is null."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return {}
    root, i = _block(lines, 0)
    if i != len(lines):
        raise ValueError(f"bad indentation: {lines[i][1]!r}")
    return root


# ------------------------------ YAML writer ------------------------------
# The scalar styles and block layout of PyYAML's emitter (safe_dump with its
# defaults): a string is plain unless it is empty, would read back as another
# type, or holds an indicator; then single-quoted; double-quoted where it has
# characters a single-quoted scalar cannot hold.
_RESOLVES = [re.compile(p, re.X) for p in (
    r"""^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$""",
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
    r"""^(?:[-+]?0b[0-1_]+
        |[-+]?0[0-7_]+
        |[-+]?(?:0|[1-9][0-9_]*)
        |[-+]?0x[0-9a-fA-F_]+
        |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    r"""^(?:<<)$""",
    r"""^(?:~|null|Null|NULL|)$""",
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
         (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
         (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    r"""^(?:=)$""",
)]


def _plain_ok(s: str) -> bool:
    if not s or s.startswith(("---", "...")) or s[0] in " \t" or s[-1] in " \t":
        return False
    if any(p.match(s) for p in _RESOLVES):
        return False
    for i, ch in enumerate(s):
        followed_by_space = i + 1 == len(s) or s[i + 1] in " \t"
        if not (" " <= ch <= "~"):
            return False
        if i == 0:
            if ch in "#,[]{}&*!|>'\"%@`" or (ch in "?:-" and followed_by_space):
                return False
        elif (ch == ":" and followed_by_space) or (ch == "#" and s[i - 1] in " \t"):
            return False
    return True


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        return r.replace("e", ".0e", 1) if "." not in r and "e" in r else r
    if not isinstance(v, str):
        raise TypeError(f"dump_yaml: cannot write a {type(v).__name__}")
    if _plain_ok(v):
        return v
    if all(" " <= ch <= "~" for ch in v):
        return "'" + v.replace("'", "''") + "'"
    return '"' + "".join(_double_quoted_char(ch) for ch in v) + '"'


_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\t": "t", "\n": "n", "\x0b": "v",
            "\x0c": "f", "\r": "r", "\x1b": "e", '"': '"', "\\": "\\", "\x85": "N",
            "\xa0": "_", "\u2028": "L", "\u2029": "P"}


def _double_quoted_char(ch: str) -> str:
    if ch in _ESCAPES:
        return "\\" + _ESCAPES[ch]
    if " " <= ch <= "~":
        return ch
    n = ord(ch)
    return "\\x%02X" % n if n < 0x100 else ("\\u%04X" % n if n < 0x10000 else "\\U%08X" % n)


def _dump_map(d: dict, indent: int) -> list:
    out = []
    for k in sorted(d):
        v, key = d[k], " " * indent + _scalar(k) + ":"
        if isinstance(v, dict) and v:
            out += [key] + _dump_map(v, indent + 2)
        elif isinstance(v, list) and v:
            out += [key] + _dump_seq(v, indent)
        else:
            out.append(f"{key} {_dump_flow(v)}")
    return out


def _dump_seq(seq: list, indent: int) -> list:
    out = []
    for v in seq:
        if isinstance(v, (dict, list)) and v:
            sub = _dump_map(v, indent + 2) if isinstance(v, dict) else _dump_seq(v, indent + 2)
            out += [" " * indent + "- " + sub[0][indent + 2:]] + sub[1:]
        else:
            out.append(" " * indent + "- " + _dump_flow(v))
    return out


def _dump_flow(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, list):
        return "[]"
    return _scalar(v)


def dump_yaml(tree) -> str:
    """A tree of dicts, lists and scalars as block YAML, as PyYAML's
    `safe_dump(tree, sort_keys=True)` writes it (strings of up to a line;
    PyYAML folds longer plain ones)."""
    if isinstance(tree, dict) and tree:
        lines = _dump_map(tree, 0)
    elif isinstance(tree, list) and tree:
        lines = _dump_seq(tree, 0)
    else:
        return _dump_flow(tree) + "\n" + ("" if isinstance(tree, (dict, list)) else "...\n")
    return "\n".join(lines) + "\n"
