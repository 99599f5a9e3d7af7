"""YAML config files onto the port's ``Config`` (counterpart of
``threedod/config/yaml_loader.py`` and ``merge_from_list``).

``load_config(path, opts)`` reads ``path``, deep-merges it onto the file its
``_BASE_`` names, applies the result onto a default ``Config`` (an unknown
key raises ``KeyError``) and then the command line's ``opts``
(``['solver.max_iter', '60', ...]`` or ``'solver.max_iter=60'``).

PyYAML is not needed: ``parse_yaml`` reads the subset of YAML that
``configs/*.yaml`` use, and resolves scalars as PyYAML's ``safe_load`` does:

* block mappings and block lists, nested by indentation (spaces only);
* flow lists ``[a, [b, c]]`` and flow mappings ``{k: v}``, over one line
  or more;
* plain, single- and double-quoted scalars; decimal integers, floats with a
  dot (``1e8`` without one is a string, as in YAML 1.1), ``.inf``, ``.nan``;
  ``true``/``false`` (and YAML 1.1's yes/no/on/off), ``null``/``~``;
* ``#`` comments.

Anything outside that subset (anchors, tags, multi-line scalars, documents,
octal or hexadecimal integers, tabs) raises ``ValueError``.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import List, Optional, Tuple

from .config import Config

_BOOL = {s: v for v, words in ((True, ("yes", "true", "on")), (False, ("no", "false", "off")))
         for w in words for s in (w, w.capitalize(), w.upper())}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?")
_OTHER_NUMBERS = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+.*")
_INDICATORS = "&*!|>%@`"


def _plain(text: str):
    """A plain scalar resolved as PyYAML's resolver does."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    low = text.lstrip("+-").lower()
    if low in (".inf", ".nan") and (low == ".inf" or text[0] not in "+-"):
        return float(("-" if text.startswith("-") else "") + low[1:])
    if _OTHER_NUMBERS.fullmatch(text) or text[0] in _INDICATORS or text.startswith(("- ", "? ", "---")):
        raise ValueError(f"YAML scalar {text!r} is outside the subset this reader takes")
    return text


def _quoted(s: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at s[i]; returns (value, index after it)."""
    q, out, j = s[i], [], i + 1
    escapes = {'"': '"', "\\": "\\", "n": "\n", "t": "\t", "/": "/", "0": "\0"}
    while j < len(s):
        c = s[j]
        if q == "'" and c == "'":
            if s[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = s[j + 1:j + 2]
            if e not in escapes:
                raise ValueError(f"YAML escape \\{e} is outside the subset this reader takes")
            out.append(escapes[e])
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise ValueError(f"unterminated quoted scalar in {s!r}")


def _strip_comment(line: str) -> str:
    """``line`` without its ``#`` comment (a ``#`` at the start or after a
    space, outside quotes)."""
    i, q = 0, None
    while i < len(line):
        c = line[i]
        if q:
            if c == q:
                if q == "'" and line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    q = None
            elif c == "\\" and q == '"':
                i += 1
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            q = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _flow(s: str, i: int):
    """The flow node starting at s[i] -> (value, index after it)."""
    while i < len(s) and s[i] == " ":
        i += 1
    if i >= len(s):
        raise ValueError(f"unterminated flow collection in {s!r}")
    c = s[i]
    if c in "[{":
        close, items, mapping = "]" if c == "[" else "}", [], {}
        i += 1
        while True:
            while i < len(s) and s[i] == " ":
                i += 1
            if i < len(s) and s[i] == close:
                return (items if c == "[" else mapping), i + 1
            if c == "[":
                val, i = _flow(s, i)
                items.append(val)
            else:
                key, i = _flow(s, i)
                while i < len(s) and s[i] == " ":
                    i += 1
                if i >= len(s) or s[i] != ":":
                    raise ValueError(f"flow mapping entry without ':' in {s!r}")
                val, i = _flow(s, i + 1)
                mapping[key] = val
            while i < len(s) and s[i] == " ":
                i += 1
            if i < len(s) and s[i] == ",":
                i += 1
            elif i >= len(s) or s[i] != close:
                raise ValueError(f"malformed flow collection in {s!r}")
    if c in "'\"":
        return _quoted(s, i)
    j = i
    while j < len(s) and s[j] not in ",]}" and not (s[j] == ":" and (j + 1 == len(s) or s[j + 1] in " ,]}")):
        j += 1
    return _plain(s[i:j].strip()), j


def _open_brackets(text: str) -> int:
    """Flow brackets opened and not closed in ``text`` (outside quotes)."""
    depth, q = 0, None
    for i, c in enumerate(text):
        if q:
            q = None if c == q else q
        elif c in "'\"" and (i == 0 or text[i - 1] in " [{,:"):
            q = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth


def _value(text: str):
    """An inline value: a flow collection, a quoted or a plain scalar."""
    if text[0] in "[{'\"":
        val, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"trailing text after a YAML value: {text!r}")
        return val
    return _plain(text)


def _split_key(text: str) -> Tuple[object, Optional[str]]:
    """'key: value' -> (key, value text or None); None when not a mapping entry."""
    if text[0] in "'\"":
        key, j = _quoted(text, 0)
    else:
        m = re.match(r"([^:#\[\]{},]+?)\s*:(?:\s|$)", text)
        if not m:
            return None, None
        key, j = _plain(m.group(1)), m.end(1)
    rest = text[j:].lstrip()
    if not rest.startswith(":"):
        return None, None
    return key, rest[1:].strip()


def parse_yaml(text: str):
    """The document in ``text`` -> dicts, lists and scalars (``None`` when empty)."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("YAML indentation with tabs is outside the subset this reader takes")
        body = _strip_comment(raw)
        if body.strip():
            if body.strip() in ("---", "..."):
                raise ValueError("YAML document markers are outside the subset this reader takes")
            lines.append((len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None
    node, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"unexpected indentation at {lines[end][1]!r}")
    return node


def _block(lines, i: int, indent: int):
    """The block node whose lines start at ``i`` with ``indent`` -> (node, next line)."""
    if lines[i][1] == "-" or lines[i][1].startswith("- "):
        out = []
        while i < len(lines) and lines[i][0] == indent and (lines[i][1] == "-" or lines[i][1].startswith("- ")):
            item = lines[i][1][1:].strip()
            if not item:
                raise ValueError("a block list item on its own lines is outside the subset this reader takes")
            if item[0] not in "[{'\"" and _split_key(item)[0] is not None:
                raise ValueError(f"a mapping inside a block list is outside the subset this reader takes: {item!r}")
            out.append(_value(item))
            i += 1
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        key, rest = _split_key(lines[i][1])
        if key is None:
            raise ValueError(f"expected 'key: value' at {lines[i][1]!r}")
        if key in out:
            raise ValueError(f"duplicate YAML key {key!r}")
        i += 1
        if rest:
            while rest[0] in "[{" and _open_brackets(rest) > 0 and i < len(lines) and lines[i][0] > indent:
                rest += " " + lines[i][1]  # a flow collection continued on the next line
                i += 1
            out[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and (lines[i][1] == "-" or lines[i][1].startswith("- ")))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


# ---- onto the Config ----------------------------------------------------------


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml_with_base(path: str) -> dict:
    """The file's mapping, deep-merged onto the file its ``_BASE_`` names
    (relative to its own directory)."""
    with open(path) as f:
        data = parse_yaml(f.read()) or {}
    base = data.pop("_BASE_", None)
    if base:
        base_path = base if os.path.isabs(base) else os.path.join(os.path.dirname(path), base)
        return _deep_merge(load_yaml_with_base(base_path), data)
    return data


def _coerce(value, current):
    """``value`` (from YAML or the command line) in the type of the field's ``current`` value."""
    if isinstance(value, str):
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            # bare-word lists like "[dims,iou,z]" are not Python literals
            if isinstance(current, (list, tuple)) and value.startswith("[") and value.endswith("]"):
                value = [p.strip().strip("'\"") for p in value[1:-1].split(",") if p.strip()]
    if isinstance(current, tuple) and isinstance(value, (list, tuple)):
        return tuple(value)
    if isinstance(current, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(current, float) and isinstance(value, (int, float)):
        return float(value)
    if isinstance(current, int) and isinstance(value, (int, float)) and not isinstance(value, bool):
        return int(value)
    return value


def _apply(cfg_obj, data: dict, path: str = "") -> None:
    for key, value in data.items():
        name = key.lower()
        if not hasattr(cfg_obj, name):
            raise KeyError(f"unknown config key '{path}{key}'")
        current = getattr(cfg_obj, name)
        if dataclasses.is_dataclass(current):
            if not isinstance(value, dict):
                raise TypeError(f"'{path}{key}' expects a mapping")
            _apply(current, value, path=f"{path}{key}.")
        else:
            setattr(cfg_obj, name, _coerce(value, current))


def _set_by_path(cfg, path: str, value) -> None:
    """Set a dotted path like 'model.roi_heads.num_classes' (case-insensitive)."""
    parts = path.lower().split(".")
    obj = cfg
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise KeyError(f"config has no section '{p}' (in '{path}')")
        obj = getattr(obj, p)
    if not hasattr(obj, parts[-1]):
        raise KeyError(f"config has no key '{parts[-1]}' (in '{path}')")
    setattr(obj, parts[-1], _coerce(value, getattr(obj, parts[-1])))


def merge_from_list(cfg: Config, opts: List[str]) -> Config:
    """Command-line overrides: ['model.backbone', 'resnet34', ...] or 'a.b=c'."""
    i = 0
    while i < len(opts):
        if "=" in opts[i]:
            k, v = opts[i].split("=", 1)
            i += 1
        else:
            k, v = opts[i], opts[i + 1]
            i += 2
        _set_by_path(cfg, k, v)
    return cfg


def load_config(path: Optional[str] = None, opts: Optional[list] = None) -> Config:
    """A ``Config`` from a YAML file (with ``_BASE_``) and command-line overrides."""
    cfg = Config()
    if path:
        _apply(cfg, load_yaml_with_base(path))
    if opts:
        merge_from_list(cfg, opts)
    return cfg
