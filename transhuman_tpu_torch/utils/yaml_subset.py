"""A reader for the YAML subset of the repository's config files, without
PyYAML (the card's machine has none).

``load(text)`` returns what ``yaml.safe_load`` returns for the subset:

* block mappings nested by indentation (spaces), ``key: value`` and
  ``key:`` followed by a more indented block (or nothing: null);
* comments, whole-line and trailing (`` #`` outside quotes);
* plain scalars with YAML 1.1 resolution as PyYAML's SafeLoader does it:
  booleans (``True``/``false``/``yes``/``Off`` ...), null (``~``, ``null``,
  empty), ints (decimal, ``0b``, ``0x``, leading-zero octal, ``_``
  separators, ``1:30`` base 60), floats only with a dot (``7e-4`` stays
  the string ``'7e-4'``; ``1.5e-3``, ``.5``, ``.inf``, ``.nan``), and
  strings otherwise;
* single- and double-quoted scalars (``''`` is the empty string);
* flow sequences (``[0, -20, 20]``), nested ones too.

Anything else raises ``YAMLSubsetError`` naming the line: tabs in the
indentation, anchors, aliases, tags, block scalars (``|``, ``>``), flow
mappings, block sequences, directives, several documents, timestamps and
multi-line plain scalars.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

_BOOL = {
    "yes": True, "Yes": True, "YES": True, "true": True, "True": True,
    "TRUE": True, "on": True, "On": True, "ON": True,
    "no": False, "No": False, "NO": False, "false": False, "False": False,
    "FALSE": False, "off": False, "Off": False, "OFF": False,
}
_NULL = {"~", "null", "Null", "NULL", ""}
# PyYAML's implicit resolvers (resolver.py), YAML 1.1
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
# a plain scalar may not start with these indicators (anchors, aliases,
# tags, block scalars, flow mappings, directives, reserved)
_BAD_START = set("&*!|>{}%@`")
_DQ_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/",
               "0": "\0", "r": "\r"}


class YAMLSubsetError(ValueError):
    pass


def _sexagesimal(s: str, cast):
    value = 0
    for part in s.split(":"):
        value = value * 60 + cast(part)
    return value


def _int(s: str) -> int:
    """PyYAML's construct_yaml_int."""
    v = s.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * _sexagesimal(v, int)
    return sign * int(v)


def _float(s: str) -> float:
    """PyYAML's construct_yaml_float."""
    v = s.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


def resolve_plain(s: str, line: int) -> Any:
    """A plain scalar's value under YAML 1.1 (PyYAML SafeLoader)."""
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return _int(s)
    if _FLOAT.match(s):
        return _float(s)
    if _TIMESTAMP.match(s):
        raise YAMLSubsetError(f"line {line}: timestamps are outside the "
                              f"subset: {s!r}")
    if s[0] in _BAD_START:
        raise YAMLSubsetError(f"line {line}: {s[0]!r} (anchor, alias, tag, "
                              f"block scalar or flow mapping) is outside the "
                              f"subset: {s!r}")
    if s.startswith("- ") or s == "-":
        raise YAMLSubsetError(f"line {line}: block sequences are outside "
                              "the subset")
    return s


class _Scanner:
    """Scalars and flow sequences of one line's value, from position i."""

    def __init__(self, text: str, line: int):
        self.s, self.i, self.line = text, 0, line

    def err(self, msg: str):
        raise YAMLSubsetError(f"line {self.line}: {msg}: {self.s!r}")

    def skip_ws(self):
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def at_comment_or_end(self) -> bool:
        self.skip_ws()
        return self.i >= len(self.s) or self.s[self.i] == "#"

    def value(self, in_flow: bool = False) -> Any:
        self.skip_ws()
        if self.i >= len(self.s):
            return None
        c = self.s[self.i]
        if c == "'":
            return self.single()
        if c == '"':
            return self.double()
        if c == "[":
            return self.flow_seq()
        return self.plain(in_flow)

    def single(self) -> str:
        out, self.i = [], self.i + 1
        while True:
            j = self.s.find("'", self.i)
            if j < 0:
                self.err("unterminated single-quoted scalar (multi-line "
                         "scalars are outside the subset)")
            out.append(self.s[self.i:j])
            if self.s[j + 1:j + 2] == "'":
                out.append("'")
                self.i = j + 2
                continue
            self.i = j + 1
            return "".join(out)

    def double(self) -> str:
        out, self.i = [], self.i + 1
        while self.i < len(self.s):
            c = self.s[self.i]
            if c == '"':
                self.i += 1
                return "".join(out)
            if c == "\\":
                e = self.s[self.i + 1:self.i + 2]
                if e not in _DQ_ESCAPES:
                    self.err(f"escape \\{e} is outside the subset")
                out.append(_DQ_ESCAPES[e])
                self.i += 2
                continue
            out.append(c)
            self.i += 1
        self.err("unterminated double-quoted scalar (multi-line scalars are "
                 "outside the subset)")

    def plain(self, in_flow: bool) -> Any:
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if c == "#" and self.s[self.i - 1] == " ":
                break
            if in_flow and c in ",]":
                break
            if in_flow and c in "[{}":
                self.err(f"{c!r} inside a flow sequence's plain scalar")
            if c == ":" and (self.i + 1 == len(self.s)
                             or self.s[self.i + 1] == " "):
                self.err("a mapping inside a value is outside the subset")
            self.i += 1
        text = self.s[start:self.i].rstrip(" ")
        return resolve_plain(text, self.line)

    def flow_seq(self) -> list:
        self.i += 1
        out = []
        self.skip_ws()
        if self.s[self.i:self.i + 1] == "]":
            self.i += 1
            return out
        while True:
            self.skip_ws()
            if self.i >= len(self.s):
                self.err("unterminated flow sequence (multi-line flow "
                         "sequences are outside the subset)")
            if self.s[self.i] in ",]":
                self.err("an empty flow sequence entry")
            out.append(self.value(in_flow=True))
            self.skip_ws()
            c = self.s[self.i:self.i + 1]
            if c == "]":
                self.i += 1
                return out
            if c != ",":
                self.err("expected ',' or ']' in a flow sequence")
            self.i += 1
            self.skip_ws()
            if self.s[self.i:self.i + 1] == "]":  # trailing comma
                self.i += 1
                return out


_KEY = re.compile(r"^([^\s#'\"\[\]{}&*!|>%@`,][^#]*?|'[^']*'|\"[^\"]*\")"
                  r"\s*:(?:\s|$)")


def _split_lines(text: str) -> List[Tuple[int, int, str]]:
    """(line number, indent, content) of the lines that hold something."""
    out = []
    for n, raw in enumerate(text.splitlines(), 1):
        stripped = raw.lstrip(" ")
        if stripped.startswith("\t"):
            raise YAMLSubsetError(f"line {n}: tabs are outside the subset")
        if not stripped or stripped.startswith("#"):
            continue
        if n == 1 and stripped.startswith("%"):
            raise YAMLSubsetError(f"line {n}: directives are outside the "
                                  "subset")
        if stripped.rstrip() in ("---", "...") or stripped.startswith(
                ("--- ", "... ")):
            raise YAMLSubsetError(f"line {n}: document markers (several "
                                  "documents) are outside the subset")
        out.append((n, len(raw) - len(stripped), stripped.rstrip()))
    return out


def _key(content: str, n: int) -> Tuple[str, str]:
    m = _KEY.match(content)
    if not m:
        if content.startswith("- ") or content == "-":
            raise YAMLSubsetError(f"line {n}: block sequences are outside "
                                  "the subset")
        raise YAMLSubsetError(f"line {n}: not a 'key: value' line of the "
                              f"subset: {content!r}")
    raw = m.group(1).rstrip()
    if raw[0] in "'\"":
        key = raw[1:-1]
    else:
        key = resolve_plain(raw, n)
        if not isinstance(key, str):
            raise YAMLSubsetError(f"line {n}: a key that resolves to "
                                  f"{type(key).__name__} is outside the "
                                  f"subset: {raw!r}")
    return key, content[m.end():]


def _block(lines, pos: int, indent: int) -> Tuple[dict, int]:
    out: dict = {}
    while pos < len(lines):
        n, ind, content = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise YAMLSubsetError(f"line {n}: unexpected indentation")
        key, rest = _key(content, n)
        sc = _Scanner(rest, n)
        pos += 1
        if sc.at_comment_or_end():
            if pos < len(lines) and lines[pos][1] > indent:
                out[key], pos = _block(lines, pos, lines[pos][1])
            else:
                out[key] = None
            continue
        out[key] = sc.value()
        if not sc.at_comment_or_end():
            sc.err("trailing text after the value")
        if pos < len(lines) and lines[pos][1] > indent:
            raise YAMLSubsetError(f"line {lines[pos][0]}: multi-line plain "
                                  "scalars are outside the subset")
    return out, pos


def load(text: str) -> Optional[dict]:
    """The document's value: a dict, or None for an empty document (as
    ``yaml.safe_load``)."""
    lines = _split_lines(text)
    if not lines:
        return None
    if lines[0][1] != 0:
        raise YAMLSubsetError(f"line {lines[0][0]}: the document must start "
                              "at column 0")
    out, pos = _block(lines, 0, 0)
    if pos != len(lines):
        raise YAMLSubsetError(f"line {lines[pos][0]}: unexpected "
                              "indentation")
    return out


def load_file(path: str) -> Optional[dict]:
    with open(path) as f:
        return load(f.read())
