"""A reader of the YAML the routing policy is written in, without PyYAML.

The card's machine has no PyYAML, so the port reads ``policy_v1.yaml`` (and
a deployment's own file, ``$VETPU_POLICY``) with this module. It takes the
subset such a file uses and gives what ``yaml.safe_load`` gives for it:

- block mappings (nested by indentation, spaces only) and flow mappings
  ``{a: 1, b: [1, 2]}``, flow lists ``[1, 2]``, both of them free to span
  lines and to end with a comma;
- plain and quoted scalars, resolved by PyYAML's rules for YAML 1.1:
  ``null`` / ``~`` / nothing, the booleans (``true``, ``yes``, ``on`` and
  their negatives, in PyYAML's three spellings), decimal ints and floats
  (``1.0``, ``.5``, ``1.0e+3``; ``1e3`` stays a string, as in PyYAML),
  ``.inf`` and ``.nan``; single-quoted (``''`` is a quote) and
  double-quoted strings with their escapes;
- ``#`` comments, blank lines and one ``---`` before the document.

Anything else raises ``YAMLSubsetError`` naming the line: anchors, aliases,
tags, block sequences (``- item``), block scalars (``|``, ``>``), scalars
over several lines, tabs, directives, merge keys, timestamps and the int
forms other than decimal (octal, hex, binary, sexagesimal), which PyYAML
would read as something this reader does not make.
"""

from __future__ import annotations

import re
from typing import Any

__all__ = ["YAMLSubsetError", "loads", "load_file"]


class YAMLSubsetError(ValueError):
    """The text is outside the subset this reader takes (or is not YAML)."""


_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_DEC_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_OTHER_INT = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
                        r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?")
_SEXAGESIMAL_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
_TIMESTAMP = re.compile(r"[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_FLOW_END = ",]}"


def _resolve(text: str, line: int) -> Any:
    """A plain scalar's value, by PyYAML's implicit resolvers."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if text[0] in "-+0123456789.":
        if _DEC_INT.fullmatch(text):
            return int(text.replace("_", ""))
        if _FLOAT.fullmatch(text):
            return float(text.replace("_", ""))
        if _INF.fullmatch(text):
            return float("-inf") if text[0] == "-" else float("inf")
        if _NAN.fullmatch(text):
            return float("nan")
        if (_OTHER_INT.fullmatch(text) or _SEXAGESIMAL_FLOAT.fullmatch(text)
                or _TIMESTAMP.match(text)):
            raise YAMLSubsetError(
                f"line {line}: {text!r} is outside the subset (only decimal "
                f"ints, floats and strings)")
    if text == "<<" or text == "=":
        raise YAMLSubsetError(f"line {line}: the key {text!r} is outside the "
                              f"subset")
    if text[0] in "&*!|>%@`" or text[:2] in ("- ", "? ") or text == "-":
        raise YAMLSubsetError(
            f"line {line}: {text!r} starts with an indicator outside the "
            f"subset (anchors, aliases, tags, block scalars, sequences)")
    return text


class _Cursor:
    """A position in the document's text, which may run over lines."""

    def __init__(self, lines: list[tuple[int, str]], row: int, col: int):
        self.lines, self.row, self.col = lines, row, col

    @property
    def lineno(self) -> int:
        return self.lines[min(self.row, len(self.lines) - 1)][0]

    def peek(self) -> str:
        """The next character that is not a space, a comment or a line end
        ("" at the end of the text)."""
        while self.row < len(self.lines):
            text = self.lines[self.row][1]
            while self.col < len(text) and text[self.col] == " ":
                self.col += 1
            if self.col < len(text) and text[self.col] != "#":
                return text[self.col]
            self.row, self.col = self.row + 1, 0
        return ""

    def take(self, ch: str) -> None:
        if self.peek() != ch:
            raise YAMLSubsetError(f"line {self.lineno}: expected {ch!r}")
        self.col += 1

    def rest(self) -> str:
        return self.lines[self.row][1][self.col:]


def _quoted(cur: _Cursor) -> str:
    """A single- or double-quoted scalar on one line, the cursor on its
    opening quote."""
    text, q = cur.rest(), cur.rest()[0]
    out, i = [], 1
    while i < len(text):
        ch = text[i]
        if ch == q:
            if q == "'" and text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            cur.col += i + 1
            return "".join(out)
        if ch == "\\" and q == '"':
            esc = text[i + 1:i + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
                continue
            width = _HEX_ESCAPES.get(esc)
            digits = text[i + 2:i + 2 + width] if width else ""
            if width and re.fullmatch(r"[0-9a-fA-F]+", digits) and \
                    len(digits) == width:
                out.append(chr(int(digits, 16)))
                i += 2 + width
                continue
            raise YAMLSubsetError(
                f"line {cur.lineno}: the escape \\{esc} is outside the subset")
        out.append(ch)
        i += 1
    raise YAMLSubsetError(f"line {cur.lineno}: a quoted scalar over several "
                          f"lines is outside the subset")


def _flow_plain(cur: _Cursor) -> Any:
    """A plain scalar inside a flow collection: up to a flow indicator, a
    comment, the line's end or ``": "``."""
    text = cur.rest()
    end = len(text)
    for i, ch in enumerate(text):
        if ch in _FLOW_END or (ch == "#" and i and text[i - 1] == " ") or (
                ch == ":" and (i + 1 == len(text) or text[i + 1] in " ,]}")):
            end = i
            break
    value = text[:end].strip()
    cur.col += end
    if not value:
        raise YAMLSubsetError(f"line {cur.lineno}: an empty entry in a flow "
                              f"collection")
    return _resolve(value, cur.lineno)


def _flow_node(cur: _Cursor) -> Any:
    ch = cur.peek()
    if ch == "":
        raise YAMLSubsetError(f"line {cur.lines[-1][0]}: unclosed flow "
                              f"collection")
    if ch == "{":
        return _flow_mapping(cur)
    if ch == "[":
        return _flow_list(cur)
    if ch in "'\"":
        return _quoted(cur)
    return _flow_plain(cur)


def _flow_list(cur: _Cursor) -> list:
    cur.take("[")
    out = []
    while cur.peek() != "]":
        out.append(_flow_node(cur))
        if cur.peek() == ":":
            raise YAMLSubsetError(f"line {cur.lineno}: a mapping inside a "
                                  f"flow list is outside the subset")
        if cur.peek() != "]":
            cur.take(",")
    cur.take("]")
    return out


def _flow_mapping(cur: _Cursor) -> dict:
    cur.take("{")
    out: dict = {}
    while cur.peek() != "}":
        k = _flow_node(cur)
        if cur.peek() == ":":
            cur.take(":")
            v = None if cur.peek() in (",", "}") else _flow_node(cur)
        else:
            v = None
        if isinstance(k, (list, dict)):
            raise YAMLSubsetError(f"line {cur.lineno}: a collection as a key "
                                  f"is outside the subset")
        out[k] = v
        if cur.peek() != "}":
            cur.take(",")
    cur.take("}")
    return out


def _split_key(text: str, line: int) -> tuple[Any, str]:
    """``key: value`` of a block mapping's line: the key and the rest."""
    if text[0] in "'\"":
        cur = _Cursor([(line, text)], 0, 0)
        k = _quoted(cur)
        rest = cur.rest()
        if not (rest.startswith(":") and (len(rest) == 1 or rest[1] == " ")):
            raise YAMLSubsetError(f"line {line}: expected ': ' after the key")
        return k, rest[1:].strip()
    m = re.search(r":(?: |$)", text)
    if m is None:
        raise YAMLSubsetError(
            f"line {line}: expected 'key: value' (a scalar over several "
            f"lines, or a block sequence, is outside the subset)")
    k = text[:m.start()].rstrip()
    if not k or k[0] in "[{":
        raise YAMLSubsetError(f"line {line}: a complex key is outside the "
                              f"subset")
    return _resolve(k, line), text[m.end():].strip()


def _strip_comment(text: str) -> str:
    """``text`` without a trailing ``# comment`` (a ``#`` at the line's start
    or after a space, outside quotes)."""
    q = None
    for i, ch in enumerate(text):
        if q:
            if ch == q:
                q = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " [{,:"):
            q = ch
        elif ch == "#" and (i == 0 or text[i - 1] == " "):
            return text[:i].rstrip()
    return text.rstrip()


def loads(text: str) -> Any:
    """The document in ``text``, as ``yaml.safe_load`` would give it, or
    ``YAMLSubsetError`` naming the line where it leaves the subset."""
    lines: list[tuple[int, str]] = []
    for n, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw:
            raise YAMLSubsetError(f"line {n}: tabs are outside the subset")
        body = _strip_comment(raw)
        if not body.strip():
            continue
        if not lines and body == "---":
            continue
        if body.startswith(("%", "---", "...")):
            raise YAMLSubsetError(f"line {n}: directives and more than one "
                                  f"document are outside the subset")
        lines.append((n, raw.rstrip()))
    if not lines:
        return None
    row, value = _block(lines, 0, _indent(lines[0][1]))
    if row != len(lines):
        raise YAMLSubsetError(f"line {lines[row][0]}: bad indentation")
    return value


def _indent(text: str) -> int:
    return len(text) - len(text.lstrip(" "))


def _block(lines, row: int, indent: int) -> tuple[int, Any]:
    """The block node starting at ``lines[row]`` (indented ``indent``):
    a block mapping, or a flow collection standing alone as the document.
    Returns the row after it and its value."""
    if row == 0 and _strip_comment(lines[0][1])[indent] in "[{":
        cur = _Cursor(lines, row, indent)
        value = _flow_node(cur)
        if cur.peek():
            raise YAMLSubsetError(f"line {cur.lineno}: text after the "
                                  f"document's value")
        return len(lines), value
    out: dict = {}
    while row < len(lines):
        n, text = lines[row]
        ind = _indent(text)
        if ind < indent:
            break
        if ind > indent:
            raise YAMLSubsetError(f"line {n}: bad indentation (a scalar over "
                                  f"several lines is outside the subset)")
        body = _strip_comment(text)[indent:]
        if body.startswith("-"):
            raise YAMLSubsetError(f"line {n}: block sequences are outside the "
                                  f"subset; write a flow list [a, b]")
        k, rest = _split_key(body, n)
        if rest:
            if rest[0] in "[{":
                cur = _Cursor(lines, row, indent + len(body) - len(rest))
                out[k] = _flow_node(cur)
                if cur.rest().strip() and not cur.rest().strip().startswith(
                        "#"):
                    raise YAMLSubsetError(f"line {cur.lineno}: text after a "
                                          f"flow collection")
                row = cur.row + 1
            elif rest[0] in "'\"":
                cur = _Cursor([(n, rest)], 0, 0)
                out[k] = _quoted(cur)
                if cur.rest().strip():
                    raise YAMLSubsetError(f"line {n}: text after a quoted "
                                          f"scalar")
                row += 1
            else:
                if re.search(r":(?: |$)", rest):
                    raise YAMLSubsetError(f"line {n}: a mapping is not "
                                          f"allowed in a plain value")
                out[k] = _resolve(rest, n)
                row += 1
            if row < len(lines) and _indent(lines[row][1]) > indent:
                raise YAMLSubsetError(
                    f"line {lines[row][0]}: bad indentation (a scalar over "
                    f"several lines is outside the subset)")
        else:
            row += 1
            if row < len(lines) and _indent(lines[row][1]) > indent:
                row, out[k] = _block(lines, row, _indent(lines[row][1]))
            else:
                out[k] = None
    return row, out


def load_file(path) -> Any:
    """``loads`` of a UTF-8 file, its path in the message of an error."""
    from pathlib import Path

    try:
        return loads(Path(path).read_text(encoding="utf-8"))
    except YAMLSubsetError as e:
        raise YAMLSubsetError(f"{path}: {e}") from None
