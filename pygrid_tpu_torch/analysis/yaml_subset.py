"""A reader for the YAML subset ``docs/wire_protocol.yaml`` is written in.

GL7 holds the code against that spec. The card's machine has no PyYAML,
so the port reads the spec itself, as it carries its own msgpack and
HTTP stack. The subset: ``#`` comments, block mappings (``key: value``
and ``key:`` over an indented block), block sequences (``- item``, an
item being a scalar, a flow collection or a ``key: value`` mapping),
flow mappings and sequences (``{a: b, c: {d: 1}}``, ``[a, b]``), and
scalars as YAML 1.1's safe loader reads them: ints, floats,
``true``/``false``, ``null``/``~``, quoted and plain strings. Anything
else raises :class:`YamlSubsetError` with its line.
"""

from __future__ import annotations

import re
from typing import Any

_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_BOOLS = {
    "true": True, "True": True, "TRUE": True, "yes": True, "Yes": True,
    "on": True, "On": True, "false": False, "False": False, "FALSE": False,
    "no": False, "No": False, "off": False, "Off": False,
}
_NULLS = {"", "~", "null", "Null", "NULL"}


class YamlSubsetError(ValueError):
    pass


def _strip_comment(text: str) -> str:
    """``text`` without a trailing ``# comment`` (outside quotes)."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _scalar(text: str, line: int) -> Any:
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        return body.replace("''", "'") if text[0] == "'" else (
            body.encode().decode("unicode_escape")
        )
    if text[:1] in ("'", '"'):
        raise YamlSubsetError(f"line {line}: unterminated quote in {text!r}")
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and text not in (".", "-.", "+."):
        return float(text.replace("_", ""))
    if text[:1] in ("[", "{", "&", "*", "!", "|", ">", "@", "`"):
        raise YamlSubsetError(f"line {line}: unsupported YAML in {text!r}")
    return text


class _Flow:
    """A flow collection (``{...}`` or ``[...]``) read char by char."""

    def __init__(self, text: str, line: int) -> None:
        self.text = text
        self.pos = 0
        self.line = line

    def _ws(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def _fail(self, what: str) -> YamlSubsetError:
        return YamlSubsetError(f"line {self.line}: {what} in {self.text!r}")

    def value(self) -> Any:
        self._ws()
        ch = self.text[self.pos : self.pos + 1]
        if ch == "{":
            return self._mapping()
        if ch == "[":
            return self._sequence()
        start = self.pos
        if ch in ("'", '"'):
            end = self.text.find(ch, self.pos + 1)
            if end < 0:
                raise self._fail("unterminated quote")
            self.pos = end + 1
        else:
            while (
                self.pos < len(self.text) and self.text[self.pos] not in ",]}"
                and not (
                    self.text[self.pos] == ":"
                    and self.text[self.pos + 1 : self.pos + 2] in (" ", "")
                )
            ):
                self.pos += 1
        return _scalar(self.text[start : self.pos], self.line)

    def _expect(self, ch: str) -> None:
        self._ws()
        if self.text[self.pos : self.pos + 1] != ch:
            raise self._fail(f"expected {ch!r}")
        self.pos += 1

    def _mapping(self) -> dict:
        self._expect("{")
        out: dict = {}
        self._ws()
        if self.text[self.pos : self.pos + 1] == "}":
            self.pos += 1
            return out
        while True:
            key = self.value()
            self._expect(":")
            out[key] = self.value()
            self._ws()
            ch = self.text[self.pos : self.pos + 1]
            self.pos += 1
            if ch == "}":
                return out
            if ch != ",":
                raise self._fail("expected ',' or '}'")

    def _sequence(self) -> list:
        self._expect("[")
        out: list = []
        self._ws()
        if self.text[self.pos : self.pos + 1] == "]":
            self.pos += 1
            return out
        while True:
            out.append(self.value())
            self._ws()
            ch = self.text[self.pos : self.pos + 1]
            self.pos += 1
            if ch == "]":
                return out
            if ch != ",":
                raise self._fail("expected ',' or ']'")

    def whole(self) -> Any:
        out = self.value()
        self._ws()
        if self.pos != len(self.text):
            raise self._fail("trailing text")
        return out


def _inline(text: str, line: int) -> Any:
    if text[:1] in ("{", "["):
        return _Flow(text, line).whole()
    return _scalar(text, line)


_KEY = re.compile(r"""((?:"[^"]*"|'[^']*'|[^:#'"][^:]*?))\s*:(?:\s+|$)""")


class _Block:
    def __init__(self, source: str) -> None:
        self.lines: list[tuple[int, str, int]] = []  # indent, text, line no
        for n, raw in enumerate(source.splitlines(), 1):
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise YamlSubsetError(f"line {n}: tab indentation")
            text = _strip_comment(raw)
            if not text.strip() or text.strip() in ("---", "..."):
                continue
            self.lines.append((len(text) - len(text.lstrip()), text.strip(), n))
        self.i = 0

    def parse(self) -> Any:
        if not self.lines:
            return None
        out = self._node(self.lines[0][0])
        if self.i != len(self.lines):
            raise YamlSubsetError(f"line {self.lines[self.i][2]}: bad indentation")
        return out

    def _node(self, indent: int) -> Any:
        text = self.lines[self.i][1]
        if text == "-" or text.startswith("- "):
            return self._sequence(indent)
        if _KEY.match(text):
            return self._mapping(indent)
        self.i += 1
        return _inline(text, self.lines[self.i - 1][2])

    def _child(self, indent: int) -> Any:
        """The block under a ``key:`` or ``-`` with nothing after it."""
        if self.i < len(self.lines) and self.lines[self.i][0] > indent:
            return self._node(self.lines[self.i][0])
        return None

    def _mapping(self, indent: int, first: str | None = None) -> dict:
        out: dict = {}
        while self.i < len(self.lines) or first is not None:
            if first is not None:
                text, line, first = first, self.lines[self.i - 1][2], None
            else:
                ind, text, line = self.lines[self.i]
                if ind < indent:
                    break
                if ind > indent:
                    raise YamlSubsetError(f"line {line}: bad indentation")
                if text == "-" or text.startswith("- "):
                    break
                self.i += 1
            m = _KEY.match(text)
            if m is None:
                raise YamlSubsetError(f"line {line}: expected 'key:' in {text!r}")
            key = _scalar(m.group(1), line)
            rest = text[m.end():].strip()
            if key in out:
                raise YamlSubsetError(f"line {line}: duplicate key {key!r}")
            if rest:
                out[key] = _inline(rest, line)
            elif (
                self.i < len(self.lines)
                and self.lines[self.i][0] == indent
                and self.lines[self.i][1].startswith("- ")
            ):
                # a sequence may sit at its key's own indentation
                out[key] = self._sequence(indent)
            else:
                out[key] = self._child(indent)
        return out

    def _sequence(self, indent: int) -> list:
        out: list = []
        while self.i < len(self.lines):
            ind, text, line = self.lines[self.i]
            if ind != indent or not (text == "-" or text.startswith("- ")):
                if ind > indent:
                    raise YamlSubsetError(f"line {line}: bad indentation")
                break
            self.i += 1
            rest = text[1:].strip()
            if not rest:
                out.append(self._child(indent))
            elif rest[:1] not in ("{", "[") and _KEY.match(rest):
                # ``- key: value`` opens a mapping at the item's column
                item_indent = indent + (len(text) - len(rest))
                out.append(self._mapping(item_indent, first=rest))
            else:
                out.append(_inline(rest, line))
        return out


def safe_load(source: str) -> Any:
    """Parse ``source`` (a str) as the YAML subset described above."""
    return _Block(source).parse()
