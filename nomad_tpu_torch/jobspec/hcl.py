"""Minimal HCL1 parser — enough for the job specification language
(ref jobspec/parse.go, which feeds HCL1 through hashicorp/hcl).

Supports the constructs jobspecs use: blocks (`job "name" { ... }`, nested,
with 0..2 string labels), assignments (`key = value`), strings (with escapes),
heredocs, numbers, booleans, lists, objects (`{ k = v }`), comments
(#, //, /* */), and duration-literal passthrough (durations stay strings for
the caller to parse). Produces plain dicts: blocks become
``{type: {label: body}}`` and repeated blocks become lists.
"""

from __future__ import annotations

import re
from typing import Any, Optional

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[ \t\r,]+)
  | (?P<comment>\#[^\n]*|//[^\n]*|/\*.*?\*/)
  | (?P<heredoc><<-?(?P<hd_tag>[A-Za-z_][A-Za-z0-9_]*)\n(?P<hd_body>.*?)\n\s*(?P=hd_tag))
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<number>-?\d+\.\d+|-?\d+(?![\w.]))
  | (?P<bool>\btrue\b|\bfalse\b)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_\-.]*)
  | (?P<punct>[{}\[\]=\n])
    """,
    re.VERBOSE | re.DOTALL,
)


class HCLError(ValueError):
    pass


def _tokenize(src: str):
    tokens = []
    pos = 0
    line = 1
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise HCLError(f"unexpected character {src[pos]!r} at line {line}")
        line += src[pos : m.end()].count("\n")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        if kind == "heredoc":
            tokens.append(("string", m.group("hd_body"), line))
        elif kind == "punct" and m.group() == "\n":
            tokens.append(("newline", "\n", line))
        else:
            tokens.append((kind, m.group(), line))
    tokens.append(("eof", "", line))
    return tokens


_ESCAPES = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "r": "\r"}


def _unquote(s: str) -> str:
    body = s[1:-1]
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            out.append(_ESCAPES.get(body[i + 1], "\\" + body[i + 1]))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


class _Parser:
    def __init__(self, tokens):
        self.tokens = tokens
        self.pos = 0

    def peek(self):
        return self.tokens[self.pos]

    def next(self):
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def skip_newlines(self):
        while self.peek()[0] == "newline":
            self.next()

    def parse_body(self, stop: Optional[str] = "eof") -> dict:
        """Parse a sequence of assignments and blocks until `stop`."""
        out: dict[str, Any] = {}
        while True:
            self.skip_newlines()
            kind, value, line = self.peek()
            if kind == "eof" or (stop == "}" and value == "}"):
                return out
            if kind not in ("ident", "string"):
                raise HCLError(f"expected key at line {line}, got {value!r}")
            key = _unquote(value) if kind == "string" else value
            self.next()
            self._parse_entry(out, key)

    def _parse_entry(self, out: dict, key: str):
        labels = []
        while True:
            kind, value, line = self.peek()
            if kind == "punct" and value == "=":
                self.next()
                self._store(out, key, labels, self.parse_value())
                return
            if kind == "string" and not labels or (kind == "string" and labels):
                labels.append(_unquote(value))
                self.next()
                continue
            if kind == "punct" and value == "{":
                self.next()
                body = self.parse_body(stop="}")
                self._expect("}")
                self._store(out, key, labels, body)
                return
            raise HCLError(
                f"unexpected {value!r} after {key!r} at line {line}"
            )

    def _store(self, out: dict, key: str, labels: list[str], value):
        """Blocks with labels nest: job "x" { } → {"job": {"x": {...}}}.
        Repeated keys become lists (HCL1 object-list semantics)."""
        target = out
        path = [key] + labels
        for part in path[:-1]:
            nxt = target.get(part)
            if not isinstance(nxt, dict):
                nxt = {}
                target[part] = nxt
            target = nxt
        last = path[-1]
        if last in target:
            existing = target[last]
            if isinstance(existing, list):
                existing.append(value)
            else:
                target[last] = [existing, value]
        else:
            target[last] = value

    def _expect(self, punct: str):
        kind, value, line = self.next()
        if value != punct:
            raise HCLError(f"expected {punct!r} at line {line}, got {value!r}")

    def parse_value(self):
        self.skip_newlines()
        kind, value, line = self.next()
        if kind == "string":
            return _unquote(value)
        if kind == "number":
            return float(value) if "." in value else int(value)
        if kind == "bool":
            return value == "true"
        if kind == "ident":
            return value  # bare identifier treated as string
        if value == "[":
            items = []
            while True:
                self.skip_newlines()
                if self.peek()[1] == "]":
                    self.next()
                    return items
                items.append(self.parse_value())
        if value == "{":
            body = self.parse_body(stop="}")
            self._expect("}")
            return body
        raise HCLError(f"unexpected value {value!r} at line {line}")


def parse(src: str) -> dict:
    """Parse HCL source into nested dicts."""
    return _Parser(_tokenize(src)).parse_body()


_DURATION_RE = re.compile(r"^(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)$")
_DURATION_NS = {
    "ns": 1,
    "us": 1_000,
    "µs": 1_000,
    "ms": 1_000_000,
    "s": 1_000_000_000,
    "m": 60 * 1_000_000_000,
    "h": 3600 * 1_000_000_000,
}


def parse_duration(v) -> int:
    """Go-style duration string → nanoseconds ('30s', '10m', '1.5h')."""
    if isinstance(v, (int, float)):
        return int(v)
    total = 0
    rest = v.strip()
    part_re = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
    pos = 0
    matched = False
    for m in part_re.finditer(rest):
        if m.start() != pos:
            raise HCLError(f"invalid duration: {v!r}")
        total += int(float(m.group(1)) * _DURATION_NS[m.group(2)])
        pos = m.end()
        matched = True
    if not matched or pos != len(rest):
        raise HCLError(f"invalid duration: {v!r}")
    return total
