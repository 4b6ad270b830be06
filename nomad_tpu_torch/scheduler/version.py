"""Version parsing and constraint matching with go-version semantics
(ref vendor/github.com/hashicorp/go-version used by feasible.go:604-643).

Supports the operators go-version does: ``=``, ``!=``, ``>``, ``<``, ``>=``,
``<=``, ``~>`` (pessimistic), with comma-separated conjunctions, numeric
segment comparison, and prerelease ordering (a prerelease sorts before its
release).
"""

from __future__ import annotations

import re
from typing import Optional

_VERSION_RE = re.compile(
    r"^v?([0-9]+(\.[0-9]+)*?)"
    r"(-([0-9]+[0-9A-Za-z\-~]*(\.[0-9A-Za-z\-~]+)*)|(-?([A-Za-z\-~]+[0-9A-Za-z\-~]*(\.[0-9A-Za-z\-~]+)*)))?"
    r"(\+([0-9A-Za-z\-~]+(\.[0-9A-Za-z\-~]+)*))?"
    r"?$"
)

_CONSTRAINT_RE = re.compile(r"^\s*(=|!=|>=|<=|>|<|~>)?\s*(.+?)\s*$")


class Version:
    __slots__ = ("segments", "prerelease", "src")

    def __init__(self, segments: list[int], prerelease: str, src: str):
        self.segments = segments
        self.prerelease = prerelease
        self.src = src

    @classmethod
    def parse(cls, s: str) -> Optional["Version"]:
        m = _VERSION_RE.match(s.strip())
        if not m:
            return None
        try:
            segments = [int(x) for x in m.group(1).split(".")]
        except ValueError:
            return None
        # go-version pads to 3 segments for comparison
        while len(segments) < 3:
            segments.append(0)
        pre = m.group(4) or m.group(7) or ""
        return cls(segments, pre, s)

    def _cmp_prerelease(self, other: "Version") -> int:
        a, b = self.prerelease, other.prerelease
        if a == b:
            return 0
        if a == "":
            return 1  # release > prerelease
        if b == "":
            return -1
        for x, y in zip(a.split("."), b.split(".")):
            xn, yn = x.isdigit(), y.isdigit()
            if xn and yn:
                xi, yi = int(x), int(y)
                if xi != yi:
                    return -1 if xi < yi else 1
            elif xn != yn:
                return -1 if xn else 1  # numeric identifiers sort lower
            elif x != y:
                return -1 if x < y else 1
        la, lb = len(a.split(".")), len(b.split("."))
        return 0 if la == lb else (-1 if la < lb else 1)

    def compare(self, other: "Version") -> int:
        n = max(len(self.segments), len(other.segments))
        a = self.segments + [0] * (n - len(self.segments))
        b = other.segments + [0] * (n - len(other.segments))
        if a != b:
            return -1 if a < b else 1
        return self._cmp_prerelease(other)


class Constraints:
    """A parsed conjunction of version constraints."""

    def __init__(self, parts: list[tuple[str, Version, int]]):
        self.parts = parts

    @classmethod
    def parse(cls, s: str) -> Optional["Constraints"]:
        parts = []
        for raw in s.split(","):
            m = _CONSTRAINT_RE.match(raw)
            if not m:
                return None
            op = m.group(1) or "="
            vs = m.group(2)
            v = Version.parse(vs)
            if v is None:
                return None
            # Track the number of segments the user actually wrote, for ~>
            explicit = len(vs.split("-")[0].split("."))
            parts.append((op, v, explicit))
        return cls(parts)

    def check(self, v: Version) -> bool:
        return all(self._check_one(op, c, explicit, v) for op, c, explicit in self.parts)

    @staticmethod
    def _check_one(op: str, c: Version, explicit: int, v: Version) -> bool:
        cmp = v.compare(c)
        if op == "=":
            return cmp == 0
        if op == "!=":
            return cmp != 0
        if op == ">":
            return cmp == 1
        if op == "<":
            return cmp == -1
        if op == ">=":
            return cmp != -1
        if op == "<=":
            return cmp != 1
        if op == "~>":
            # Pessimistic: >= c and the segments before the last explicit one
            # must match (ref go-version constraintPessimistic)
            if v.compare(c) == -1:
                return False
            fixed = max(explicit - 1, 1)
            return v.segments[:fixed] == c.segments[:fixed]
        return False
