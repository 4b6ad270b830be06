"""Bounded ring trace store with head sampling upstream (span.py) and
tail-based keeps here: the recent-ring evicts oldest-first, but the
slowest-N traces and error/fault traces survive eviction in their own
bounded keeps — the p99 tail and every fault are queryable long after
the storm that produced them scrolled the ring.

All structures are bounded:

- ``_open``: spans of traces still in flight (cap ``max_open`` traces ×
  ``max_spans`` spans each; overflow counts into ``dropped_spans``);
- ``_records``: finished traces, member of one or more keep classes
  (ring / slowest / errors); a record leaves memory when its last keep
  releases it.
"""

from __future__ import annotations

import heapq
import threading
from collections import deque
from typing import Optional


class TraceStore:
    def __init__(self, retain: int = 256, slow_keep: int = 32,
                 error_keep: int = 32, max_open: int = 8192,
                 max_spans: int = 512):
        self.retain = retain
        self.slow_keep = slow_keep
        self.error_keep = error_keep
        self.max_open = max_open
        self.max_spans = max_spans
        self._lock = threading.Lock()
        #: trace_id -> [span dicts] for traces not yet finished
        self._open: dict[str, list] = {}
        #: trace_id -> finished record (membership via the keeps below)
        self._records: dict[str, dict] = {}
        self._ring: deque[str] = deque()
        #: membership sets mirroring the deques: _release runs on every
        #: steady-state finish (each ack evicts one ring entry) and must
        #: not scan 256-entry deques under the store lock
        self._ring_ids: set[str] = set()
        #: min-heap of (duration, trace_id) — the slowest-N keep
        self._slow: list[tuple[float, str]] = []
        self._slow_ids: set[str] = set()
        self._errors: deque[str] = deque()
        self._error_ids: set[str] = set()
        self.counters = {
            "started": 0, "finished": 0, "dropped_spans": 0,
            "evicted": 0, "late_spans": 0,
        }

    def configure(self, retain: int = None, slow_keep: int = None,
                  error_keep: int = None):
        with self._lock:
            if retain is not None:
                self.retain = retain
            if slow_keep is not None:
                self.slow_keep = slow_keep
            if error_keep is not None:
                self.error_keep = error_keep

    # ------------------------------------------------------------------
    def open_trace(self, trace_id: str):
        with self._lock:
            if trace_id in self._open:
                return
            if len(self._open) >= self.max_open:
                # oldest-open eviction: a trace that never finishes
                # (crashed worker, lost eval) must not pin memory
                victim = next(iter(self._open))
                del self._open[victim]
                self.counters["evicted"] += 1
            self._open[trace_id] = []
            self.counters["started"] += 1

    def add_span(self, span: dict):
        trace_id = span.get("trace_id")
        with self._lock:
            spans = self._open.get(trace_id)
            if spans is None:
                record = self._records.get(trace_id)
                if record is not None:
                    # late span on a retained trace (mirror patches land
                    # after the ack): still part of the tree
                    if len(record["spans"]) < self.max_spans:
                        record["spans"].append(span)
                        self.counters["late_spans"] += 1
                    else:
                        self.counters["dropped_spans"] += 1
                else:
                    self.counters["dropped_spans"] += 1
                return
            if len(spans) >= self.max_spans:
                self.counters["dropped_spans"] += 1
                return
            spans.append(span)

    def finish_trace(self, trace_id: str, root: dict) -> Optional[dict]:
        with self._lock:
            spans = self._open.pop(trace_id, None)
            if spans is None:
                return None
            spans.append(root)
            has_error = any(s.get("error") for s in spans)
            record = {
                "trace_id": trace_id,
                "root": root.get("name"),
                "start": root.get("start"),
                "duration_ms": root.get("duration_ms", 0.0),
                "error": bool(has_error),
                "spans": spans,
            }
            self._records[trace_id] = record
            self.counters["finished"] += 1

            self._ring.append(trace_id)
            self._ring_ids.add(trace_id)
            if len(self._ring) > self.retain:
                victim = self._ring.popleft()
                self._ring_ids.discard(victim)
                self._release(victim)

            duration = record["duration_ms"]
            if self.slow_keep > 0:
                heapq.heappush(self._slow, (duration, trace_id))
                self._slow_ids.add(trace_id)
                while len(self._slow) > self.slow_keep:
                    _, victim = heapq.heappop(self._slow)
                    self._slow_ids.discard(victim)
                    self._release(victim)

            if has_error and self.error_keep > 0:
                self._errors.append(trace_id)
                self._error_ids.add(trace_id)
                if len(self._errors) > self.error_keep:
                    victim = self._errors.popleft()
                    self._error_ids.discard(victim)
                    self._release(victim)
            return record

    def drop_trace(self, trace_id: str):
        """Abandon an in-flight trace (broker flush)."""
        with self._lock:
            self._open.pop(trace_id, None)

    def _release(self, trace_id: str):
        """Drop the record unless some keep still holds it (the caller
        already removed the id from ITS OWN keep's membership set). Must
        hold the lock. O(1): set lookups only."""
        if (
            trace_id in self._ring_ids
            or trace_id in self._slow_ids
            or trace_id in self._error_ids
        ):
            return
        if self._records.pop(trace_id, None) is not None:
            self.counters["evicted"] += 1

    # ------------------------------------------------------------------
    def knows(self, trace_id: str) -> bool:
        """Whether this store is tracking the trace (open or retained).
        Cross-node span sources (the FSM's raft annotation) check this
        so a FOLLOWER — whose store never opened the leader-minted
        trace — skips recording instead of inflating dropped_spans."""
        with self._lock:
            return trace_id in self._open or trace_id in self._records

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            record = self._records.get(trace_id)
            if record is not None:
                return {**record, "spans": list(record["spans"])}
            spans = self._open.get(trace_id)
            if spans is not None:
                return {
                    "trace_id": trace_id, "root": None, "start": None,
                    "duration_ms": None, "error": False, "open": True,
                    "spans": list(spans),
                }
            return None

    def records(self) -> list[dict]:
        """Every retained finished trace (the critical-path analyzer's
        input)."""
        with self._lock:
            return [
                {**r, "spans": list(r["spans"])}
                for r in self._records.values()
            ]

    def list(self, limit: int = 50, slowest: bool = False,
             errors: bool = False) -> list[dict]:
        with self._lock:
            if errors:
                ids = list(self._errors)[-limit:]
            elif slowest:
                ids = [
                    tid for _, tid in
                    sorted(self._slow, key=lambda e: -e[0])[:limit]
                ]
            else:
                ids = list(self._ring)[-limit:][::-1]
            out = []
            for tid in ids:
                r = self._records.get(tid)
                if r is None:
                    continue
                out.append({
                    "trace_id": tid,
                    "root": r["root"],
                    "start": r["start"],
                    "duration_ms": r["duration_ms"],
                    "error": r["error"],
                    "spans": len(r["spans"]),
                })
            return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "retained": len(self._records),
                "ring": len(self._ring),
                "slowest_kept": len(self._slow_ids),
                "errors_kept": len(self._errors),
                "open": len(self._open),
                "open_spans": sum(len(s) for s in self._open.values()),
                **self.counters,
            }

    def reset(self):
        with self._lock:
            self._open.clear()
            self._records.clear()
            self._ring.clear()
            self._ring_ids.clear()
            self._error_ids.clear()
            self._slow = []
            self._slow_ids.clear()
            self._errors.clear()
            for k in self.counters:
                self.counters[k] = 0
