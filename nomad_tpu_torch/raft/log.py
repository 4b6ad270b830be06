"""Durable raft log + stable store (ref: the reference persists its raft
log in raft-boltdb — SURVEY.md §2.9 BoltDB ledger row; dev mode uses an
in-memory store, nomad/server.go:105 raftInmem).

``FileLogStore`` is an append-only record log: each record is
``[u32 length][u32 crc32][msgpack payload]``. Torn tails from a crash are
detected by CRC and truncated on open. Compaction after a snapshot rewrites
the retained suffix into a fresh file. The stable store is a tiny
atomically-rewritten msgpack KV used for currentTerm/votedFor.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from dataclasses import dataclass, field
from typing import Optional

import msgpack

# entry types
CMD = "cmd"  # FSM command: data = (msg_type, payload)
NOOP = "noop"  # leader-establishment barrier entry
CONFIG = "config"  # membership change: data = {"voters": {id: addr}}


@dataclass
class LogEntry:
    index: int
    term: int
    etype: str = CMD
    data: object = None

    def pack(self) -> bytes:
        return msgpack.packb(
            [self.index, self.term, self.etype, self.data], use_bin_type=True
        )

    @classmethod
    def unpack(cls, raw: bytes) -> "LogEntry":
        index, term, etype, data = msgpack.unpackb(raw, raw=False)
        return cls(index=index, term=term, etype=etype, data=data)


class InmemLogStore:
    """Dev-mode / test log store (ref raftInmem, server.go:105)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[int, LogEntry] = {}
        self._first = 0
        self._last = 0

    def first_index(self) -> int:
        return self._first

    def last_index(self) -> int:
        return self._last

    def get(self, index: int) -> Optional[LogEntry]:
        with self._lock:
            return self._entries.get(index)

    def store_entries(self, entries: list[LogEntry]):
        with self._lock:
            for e in entries:
                self._entries[e.index] = e
                if self._first == 0:
                    self._first = e.index
                self._last = max(self._last, e.index)

    def delete_range(self, lo: int, hi: int):
        """Delete entries in [lo, hi] (conflict truncation or compaction)."""
        with self._lock:
            for i in range(lo, hi + 1):
                self._entries.pop(i, None)
            if not self._entries:
                self._first = self._last = 0
            else:
                self._first = min(self._entries)
                self._last = max(self._entries)


_REC_HDR = struct.Struct("<II")  # length, crc32


class FileLogStore:
    """Crash-safe append-only log file with CRC-framed records."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._entries: dict[int, LogEntry] = {}
        self._first = 0
        self._last = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._replay()
        self._f = open(self.path, "ab")

    def _replay(self):
        if not os.path.exists(self.path):
            return
        good = 0
        with open(self.path, "rb") as f:
            while True:
                hdr = f.read(_REC_HDR.size)
                if len(hdr) < _REC_HDR.size:
                    break
                length, crc = _REC_HDR.unpack(hdr)
                payload = f.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    break  # torn tail
                rec = msgpack.unpackb(payload, raw=False)
                if rec[0] == "entry":
                    e = LogEntry.unpack(rec[1])
                    self._entries[e.index] = e
                elif rec[0] == "truncate":  # logical delete_range marker
                    lo, hi = rec[1], rec[2]
                    for i in range(lo, hi + 1):
                        self._entries.pop(i, None)
                good = f.tell()
        # chop a torn tail so future appends are clean
        if os.path.getsize(self.path) > good:
            with open(self.path, "r+b") as f:
                f.truncate(good)
        if self._entries:
            self._first = min(self._entries)
            self._last = max(self._entries)

    def _append_record(self, rec) -> None:
        payload = msgpack.packb(rec, use_bin_type=True)
        self._f.write(_REC_HDR.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)
        self._f.flush()
        os.fsync(self._f.fileno())

    def first_index(self) -> int:
        return self._first

    def last_index(self) -> int:
        return self._last

    def get(self, index: int) -> Optional[LogEntry]:
        with self._lock:
            return self._entries.get(index)

    def store_entries(self, entries: list[LogEntry]):
        with self._lock:
            for e in entries:
                self._append_record(["entry", e.pack()])
                self._entries[e.index] = e
                if self._first == 0:
                    self._first = e.index
                self._last = max(self._last, e.index)

    def delete_range(self, lo: int, hi: int):
        with self._lock:
            self._append_record(["truncate", lo, hi])
            for i in range(lo, hi + 1):
                self._entries.pop(i, None)
            if not self._entries:
                self._first = self._last = 0
            else:
                self._first = min(self._entries)
                self._last = max(self._entries)
            # rewrite when the file is mostly tombstones
            if len(self._entries) * 4 < (hi - lo + 1):
                self._compact_locked()

    def _compact_locked(self):
        tmp = self.path + ".tmp"
        self._f.close()
        with open(tmp, "wb") as f:
            for i in sorted(self._entries):
                payload = msgpack.packb(
                    ["entry", self._entries[i].pack()], use_bin_type=True
                )
                f.write(_REC_HDR.pack(len(payload), zlib.crc32(payload)))
                f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")

    def close(self):
        self._f.close()


class StableStore:
    """Atomically-rewritten msgpack KV for currentTerm/votedFor."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        # nta: ignore[unbounded-cache] WHY: the durable stable store
        # (currentTerm/votedFor); the key set is protocol-fixed
        self._data: dict = {}
        self._lock = threading.Lock()
        if path and os.path.exists(path):
            with open(path, "rb") as f:
                raw = f.read()
            if raw:
                self._data = msgpack.unpackb(raw, raw=False)

    def get(self, key: str, default=None):
        with self._lock:
            return self._data.get(key, default)

    def set(self, key: str, value):
        with self._lock:
            self._data[key] = value
            if self.path:
                tmp = self.path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(msgpack.packb(self._data, use_bin_type=True))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)

    def set_many(self, **kv):
        with self._lock:
            self._data.update(kv)
            if self.path:
                tmp = self.path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(msgpack.packb(self._data, use_bin_type=True))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)


@dataclass
class Snapshot:
    last_index: int
    last_term: int
    data: bytes
    voters: dict = field(default_factory=dict)


class SnapshotStore:
    """Retains the most recent FSM snapshots (ref snapshotsRetained=2,
    server.go:60). ``path=None`` keeps them in memory (dev mode)."""

    RETAIN = 2

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._mem: list[Snapshot] = []
        if path:
            os.makedirs(path, exist_ok=True)

    def save(self, snap: Snapshot):
        if self.path is None:
            self._mem.append(snap)
            self._mem = self._mem[-self.RETAIN:]
            return
        name = f"snap-{snap.last_index:020d}-{snap.last_term:010d}.bin"
        tmp = os.path.join(self.path, name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(
                msgpack.packb(
                    {
                        "last_index": snap.last_index,
                        "last_term": snap.last_term,
                        "voters": snap.voters,
                        "data": snap.data,
                    },
                    use_bin_type=True,
                )
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, name))
        snaps = sorted(os.listdir(self.path))
        for old in snaps[:-self.RETAIN]:
            os.unlink(os.path.join(self.path, old))

    def latest(self) -> Optional[Snapshot]:
        if self.path is None:
            return self._mem[-1] if self._mem else None
        snaps = sorted(
            n for n in os.listdir(self.path) if n.startswith("snap-")
        )
        if not snaps:
            return None
        with open(os.path.join(self.path, snaps[-1]), "rb") as f:
            d = msgpack.unpackb(f.read(), raw=False)
        return Snapshot(
            last_index=d["last_index"],
            last_term=d["last_term"],
            data=d["data"],
            voters=d.get("voters", {}),
        )
