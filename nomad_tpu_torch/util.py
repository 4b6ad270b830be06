"""Small shared helpers (the reference's helper/ grab-bag)."""

from __future__ import annotations

import logging
import os
import threading
import time


class LogBuffer(logging.Handler):
    """Ring buffer of recent log records with a monotonically increasing
    index, backing GET /v1/agent/monitor (the reference streams hclog over
    the monitor endpoint, command/agent/monitor/; here clients poll with
    the last index they saw)."""

    def __init__(self, capacity: int = 512):
        super().__init__()
        self.capacity = capacity
        self._records: list[tuple[int, dict]] = []
        self._next = 1
        self._lock = threading.Lock()
        self.setFormatter(
            logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s")
        )

    def emit(self, record: logging.LogRecord):
        try:
            line = self.format(record)
        except Exception:
            return
        entry = {
            "time": time.time(),
            "level": record.levelname,
            "name": record.name,
            "message": line,
        }
        with self._lock:
            self._records.append((self._next, entry))
            self._next += 1
            if len(self._records) > self.capacity:
                del self._records[: len(self._records) - self.capacity]

    def since(self, index: int) -> tuple[list[dict], int]:
        """Entries with index > ``index`` and the new high-water mark."""
        with self._lock:
            out = [e for i, e in self._records if i > index]
            return out, self._next - 1

    _global: "LogBuffer | None" = None

    @classmethod
    def install(cls) -> "LogBuffer":
        """Attach one shared buffer to the nomad_tpu logger tree."""
        if cls._global is None:
            cls._global = cls()
            tree = logging.getLogger("nomad_tpu")
            tree.addHandler(cls._global)
            if tree.level == logging.NOTSET:
                # the root default (WARNING) would drop INFO records
                # before any handler sees them; agents reconfigure via
                # the config system's apply_log_level
                tree.setLevel(logging.INFO)
        return cls._global


def contained_path(base: str, rel: str) -> str:
    """Join ``rel`` under ``base`` and guarantee the result stays inside.

    realpath on both sides: symlinks planted inside the tree (a task
    running ``ln -s / esc``) must not escape; a bare prefix test would also
    accept sibling dirs whose names extend the base. Raises ValueError."""
    base = os.path.realpath(base)
    path = os.path.realpath(os.path.join(base, rel.lstrip("/")))
    if path != base and os.path.commonpath([base, path]) != base:
        raise ValueError(f"path escapes the base directory: {rel}")
    return path
