"""Client durable state (ref client/state/state_database.go:107).

The reference persists alloc documents, per-task runner state, and driver
task handles in BoltDB under the client's data_dir so a restarted client can
restore its runners and reattach to still-running tasks via RecoverTask
(client.go:979 restoreState, driver.proto:35). This is the same store on
sqlite3 (stdlib; single writer, WAL) — one row per alloc, task state, and
driver handle, plus a small meta table carrying the node identity so a
restarted client re-registers as the SAME node instead of orphaning its
allocs on a ghost."""

from __future__ import annotations

import json
import os
import sqlite3
import threading
from typing import Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS meta (
    key TEXT PRIMARY KEY,
    value TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS allocs (
    alloc_id TEXT PRIMARY KEY,
    doc TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS task_states (
    alloc_id TEXT NOT NULL,
    task TEXT NOT NULL,
    doc TEXT NOT NULL,
    PRIMARY KEY (alloc_id, task)
);
CREATE TABLE IF NOT EXISTS driver_handles (
    alloc_id TEXT NOT NULL,
    task TEXT NOT NULL,
    doc TEXT NOT NULL,
    PRIMARY KEY (alloc_id, task)
);
"""


class ClientStateDB:
    """Durable client-local state under ``data_dir/client.db``."""

    def __init__(self, data_dir: str):
        os.makedirs(data_dir, exist_ok=True)
        self.path = os.path.join(data_dir, "client.db")
        self._lock = threading.Lock()
        self.closed = False
        self._db = sqlite3.connect(self.path, check_same_thread=False)
        with self._lock:
            self._db.executescript(_SCHEMA)
            self._db.execute("PRAGMA journal_mode=WAL")
            self._db.commit()

    def close(self):
        with self._lock:
            self.closed = True
            self._db.close()

    # -- meta (node identity) -------------------------------------------
    def get_meta(self, key: str) -> Optional[str]:
        with self._lock:
            row = self._db.execute(
                "SELECT value FROM meta WHERE key = ?", (key,)
            ).fetchone()
        return row[0] if row else None

    def put_meta(self, key: str, value: str):
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO meta (key, value) VALUES (?, ?)",
                (key, value),
            )
            self._db.commit()

    # -- allocs ----------------------------------------------------------
    def put_alloc(self, alloc_dict: dict):
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO allocs (alloc_id, doc) VALUES (?, ?)",
                (alloc_dict["id"], json.dumps(alloc_dict)),
            )
            self._db.commit()

    def get_allocs(self) -> list[dict]:
        with self._lock:
            rows = self._db.execute("SELECT doc FROM allocs").fetchall()
        return [json.loads(r[0]) for r in rows]

    def delete_alloc(self, alloc_id: str):
        """Removes the alloc and everything hanging off it."""
        with self._lock:
            self._db.execute("DELETE FROM allocs WHERE alloc_id = ?", (alloc_id,))
            self._db.execute(
                "DELETE FROM task_states WHERE alloc_id = ?", (alloc_id,)
            )
            self._db.execute(
                "DELETE FROM driver_handles WHERE alloc_id = ?", (alloc_id,)
            )
            self._db.commit()

    def put_alloc_update(self, alloc_dict: dict, task_docs: dict[str, dict]):
        """Alloc doc + all its task-state rows in ONE transaction — the
        hot path on every task state transition."""
        with self._lock:
            alloc_id = alloc_dict["id"]
            self._db.execute(
                "INSERT OR REPLACE INTO allocs (alloc_id, doc) VALUES (?, ?)",
                (alloc_id, json.dumps(alloc_dict)),
            )
            self._db.executemany(
                "INSERT OR REPLACE INTO task_states (alloc_id, task, doc)"
                " VALUES (?, ?, ?)",
                [
                    (alloc_id, task, json.dumps(doc))
                    for task, doc in task_docs.items()
                ],
            )
            self._db.commit()

    # -- task states -----------------------------------------------------
    def put_task_state(self, alloc_id: str, task: str, doc: dict):
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO task_states (alloc_id, task, doc)"
                " VALUES (?, ?, ?)",
                (alloc_id, task, json.dumps(doc)),
            )
            self._db.commit()

    def get_task_states(self, alloc_id: str) -> dict[str, dict]:
        with self._lock:
            rows = self._db.execute(
                "SELECT task, doc FROM task_states WHERE alloc_id = ?",
                (alloc_id,),
            ).fetchall()
        return {task: json.loads(doc) for task, doc in rows}

    # -- driver handles --------------------------------------------------
    def put_driver_handle(self, alloc_id: str, task: str, doc: dict):
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO driver_handles (alloc_id, task, doc)"
                " VALUES (?, ?, ?)",
                (alloc_id, task, json.dumps(doc)),
            )
            self._db.commit()

    def get_driver_handle(self, alloc_id: str, task: str) -> Optional[dict]:
        with self._lock:
            row = self._db.execute(
                "SELECT doc FROM driver_handles WHERE alloc_id = ? AND task = ?",
                (alloc_id, task),
            ).fetchone()
        return json.loads(row[0]) if row else None

    def delete_driver_handle(self, alloc_id: str, task: str):
        with self._lock:
            self._db.execute(
                "DELETE FROM driver_handles WHERE alloc_id = ? AND task = ?",
                (alloc_id, task),
            )
            self._db.commit()
