"""Previous-allocation watcher + ephemeral disk migration (ref
client/allocwatcher/: the upstream_allocs/await-prev hook and the local/
remote disk migrators behind sticky/migrate ephemeral_disk).

A replacement allocation (``previous_allocation`` set) with a sticky or
migrating ephemeral disk waits for its predecessor to go terminal, then
inherits the predecessor's shared ``alloc/`` data: moved directly when the
predecessor ran on this node, or pulled file-by-file through the server's
client-fs forwarding hop when it ran elsewhere (migrate=true)."""

from __future__ import annotations

import logging
import os
import shutil
import time

logger = logging.getLogger("nomad_tpu.client.allocwatcher")

TERMINAL = ("complete", "failed", "lost")


def _prev_terminal(client, prev_id: str) -> bool:
    """Terminal check that prefers the local runner's live state (cheap)
    and falls back to asking a server."""
    runner = client.alloc_runners.get(prev_id)
    if runner is not None:
        return runner.client_status() in TERMINAL
    getter = getattr(client.server, "alloc_get", None)
    if getter is not None:
        doc = getter(prev_id)
    else:
        alloc = client.server.state.alloc_by_id(prev_id)
        doc = None if alloc is None else {"client_status": alloc.client_status}
    if doc is None:
        return True  # GC'd predecessor: nothing to wait for
    return doc.get("client_status") in TERMINAL


def await_previous(client, alloc, tg, timeout: float = 60.0) -> None:
    """Block (bounded) until the previous allocation is terminal, then
    migrate its ephemeral disk when the task group asks for it."""
    prev_id = alloc.previous_allocation
    if not prev_id or tg is None:
        return
    disk = tg.ephemeral_disk
    if not (disk.sticky or disk.migrate):
        return

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if _prev_terminal(client, prev_id):
                break
        except Exception:
            logger.exception("previous-alloc status check failed")
            break
        time.sleep(0.2)

    prev_dir = os.path.join(client.data_dir, "allocs", prev_id, "alloc")
    new_dir = os.path.join(client.data_dir, "allocs", alloc.id, "alloc")
    if os.path.isdir(prev_dir):
        _migrate_local(prev_dir, new_dir)
    elif disk.migrate:
        _migrate_remote(client, prev_id, new_dir)


def _migrate_local(prev_dir: str, new_dir: str) -> None:
    """Move the predecessor's shared dir contents into the new alloc
    (ref allocwatcher local migrator — same node, plain rename)."""
    os.makedirs(new_dir, exist_ok=True)
    for name in os.listdir(prev_dir):
        src = os.path.join(prev_dir, name)
        dst = os.path.join(new_dir, name)
        try:
            if os.path.exists(dst):
                continue
            shutil.move(src, dst)
        except OSError:
            logger.exception("local disk migration of %s failed", name)


def _migrate_remote(client, prev_id: str, new_dir: str) -> None:
    """Pull alloc/ files from the predecessor's node through the server's
    ClientFS forwarding hop (ref allocwatcher remote migrator over the
    streaming FS API)."""
    forward = getattr(client.server, "forward_client_fs", None)
    if forward is None:
        return
    os.makedirs(new_dir, exist_ok=True)

    def pull(rel: str):
        try:
            entries = forward(prev_id, "List", {"path": "alloc/" + rel})
        except Exception:
            logger.exception("remote migration list %r failed", rel)
            return
        for entry in entries:
            name = entry["Name"]
            sub = os.path.join(rel, name) if rel else name
            local = os.path.join(new_dir, sub)
            if entry.get("IsDir"):
                os.makedirs(local, exist_ok=True)
                pull(sub)
                continue
            try:
                chunks = []
                offset = 0
                while True:
                    chunk = forward(
                        prev_id,
                        "Cat",
                        {
                            "path": "alloc/" + sub,
                            "offset": offset,
                            "limit": 1 << 20,
                        },
                    )
                    piece = chunk.get("Data", "")
                    chunks.append(piece)
                    offset = chunk.get("Offset", offset + len(piece))
                    if offset >= chunk.get("Size", 0) or not piece:
                        break
                os.makedirs(os.path.dirname(local), exist_ok=True)
                with open(local, "w") as f:
                    f.write("".join(chunks))
            except Exception:
                logger.exception("remote migration of %s failed", sub)

    pull("")
