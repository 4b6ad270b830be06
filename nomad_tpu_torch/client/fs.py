"""Allocation filesystem operations (ref client fs/logs/exec surface:
command/agent/fs_endpoint.go serving, client_fs_endpoint.go forwarding).

Pure functions over an allocation directory, shared by the agent's local
HTTP handlers and the client's RPC service (the server→client forwarding
path for allocations living on remote nodes)."""

from __future__ import annotations

import os
import subprocess

from ..util import contained_path


def list_dir(alloc_dir: str, path: str) -> list[dict]:
    full = contained_path(alloc_dir, path)
    entries = []
    for name in sorted(os.listdir(full)):
        p = os.path.join(full, name)
        st = os.stat(p)
        entries.append(
            {
                "Name": name,
                "IsDir": os.path.isdir(p),
                "Size": st.st_size,
                "ModTime": int(st.st_mtime),
            }
        )
    return entries


def cat(alloc_dir: str, path: str, offset: int = 0, limit: int = 1 << 20) -> dict:
    full = contained_path(alloc_dir, path)
    size = os.path.getsize(full)
    with open(full, "rb") as f:
        f.seek(offset)
        data = f.read(limit)
    return {
        "Data": data.decode("utf-8", "replace"),
        "Offset": offset + len(data),
        "Size": size,
    }


def logs(
    alloc_dir: str,
    task: str,
    kind: str,
    offset: int = 0,
    origin: str = "start",
    limit: int = 1 << 20,
) -> dict:
    if kind not in ("stdout", "stderr"):
        raise ValueError("type must be stdout or stderr")
    # Rotation (logmon) writes <task>.<kind>.<n>; the surviving files are
    # served as ONE logical stream so a follower's offset cursor crosses
    # rotation boundaries without losing the old file's tail (the frames
    # model of the reference's fs_endpoint.go Logs). Data reaped by
    # max_files ages out of the logical stream from the front.
    from .logmon import rotated_indexes

    log_dir = contained_path(alloc_dir, f"{task}/logs")
    prefix = f"{task}.{kind}."
    indexes = (
        rotated_indexes(log_dir, prefix) if os.path.isdir(log_dir) else []
    )
    if not indexes:
        return {"Data": "", "Offset": 0}
    segments = []  # (path, size) oldest → newest
    total = 0
    for idx in indexes:
        path = os.path.join(log_dir, prefix + str(idx))
        try:
            size = os.path.getsize(path)
        except OSError:
            continue
        segments.append((path, size))
        total += size
    start = max(total - offset, 0) if origin == "end" else min(offset, total)
    chunks = []
    remaining = limit
    position = 0
    for path, size in segments:
        if remaining <= 0:
            break
        seg_start = max(start - position, 0)
        if seg_start < size:
            with open(path, "rb") as f:
                f.seek(seg_start)
                chunks.append(f.read(min(remaining, size - seg_start)))
            remaining -= len(chunks[-1])
        position += size
    data = b"".join(chunks)
    return {
        "Data": data.decode("utf-8", "replace"),
        "Offset": start + len(data),
        "Size": total,
    }


def exec_in(alloc_dir: str, task: str, cmd: list, timeout: float = 30.0) -> dict:
    task_dir = contained_path(alloc_dir, task)
    try:
        proc = subprocess.run(
            cmd, cwd=task_dir, capture_output=True, timeout=timeout
        )
    except subprocess.TimeoutExpired as e:
        return {
            "ExitCode": -1,
            "TimedOut": True,
            "Stdout": (e.stdout or b"").decode("utf-8", "replace"),
            "Stderr": (e.stderr or b"").decode("utf-8", "replace"),
        }
    except (FileNotFoundError, NotADirectoryError, PermissionError) as e:
        raise ValueError(f"exec failed: {e}") from e
    return {
        "ExitCode": proc.returncode,
        "Stdout": proc.stdout.decode("utf-8", "replace"),
        "Stderr": proc.stderr.decode("utf-8", "replace"),
    }


def register_alloc_rpc(rpc_server, client):
    """Alloc lifecycle RPCs on the client's listener — the server→client
    path behind /v1/client/allocation/:id/{restart,signal}
    (ref client_alloc_endpoint.go → client/rpc Allocations.Restart/Signal)."""

    def check(payload):
        secret = client.node.secret_id
        if secret and payload.get("secret") != secret:
            raise ValueError("client RPC requires the node secret")

    def restart(payload):
        check(payload)
        return {
            "tasks": client.alloc_restart(
                payload["alloc_id"], payload.get("task", "")
            )
        }

    def signal(payload):
        check(payload)
        return {
            "tasks": client.alloc_signal(
                payload["alloc_id"],
                payload.get("signal", "SIGINT"),
                payload.get("task", ""),
            )
        }

    def stats(payload):
        check(payload)
        return client.alloc_stats(payload["alloc_id"])

    def host_stats(payload):
        check(payload)
        return client.host_stats()

    def exec_stream(payload, stream):
        """Duplex streaming exec (ref ExecTaskStreaming framing,
        plugins/drivers/proto/driver.proto:72-76,295): stdin frames in,
        stdout/stderr/exit frames out, bridged onto the task's execution
        context by the driver."""
        from .execstream import bridge_exec

        check(payload)
        proc = client.exec_session(
            payload["alloc_id"],
            payload.get("task", ""),
            [str(c) for c in payload.get("cmd", [])],
            tty=bool(payload.get("tty")),
        )
        bridge_exec(proc, stream)

    rpc_server.register("ClientAllocations.Restart", restart)
    rpc_server.register("ClientAllocations.Signal", signal)
    rpc_server.register("ClientAllocations.Stats", stats)
    rpc_server.register("ClientStats.Stats", host_stats)
    rpc_server.register_duplex("ClientAllocations.Exec", exec_stream)


def register_fs_rpc(rpc_server, client):
    """Expose the client's alloc dirs over its RPC listener
    (the server→client reverse path, client_fs_endpoint.go's role)."""

    def alloc_dir(payload) -> str:
        # node-secret auth (the reference authenticates client RPCs with
        # the node's SecretID): the HTTP layer already enforced namespace
        # ACLs and proves it by presenting the secret only servers know
        secret = client.node.secret_id
        if secret and payload.get("secret") != secret:
            raise ValueError("client RPC requires the node secret")
        d = os.path.join(client.data_dir, "allocs", payload["alloc_id"])
        if not os.path.isdir(d):
            raise KeyError(f"alloc dir not found for {payload['alloc_id']}")
        return d

    rpc_server.register(
        "ClientFS.List",
        lambda p: list_dir(alloc_dir(p), p.get("path", "/")),
    )
    rpc_server.register(
        "ClientFS.Cat",
        lambda p: cat(
            alloc_dir(p),
            p.get("path", "/"),
            offset=int(p.get("offset", 0)),
            limit=int(p.get("limit", 1 << 20)),
        ),
    )
    rpc_server.register(
        "ClientFS.Logs",
        lambda p: logs(
            alloc_dir(p),
            p["task"],
            p.get("type", "stdout"),
            offset=int(p.get("offset", 0)),
            origin=p.get("origin", "start"),
            limit=int(p.get("limit", 1 << 20)),
        ),
    )
    def logs_follow(payload):
        """Streaming log follow (ref fs_endpoint.go Logs with follow=true
        over streaming RPC): pushes a frame whenever the logical stream
        grows, for up to ``duration`` seconds (default 60)."""
        import time as time_mod

        base = alloc_dir(payload)
        task = payload["task"]
        kind = payload.get("type", "stdout")
        offset = int(payload.get("offset", 0))
        deadline = time_mod.monotonic() + float(payload.get("duration", 60.0))
        while time_mod.monotonic() < deadline:
            window = logs(base, task, kind, offset=offset, origin="start")
            if window["Data"]:
                offset = window["Offset"]
                yield window
            else:
                time_mod.sleep(0.2)

    rpc_server.register_stream("ClientFS.LogsFollow", logs_follow)
    rpc_server.register(
        "ClientFS.Exec",
        lambda p: exec_in(
            alloc_dir(p),
            p["task"],
            list(p.get("cmd", [])),
            timeout=float(p.get("timeout", 30.0)),
        ),
    )
