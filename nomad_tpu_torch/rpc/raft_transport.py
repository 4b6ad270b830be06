"""Raft transport over the shared RPC listener (ref: the reference's raft
rides the same TCP mux behind the RpcRaft first byte, rpc.go:195-200).
"""

from __future__ import annotations

import itertools
import socket
import threading
from typing import Callable, Optional

from ..raft.transport import Transport
from ..testing import faults as _faults
from .codec import RPC_RAFT, ConnectionClosed, read_frame, write_frame


class _RaftConn:
    def __init__(self, addr: str, timeout: float, tls_context=None):
        host, port = addr.rsplit(":", 1)
        self.sock = socket.create_connection((host, int(port)), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if tls_context is not None:
            self.sock = tls_context.wrap_socket(self.sock)
        self.sock.sendall(bytes([RPC_RAFT]))
        self.lock = threading.Lock()
        self.seq = itertools.count(1)

    def call(self, method: str, payload):
        with self.lock:
            seq = next(self.seq)
            write_frame(self.sock, [seq, method, payload])
            # nta: ignore[lock-held-blocking-call] — the per-conn lock IS
            # the request/response framing: one RPC in flight per socket,
            # concurrent callers use their own conns (transport pool)
            rseq, error, result = read_frame(self.sock)
            if error is not None:
                raise ConnectionError(f"raft rpc error: {error}")
            return result

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class TcpRaftTransport(Transport):
    """Dials peers' RPC listeners with the raft protocol byte. The local
    node's handlers are registered onto its RpcServer (register())."""

    def __init__(self, rpc_server=None, timeout: float = 5.0, tls_context=None):
        self.rpc_server = rpc_server
        self.timeout = timeout
        self.tls_context = tls_context
        self._conns: dict[str, _RaftConn] = {}
        self._lock = threading.Lock()

    def register(self, address: str, handlers: dict[str, Callable]):
        if self.rpc_server is not None:
            self.rpc_server.register_raft(handlers)

    def _conn(self, target: str) -> _RaftConn:
        with self._lock:
            c = self._conns.get(target)
            if c is not None:
                return c
            c = _RaftConn(target, self.timeout, tls_context=self.tls_context)
            self._conns[target] = c
            return c

    def _call(self, target: str, method: str, req: dict):
        plane = _faults.ACTIVE
        if plane is not None:
            act = plane.on_raft(req.get("_from") or "", target, method)
            if act in ("drop", "sever"):
                if act == "sever":
                    with self._lock:
                        c = self._conns.pop(target, None)
                    if c is not None:
                        c.close()
                raise ConnectionError(f"injected {act}: {target} {method}")
        req = {k: v for k, v in req.items() if k != "_from"}
        try:
            return self._conn(target).call(method, req)
        except (ConnectionClosed, ConnectionError, OSError) as e:
            with self._lock:
                c = self._conns.pop(target, None)
            if c is not None:
                c.close()
            raise ConnectionError(f"raft rpc to {target} failed: {e}")

    def request_vote(self, target: str, req: dict) -> dict:
        return self._call(target, "request_vote", req)

    def append_entries(self, target: str, req: dict) -> dict:
        return self._call(target, "append_entries", req)

    def install_snapshot(self, target: str, req: dict) -> dict:
        return self._call(target, "install_snapshot", req)

    def close(self):
        with self._lock:
            for c in self._conns.values():
                c.close()
            self._conns.clear()
