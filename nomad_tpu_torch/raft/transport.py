"""Raft transport abstraction.

``InmemTransport`` wires raft nodes together inside one process — the
equivalent of the reference's in-process multi-server test clusters
(nomad/testing.go TestServer + TestJoin, SURVEY.md §4.2). The TCP
transport lives in nomad_tpu.rpc and registers the same three handler
entry points behind the RPC_RAFT first-byte protocol.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..testing import faults as _faults


class Transport:
    """Point-to-point RPCs a raft node sends to its peers. ``target`` is
    the peer's address (transport-specific)."""

    def request_vote(self, target: str, req: dict) -> dict:
        raise NotImplementedError

    def append_entries(self, target: str, req: dict) -> dict:
        raise NotImplementedError

    def install_snapshot(self, target: str, req: dict) -> dict:
        raise NotImplementedError

    # the local raft node registers its handlers here
    def register(self, address: str, handlers: dict[str, Callable]):
        raise NotImplementedError


class InmemTransport(Transport):
    """Shared-registry transport for in-process clusters. A registry maps
    address → handler table; partitions are simulated by disconnecting
    addresses."""

    def __init__(self, registry: Optional[dict] = None):
        self.registry = registry if registry is not None else {}
        self._lock = threading.Lock()
        self._disconnected: set[str] = set()

    def register(self, address: str, handlers: dict[str, Callable]):
        with self._lock:
            self.registry[address] = handlers

    def disconnect(self, address: str):
        """Simulate a partition of ``address`` from everyone."""
        with self._lock:
            self._disconnected.add(address)

    def reconnect(self, address: str):
        with self._lock:
            self._disconnected.discard(address)

    def _call(self, target: str, method: str, req: dict) -> dict:
        with self._lock:
            if target in self._disconnected or req.get("_from") in self._disconnected:
                raise ConnectionError(f"{target} is partitioned")
            handlers = self.registry.get(target)
        if handlers is None:
            raise ConnectionError(f"no raft node at {target}")
        plane = _faults.ACTIVE
        if plane is not None:
            act = plane.on_raft(req.get("_from") or "", target, method)
            if act in ("drop", "sever"):
                raise ConnectionError(f"injected {act}: {target} {method}")
            if act == "duplicate":
                # deliver twice (duplicated datagram); the handler must be
                # idempotent per raft's term/index rules
                handlers[method](req)
        return handlers[method](req)

    def request_vote(self, target: str, req: dict) -> dict:
        return self._call(target, "request_vote", req)

    def append_entries(self, target: str, req: dict) -> dict:
        return self._call(target, "append_entries", req)

    def install_snapshot(self, target: str, req: dict) -> dict:
        return self._call(target, "install_snapshot", req)
