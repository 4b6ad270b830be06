"""Pooled RPC client + the typed server proxy (ref helper/pool/pool.go
conn pooling and api/ typed client).

``ConnPool.call`` retries once on a not_leader error by re-dialing the
leader address the error carries — the follower→leader forwarding model
(the reference forwards server-side, rpc.go:433; doing it client-side
keeps the wire format trivial and the hop count identical).

A per-address circuit breaker quarantines peers whose connections keep
failing (severed/partitioned servers): after ``circuit_threshold``
consecutive connection-class failures the address fails fast with a
``circuit_open`` error for ``circuit_cooldown`` seconds instead of
re-dialing in a hot loop (the reference reaches the same outcome through
its server manager's failure-ranked rebalancing, client/servers/
manager.go).

``ServerProxy`` exposes the same method surface as ``core.Server`` so the
node agent (client/client.py) works identically in-process or over TCP.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional

from .. import metrics
from ..testing import faults as _faults


class RpcError(Exception):
    def __init__(self, code: str, message: str, leader_rpc_addr: Optional[str] = None,
                 retry_after: Optional[float] = None):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message
        self.leader_rpc_addr = leader_rpc_addr
        #: server-supplied pacing hint, set on code == "overloaded": how
        #: long the caller should wait before resubmitting shed work
        self.retry_after = retry_after


class ConnPool:
    """ONE multiplexed session per server address (the yamux-analog pool,
    ref helper/pool + nomad/rpc.go:243): every concurrent call — unary,
    streaming, or duplex — is a logical stream on the shared connection,
    so the process holds one socket per peer regardless of in-flight call
    count. Dead sessions are replaced on next use."""

    #: consecutive connection-class failures before the circuit opens
    CIRCUIT_THRESHOLD = 3
    #: seconds a tripped address fails fast before a probe dial is allowed
    CIRCUIT_COOLDOWN = 5.0
    #: total attempts a call may spend chasing a moving leader: a
    #: not_leader WITH a hint hops to the hinted address; one WITHOUT a
    #: hint means an election is in flight — back off and re-ask the same
    #: server, which answers with the new leader once a quorum knows it
    LEADER_RETRIES = 6
    LEADER_BACKOFF_BASE = 0.02
    LEADER_BACKOFF_MAX = 0.25

    def __init__(self, timeout: float = 10.0, tls_context=None, name: str = "",
                 circuit_threshold: Optional[int] = None,
                 circuit_cooldown: Optional[float] = None):
        self.timeout = timeout
        self.tls_context = tls_context
        #: identity reported to the fault plane as the call source
        self.name = name
        self.circuit_threshold = (
            circuit_threshold
            if circuit_threshold is not None
            else self.CIRCUIT_THRESHOLD
        )
        self.circuit_cooldown = (
            circuit_cooldown
            if circuit_cooldown is not None
            else self.CIRCUIT_COOLDOWN
        )
        self._sessions: dict[str, "MuxSession"] = {}
        # addr -> [consecutive_failures, open_until_monotonic]
        self._circuit: dict[str, list] = {}
        self._lock = threading.Lock()

    # -- circuit breaker -----------------------------------------------
    def _circuit_check(self, addr: str):
        """Fail fast while ``addr``'s circuit is open; past the cooldown
        the next call probes the address again (half-open)."""
        with self._lock:
            entry = self._circuit.get(addr)
            if entry is not None and entry[1] > time.monotonic():
                raise RpcError(
                    "circuit_open",
                    f"{addr}: quarantined after {entry[0]} connection failures",
                )

    def _circuit_record(self, addr: str, ok: bool):
        with self._lock:
            if ok:
                self._circuit.pop(addr, None)
                return
            entry = self._circuit.setdefault(addr, [0, 0.0])
            entry[0] += 1
            if entry[0] >= self.circuit_threshold:
                entry[1] = time.monotonic() + self.circuit_cooldown
                metrics.incr("rpc.circuit_open")

    def circuit_state(self, addr: str) -> dict:
        """Observability/test hook: {failures, open} for ``addr``."""
        with self._lock:
            entry = self._circuit.get(addr)
            return {
                "failures": entry[0] if entry else 0,
                "open": bool(entry and entry[1] > time.monotonic()),
            }

    def _sever(self, addr: str):
        """Kill the cached session to ``addr`` as if the transport failed
        (the fault plane's sever action; every in-flight stream errors)."""
        with self._lock:
            sess = self._sessions.pop(addr, None)
        if sess is not None:
            sess.inject_failure()

    def _inject(self, addr: str, method: str, duplicable: bool = True) -> bool:
        """Consult the fault plane; returns True when the call must be
        duplicated. Raises RpcError for drop/sever — which feed the
        circuit breaker like any real connection failure, so simulated
        partitions trip it exactly as a dead peer would. Seams that
        cannot honor duplication (streams) pass ``duplicable=False`` and
        duplicate rules are skipped without a false trip."""
        plane = _faults.ACTIVE
        if plane is None:
            return False
        # an open circuit short-circuits BEFORE the injected network: the
        # client never dials, so simulated faults can't fire either
        self._circuit_check(addr)
        act = plane.on_rpc(
            self.name, addr, method,
            exclude=() if duplicable else ("duplicate",),
        )
        if act == "drop":
            self._circuit_record(addr, ok=False)
            raise RpcError("connection", f"{addr}: {method}: injected drop")
        if act == "sever":
            self._sever(addr)
            self._circuit_record(addr, ok=False)
            raise RpcError("connection", f"{addr}: {method}: injected sever")
        return act == "duplicate"

    def _session(self, addr: str):
        """→ (session, cached): a cached session may have died since its
        last use; callers retry once on a fresh one when opening fails.
        The dial (and TLS handshake) happens OUTSIDE the pool lock — one
        unreachable server must not stall calls to every other address."""
        from .codec import RPC_STREAMING
        from .mux import MuxSession

        with self._lock:
            sess = self._sessions.get(addr)
            if sess is not None and not sess.dead:
                return sess, True
        host, port = addr.rsplit(":", 1)
        sock = socket.create_connection(
            (host, int(port)), timeout=self.timeout
        )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self.tls_context is not None:
            sock = self.tls_context.wrap_socket(sock)
        sock.sendall(bytes([RPC_STREAMING]))
        sess = MuxSession(sock).start()
        with self._lock:
            racer = self._sessions.get(addr)
            if racer is not None and not racer.dead:
                # another thread dialed first; one session per addr wins
                sess.close()
                return racer, True
            self._sessions[addr] = sess
            return sess, False

    def _open(self, addr: str, method: str, payload, retry_stale: bool):
        """Open a stream, retrying once on a fresh session if the cached
        one died — safe because a failed open means the request frame
        never reached the server whole. Checks the circuit breaker first
        and records connection-class outcomes into it."""
        from .mux import StreamClosed

        self._circuit_check(addr)
        try:
            sess, cached = self._session(addr)
        except OSError as e:
            self._circuit_record(addr, ok=False)
            raise RpcError("connect", f"{addr}: {e}")
        try:
            stream = sess.open(method, payload)
        except StreamClosed:
            with self._lock:
                if self._sessions.get(addr) is sess:
                    del self._sessions[addr]
            if cached and retry_stale:
                return self._open(addr, method, payload, retry_stale=False)
            self._circuit_record(addr, ok=False)
            raise RpcError("connection", f"{addr}: session closed")
        self._circuit_record(addr, ok=True)
        return stream

    @staticmethod
    def _rpc_error(err: dict) -> RpcError:
        return RpcError(
            err.get("code", "error"),
            err.get("message", ""),
            err.get("leader_rpc_addr"),
            retry_after=err.get("retry_after"),
        )

    def call(
        self,
        addr: str,
        method: str,
        payload,
        timeout: Optional[float] = None,
        retry_leader: bool = True,
        retry_stale: bool = True,
    ):
        """One RPC. On a not_leader error the call chases the leader for
        up to ``LEADER_RETRIES`` attempts with exponential backoff: a
        hinted error hops straight to the hinted address; a hint-less one
        (election in flight — the old leader just died) backs off and
        re-asks, so losing the remote leader mid-call converges on the
        re-elected leader instead of surfacing a transient error to the
        submitter. Retrying not_leader is always safe: it is an explicit
        handler answer, so the write was refused, not applied. A dead
        cached session retries once on a fresh one — but ONLY when the
        open failed to send, so the server cannot have executed the call.
        Failures after the request was flushed — including a timeout,
        where the handler may still be running — are never retried:
        re-sending would duplicate a non-idempotent write."""
        from ..trace import tracer
        from ..core import overload as _overload

        ctx = tracer.current()
        if (
            ctx is not None
            and ctx.sampled
            and isinstance(payload, dict)
            and "_trace" not in payload
        ):
            # trace-context propagation: the handler side re-activates
            # this so server-side spans parent under the caller's span.
            # Copied, never mutated in place — the caller may retry the
            # same payload object through another pool
            payload = {**payload, "_trace": ctx.to_dict()}
        deadline_ns = _overload.current_deadline()
        if (
            deadline_ns
            and isinstance(payload, dict)
            and "_deadline" not in payload
        ):
            # deadline propagation (the _trace pattern, core/overload.py):
            # the handler side re-activates it so the server — and any
            # eval/plan minted there — inherits the caller's deadline
            payload = {**payload, "_deadline": deadline_ns}
        with tracer.span(f"rpc.{method}", tags={"addr": addr}):
            return self._call_inner(
                addr, method, payload, timeout, retry_leader, retry_stale
            )

    def _call_inner(
        self, addr, method, payload, timeout, retry_leader, retry_stale
    ):
        from ..core.overload import retry_budget

        attempts = self.LEADER_RETRIES if retry_leader else 1
        origin = addr
        last_err = None
        for attempt in range(attempts):
            if attempt:
                # every RETRY (not the first attempt) spends a token from
                # the process-wide retry budget: when many ladders chase
                # a dead leader at once, the budget — not the product of
                # their individual limits — bounds total retry volume
                # (core/overload.py, the metastable-retry-storm guard)
                if not retry_budget().try_acquire():
                    metrics.incr("rpc.retry_budget_exhausted")
                    raise last_err
                # backoff before the next hop: a hint that points at a
                # just-severed peer (or a hint-less mid-election answer)
                # otherwise hot-loops through the circuit breaker
                time.sleep(
                    min(
                        self.LEADER_BACKOFF_BASE * (2 ** (attempt - 1)),
                        self.LEADER_BACKOFF_MAX,
                    )
                )
            try:
                return self._call_once(addr, method, payload, timeout,
                                       retry_stale)
            except RpcError as err:
                if attempts == 1:
                    raise
                if err.code == "not_leader":
                    last_err = err
                    metrics.incr("rpc.not_leader_retry")
                    if err.leader_rpc_addr:
                        addr = err.leader_rpc_addr
                    # no hint: election in flight — re-ask the same
                    # address, which answers with the new leader once a
                    # quorum knows it
                    continue
                if addr != origin and err.code in ("connect", "circuit_open"):
                    # the HINTED leader is unreachable — likely the very
                    # server whose death caused the election. Both codes
                    # are raised strictly before the request is sent, so
                    # falling back to the origin cannot double-apply
                    last_err = err
                    metrics.incr("rpc.leader_hop_unreachable")
                    addr = origin
                    continue
                raise
        raise last_err

    def _call_once(self, addr, method, payload, timeout, retry_stale):
        from .mux import StreamClosed, StreamError

        duplicate = self._inject(addr, method)
        stream = self._open(addr, method, payload, retry_stale)
        try:
            result = stream.recv(timeout=timeout or self.timeout)
            stream.close()
            if duplicate:
                # fault plane: deliver the request a second time (at-least-
                # once transport semantics); the duplicate's outcome is
                # discarded like a lost response would be
                try:
                    dup = self._open(addr, method, payload, retry_stale=False)
                    dup.recv(timeout=timeout or self.timeout)
                    dup.close()
                except (RpcError, StreamError, StreamClosed, TimeoutError):
                    pass
            return result
        except StreamError as e:
            stream.close()
            raise self._rpc_error(e.error)
        except TimeoutError:
            stream.close()
            raise RpcError("timeout", f"{addr}: {method}: timed out")
        except StreamClosed:
            stream.close()  # release the local stream record
            self._circuit_record(addr, ok=False)
            raise RpcError("connection", f"{addr}: stream closed")

    def call_stream(self, addr: str, method: str, payload,
                    timeout: Optional[float] = None):
        """Streaming RPC: yields chunk frames until end of stream. Rides
        the shared session — other calls proceed concurrently."""
        from .mux import StreamClosed, StreamError

        self._inject(addr, method, duplicable=False)
        stream = self._open(addr, method, payload, retry_stale=True)
        try:
            while True:
                try:
                    yield stream.recv(timeout=timeout or self.timeout)
                except StreamClosed:
                    return
                except StreamError as e:
                    raise self._rpc_error(e.error)
                except TimeoutError:
                    raise RpcError("timeout", f"{addr}: {method}: timed out")
        finally:
            stream.close()

    def call_duplex(self, addr: str, method: str, payload):
        """Open a BIDIRECTIONAL stream (the exec path): returns the live
        mux Stream; the caller drives send()/recv()/close()."""
        self._inject(addr, method, duplicable=False)
        return self._open(addr, method, payload, retry_stale=True)

    def close(self):
        with self._lock:
            for sess in self._sessions.values():
                sess.close()
            self._sessions.clear()


class ServerProxy:
    """RPC-backed stand-in for core.Server: the node agent's view of the
    cluster (ref client/rpc.go + client/servers/ server manager).

    Maintains a server list; each call tries the current server and
    rotates on connection failure (ref client/servers/manager.go)."""

    def __init__(self, servers: list[str], pool: Optional[ConnPool] = None,
                 max_retries: int = 3):
        if not servers:
            raise ValueError("at least one server address required")
        self.servers = list(servers)
        self.pool = pool or ConnPool()
        self.max_retries = max_retries
        self._lock = threading.Lock()
        self._current = 0

    def set_servers(self, servers: list[str]):
        with self._lock:
            self.servers = list(servers)
            self._current = 0

    #: rotation backoff: base * 2^attempt, capped (manager.go's failure
    #: backoff; nonzero from the FIRST failure so a severed cluster is
    #: polled, not hammered)
    RETRY_BACKOFF_BASE = 0.05
    RETRY_BACKOFF_MAX = 1.0

    def _call(self, method: str, payload, timeout: Optional[float] = None):
        from ..core.overload import retry_budget

        last_err = None
        for attempt in range(self.max_retries):
            with self._lock:
                addr = self.servers[self._current % len(self.servers)]
            try:
                return self.pool.call(addr, method, payload, timeout=timeout)
            except RpcError as e:
                if e.code in (
                    "connect", "connection", "not_leader", "circuit_open"
                ):
                    # rotate to the next server (manager.go
                    # NotifyFailedServer); a circuit_open peer costs no
                    # dial, so the sleep is what paces the loop
                    with self._lock:
                        self._current += 1
                    last_err = e
                    if attempt + 1 < self.max_retries:
                        # a rotation retry rides the process-wide retry
                        # budget too (core/overload.py): fail fast with
                        # the last error once the bucket is dry
                        if not retry_budget().try_acquire():
                            metrics.incr("rpc.retry_budget_exhausted")
                            raise last_err
                        time.sleep(
                            min(
                                self.RETRY_BACKOFF_BASE * (2 ** attempt),
                                self.RETRY_BACKOFF_MAX,
                            )
                        )
                    continue
                raise
        raise last_err

    # ------------------------------------------------------------------
    # the node-agent surface (mirrors core.Server methods)
    # ------------------------------------------------------------------
    def node_register(self, node) -> dict:
        return self._call("Node.Register", {"node": node.to_dict()})

    def derive_vault_token(self, alloc_id: str, task: str) -> str:
        """ref node_endpoint.go DeriveVaultToken (client→server RPC)."""
        return self._call(
            "Node.DeriveVaultToken", {"alloc_id": alloc_id, "task": task}
        )

    def node_heartbeat(self, node_id: str) -> dict:
        return self._call("Node.UpdateStatus", {"node_id": node_id, "heartbeat": True})

    def node_update_status(self, node_id: str, status: str) -> dict:
        return self._call(
            "Node.UpdateStatus", {"node_id": node_id, "status": status}
        )

    def node_drain(
        self, node_id: str, drain: bool, deadline_ns: int = 0,
        mark_eligible: bool | None = None,
    ) -> dict:
        return self._call(
            "Node.Drain",
            {
                "node_id": node_id,
                "drain": drain,
                "deadline_ns": deadline_ns,
                "mark_eligible": mark_eligible,
            },
        )

    def node_update_eligibility(self, node_id: str, eligibility: str) -> dict:
        return self._call(
            "Node.Eligibility",
            {"node_id": node_id, "eligibility": eligibility},
        )

    def get_client_allocs(self, node_id: str, min_index: int = 0, timeout: float = 30.0):
        resp = self._call(
            "Node.GetClientAllocs",
            {"node_id": node_id, "min_index": min_index, "timeout": timeout},
            timeout=timeout + 10.0,
        )
        from ..structs.model import Allocation

        return (
            [Allocation.from_dict(d) for d in resp["allocs"]],
            resp["index"],
        )

    def update_allocs(self, allocs) -> None:
        self._call(
            "Node.UpdateAlloc", {"allocs": [a.to_dict() for a in allocs]}
        )

    def alloc_get(self, alloc_id: str):
        return self._call("Alloc.GetAlloc", {"alloc_id": alloc_id})["alloc"]

    def catalog_service(self, name: str) -> list[dict]:
        return self._call("Catalog.Service", {"name": name})["entries"]

    def forward_client_fs(self, alloc_id: str, method: str, params: dict):
        return self._call(
            "ClientFS.Forward",
            {"alloc_id": alloc_id, "method": method, "params": params},
            timeout=45.0,
        )

    # job/eval/etc. surface used by the HTTP API & CLI when remote
    def job_register(self, job) -> str:
        return self._call("Job.Register", {"job": job.to_dict()})

    def job_deregister(self, namespace: str, job_id: str, purge: bool = False) -> str:
        return self._call(
            "Job.Deregister",
            {"namespace": namespace, "job_id": job_id, "purge": purge},
        )
