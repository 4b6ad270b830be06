"""RPC listener: one TCP port, first-byte protocol select, endpoint
registry, forwarding (ref nomad/rpc.go:170-366).

Protocol RPC_NOMAD serves request/response endpoint calls; RPC_RAFT
serves raft consensus messages on the same port (the reference does the
same single-listener mux). Endpoint handlers are registered as
``"Service.Method" -> callable(payload) -> result``. Handlers raising
``NotLeaderError`` are answered with a structured error carrying the
leader's RPC address so clients can retry there (the reference's
forward-to-leader, rpc.go:433-490, is done client-side by ConnPool or
server-side via ``forward``)."""

from __future__ import annotations

import logging
import socket
import ssl
import threading
from typing import Callable, Optional

from ..core.overload import DeadlineExceeded, ErrOverloaded
from ..raft import NotLeaderError
from .codec import (
    RPC_NOMAD,
    RPC_RAFT,
    RPC_STREAMING,
    ConnectionClosed,
    read_frame,
    write_frame,
)
from .mux import MuxSession, Stream, StreamClosed

logger = logging.getLogger("nomad_tpu.rpc")


class RpcServer:
    #: methods never subject to admission control: shedding heartbeats or
    #: registrations under overload starves node TTLs and converts a load
    #: spike into a false mass-node-down event (the heartbeat-starvation
    #: satellite, tests/test_overload.py). Raft traffic rides a separate
    #: dispatch and is likewise never shed.
    ADMISSION_EXEMPT = frozenset({"Node.UpdateStatus", "Node.Register"})

    def __init__(
        self, bind_addr: str = "127.0.0.1", port: int = 0, tls_context=None
    ):
        #: mTLS server context (helper/tlsutil role); when set, every
        #: accepted connection handshakes and must present a CA-signed cert
        self.tls_context = tls_context
        self.handlers: dict[str, Callable] = {}
        self.stream_handlers: dict[str, Callable] = {}
        self.duplex_handlers: dict[str, Callable] = {}
        self.raft_handlers: dict[str, Callable] = {}
        # maps raft node_id -> rpc "host:port" (fed by config/gossip) so
        # NotLeaderError responses can carry a dialable leader address
        self.server_rpc_addrs: dict[str, str] = {}
        #: live raft voter map accessor (set by ServerAgent.start). The
        #: boot-time server_rpc_addrs seed goes stale — a restarted
        #: joiner boots with an EMPTY map, and hint-less not_leader
        #: answers strand clients on the follower they asked — so hints
        #: fall back to the replicated voter map, which on TCP agents
        #: holds dialable addresses (raft rides the RPC listener).
        self.voters_snapshot = None
        #: optional admission hook (set by ServerAgent when the overload
        #: stanza is configured): ``admission_check(method, payload)``
        #: raises ErrOverloaded to shed the call before any handler work.
        #: ADMISSION_EXEMPT methods bypass it unconditionally.
        self.admission_check: Optional[Callable] = None
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((bind_addr, port))
        self._sock.listen(128)
        self.address = f"{self._sock.getsockname()[0]}:{self._sock.getsockname()[1]}"
        self._running = False
        self._threads: list[threading.Thread] = []
        #: accepted connections still being served; stop() closes them.
        #: Without this a stopped server keeps ANSWERING on connections
        #: accepted before the stop — the mux read loop never checks
        #: _running — so a restarted server (same port, new object)
        #: coexists with a zombie twin that serves clients' CACHED
        #: sessions from its frozen pre-stop raft view. A real process
        #: death closes every socket; a simulated restart must too.
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    def register_stream(self, method: str, handler: Callable):
        """Register a streaming method (ref structs/streaming_rpc.go): the
        handler is a GENERATOR; each yielded item goes out as its own
        frame `[seq, None, {"chunk": item, "more": True}]`, terminated by
        `{"more": False}` (or an error frame). On the multiplexed protocol
        each yield is one stream data frame instead."""
        self.stream_handlers[method] = handler

    def register_duplex(self, method: str, handler: Callable):
        """Register a BIDIRECTIONAL streaming method (the reference's
        ExecTaskStreaming shape, plugins/drivers/proto/driver.proto:72-76):
        ``handler(payload, stream)`` runs on its own thread with a live
        mux Stream — it may recv() input frames (stdin) and send() output
        frames concurrently. Only reachable over the multiplexed
        protocol."""
        self.duplex_handlers[method] = handler

    def register(self, method: str, handler: Callable):
        self.handlers[method] = handler

    def register_raft(self, handlers: dict[str, Callable]):
        self.raft_handlers = dict(handlers)

    def start(self):
        self._running = True
        t = threading.Thread(target=self._accept_loop, daemon=True, name="rpc-accept")
        t.start()
        self._threads.append(t)

    def stop(self):
        self._running = False
        # wake the blocked accept with a throwaway connection so the thread
        # observes _running and exits BEFORE the fd closes: closing under a
        # blocked accept lets the kernel recycle the fd into a NEW listener
        # (a later test/agent on the reused port), and the stale thread then
        # steals — and mis-serves — that listener's connections
        try:
            wake = socket.create_connection(
                self._sock.getsockname(), timeout=1.0
            )
            wake.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=2.0)
        try:
            self._sock.close()
        except OSError:
            pass
        # hang up every in-flight connection: their reader loops unblock
        # with EOF and exit, and clients' cached sessions fail their NEXT
        # open-before-send, which is the one retry ConnPool allows
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
                name="rpc-conn",
            )
            t.start()

    def _serve_conn(self, conn: socket.socket):
        try:
            if self.tls_context is not None:
                # handshake per connection in its own thread, bounded so a
                # plaintext peer can't pin the thread forever; a peer
                # without a CA-signed client cert is rejected here
                conn.settimeout(10.0)
                conn = self.tls_context.wrap_socket(conn, server_side=True)
                conn.settimeout(None)
            # registered AFTER the tls wrap (the wrapped object owns the
            # fd) and re-checked against _running so a conn accepted
            # during stop() can't slip past the hang-up sweep
            with self._conns_lock:
                self._conns.add(conn)
            if not self._running:
                return
            proto = conn.recv(1)
            if not proto:
                return
            if proto[0] == RPC_NOMAD:
                self._serve_rpc(conn, self._dispatch)
            elif proto[0] == RPC_RAFT:
                self._serve_rpc(conn, self._dispatch_raft)
            elif proto[0] == RPC_STREAMING:
                self._serve_mux(conn)
            else:
                logger.warning("unknown rpc protocol byte %r", proto)
        except ssl.SSLError as e:
            # must precede OSError (SSLError subclasses it): rejected
            # handshakes need log evidence for mTLS debugging. Suppressed
            # during shutdown — stop()'s plaintext wake connection would
            # otherwise log a fake handshake failure on every clean exit
            if self._running:
                logger.warning("tls handshake failed: %s", e)
        except (ConnectionClosed, OSError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _serve_rpc(self, conn: socket.socket, dispatch):
        while self._running:
            try:
                seq, method, payload = read_frame(conn)
            except (ConnectionClosed, OSError):
                return
            try:
                stream = self.stream_handlers.get(method)
                if stream is not None and dispatch == self._dispatch:
                    # streaming method: one frame per yielded chunk, then
                    # an end-of-stream marker (streaming_rpc.go framing)
                    for chunk in stream(payload):
                        write_frame(
                            conn, [seq, None, {"chunk": chunk, "more": True}]
                        )
                    write_frame(conn, [seq, None, {"more": False}])
                    continue
                result = dispatch(method, payload)
                write_frame(conn, [seq, None, result])
            except NotLeaderError as e:
                write_frame(
                    conn,
                    [
                        seq,
                        {
                            "code": "not_leader",
                            "message": str(e),
                            "leader_rpc_addr": self._leader_rpc_addr(e),
                        },
                        None,
                    ],
                )
            except ErrOverloaded as e:
                write_frame(
                    conn,
                    [
                        seq,
                        {
                            "code": "overloaded",
                            "message": str(e),
                            "retry_after": getattr(e, "retry_after", 1.0),
                        },
                        None,
                    ],
                )
            except DeadlineExceeded as e:
                write_frame(
                    conn,
                    [
                        seq,
                        {"code": "deadline_exceeded", "message": str(e)},
                        None,
                    ],
                )
            except KeyError as e:
                write_frame(
                    conn, [seq, {"code": "not_found", "message": str(e)}, None]
                )
            except ValueError as e:
                write_frame(
                    conn, [seq, {"code": "invalid", "message": str(e)}, None]
                )
            except Exception as e:
                logger.exception("rpc handler error for %s", method)
                write_frame(
                    conn, [seq, {"code": "internal", "message": str(e)}, None]
                )

    # ------------------------------------------------------------------
    # multiplexed protocol (yamux analog, rpc/mux.py): every RPC —
    # unary, streaming, or duplex — is one logical stream on a shared
    # connection, so client fd count stays flat at cluster scale
    # ------------------------------------------------------------------
    def _serve_mux(self, conn: socket.socket):
        def on_open(stream: Stream, method: str, payload):
            t = threading.Thread(
                target=self._run_mux_stream,
                args=(stream, method, payload),
                daemon=True,
                name=f"mux-{method}",
            )
            t.start()

        session = MuxSession(conn, on_open=on_open)
        # this thread IS the session's reader loop (one thread per conn,
        # same as the legacy protocol; per-stream work runs on on_open
        # threads)
        session._read_loop()

    def _run_mux_stream(self, stream: Stream, method: str, payload):
        try:
            duplex = self.duplex_handlers.get(method)
            if duplex is not None:
                duplex(payload, stream)
                stream.close()
                return
            gen = self.stream_handlers.get(method)
            if gen is not None:
                for chunk in gen(payload):
                    stream.send(chunk)
                stream.close()
                return
            result = self._dispatch(method, payload)
            stream.send(result)
            stream.close()
        except StreamClosed:
            pass
        except Exception as e:
            if not isinstance(
                e,
                (NotLeaderError, KeyError, ValueError,
                 ErrOverloaded, DeadlineExceeded),
            ):
                logger.exception("rpc handler error for %s", method)
            try:
                stream.close(self._error_obj(e))
            except StreamClosed:
                pass

    def _leader_rpc_addr(self, e) -> "Optional[str]":
        """Dialable address for a not_leader hint: the boot-time map
        first, then the live raft voter map (a restarted joiner's boot
        map is empty; the voter map is replicated state). Addresses
        that do not parse as host:port — inmem transports' ``raft-*``
        pseudo-addresses — are withheld: a wrong hint is worse than a
        hint-less answer, which the client retries in place."""
        if e.leader_id and e.leader_id in self.server_rpc_addrs:
            return self.server_rpc_addrs[e.leader_id]
        addr = None
        if e.leader_id and self.voters_snapshot is not None:
            try:
                addr = self.voters_snapshot().get(e.leader_id)
            except Exception:
                addr = None
        addr = addr or e.leader_addr
        if addr and ":" in addr and addr.rsplit(":", 1)[1].isdigit():
            return addr
        return None

    def _error_obj(self, e: Exception) -> dict:
        if isinstance(e, NotLeaderError):
            return {
                "code": "not_leader",
                "message": str(e),
                "leader_rpc_addr": self._leader_rpc_addr(e),
            }
        if isinstance(e, ErrOverloaded):
            return {
                "code": "overloaded",
                "message": str(e),
                "retry_after": getattr(e, "retry_after", 1.0),
            }
        if isinstance(e, DeadlineExceeded):
            return {"code": "deadline_exceeded", "message": str(e)}
        if isinstance(e, KeyError):
            return {"code": "not_found", "message": str(e)}
        if isinstance(e, ValueError):
            return {"code": "invalid", "message": str(e)}
        return {"code": "internal", "message": str(e)}

    def _dispatch(self, method: str, payload):
        handler = self.handlers.get(method)
        if handler is None:
            raise KeyError(f"unknown rpc method: {method}")
        trace_doc = None
        deadline_ns = 0
        if isinstance(payload, dict):
            trace_doc = payload.pop("_trace", None)
            deadline_ns = payload.pop("_deadline", 0) or 0
        if deadline_ns:
            from ..core.overload import deadline_expired

            # refuse-before-work: a call whose deadline already passed in
            # flight gets a terminal deadline_exceeded here instead of
            # consuming handler/broker/raft time nobody is waiting on
            if deadline_expired(deadline_ns):
                raise DeadlineExceeded(
                    f"{method}: deadline exceeded before dispatch",
                    where="rpc",
                )
        if (
            self.admission_check is not None
            and method not in self.ADMISSION_EXEMPT
        ):
            self.admission_check(method, payload)
        if trace_doc is None and not deadline_ns:
            return handler(payload)
        from ..core.overload import deadline_scope
        from ..trace import tracer

        with deadline_scope(deadline_ns):
            if trace_doc is None:
                return handler(payload)
            # wire-propagated trace context: everything the handler does —
            # including eval creation (Server._adopt_eval_trace) — parents
            # under the remote caller's span, so a job submitted over RPC
            # is one tree from the client socket to the device and back
            ctx = tracer.ctx_from_annotation(trace_doc)
            with tracer.activate(ctx):
                with tracer.span(f"rpc.server.{method}"):
                    return handler(payload)

    def _dispatch_raft(self, method: str, payload):
        handler = self.raft_handlers.get(method)
        if handler is None:
            raise KeyError(f"unknown raft rpc: {method}")
        return handler(payload)
