"""Stream-multiplexed RPC session — the yamux analog (ref nomad/rpc.go:27,
243: the reference runs a yamux session per connection and serves every RPC,
streaming or not, as its own logical stream).

One TCP connection carries any number of concurrent logical streams, so a
10K-node cluster needs one socket per (client, server) pair instead of one
per in-flight call. Frames are msgpack arrays on the shared framed codec:

    ["o", sid, method, payload]   open stream (request header)
    ["d", sid, obj]               data frame (either direction)
    ["w", sid, n]                 window grant: n more data frames may be sent
    ["e", sid, error|None]        half-close sender's direction (error ends both)

Flow control is yamux-style credit windows at frame granularity: each
direction starts with ``WINDOW`` credits; a data frame consumes one, and the
consumer grants credit back as it drains its queue (``Stream.recv``). A
sender with no credit blocks — backpressure propagates to the producer
instead of ballooning buffers (yamux's receive-window contract).

The session is symmetric; only stream-ID parity differs (opener uses odd
IDs server-side even — here the dialer opens all streams, IDs just count
up). ``MuxSession`` is used by ConnPool (dial side) and RpcServer (accept
side, protocol byte RPC_STREAMING).
"""

from __future__ import annotations

import itertools
import socket
import threading
from typing import Callable, Optional

from .codec import ConnectionClosed, read_frame, write_frame

#: per-direction, per-stream window in frames (yamux defaults to 256KB of
#: bytes; frames here are bounded by MAX_FRAME so a frame count is the
#: simpler equivalent)
WINDOW = 64
#: grant credit back once this many frames have been consumed
GRANT_AT = WINDOW // 2
#: socket-level send bound: a peer that stops draining (SIGSTOP, blackhole
#: with an open window) wedges sendall once the TCP buffer fills; after
#: this many seconds the session is declared dead so every caller fails
#: fast instead of hanging on the shared writer lock (yamux's
#: ConnectionWriteTimeout role)
SEND_TIMEOUT = 30.0


class StreamClosed(Exception):
    """The peer closed the stream (or the session died)."""


class StreamError(Exception):
    """The peer ended the stream with an error object."""

    def __init__(self, error: dict):
        super().__init__(str(error.get("message", error)))
        self.error = error or {}


_END = object()  # in-queue sentinel: peer half-closed


class Stream:
    """One logical bidirectional stream within a session."""

    def __init__(self, session: "MuxSession", sid: int):
        self.session = session
        self.sid = sid
        self._in: list = []
        self._in_cv = threading.Condition()
        self._consumed = 0
        self._credit = WINDOW
        self._credit_cv = threading.Condition()
        self._peer_closed = False  # peer finished SENDING (half-close)
        self._peer_error = False  # peer ended with an error (reset)
        self._local_closed = False
        self._error: Optional[dict] = None

    # -- receive -------------------------------------------------------
    def _deliver(self, obj):
        with self._in_cv:
            self._in.append(obj)
            self._in_cv.notify_all()

    def _deliver_end(self, error):
        with self._in_cv:
            self._error = error
            self._peer_closed = True
            self._in.append(_END)
            self._in_cv.notify_all()

    def recv(self, timeout: Optional[float] = None):
        """Next data object from the peer; raises StreamClosed at end of
        stream, StreamError on an error end, TimeoutError on timeout."""
        with self._in_cv:
            while not self._in:
                if not self._in_cv.wait(timeout=timeout):
                    raise TimeoutError(f"stream {self.sid} recv timeout")
            obj = self._in.pop(0)
        if obj is _END:
            with self._in_cv:  # keep the sentinel for repeated recv()
                self._in.insert(0, _END)
            if self._error:
                raise StreamError(self._error)
            raise StreamClosed()
        self._consumed += 1
        if self._consumed >= GRANT_AT:
            grant, self._consumed = self._consumed, 0
            self.session._send_frame(["w", self.sid, grant])
        return obj

    def __iter__(self):
        while True:
            try:
                yield self.recv()
            except StreamClosed:
                return

    # -- send ----------------------------------------------------------
    def _grant(self, n: int):
        with self._credit_cv:
            self._credit += n
            self._credit_cv.notify_all()

    def send(self, obj, timeout: Optional[float] = 60.0):
        """Send one data frame; blocks while the peer's window is empty
        (backpressure). A peer HALF-close (it finished sending) does not
        stop our direction — only a peer error/reset, our own close, or
        session death does (yamux half-close semantics)."""
        with self._credit_cv:
            while self._credit <= 0:
                if self._local_closed or self._peer_error or self.session.dead:
                    raise StreamClosed()
                if not self._credit_cv.wait(timeout=timeout):
                    raise TimeoutError(f"stream {self.sid} send window stalled")
            if self._local_closed or self._peer_error or self.session.dead:
                raise StreamClosed()
            self._credit -= 1
        self.session._send_frame(["d", self.sid, obj])

    def close(self, error: Optional[dict] = None):
        """Half-close our direction (idempotent)."""
        if self._local_closed:
            return
        self._local_closed = True
        try:
            self.session._send_frame(["e", self.sid, error])
        except (StreamClosed, OSError, ConnectionClosed):
            pass
        self.session._maybe_drop(self)

    # convenience for request/response use
    def result(self, timeout: Optional[float] = None):
        """Single-response contract: one data frame then end."""
        out = self.recv(timeout=timeout)
        return out


class _LocalSession:
    def __init__(self):
        self.dead = False


class LocalStream:
    """In-process duplex stream pair with the Stream surface (send/recv/
    close/iter) and no wire: ``pipe_streams()`` returns two connected
    ends. Used to bridge in-process components (a DevAgent's local client
    exec) to code written against mux streams."""

    def __init__(self):
        self._in: list = []
        self._cv = threading.Condition()
        self._error: Optional[dict] = None
        self._peer_closed = False
        self._local_closed = False
        self.peer: "LocalStream" = None  # set by pipe_streams
        self.session = _LocalSession()

    def _deliver(self, obj):
        with self._cv:
            self._in.append(obj)
            self._cv.notify_all()

    def _deliver_end(self, error):
        with self._cv:
            self._error = error
            self._peer_closed = True
            self._in.append(_END)
            self._cv.notify_all()

    def recv(self, timeout: Optional[float] = None):
        with self._cv:
            while not self._in:
                if not self._cv.wait(timeout=timeout):
                    raise TimeoutError("local stream recv timeout")
            obj = self._in.pop(0)
            if obj is _END:
                self._in.insert(0, _END)
                if self._error:
                    raise StreamError(self._error)
                raise StreamClosed()
        return obj

    def __iter__(self):
        while True:
            try:
                yield self.recv()
            except StreamClosed:
                return

    def send(self, obj, timeout: Optional[float] = None):
        if self._local_closed or self.peer is None or self.session.dead:
            raise StreamClosed()
        self.peer._deliver(obj)

    def close(self, error: Optional[dict] = None):
        if self._local_closed:
            return
        self._local_closed = True
        if self.peer is not None:
            self.peer._deliver_end(error)

    def abort(self):
        """Tear the whole pipe down (both directions): the local analog of
        a dead mux session. Producers blocked on the other end observe
        ``session.dead`` and stop — e.g. an exec whose websocket dropped
        must kill the process, not buffer its output forever."""
        self.session.dead = True
        self.close()
        if self.peer is not None:
            self.peer._deliver_end(
                {"code": "connection", "message": "pipe aborted"}
            )


def pipe_streams() -> tuple[LocalStream, LocalStream]:
    a, b = LocalStream(), LocalStream()
    a.peer, b.peer = b, a
    b.session = a.session  # one shared liveness flag for both ends
    return a, b


class MuxSession:
    """A multiplexed session over one connected socket. Call ``serve`` on
    the accept side (with a dispatcher) or use ``open`` on the dial side;
    both sides share the same reader loop."""

    def __init__(self, sock: socket.socket, on_open: Optional[Callable] = None):
        self.sock = sock
        # one shared timeout bounds SENDS (see SEND_TIMEOUT); the reader
        # loop treats the same timeout as a benign idle tick and retries
        sock.settimeout(SEND_TIMEOUT)
        #: accept-side hook: on_open(stream, method, payload)
        self.on_open = on_open
        self.dead = False
        self._streams: dict[int, Stream] = {}
        self._lock = threading.Lock()
        self._wlock = threading.Lock()
        self._ids = itertools.count(1)
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True, name="mux-reader"
        )

    def start(self):
        self._reader.start()
        return self

    # -- plumbing ------------------------------------------------------
    def _send_frame(self, frame):
        if self.dead:
            raise StreamClosed()
        try:
            with self._wlock:
                write_frame(self.sock, frame)
        except (OSError, ConnectionClosed) as e:
            self._die()
            raise StreamClosed() from e

    def _maybe_drop(self, stream: Stream):
        if stream._local_closed and stream._peer_closed:
            with self._lock:
                self._streams.pop(stream.sid, None)

    def _die(self):
        self.dead = True
        with self._lock:
            streams = list(self._streams.values())
            self._streams.clear()
        for s in streams:
            s._deliver_end({"code": "connection", "message": "session closed"})
            with s._credit_cv:
                s._credit_cv.notify_all()
        try:
            self.sock.close()
        except OSError:
            pass

    def close(self):
        self._die()

    def inject_failure(self):
        """Chaos seam: tear the session down as if the transport failed
        mid-flight — every open stream observes the connection-closed end
        and blocked senders wake, exactly the observable a peer crash or
        cable pull produces."""
        self._die()

    def _read_frame_blocking(self):
        """read_frame that treats the socket's send-bound timeout as an
        idle tick on the receive side: a quiet connection is healthy, and
        partial frames keep accumulating across ticks."""
        import struct

        import msgpack

        def read_exact(n: int) -> bytes:
            buf = bytearray()
            while len(buf) < n:
                try:
                    chunk = self.sock.recv(n - len(buf))
                except socket.timeout:
                    if self.dead:
                        raise ConnectionClosed()
                    continue
                if not chunk:
                    raise ConnectionClosed()
                buf.extend(chunk)
            return bytes(buf)

        (length,) = struct.unpack(">I", read_exact(4))
        return msgpack.unpackb(read_exact(length), raw=False)

    def _read_loop(self):
        try:
            while not self.dead:
                frame = self._read_frame_blocking()
                kind = frame[0]
                sid = frame[1]
                if kind == "o":
                    _, _, method, payload = frame
                    stream = Stream(self, sid)
                    with self._lock:
                        self._streams[sid] = stream
                    if self.on_open is not None:
                        self.on_open(stream, method, payload)
                    else:  # dial side never receives opens
                        stream.close({"code": "invalid", "message": "unexpected open"})
                elif kind == "d":
                    with self._lock:
                        stream = self._streams.get(sid)
                    if stream is not None:
                        stream._deliver(frame[2])
                elif kind == "w":
                    with self._lock:
                        stream = self._streams.get(sid)
                    if stream is not None:
                        stream._grant(frame[2])
                elif kind == "e":
                    with self._lock:
                        stream = self._streams.get(sid)
                    if stream is not None:
                        stream._deliver_end(frame[2])
                        with stream._credit_cv:
                            stream._peer_closed = True
                            if frame[2]:  # error end = reset both ways
                                stream._peer_error = True
                            stream._credit_cv.notify_all()
                        self._maybe_drop(stream)
        except (ConnectionClosed, OSError, ValueError):
            pass
        finally:
            self._die()

    # -- dial side -----------------------------------------------------
    def open(self, method: str, payload) -> Stream:
        """Open a new stream carrying one RPC (request/stream/duplex)."""
        sid = next(self._ids)
        stream = Stream(self, sid)
        with self._lock:
            if self.dead:
                raise StreamClosed()
            self._streams[sid] = stream
        try:
            self._send_frame(["o", sid, method, payload])
        except StreamClosed:
            with self._lock:
                self._streams.pop(sid, None)
            raise
        return stream
