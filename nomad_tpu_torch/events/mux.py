"""Shared-socket fan-out pump for the chunked ``/v1/event/stream`` tier.

A parked thread per streaming connection caps fan-out at thread-scheduler
scale: 10K watchers would mean 10K server threads, each woken on every
publish to re-serialize and write one frame. This mux replaces all of
them with ONE pump thread:

- the HTTP handler finishes the response headers, detaches the socket
  from the per-request lifecycle, registers it here, and returns — the
  handler thread lives milliseconds regardless of how long the stream
  does;
- a broker offer marks the subscription's connection dirty (the
  ``Subscription._on_ready`` hook) and wakes the pump;
- the pump drains each dirty subscription through the encode-once wire
  path (``Subscription.take_wire``), frames the whole batch as ONE
  chunked-transfer chunk, and writes it to the non-blocking socket —
  frame-level batching on the socket write path: a subscriber that fell
  behind catches up in large writes instead of per-frame syscalls;
- an epoll selector watches every socket for hangups (and for
  writability while a partial write is pending), so client disconnects
  tear subscriptions down without a reader thread each;
- idle connections get the ``{}`` heartbeat on their own cadence.

Slow consumers are handled at two layers: the broker closes a
subscription whose queue overflows (the resumable-close contract), and
the mux stops draining a subscription whose socket buffer backs up past
``max_pending`` — the queue then overflows upstream and the same
contract applies. Either way the final Error frame is flushed when the
socket drains, never silently dropped.

The websocket tier keeps its thread-per-connection shape (it needs a
reader for pings and carries a handful of UI consumers, not the fan-out
load) but shares the same encode-once wire path.
"""

from __future__ import annotations

import logging
import selectors
import threading
import time
from collections import deque

logger = logging.getLogger("nomad_tpu.events.mux")

_LAST_CHUNK = b"0\r\n\r\n"


def _chunk(payload: bytes) -> bytes:
    """One HTTP/1.1 chunked-transfer chunk wrapping ``payload`` (which
    carries whole NDJSON lines, so chunk boundaries never split a
    frame)."""
    return b"%x\r\n%s\r\n" % (len(payload), payload)


class _Conn:
    __slots__ = (
        "sock",
        "fd",
        "sub",
        "heartbeat",
        "admission_class",
        "out",
        "last_tx",
        "closing",
        "dirty",
        "want_write",
    )

    def __init__(
        self, sock, sub, heartbeat: float, admission_class: str = "service"
    ):
        self.sock = sock
        self.fd = sock.fileno()
        self.sub = sub
        self.heartbeat = heartbeat
        #: overload shedding class (core/overload.py CLASS_*): the
        #: brownout ladder hangs up batch streams first, service next,
        #: system never
        self.admission_class = admission_class
        self.out = bytearray()
        self.last_tx = time.monotonic()
        #: the terminal chunk is queued; drop once the buffer drains
        self.closing = False
        #: sits in the pump's dirty queue (dedup flag; races are benign —
        #: a double append costs one no-op service pass)
        self.dirty = False
        self.want_write = False


class StreamMux:
    """One pump thread multiplexing every adopted stream socket."""

    def __init__(
        self,
        frame_batch: int = 64,
        max_pending: int = 512 * 1024,
        sweep: float = 0.25,
    ):
        #: queue entries drained per take_wire call (one socket write)
        self.frame_batch = max(1, int(frame_batch))
        #: per-connection outbound-buffer cap: past it the mux stops
        #: draining the subscription and lets the broker's slow-consumer
        #: close fire upstream
        self.max_pending = int(max_pending)
        #: pump wake ceiling (heartbeat granularity / retry cadence);
        #: _sweep adapts downward to half the fastest requested
        #: heartbeat so a sub-sweep cadence is honored, not quantized
        self.sweep = float(sweep)
        self._sweep = float(sweep)
        self._sel = selectors.DefaultSelector()
        self._conns: dict[int, _Conn] = {}
        #: connections adopted by serve() but not yet selector-registered
        #: (all selector calls stay on the pump thread)
        self._adds: deque[_Conn] = deque()
        self._dirty: deque[_Conn] = deque()
        self._wake = threading.Event()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.served = 0
        self.dropped = 0
        #: admission classes currently being shed (brownout); guarded by
        #: _lock, read per adopted conn (never snapshotted across a
        #: loop — a restore racing an adoption must win)
        self._shed_classes: set = set()
        #: newly-shed classes awaiting a disconnect sweep (pump-drained)
        self._shed_req: deque = deque()
        #: streams hung up by the shed policy, per class (under _lock)
        # nta: ignore[unbounded-cache] WHY: keyed by admission class —
        # at most the three fixed CLASS_* values, not per-subscriber.
        self.shed_streams: dict = {}

    # ------------------------------------------------------------------
    def serve(
        self,
        sock,
        sub,
        heartbeat: float = 10.0,
        admission_class: str = "service",
    ):
        """Adopt ``sock`` (response headers already written and flushed)
        and pump ``sub``'s frames to it until either side closes. Returns
        immediately; the caller must not touch the socket again.
        ``admission_class`` places the stream in the brownout shed order
        (batch first, service next, system never)."""
        sock.setblocking(False)
        # honor the client's requested cadence (the HTTP layer already
        # floors it at 0.1s); the pump's wait adapts below, so a fast
        # heartbeat costs extra wakeups only while such a conn exists
        conn = _Conn(
            sock, sub, max(0.1, float(heartbeat)), admission_class
        )
        with self._lock:
            if self._stop.is_set():
                # a stream that raced the shutdown: adopting it would
                # leak the socket and subscription (no pump will ever
                # service or tear them down) and hang the client on a
                # headers-only response until its own timeout
                stopping = True
            else:
                stopping = False
                if self._thread is None:
                    # started BEFORE publishing: a concurrent stop()
                    # must never observe (and join) an unstarted thread
                    thread = threading.Thread(
                        target=self._run, daemon=True,
                        name="event-stream-mux",
                    )
                    thread.start()
                    self._thread = thread
                self.served += 1
                self._sweep = min(self._sweep, conn.heartbeat / 2.0)
                # adopted INSIDE the lock: stop() flips _stop under the
                # same lock, so either this conn lands in _adds before
                # the stop (and the final teardown sweep reaps it) or
                # serve observes the stop and rejects — no window where
                # an adopted socket escapes both
                # nta: ignore[subscriber-eviction] WHY: _adds is a
                # hand-off queue the pump drains every sweep (_admit
                # popleft); eviction of the admitted connection itself
                # is _drop's job.
                self._adds.append(conn)
        if stopping:
            try:
                sock.close()
            except OSError:
                pass
            sub.close()
            return
        # the hook makes every broker offer O(1)-wake this connection;
        # set it after adoption — frames queued meanwhile are drained by
        # the initial notify below, so nothing can land unseen
        sub._on_ready = lambda c=conn: self._notify(c)
        self._notify(conn)  # drain the subscribe-time replay/snapshot

    def _notify(self, conn: _Conn):
        if not conn.dirty:
            conn.dirty = True
            # nta: ignore[subscriber-eviction] WHY: dedup-flagged (at most
            # one live entry per connection); the pump pops every entry on
            # the next sweep.
            self._dirty.append(conn)
        self._wake.set()

    # ------------------------------------------------------------------
    def _run(self):
        while not self._stop.is_set():
            if self._wake.wait(self._sweep):
                self._wake.clear()
            try:
                now = time.monotonic()
                self._admit(now)
                self._shed_pass()
                self._poll(now)
                self._drain_dirty(now)
                self._heartbeats(now)
            except Exception:  # one bad tick is delay; a dead pump is a
                logger.exception("stream mux tick failed")  # silent stall
        self._teardown()

    def _admit(self, now: float):
        while self._adds:
            conn = self._adds.popleft()
            self._conns[conn.fd] = conn
            try:
                self._sel.register(conn.sock, selectors.EVENT_READ, conn)
            except (ValueError, OSError):
                self._drop(conn, "register")
                continue
            # the shed check reads the live set per conn, NOT a snapshot
            # taken at loop entry: a conn appended while this loop runs
            # (serve() is any-thread) may postdate a restore — judging
            # it by a pre-restore snapshot would hang up a legitimately
            # re-admitted stream
            with self._lock:
                shed_now = conn.admission_class in self._shed_classes
            if shed_now:
                # adopted mid-brownout: hang up with the resumable close
                # frame rather than silently serving a class the ladder
                # already disconnected — the client sees the same Error
                # frame either way and retries after the storm
                self._shed_conn(conn)
            # service unconditionally at admission: a _drain_dirty pass
            # that ran between serve()'s parking of this conn and this
            # admit pops the conn's dirty entry but skips the (not yet
            # admitted) conn — and a publish that raced into that
            # dirty=True window appended no second entry, so its frames
            # would wait for the NEXT publish to re-notify. An empty
            # queue makes this a no-op take_wire.
            self._service(conn, now)

    # ------------------------------------------------------------------
    # brownout stream shedding (core/overload.py ladder actions)
    # ------------------------------------------------------------------
    def set_class_shed(self, admission_class: str, shed: bool):
        """Brownout hook (any thread): ``shed=True`` hangs up every live
        stream of ``admission_class`` with the resumable close frame and
        keeps shedding new adoptions of that class until ``shed=False``.
        Restore only stops FUTURE shedding — a hung-up client reconnects
        on its own (the Error frame carries its resume index)."""
        with self._lock:
            if shed:
                self._shed_classes.add(admission_class)
            else:
                self._shed_classes.discard(admission_class)
        if shed:
            # the disconnect sweep runs on the pump thread (selector and
            # _conns are pump-owned); a mux with no pump has no conns
            # nta: ignore[subscriber-eviction] WHY: a hand-off queue the
            # pump drains to empty every tick (_shed_pass popleft);
            # bounded by brownout transitions, not subscriber count.
            self._shed_req.append(admission_class)
            self._wake.set()

    def _shed_pass(self):
        while self._shed_req:
            cls = self._shed_req.popleft()
            for conn in list(self._conns.values()):
                if conn.admission_class == cls and not conn.closing:
                    self._shed_conn(conn)

    def _shed_conn(self, conn: _Conn):
        """Pump-thread only: resumable-close ``conn``'s subscription.
        The close wakes the dirty path (sub._on_ready → _notify), the
        next service drains the final Error frame + last chunk, and the
        flush drops the connection — the normal teardown, just
        server-initiated."""
        from .. import metrics

        with self._lock:
            # nta: ignore[subscriber-eviction] WHY: a per-class counter
            # map with at most three keys (the fixed admission classes),
            # not a per-subscriber registry.
            self.shed_streams[conn.admission_class] = (
                self.shed_streams.get(conn.admission_class, 0) + 1
            )
        metrics.incr(f"overload.shed.stream_{conn.admission_class}")
        conn.sub.shed(
            "subscription closed: stream shed by brownout "
            f"({conn.admission_class})"
        )

    def _poll(self, now: float):
        """Selector pass: client hangups (readable with EOF/error) and
        write-readiness for connections with pending output."""
        try:
            events = self._sel.select(0)
        except OSError:
            return
        for key, mask in events:
            conn = key.data
            if mask & selectors.EVENT_WRITE:
                self._flush(conn, now)
            if mask & selectors.EVENT_READ:
                try:
                    data = conn.sock.recv(4096)
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError:
                    self._drop(conn, "read")
                    continue
                if not data:
                    self._drop(conn, "eof")
                # data on a chunked GET stream is pipelined noise: ignore

    def _drain_dirty(self, now: float):
        while self._dirty:
            conn = self._dirty.popleft()
            conn.dirty = False
            # identity check, not fd membership: a late dirty entry for
            # a dropped connection must not touch (or drop) whoever now
            # owns its recycled fd
            if self._conns.get(conn.fd) is conn and not conn.closing:
                self._service(conn, now)

    def _service(self, conn: _Conn, now: float):
        """Move frames queue → outbuf → socket, batching every available
        entry (up to the buffer cap) into as few writes as possible."""
        while len(conn.out) < self.max_pending:
            payload, done = conn.sub.take_wire(self.frame_batch)
            if payload:
                conn.out += _chunk(payload)
            if done:
                conn.out += _LAST_CHUNK
                conn.closing = True
                break
            if not payload:
                break
        self._flush(conn, now)

    def _flush(self, conn: _Conn, now: float):
        try:
            while conn.out:
                sent = conn.sock.send(conn.out)
                del conn.out[:sent]
                conn.last_tx = now
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._drop(conn, "write")
            return
        if conn.out:
            self._want_write(conn, True)
        else:
            self._want_write(conn, False)
            if conn.closing:
                self._drop(conn, "done")
            elif conn.sub.queued():
                # the buffer cap paused the queue drain mid-backlog; now
                # that the socket caught up, re-service — a quiet broker
                # sends no new offer to wake us otherwise and the rest of
                # the backlog (a large snapshot, say) would sit forever
                self._notify(conn)

    def _want_write(self, conn: _Conn, want: bool):
        if want == conn.want_write or self._conns.get(conn.fd) is not conn:
            return
        conn.want_write = want
        events = selectors.EVENT_READ | (
            selectors.EVENT_WRITE if want else 0
        )
        try:
            self._sel.modify(conn.sock, events, conn)
        except (KeyError, ValueError, OSError):
            pass

    def _heartbeats(self, now: float):
        for conn in list(self._conns.values()):
            if (
                not conn.out
                and not conn.closing
                and now - conn.last_tx >= conn.heartbeat
            ):
                conn.out += _chunk(b"{}\n")
                self._flush(conn, now)

    def _drop(self, conn: _Conn, why: str):
        if self._conns.get(conn.fd) is not conn:
            return  # already dropped (or the fd was reused by a new conn)
        self._conns.pop(conn.fd, None)
        with self._lock:
            # the adoption lock also guards the counters: stats() reads
            # them from arbitrary threads while the pump drops conns
            self.dropped += 1
        conn.sub._on_ready = None
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        # consumer-initiated close: the broker drops the subscription;
        # idempotent when the broker already closed it (slow consumer)
        try:
            conn.sub.close()
        except Exception:
            logger.exception("stream mux: subscription close failed (%s)", why)

    def _teardown(self):
        self._admit(time.monotonic())
        for conn in list(self._conns.values()):
            self._drop(conn, "shutdown")

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "connections": len(self._conns),
                "served": self.served,
                "dropped": self.dropped,
                "pending_adds": len(self._adds),
                "shed_classes": sorted(self._shed_classes),
                "shed_streams": dict(self.shed_streams),
            }

    def stop(self):
        with self._lock:
            # under the serve() adoption lock: every conn is either in
            # _adds/_conns before this flip (reaped by the teardown
            # below) or its serve observes the flip and rejects
            self._stop.set()
            thread, self._thread = self._thread, None
        self._wake.set()
        if thread is not None:
            thread.join(timeout=5.0)
        # a serve() that passed its stopping-check just before stop()
        # may have parked an add after the pump's own teardown ran:
        # sweep the leftovers so no adopted socket outlives the mux
        self._teardown()
