"""Event broker: FSM-sourced, index-ordered cluster events fanned out to
subscribers (ref nomad/stream/event_broker.go, event_buffer.go,
subscription.go + nomad/state/events.go eventsFromChanges).

Every server (leader or follower) derives the same events from the same
applied raft log, so any server can serve ``/v1/event/stream`` — exactly
the property the reference gets from sourcing events in the FSM rather
than in the leader's endpoints. Events are held in ONE bounded ring
buffer shared by all subscribers (oldest entries dropped when full) and
each subscriber drains its own bounded queue:

- a subscriber that asks for ``index=N`` replays retained events with
  index > N from the ring; when the ring has already overwritten part of
  that range the subscription starts with an explicit lost-gap marker
  instead of silently skipping (the chaos invariant);
- a subscriber that stops draining (slow consumer) is CLOSED, not
  buffered without bound — the close carries a resume floor (the highest
  index the ring has evicted) so reconnecting with ``index=floor``
  replays everything still retained, and a consumer resuming from its
  own older index observes the gap explicitly (ref event_broker.go's
  ErrSubscriberClosed path).

Production fan-out (ROADMAP item 3) shaped the delivery core:

- **encode-once frames** — each published ``(index, events)`` batch
  becomes one immutable :class:`Frame` whose per-event JSON, full-frame
  wire line, and per-filter-signature visibility decision are each
  computed once and shared by every matching subscriber. Per-subscriber
  publish work is a dict probe + a deque append; no subscriber ever
  re-serializes an event (``encode_event`` is THE serializer and tests
  pin its call count against the publish count).
- **snapshot-on-subscribe** — a cold subscriber (``from_index=0``) or a
  reconnecting one whose resume index fell past the ring's retention can
  start from a compact, topic-filtered, ACL-filtered state snapshot
  stamped at raft index N (the store's COW generation — an O(1) pointer
  read under the broker lock, extraction afterwards against the
  immutable generation) and then ride deltas from N. Cold watchers never
  fall back to full blocking queries; a lost-gap bail becomes
  snapshot+deltas.

The ring's contents are deliberately NOT snapshotted: after a restore
the broker resets to the restored state index and live subscribers are
closed with that index (re-derivable state, same as the reference's
in-memory event buffer).
"""

from __future__ import annotations

import json
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable, Optional

TOPIC_JOB = "Job"
TOPIC_EVAL = "Eval"
TOPIC_ALLOC = "Alloc"
TOPIC_DEPLOYMENT = "Deployment"
TOPIC_NODE = "Node"
TOPIC_NODE_EVENT = "NodeEvent"
TOPIC_PLAN_RESULT = "PlanResult"
TOPIC_ALL = "*"

ALL_TOPICS = (
    TOPIC_JOB,
    TOPIC_EVAL,
    TOPIC_ALLOC,
    TOPIC_DEPLOYMENT,
    TOPIC_NODE,
    TOPIC_NODE_EVENT,
    TOPIC_PLAN_RESULT,
)

#: topics whose events are cluster-scoped (no namespace): gated by the
#: node:read coarse capability rather than a namespace capability
NODE_TOPICS = (TOPIC_NODE, TOPIC_NODE_EVENT)

#: topics with standing state objects a snapshot can carry; NodeEvent
#: and PlanResult are ephemeral — their only history is the ring
SNAPSHOT_TOPICS = (
    TOPIC_JOB,
    TOPIC_EVAL,
    TOPIC_ALLOC,
    TOPIC_DEPLOYMENT,
    TOPIC_NODE,
)

EPHEMERAL_TOPICS = (TOPIC_NODE_EVENT, TOPIC_PLAN_RESULT)


def required_capability(topic: str) -> str:
    """The ACL requirement for subscribing to ``topic`` (ref
    command/agent/event_endpoint.go aclCheckForEvents): node-scoped
    topics need node:read, everything else the namespace's read-job."""
    if topic in NODE_TOPICS:
        return "node:read"
    return "ns:read-job"


def event_visible(acl, event: "Event") -> bool:
    """Per-event ACL filter applied at delivery (the subscribe-time check
    used the caller-chosen namespace; each event re-checks against ITS
    namespace, the same cross-namespace rule as list endpoints)."""
    if acl is None or acl.management:
        return True
    if event.topic in NODE_TOPICS:
        return acl.allow_node_read()
    return acl.allow_namespace_operation(
        event.namespace or "default", "read-job"
    )


@dataclass
class Event:
    """One typed cluster event (ref stream/event.go Event)."""

    topic: str
    type: str
    key: str
    index: int
    namespace: str = ""
    payload: dict = field(default_factory=dict)
    #: secondary match keys (ref structs.Event.FilterKeys): an Alloc
    #: event matches subscriptions keyed by its job/eval/deployment id
    filter_keys: tuple = ()

    def to_dict(self) -> dict:
        return {
            "Topic": self.topic,
            "Type": self.type,
            "Key": self.key,
            "Namespace": self.namespace,
            "FilterKeys": list(self.filter_keys),
            "Index": self.index,
            "Payload": self.payload,
        }


def encode_event(event: Event) -> bytes:
    """THE event serializer. Every byte of event JSON that reaches any
    subscriber — chunked HTTP, websocket, snapshot frames — is produced
    here and cached on the event, so each published event is encoded
    exactly once no matter how many subscribers match it (tests pin that
    by swapping in a counting wrapper for this module attribute)."""
    return json.dumps(event.to_dict(), separators=(",", ":")).encode()


def event_wire(event: Event) -> bytes:
    """The event's cached wire encoding (encode-once: the first caller
    pays ``encode_event``; everyone after shares the bytes)."""
    wire = event.__dict__.get("_wire")
    if wire is None:
        wire = encode_event(event)
        event._wire = wire
    return wire


class Frame:
    """One published ``(raft index, events)`` batch plus its encodings.

    Immutable after construction and shared by the ring and by every
    matching subscriber's queue. Three things are computed once and then
    shared across the whole fan-out:

    - the per-event JSON (``event_wire``),
    - the full-frame NDJSON wire line (``wire``),
    - the per-filter-signature visibility decision (``visible_for`` —
      subscribers with the same topics/namespace/ACL identity share one
      match computation per frame).
    """

    __slots__ = ("index", "events", "_wire", "_visible")

    def __init__(self, index: int, events: Iterable[Event]):
        self.index = index
        self.events = tuple(events)
        self._wire: Optional[bytes] = None
        #: filter signature -> tuple of visible event positions.
        # nta: ignore[unbounded-cache] WHY: keyed by live-subscriber
        # filter signatures (shared across the fleet) and the whole
        # frame dies with the bounded ring's eviction — a per-frame
        # memo, not a long-lived cache.
        self._visible: dict = {}

    def wire(self) -> bytes:
        """The full-frame NDJSON line, built once then shared."""
        wire = self._wire
        if wire is None:
            wire = b"".join(
                (
                    b'{"Index":%d,"Events":[' % self.index,
                    b",".join(event_wire(e) for e in self.events),
                    b"]}\n",
                )
            )
            self._wire = wire
        return wire

    def wire_for(self, pos: tuple) -> bytes:
        """Wire line for a partially-visible subscriber: reuses the
        per-event encodings; the full-visibility fast path shares the
        one full-frame line."""
        if len(pos) == len(self.events):
            return self.wire()
        return b"".join(
            (
                b'{"Index":%d,"Events":[' % self.index,
                b",".join(event_wire(self.events[i]) for i in pos),
                b"]}\n",
            )
        )

    def visible_for(
        self, sub: "Subscription", ephemeral_only: bool = False
    ) -> tuple:
        """Positions of the events this subscriber may see — memoized per
        filter signature, so 10K identical watchers pay one match pass.
        ``ephemeral_only`` restricts to EPHEMERAL_TOPICS events (the
        snapshot dedupe floor must not swallow what no snapshot can
        carry). Benign if two publishers race: both compute identical
        tuples."""
        key = (sub._sig, ephemeral_only)
        pos = self._visible.get(key)
        if pos is None:
            pos = tuple(
                i
                for i, e in enumerate(self.events)
                if (
                    not ephemeral_only or e.topic in EPHEMERAL_TOPICS
                )
                and sub.matches(e)
            )
            # nta: ignore[subscriber-eviction] WHY: per-frame memo — the
            # ring's eviction IS the eviction path; entries never outlive
            # the frame (see _visible's WHY above).
            self._visible[key] = pos
        return pos


class SubscriptionClosedError(Exception):
    """Raised from Subscription.next once the broker has closed the
    subscription. ``resume_index`` is the highest index already evicted
    from the ring at close time (the resume floor): reconnecting with
    ``index=resume_index`` replays every frame still retained — nothing
    is silently skipped — and a consumer resuming from its OWN older
    index instead gets the explicit lost-gap marker."""

    def __init__(self, reason: str, resume_index: int):
        super().__init__(reason)
        self.reason = reason
        self.resume_index = resume_index


class BrokerLimitError(Exception):
    """subscribe() refused: the broker is at ``max_subscribers``."""


#: queue entry kinds (entries are (kind, a, b) triples)
_EV = "ev"  # (frame, visible positions)
_GAP = "gap"  # (through_index, None)
_SNAP = "snap"  # (stamp index, tuple of snapshot Events)
_SNAP_END = "snapend"  # (stamp index, None)

#: snapshot Events per _SNAP queue entry / wire line (one multi-MB frame
#: would stall the socket batcher; ~256 keeps lines around chunk size)
SNAPSHOT_BATCH = 256


class Subscription:
    """One consumer's bounded queue over the broker's fan-out (ref
    stream/subscription.go). The queue holds shared :class:`Frame`
    references (plus gap / snapshot markers), never per-subscriber event
    copies. Consumers drain through ``next`` (typed frames, the in-proc
    consumers), ``next_wires`` (blocking wire lines, the websocket tier)
    or ``take_wire`` (non-blocking batched wire, the stream mux)."""

    def __init__(
        self,
        broker: "EventBroker",
        topics: dict[str, set[str]],
        acl=None,
        namespace: str = "*",
        max_queued: int = 1024,
    ):
        self.broker = broker
        self.topics = topics
        self.acl = acl
        self.namespace = namespace
        self.max_queued = max_queued
        #: filter signature: subscribers sharing (topics, namespace, ACL
        #: identity) share one per-frame visibility computation. The ACL
        #: OBJECT rides the tuple (identity hash), not id(acl): a memo
        #: key must keep the token alive — a recycled address after the
        #: token's GC would serve the dead token's visibility decisions
        #: to whoever allocates there next (cross-tenant leak).
        self._sig = (
            tuple(
                sorted((t, tuple(sorted(k))) for t, k in topics.items())
            ),
            namespace,
            acl,
        )
        #: frames at or below this index are covered by the snapshot this
        #: subscription started from (the dedupe floor: a publish racing
        #: the subscribe must not deliver what the snapshot already has)
        self.min_index = 0
        #: highest index this consumer has fully drained (the broker's
        #: per-subscriber lag tap: lag = broker head - delivered_index)
        self.delivered_index = 0
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._close_reason = ""
        self._resume_index = 0
        #: mux wake hook (events/mux.py): called after an append when a
        #: shared pump serves this subscription instead of a parked
        #: thread; must be cheap and must not raise
        self._on_ready = None

    # -- filtering ------------------------------------------------------
    def _topic_keys(self, topic: str) -> Optional[set[str]]:
        keys = self.topics.get(topic)
        if keys is None:
            keys = self.topics.get(TOPIC_ALL)
        return keys

    def matches(self, event: Event) -> bool:
        keys = self._topic_keys(event.topic)
        if keys is None:
            return False
        if TOPIC_ALL not in keys:
            if event.key not in keys and not keys.intersection(
                event.filter_keys
            ):
                return False
        if (
            self.namespace not in ("*", "")
            and event.namespace
            and event.namespace != self.namespace
        ):
            return False
        return event_visible(self.acl, event)

    # -- delivery (broker side) ----------------------------------------
    def _offer(self, frame: Frame) -> bool:
        """Enqueue one shared frame; False means this subscriber is too
        slow and must be closed (no-slow-consumer backpressure). Frames
        at or below the snapshot floor deliver only their EPHEMERAL
        events: the state topics are already covered by the snapshot,
        but NodeEvent/PlanResult history exists nowhere else — dropping
        the whole frame would be exactly the silent gap the plane
        forbids."""
        if frame.index <= self.min_index:
            pos = frame.visible_for(self, ephemeral_only=True)
        else:
            pos = frame.visible_for(self)
        if not pos:
            return True
        with self._cond:
            if self._closed:
                return True
            if len(self._queue) >= self.max_queued:
                return False
            self._queue.append((_EV, frame, pos))
            self._cond.notify_all()
        on_ready = self._on_ready
        if on_ready is not None:
            on_ready()
        return True

    def _offer_gap(self, through_index: int):
        with self._cond:
            if self._closed:
                return
            # a gap marker is never dropped for queue pressure: dropping
            # it is exactly the silent gap the marker exists to prevent
            # (one marker per subscribe/trim event, not per publish)
            # nta: ignore[subscriber-eviction] WHY: un-capped on purpose —
            # see the comment above; the queue itself is drained by
            # next/take_wire and bounded by _offer's cap.
            self._queue.append((_GAP, through_index, None))
            self._cond.notify_all()
        on_ready = self._on_ready
        if on_ready is not None:
            on_ready()

    def _prepend_snapshot(self, index: int, events: list):
        """Install snapshot entries at the FRONT of the queue: live
        frames may already have queued behind the subscribe (they carry
        index > ``min_index`` by construction), and the consumer must see
        snapshot, then deltas. Exempt from ``max_queued`` — the snapshot
        is the price of admission, bounded by store size, and delivered
        first."""
        entries: list = [
            (_SNAP, index, tuple(events[start:start + SNAPSHOT_BATCH]))
            for start in range(0, len(events), SNAPSHOT_BATCH)
        ]
        entries.append((_SNAP_END, index, None))
        with self._cond:
            if self._closed:
                return
            # a snapshot bigger than the configured buffer must not eat
            # the whole live-delta budget: widen this subscription's cap
            # to snapshot + the configured headroom, or the first live
            # publish during the snapshot drain would slow-close it and
            # a reconnect would just re-snapshot — a livelock on any
            # store larger than one queue
            self.max_queued += len(entries)
            # appendleft reverses, so walk the delivery order backwards:
            # the consumer sees batch 0..N in extraction order, marker last
            for entry in reversed(entries):
                # nta: ignore[subscriber-eviction] WHY: one snapshot per
                # subscribe, delivered first and bounded by store size;
                # steady-state growth is _offer's capped path.
                self._queue.appendleft(entry)
            self._cond.notify_all()
        on_ready = self._on_ready
        if on_ready is not None:
            on_ready()

    def shed(self, reason: str):
        """Server-initiated resumable close (the brownout stream-shed
        path, events/mux.py): the final Error frame advertises THIS
        subscriber's own delivered index, so a reconnect with
        ``?index=<that>`` resumes exactly after the last frame it
        drained — strictly tighter than the slow-consumer close's
        ring-floor resume (the shed client isn't behind)."""
        with self._cond:
            resume = self.delivered_index
        self._close(reason, resume)

    def _close(self, reason: str, resume_index: int):
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._close_reason = reason
            self._resume_index = resume_index
            self._cond.notify_all()
        on_ready = self._on_ready
        if on_ready is not None:
            on_ready()  # the mux must flush the final Error frame

    # -- consumer side --------------------------------------------------
    def next(self, timeout: Optional[float] = None):
        """Next frame ``(index, [Event, ...])`` (or ``(index, None)`` for
        a lost gap), ``None`` on timeout, SubscriptionClosedError once the
        broker closed this subscription and its queue is drained.
        Snapshot batches surface as ordinary ``(index, [Event, ...])``
        frames stamped at the snapshot index."""
        while True:
            with self._cond:
                self._cond.wait_for(
                    lambda: self._queue or self._closed, timeout
                )
                if self._queue:
                    kind, a, b = self._queue.popleft()
                    self._advance_locked(((kind, a, b),))
                elif self._closed:
                    raise SubscriptionClosedError(
                        self._close_reason or "subscription closed",
                        self._resume_index,
                    )
                else:
                    return None
            if kind == _EV:
                return (a.index, [a.events[i] for i in b])
            if kind == _GAP:
                return (a, None)
            if kind == _SNAP:
                return (a, list(b))
            # _SNAP_END: zero-width marker for the wire tiers; in-proc
            # consumers skip it (don't re-wait the full timeout)
            timeout = 0

    def _advance_locked(self, entries):
        """Advance the lag tap for drained ``entries`` — caller holds
        ``self._cond``. The advance used to ride the wire-encode path
        OUTSIDE the lock, so ``lag_stats`` (another thread) could read a
        torn view of a subscriber's progress; the racegraph/racedep plane
        pinned the write under the queue's own lock."""
        for kind, a, _ in entries:
            if kind == _EV:
                idx = a.index
            elif kind in (_GAP, _SNAP_END):
                idx = a
            else:
                continue
            if idx > self.delivered_index:
                self.delivered_index = idx

    def _entry_wire(self, entry) -> bytes:
        """Pure wire encoder — no state updates (encoding happens outside
        ``_cond``; see ``_advance_locked``)."""
        kind, a, b = entry
        if kind == _EV:
            return a.wire_for(b)
        if kind == _GAP:
            return b'{"LostGap":true,"Index":%d}\n' % a
        if kind == _SNAP:
            return b"".join(
                (
                    b'{"Snapshot":true,"Index":%d,"Events":[' % a,
                    b",".join(event_wire(e) for e in b),
                    b"]}\n",
                )
            )
        return b'{"SnapshotDone":true,"Index":%d}\n' % a

    def _error_wire(self) -> bytes:
        return b'{"Error":%s,"ResumeIndex":%d}\n' % (
            json.dumps(self._close_reason or "subscription closed").encode(),
            self._resume_index,
        )

    def take_wire(self, max_entries: int = 64) -> tuple[bytes, bool]:
        """Non-blocking batched wire drain (the stream mux path): up to
        ``max_entries`` queued entries as one NDJSON payload. Returns
        ``(payload, done)``; ``done=True`` means the subscription is
        closed AND fully drained — the payload then already carries the
        final Error frame."""
        with self._cond:
            n = min(len(self._queue), max_entries)
            entries = [self._queue.popleft() for _ in range(n)]
            done = self._closed and not self._queue
            self._advance_locked(entries)
        chunks = [self._entry_wire(e) for e in entries]
        if done:
            chunks.append(self._error_wire())
        return b"".join(chunks), done

    def next_wires(
        self, timeout: Optional[float] = None, max_entries: int = 64
    ) -> tuple[list, bool]:
        """Blocking wire drain (the websocket tier / inline chunked
        fallback): waits up to ``timeout`` for the first entry, then
        drains up to ``max_entries``. Returns ``(lines, done)``;
        ``([], False)`` on timeout means a heartbeat is due, ``done=True``
        means closed-and-drained with the Error frame as the last line."""
        with self._cond:
            self._cond.wait_for(lambda: self._queue or self._closed, timeout)
            n = min(len(self._queue), max_entries)
            entries = [self._queue.popleft() for _ in range(n)]
            done = self._closed and not self._queue
            self._advance_locked(entries)
        lines = [self._entry_wire(e) for e in entries]
        if done:
            lines.append(self._error_wire())
        return lines, done

    def queued(self) -> int:
        with self._cond:
            return len(self._queue)

    def close(self):
        """Consumer-initiated unsubscribe."""
        self.broker.unsubscribe(self)
        self._close("unsubscribed", self._resume_index)

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed


class EventBroker:
    """Bounded ring of published frames + subscriber fan-out (ref
    stream/event_broker.go EventBroker)."""

    def __init__(
        self,
        size: int = 4096,
        subscriber_buffer: int = 1024,
        state=None,
        snapshot_on_subscribe: bool = True,
        max_subscribers: int = 0,
        frame_batch: int = 64,
    ):
        #: max EVENTS retained across all frames (oldest dropped first)
        self.size = max(1, int(size))
        self.subscriber_buffer = max(1, int(subscriber_buffer))
        #: the state store whose COW generations stamp snapshots; None
        #: disables snapshot-on-subscribe (bare brokers in tests)
        self._state = state
        self.snapshot_on_subscribe = bool(snapshot_on_subscribe)
        #: admission cap: subscribe() raises BrokerLimitError beyond it
        #: (0 = unlimited)
        self.max_subscribers = int(max_subscribers or 0)
        #: queue entries batched per socket write by the wire tiers
        self.frame_batch = max(1, int(frame_batch))
        self._lock = threading.Lock()
        #: ring of Frame objects, index-ascending
        self._frames: deque[Frame] = deque()
        self._n_events = 0
        self._latest_index = 0
        #: highest index ever evicted from the ring (lost-gap watermark)
        self._dropped_through = 0
        self._subs: list[Subscription] = []
        self._published = 0
        self._closed_slow = 0
        self._snapshots_served = 0
        #: one generation's worth of extracted snapshot events, keyed by
        #: (stamp index, topic key): a ramp of N identical cold watchers
        #: extracts once and shares the Event objects AND their cached
        #: encodings; a new stamp index clears it (see _snapshot_events)
        self._snap_cache: dict = {}

    # -- publish (FSM apply path) ---------------------------------------
    def publish(self, index: int, events: list[Event]):
        if not events:
            return
        frame = Frame(index, events)
        with self._lock:
            self._latest_index = max(self._latest_index, index)
            self._frames.append(frame)
            self._n_events += len(frame.events)
            self._published += len(frame.events)
            while self._n_events > self.size and len(self._frames) > 1:
                old = self._frames.popleft()
                self._n_events -= len(old.events)
                self._dropped_through = max(
                    self._dropped_through, old.index
                )
            if self._snap_cache:
                # any publish supersedes every cached snapshot stamp —
                # dropping the cache here keeps a ramp of cold watchers
                # cheap (hits between writes) without pinning a full
                # serialized copy of the store for the process lifetime
                self._snap_cache.clear()
            subs = list(self._subs)
        for sub in subs:
            if not sub._offer(frame):
                self._close_slow(sub)

    def _resume_floor_locked(self) -> int:
        """The index to advertise on a close: reconnecting with
        ``index=floor`` replays every frame still retained (from_index is
        exclusive), so nothing retained is silently skipped — and a
        consumer resuming from its own older index still gets the
        explicit gap marker."""
        return self._dropped_through

    def _close_slow(self, sub: Subscription):
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)
            self._closed_slow += 1
            resume = self._resume_floor_locked()
        sub._close(
            "subscription closed: slow consumer (queue overflow)", resume
        )

    # -- subscribe ------------------------------------------------------
    def subscribe(
        self,
        topics: Optional[dict[str, Iterable[str]]] = None,
        from_index: int = 0,
        acl=None,
        namespace: str = "*",
        max_queued: Optional[int] = None,
        snapshot: bool = False,
    ) -> Subscription:
        """Register a subscriber. ``topics`` maps topic → keys ("*" for
        all); ``from_index=N`` replays retained events with index > N
        (the blocking-query convention: pass the last index you saw).
        An explicit resume (N > 0) older than the ring's retention gets a
        lost-gap frame first, then everything still retained.
        ``from_index=0`` is a FRESH subscribe — "whatever is retained,
        then live" — and makes no completeness claim, so it never emits a
        gap frame (every fresh subscriber on a long-lived cluster would
        otherwise start with one).

        ``snapshot=True`` (requires a broker constructed with a state
        store) upgrades both cold starts and lost-gap resumes to the
        snapshot-then-deltas contract: a state snapshot stamped at raft
        index N, then deltas from N. A resume still within retention
        ignores the flag — plain replay is strictly cheaper and
        complete. (External watchers only: the columnar planes are
        committed in-state and never ride this stream.)"""
        norm: dict[str, set[str]] = {}
        for topic, keys in (topics or {TOPIC_ALL: ("*",)}).items():
            keyset = {k for k in keys} or {"*"}
            norm[topic] = keyset
        sub = Subscription(
            self,
            norm,
            acl=acl,
            namespace=namespace,
            max_queued=max_queued or self.subscriber_buffer,
        )
        snap = None
        with self._lock:
            if (
                self.max_subscribers
                and len(self._subs) >= self.max_subscribers
            ):
                raise BrokerLimitError(
                    "event broker subscriber limit reached "
                    f"({self.max_subscribers})"
                )
            if (
                snapshot
                and self._state is not None
                and any(
                    t == TOPIC_ALL or t in SNAPSHOT_TOPICS for t in norm
                )
                and (
                    from_index == 0
                    or self._dropped_through > from_index
                )
            ):
                # (a subscription to ONLY ephemeral topics — NodeEvent /
                # PlanResult — keeps the classic contract: the snapshot
                # carries nothing for them, and jumping from_index to the
                # store head would silently discard their retained ring
                # history, which is their only history)
                # O(1) under the lock: the store's COW generation IS the
                # snapshot; the (possibly large) per-topic extraction
                # happens after the lock drops, against this immutable
                # generation. A STATE-topic event the snapshot already
                # covers (index <= N) is suppressed by the min_index
                # floor; an EPHEMERAL event rides through it (_offer's
                # ephemeral_only path — no snapshot can carry it), so
                # the ring replay below still runs from the caller's
                # resume point when the subscription spans ephemeral
                # topics. Anything past N is either in the ring or
                # published after this sub registered — never a gap.
                snap = self._state.snapshot()
                sub.min_index = snap.latest_index()
                if not any(
                    t == TOPIC_ALL or t in EPHEMERAL_TOPICS
                    for t in norm
                ):
                    from_index = sub.min_index
            # lag baseline: a subscriber owes delivery only from its
            # start point (resume index, snapshot stamp, or whatever the
            # ring still retains for a fresh subscribe)
            sub.delivered_index = (
                sub.min_index
                if snap is not None
                else (from_index or self._dropped_through)
            )
            replay = [f for f in self._frames if f.index > from_index]
            # cap the replay to the NEWEST frames that fit the queue with
            # headroom for live publishes — an uncapped replay would close
            # the subscription mid-replay on any cluster retaining more
            # frames than one queue, so index-less consumers (the UI)
            # could never reach the live tail
            cap = max(1, sub.max_queued - 1)
            trimmed_through = 0
            if len(replay) > cap:
                trimmed_through = replay[-cap - 1].index
                replay = replay[-cap:]
            if from_index and (
                self._dropped_through > from_index or trimmed_through
            ):
                # an explicit resume lost part of its range (ring eviction
                # and/or replay trim): say so, never silently skip. A
                # fresh subscribe (from_index=0) makes no completeness
                # claim, so trims there stay silent. With a snapshot this
                # marker still fires for a subscription spanning
                # ephemeral topics whose resume fell past retention: the
                # snapshot healed the state topics, but the evicted
                # NodeEvent/PlanResult history is genuinely gone —
                # silence here would be a silent gap. (A snapshot scoped
                # to state topics only never reaches this branch:
                # from_index was moved to the stamp above.)
                sub._offer_gap(
                    max(self._dropped_through, trimmed_through)
                )
            for f in replay:
                sub._offer(f)
            # admission is cap-gated (max_subscribers, above); eviction
            # runs on the delivery path (_close_slow on overflow) and on
            # consumer close (unsubscribe) — both visible to the
            # subscriber-eviction rule, so no suppression is needed here
            self._subs.append(sub)
        if snap is not None:
            events = self._snapshot_events(snap, norm)
            if sub.acl is None and namespace in ("*", "") and norm.get(
                TOPIC_ALL
            ) == {"*"}:
                visible = events  # the common watcher: everything
            else:
                visible = [e for e in events if sub.matches(e)]
            sub._prepend_snapshot(snap.latest_index(), visible)
            with self._lock:
                self._snapshots_served += 1
        return sub

    def _snapshot_events(self, snap, topics: dict) -> list:
        """Topic-filtered snapshot Event list for generation ``snap``,
        cached per (stamp index, topic key): ramping N cold watchers
        against a quiet broker extracts once and shares both the Event
        objects and their cached encodings."""
        wanted = frozenset(topics)
        key = (snap.latest_index(), wanted)
        with self._lock:
            events = self._snap_cache.get(key)
        if events is not None:
            return events
        events = snap.snapshot_events(
            None if TOPIC_ALL in wanted else wanted
        )
        with self._lock:
            if any(k[0] != key[0] for k in self._snap_cache):
                self._snap_cache.clear()  # older generation: stale
            if len(self._snap_cache) < 8:  # distinct topic filters
                self._snap_cache[key] = events
        return events

    def unsubscribe(self, sub: Subscription):
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    # -- introspection --------------------------------------------------
    def oldest_index(self) -> int:
        """Oldest raft index still retained (resume floor)."""
        with self._lock:
            if self._frames:
                return self._frames[0].index
            return self._latest_index

    def latest_index(self) -> int:
        with self._lock:
            return self._latest_index

    def stats(self) -> dict:
        with self._lock:
            return {
                "events_buffered": self._n_events,
                "frames_buffered": len(self._frames),
                "events_published": self._published,
                "subscribers": len(self._subs),
                "slow_consumers_closed": self._closed_slow,
                "snapshots_served": self._snapshots_served,
                "oldest_index": (
                    self._frames[0].index
                    if self._frames
                    else self._latest_index
                ),
                "latest_index": self._latest_index,
            }

    def lag_stats(self, top: int = 0) -> dict:
        """Delivery lag per live subscriber: broker head index minus the
        subscriber's last drained index. O(subscribers) plain attribute
        reads — cheap enough for the flight recorder's 1Hz sample even
        at production fan-out. ``top`` > 0 adds the worst-N subscribers
        with queue depth and topics (the watchdog bundle's finding)."""
        with self._lock:
            head = self._latest_index
            subs = list(self._subs)
        lags = sorted(
            (max(0, head - s.delivered_index) for s in subs), reverse=True
        )
        out = {
            "subscribers": len(lags),
            "max": lags[0] if lags else 0,
            "p99": lags[min(len(lags) - 1, len(lags) // 100)] if lags else 0,
        }
        if top:
            ranked = sorted(
                subs,
                key=lambda s: head - s.delivered_index,
                reverse=True,
            )
            out["top"] = [
                {
                    "lag": max(0, head - s.delivered_index),
                    "queued": s.queued(),
                    "topics": sorted(s.topics),
                    "namespace": s.namespace,
                }
                for s in ranked[:top]
            ]
        return out

    def acl_changed(self):
        """ACL token/policy writes applied: close every token-backed
        subscription so its capabilities re-resolve on reconnect (ref
        event_broker.go closing subscriptions on ACL changes — a revoked
        token must not keep streaming until it disconnects by itself).
        Anonymous/ACL-off subscriptions (acl=None, in-proc consumers like
        the deployment watcher) are untouched."""
        with self._lock:
            affected = [s for s in self._subs if s.acl is not None]
            for sub in affected:
                self._subs.remove(sub)
            resume = self._resume_floor_locked()
        for sub in affected:
            sub._close("subscription closed: ACL change", resume)

    # -- lifecycle ------------------------------------------------------
    def reset(self, index: int):
        """Restore-path reset (FSM.restore): the ring is re-derivable
        state, so drop it and close live subscribers with the restored
        index as their resume point."""
        with self._lock:
            self._frames.clear()
            self._n_events = 0
            self._latest_index = index
            self._dropped_through = index
            self._snap_cache.clear()
            subs, self._subs = self._subs, []
        for sub in subs:
            sub._close("event buffer reset (snapshot restore)", index)

    def shutdown(self):
        with self._lock:
            subs, self._subs = self._subs, []
            resume = self._resume_floor_locked()
        for sub in subs:
            sub._close("event broker shut down", resume)
