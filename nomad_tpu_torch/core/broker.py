"""EvalBroker: leader-side priority queue of evaluations with at-least-once
delivery (ref nomad/eval_broker.go).

Semantics preserved: per-scheduler-type ready heaps ordered by priority,
per-job serialization (one eval in flight per job; the rest block behind
it), token'd unack with Nack timers, delivery limit → ``_failed`` queue,
nack re-enqueue delay ramp, wait/wait_until delayed evals, and requeue-on-ack
for reblocked evals. This is also where the TPU batch bridge drains N evals
at a time (``dequeue_batch``).
"""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time
from typing import Optional

from .. import metrics
from ..structs.model import Evaluation, generate_uuid
from ..trace import tracer

logger = logging.getLogger("nomad_tpu.eval_broker")

FAILED_QUEUE = "_failed"

DEFAULT_NACK_TIMEOUT = 60.0
DEFAULT_DELIVERY_LIMIT = 3
DEFAULT_INITIAL_NACK_DELAY = 1.0
DEFAULT_SUBSEQUENT_NACK_DELAY = 20.0


class BrokerError(Exception):
    pass


class _TimerHandle:
    """Cancelable entry in the shared timer wheel; mimics the only part of
    the threading.Timer surface the broker used (``cancel``)."""

    __slots__ = ("cancelled",)

    def __init__(self):
        self.cancelled = False

    def cancel(self):
        self.cancelled = True


class _TimerWheel:
    """ONE shared timer thread replacing per-eval ``threading.Timer``s.

    ``threading.Timer`` spawns a whole OS thread per arm — and the broker
    arms on every dequeue, lease reset, pause/resume and nack re-enqueue.
    At drain batch sizes that was hundreds of thread spawns per second on
    the scheduling hot path (it profiled as the single largest non-wait
    cost in the drain worker). Entries are lazily invalidated: ``cancel``
    flips a flag and the wheel skips the entry at its deadline — the same
    guarantee Timer.cancel gives (an already-running callback can't be
    stopped either way; the broker's lock + paused-set checks remain the
    real guards)."""

    def __init__(self):
        self._heap: list = []
        self._seq = itertools.count()
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._compact_at = 64

    def arm(self, delay: float, fn, args: tuple) -> _TimerHandle:
        handle = _TimerHandle()
        deadline = time.monotonic() + delay
        with self._cond:
            heapq.heappush(
                self._heap, (deadline, next(self._seq), handle, fn, args)
            )
            if len(self._heap) >= self._compact_at:
                # drop cancelled entries eagerly: most nack timers cancel
                # within milliseconds of a 60s deadline, and a lazily-kept
                # entry pins its broker (bound method) until the deadline
                self._heap = [e for e in self._heap if not e[2].cancelled]
                heapq.heapify(self._heap)
                self._compact_at = max(64, 2 * len(self._heap))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="eval-broker-timers"
                )
                self._thread.start()
            self._cond.notify()
        return handle

    def _run(self):
        while True:
            due = []
            with self._cond:
                while True:
                    now = time.monotonic()
                    while self._heap and self._heap[0][0] <= now:
                        due.append(heapq.heappop(self._heap))
                    if due:
                        break
                    wait = self._heap[0][0] - now if self._heap else None
                    self._cond.wait(wait)
            for _, _, handle, fn, args in due:
                if handle.cancelled:
                    continue
                try:
                    fn(*args)
                except Exception:
                    # never kill the wheel, but never lose the trace either
                    # (a failed _enqueue_waiting means a silently lost eval)
                    logger.exception(
                        "broker timer callback %s%r failed",
                        getattr(fn, "__name__", fn), args,
                    )


#: module-level singleton: brokers come and go (tests spin up servers by
#: the dozen) but at most one timer thread ever exists. Shared beyond the
#: broker: server heartbeat timers arm here too — threading.Timer is one
#: OS thread per arm, and one-thread-per-NODE capped the cluster at the
#: environment's thread limit (~4K nodes; surfaced by the churn soak's
#: 10K-node ramp, which was killed at exactly the thread cap)
_WHEEL = _TimerWheel()


def shared_timer_wheel() -> _TimerWheel:
    """The process-wide timer wheel (see _WHEEL above)."""
    return _WHEEL


class _PendingHeap:
    """Priority heap: highest priority first, FIFO within a priority."""

    def __init__(self):
        self._heap: list = []
        self._counter = itertools.count()

    def push(self, ev: Evaluation):
        heapq.heappush(self._heap, (-ev.priority, next(self._counter), ev))

    def pop(self) -> Evaluation:
        return heapq.heappop(self._heap)[2]

    def peek(self) -> Optional[Evaluation]:
        return self._heap[0][2] if self._heap else None

    def __len__(self):
        return len(self._heap)


class _Shard:
    """One ready-queue shard: a per-job-hash slice of the broker's whole
    state machine under its OWN lock. Because routing is by (namespace,
    job) hash, EVERYTHING keyed to a job — the in-flight eval, the
    blocked heap behind it, the unack records, nack timers, pause set and
    requeue-on-ack slot — lives together in one shard, so per-job
    ordering and the token/nack semantics are shard-local invariants
    exactly as they were broker-global before."""

    __slots__ = (
        "lock", "evals", "job_evals", "blocked", "ready", "unack",
        "paused", "requeue", "time_wait",
    )

    def __init__(self):
        self.lock = threading.Lock()
        # eval id -> dequeue attempt count (dedup + delivery limit)
        self.evals: dict[str, int] = {}
        # per-job serialization: (ns, job) -> in-flight eval id
        self.job_evals: dict[tuple[str, str], str] = {}
        # (ns, job) -> heap of evals blocked behind the in-flight one
        self.blocked: dict[tuple[str, str], _PendingHeap] = {}
        # scheduler type -> ready heap
        self.ready: dict[str, _PendingHeap] = {}
        # eval id -> (eval, token, nack timer)
        self.unack: dict[str, tuple[Evaluation, str, _TimerHandle]] = {}
        # evals whose nack timer is paused (plan in flight); checked by
        # the timer path under the lock since cancel() can't stop a fired
        # timer
        self.paused: set[str] = set()
        # token -> eval to requeue on ack
        self.requeue: dict[str, Evaluation] = {}
        # eval id -> wait timer
        self.time_wait: dict[str, _TimerHandle] = {}


class EvalBroker:
    """Sharded by job hash (``ready_shards``; ROADMAP item 1c): N workers
    dequeuing through one lock+condvar convoyed on the broker itself once
    the applier stopped being the bottleneck — the profiler charged
    worker idle directly to the dequeue lock. Each shard owns its slice
    of the state machine under its own lock; dequeue scans shard peeks
    (one short lock hold apiece, rotated start per caller so workers
    don't herd) and pops the best-priority candidate. Cross-shard
    priority is best-effort under contention (the peek and the pop are
    separate acquisitions); per-job ordering, token guards, nack/requeue
    and delivery-limit semantics are exact — they are shard-local.
    ``ready_shards=1`` (the default) degenerates to the classic single
    critical section."""

    def __init__(
        self,
        nack_timeout: float = DEFAULT_NACK_TIMEOUT,
        delivery_limit: int = DEFAULT_DELIVERY_LIMIT,
        initial_nack_delay: float = DEFAULT_INITIAL_NACK_DELAY,
        subsequent_nack_delay: float = DEFAULT_SUBSEQUENT_NACK_DELAY,
        ready_shards: int = 1,
    ):
        self.nack_timeout = nack_timeout
        self.delivery_limit = delivery_limit
        self.initial_nack_delay = initial_nack_delay
        self.subsequent_nack_delay = subsequent_nack_delay

        self.enabled = False
        #: serializes enabled-state transitions: two concurrent
        #: set_enabled calls must agree on who saw the enable->disable
        #: edge (the flush trigger), or a toggle can double-flush or
        #: skip the flush entirely
        self._enabled_lock = threading.Lock()
        self._shards = [_Shard() for _ in range(max(1, int(ready_shards)))]
        # eval id -> owning shard (ack/nack/outstanding know only the id);
        # tiny critical section, written at first enqueue, dropped at ack
        self._route: dict[str, _Shard] = {}
        self._route_lock = threading.Lock()
        # the sleep side of dequeue: a generation-counted condvar OUTSIDE
        # the shard locks (lock order: shard.lock -> _wake, never the
        # reverse — waiters hold no shard lock). The generation closes
        # the classic lost-wakeup window between an empty scan and the
        # wait.
        self._wake = threading.Condition()
        self._wake_seq = 0
        # rotated scan start so concurrent dequeuers spread over shards
        self._rotor = itertools.count()
        # hook: (ev) -> None; the leader marks an eval whose deadline
        # passed before delivery as terminally failed
        # (``deadline_exceeded``) — refused work is always accounted,
        # never silently dropped (core/overload.py)
        self.on_deadline_exceeded = None
        # the eval.e2e enqueue→ack tap lives in the trace plane now: the
        # root span opened at first enqueue (tracer.eval_root) is closed
        # at ack (tracer.finish_eval), which emits the eval.e2e timer
        # with the trace id as exemplar — one source of truth for the
        # soak scorekeeper AND the span tree

    # ------------------------------------------------------------------
    def _shard_for(self, ev: Evaluation) -> _Shard:
        return self._shards[
            hash((ev.namespace, ev.job_id)) % len(self._shards)
        ]

    def _shard_of(self, eval_id: str) -> Optional[_Shard]:
        with self._route_lock:
            return self._route.get(eval_id)

    def _notify(self):
        with self._wake:
            self._wake_seq += 1
            self._wake.notify_all()

    # ------------------------------------------------------------------
    def set_enabled(self, enabled: bool):
        with self._enabled_lock:
            prev = self.enabled
            self.enabled = enabled
        if prev and not enabled:
            self.flush()
        if enabled:
            self._notify()

    # ------------------------------------------------------------------
    def enqueue(self, ev: Evaluation):
        shard = self._shard_for(ev)
        with shard.lock:
            self._process_enqueue(shard, ev, "")

    def enqueue_all(self, evals: dict | list):
        """Enqueue many evals; accepts {eval: token}, a list of evals,
        or a list of (eval, token) pairs. The pair form is the usable
        spelling of the reference's token'd EnqueueAll (eval_broker.go's
        map[*Evaluation]string) — Evaluation is an unhashable dataclass
        here, so it can't key a dict."""
        if isinstance(evals, dict):
            items = list(evals.items())
        else:
            items = [
                ev if isinstance(ev, tuple) else (ev, "") for ev in evals
            ]
        for ev, token in items:
            shard = self._shard_for(ev)
            with shard.lock:
                self._process_enqueue(shard, ev, token)

    def _process_enqueue(self, shard: _Shard, ev: Evaluation, token: str):
        """ref eval_broker.go:212-254; caller holds shard.lock."""
        if not self.enabled:
            return
        if ev.id in shard.evals:
            if token == "":
                return
            unack = shard.unack.get(ev.id)
            if unack is not None and unack[1] == token:
                shard.requeue[token] = ev
            return
        shard.evals[ev.id] = 0
        with self._route_lock:
            self._route[ev.id] = shard
        tracer.eval_root(
            ev.id,
            tags={
                "job": ev.job_id,
                "type": ev.type,
                "triggered_by": ev.triggered_by,
            },
        )

        if ev.wait_until:
            now = time.time_ns()
            delay = max((ev.wait_until - now) / 1e9, 0.0)
            if delay > 0:
                shard.time_wait[ev.id] = _WHEEL.arm(
                    delay, self._enqueue_waiting, (ev,)
                )
                return

        self._enqueue_locked(shard, ev, ev.type)

    def _enqueue_waiting(self, ev: Evaluation):
        shard = self._shard_for(ev)
        with shard.lock:
            shard.time_wait.pop(ev.id, None)
            self._enqueue_locked(shard, ev, ev.type)

    def _enqueue_locked(self, shard: _Shard, ev: Evaluation, queue: str):
        """ref eval_broker.go:277-327; caller holds shard.lock."""
        if not self.enabled:
            return
        # (re-)register the route AND the dedup-registry entry on EVERY
        # entry into the ready/blocked structures, not just first
        # enqueue: a wait-timer callback that lost the flush race (timer
        # fired, blocked on the shard lock while flush dropped all
        # state, broker re-enabled) would otherwise insert an eval that
        # (a) no ack/nack can resolve — wedging its (ns, job) slot — and
        # (b) escapes dedup, so a legitimate restore-path re-enqueue
        # pushes a SECOND ready copy and two workers race the same eval.
        # Both writes are idempotent: the shard is a pure function of
        # (ns, job) and setdefault preserves a live dequeue count.
        with self._route_lock:
            self._route[ev.id] = shard
        shard.evals.setdefault(ev.id, 0)
        key = (ev.namespace, ev.job_id)
        pending_eval = shard.job_evals.get(key, "")
        if pending_eval == "":
            shard.job_evals[key] = ev.id
        elif pending_eval != ev.id:
            shard.blocked.setdefault(key, _PendingHeap()).push(ev)
            return

        shard.ready.setdefault(queue, _PendingHeap()).push(ev)
        self._notify()

    # ------------------------------------------------------------------
    def dequeue(
        self, schedulers: list[str], timeout: Optional[float] = None
    ) -> tuple[Optional[Evaluation], str]:
        """Blocking dequeue for the given scheduler types; returns
        (eval, token) or (None, "") on timeout (ref eval_broker.go:329-460)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        offset = next(self._rotor)
        while True:
            with self._wake:
                seq = self._wake_seq
            ev, token = self._scan_shards(schedulers, offset)
            if ev is not None:
                return ev, token
            remaining = (
                None if deadline is None else deadline - time.monotonic()
            )
            if remaining is not None and remaining <= 0:
                return None, ""
            with self._wake:
                if self._wake_seq == seq:
                    self._wake.wait(
                        remaining if remaining is not None else 1.0
                    )

    def dequeue_batch(
        self, schedulers: list[str], max_evals: int, timeout: Optional[float] = None
    ) -> list[tuple[Evaluation, str]]:
        """Drain up to max_evals ready evaluations in one call — the TPU batch
        bridge (SURVEY §2.3: "where the TPU bridge drains N evals at a time").
        Blocks for the first eval only."""
        out = []
        ev, token = self.dequeue(schedulers, timeout)
        if ev is None:
            return out
        out.append((ev, token))
        offset = next(self._rotor)
        while len(out) < max_evals:
            ev, token = self._scan_shards(schedulers, offset)
            if ev is None:
                break
            out.append((ev, token))
        return out

    def _scan_shards(
        self, schedulers: list[str], offset: int
    ) -> tuple[Optional[Evaluation], str]:
        """One non-blocking pass: peek every shard (short per-shard lock
        holds, rotated start), then pop from the best-priority shard. A
        concurrent dequeuer may win the pop race — rescan until a pass
        finds the broker empty."""
        n = len(self._shards)
        while True:
            best_shard = None
            best_prio = None
            for i in range(n):
                shard = self._shards[(offset + i) % n]
                with shard.lock:
                    for sched in schedulers:
                        heap_ = shard.ready.get(sched)
                        if not heap_ or not len(heap_):
                            continue
                        candidate = heap_.peek()
                        if best_prio is None or candidate.priority > best_prio:
                            best_prio = candidate.priority
                            best_shard = shard
            if best_shard is None:
                return None, ""
            expired: list = []
            with best_shard.lock:
                ev, token = self._scan(best_shard, schedulers, expired)
            # report refused-expired evals OUTSIDE the shard lock: the
            # terminal callback (leader wiring) does a raft apply, and
            # trace finishing does retention bookkeeping — neither
            # belongs inside the broker's central serialization point
            for dead_ev, finished_root in expired:
                tracer.finish_root(finished_root)
                metrics.incr("overload.deadline_exceeded.broker")
                logger.warning(
                    "refusing to dequeue eval %s: deadline exceeded "
                    "(job %s, %.3fs past)",
                    dead_ev.id[:8], dead_ev.job_id,
                    (time.time_ns() - dead_ev.deadline) / 1e9,
                )
                if self.on_deadline_exceeded is not None:
                    try:
                        self.on_deadline_exceeded(dead_ev)
                    except Exception:
                        logger.exception(
                            "deadline-exceeded callback failed for %s",
                            dead_ev.id[:8],
                        )
            if ev is not None:
                return ev, token
            # raced: the peeked eval was taken; rescan

    def _scan(
        self, shard: _Shard, schedulers: list[str], expired: list = None
    ) -> tuple[Optional[Evaluation], str]:
        """Pick the highest-priority eval across the shard's eligible
        queues; caller holds shard.lock. Evals whose deadline already
        passed are REFUSED at the pop (the overload plane's first
        enforcement point, core/overload.py): their broker state is
        resolved terminally here — exactly the cleanup ``ack`` performs —
        and they ride ``expired`` out to the caller, which reports them
        (trace finish + metric + terminal callback) outside the lock.
        Paying a worker/applier/device round for work nobody is waiting
        on anymore would only deepen the overload that expired it."""
        while True:
            best: Optional[Evaluation] = None
            best_queue = ""
            for sched in schedulers:
                heap_ = shard.ready.get(sched)
                if not heap_ or not len(heap_):
                    continue
                candidate = heap_.peek()
                if best is None or candidate.priority > best.priority:
                    best = candidate
                    best_queue = sched
            if best is None:
                return None, ""
            ev = shard.ready[best_queue].pop()

            if ev.deadline and time.time_ns() >= ev.deadline:
                tracer.eval_event(
                    ev.id, "eval.deadline_exceeded",
                    tags={"where": "broker"},
                )
                # terminal resolution of the broker's state for this
                # eval: the ack cleanup, minus unack (it was never
                # delivered)
                shard.evals.pop(ev.id, None)
                with self._route_lock:
                    self._route.pop(ev.id, None)
                finished_root = tracer.detach_eval(ev.id)
                key = (ev.namespace, ev.job_id)
                if shard.job_evals.get(key) == ev.id:
                    shard.job_evals.pop(key, None)
                    blocked = shard.blocked.get(key)
                    if blocked is not None and len(blocked):
                        nxt = blocked.pop()
                        if not len(blocked):
                            del shard.blocked[key]
                        self._enqueue_locked(shard, nxt, nxt.type)
                if expired is not None:
                    expired.append((ev, finished_root))
                continue  # rescan: the next-best eval may still be live

            token = generate_uuid()
            shard.evals[ev.id] = shard.evals.get(ev.id, 0) + 1
            # ready-queue wait becomes a span on first delivery (the stage
            # between submit and a worker picking the eval up)
            tracer.eval_dequeued(ev.id)

            shard.unack[ev.id] = (
                ev, token,
                _WHEEL.arm(self.nack_timeout, self._nack_timeout, (ev.id, token)),
            )
            return ev, token

    def _nack_timeout(self, eval_id: str, token: str):
        try:
            self.nack(eval_id, token, from_timer=True)
        except BrokerError:
            pass

    # ------------------------------------------------------------------
    def outstanding(self, eval_id: str) -> tuple[str, bool]:
        shard = self._shard_of(eval_id)
        if shard is None:
            return "", False
        with shard.lock:
            unack = shard.unack.get(eval_id)
            if unack is None:
                return "", False
            return unack[1], True

    def outstanding_reset(self, eval_id: str, token: str):
        """Restart the nack timer — the worker's lease extension while it
        is still making progress (ref eval_broker.go OutstandingReset,
        called from the worker's WaitForIndex heartbeat)."""
        shard = self._shard_of(eval_id)
        if shard is None:
            raise BrokerError("evaluation is not outstanding")
        with shard.lock:
            unack = shard.unack.get(eval_id)
            if unack is None:
                raise BrokerError("evaluation is not outstanding")
            ev, utoken, timer = unack
            if utoken != token:
                raise BrokerError("evaluation token does not match")
            timer.cancel()
            shard.unack[eval_id] = (
                ev, token,
                _WHEEL.arm(self.nack_timeout, self._nack_timeout, (eval_id, token)),
            )

    def pause_nack_timeout(self, eval_id: str, token: str):
        """Pause the nack timer while the eval's plan waits in the plan
        queue — progress is being made; also the token guard: a stale
        worker (its eval nacked and re-dequeued elsewhere) fails here and
        its plan never reaches the queue (ref eval_broker.go:656-672,
        plan_endpoint.go:30-35)."""
        shard = self._shard_of(eval_id)
        if shard is None:
            raise BrokerError("evaluation is not outstanding")
        with shard.lock:
            unack = shard.unack.get(eval_id)
            if unack is None:
                raise BrokerError("evaluation is not outstanding")
            _, utoken, timer = unack
            if utoken != token:
                raise BrokerError("evaluation token does not match")
            shard.paused.add(eval_id)
            timer.cancel()

    def resume_nack_timeout(self, eval_id: str, token: str):
        """Re-arm the nack timer after the plan result returns
        (ref eval_broker.go:674-690). Token validation precedes the paused-
        set removal: a stale holder's resume must not strip the CURRENT
        holder's pause (a lock-blocked timer callback would then slip past
        the paused guard and nack a live plan)."""
        shard = self._shard_of(eval_id)
        if shard is None:
            raise BrokerError("evaluation is not outstanding")
        with shard.lock:
            unack = shard.unack.get(eval_id)
            if unack is None:
                raise BrokerError("evaluation is not outstanding")
            ev, utoken, _ = unack
            if utoken != token:
                raise BrokerError("evaluation token does not match")
            shard.paused.discard(eval_id)
            shard.unack[eval_id] = (
                ev, token,
                _WHEEL.arm(self.nack_timeout, self._nack_timeout, (eval_id, token)),
            )

    def ack(self, eval_id: str, token: str):
        """ref eval_broker.go:531-592"""
        shard = self._shard_of(eval_id)
        if shard is None:
            raise BrokerError("Evaluation ID not found")
        with shard.lock:
            requeued = shard.requeue.pop(token, None)
            unack = shard.unack.get(eval_id)
            if unack is None:
                raise BrokerError("Evaluation ID not found")
            ev, utoken, timer = unack
            if utoken != token:
                raise BrokerError("Token does not match for Evaluation ID")
            timer.cancel()
            del shard.unack[eval_id]
            shard.evals.pop(eval_id, None)
            shard.paused.discard(eval_id)
            with self._route_lock:
                self._route.pop(eval_id, None)
            # detach the root HERE, before a requeued copy of this eval
            # re-enqueues below — its fresh lifecycle must mint a fresh
            # root, not inherit (and then lose) this one. The finish —
            # retention bookkeeping — runs after the lock is released
            finished_root = tracer.detach_eval(eval_id)

            key = (ev.namespace, ev.job_id)
            shard.job_evals.pop(key, None)

            blocked = shard.blocked.get(key)
            if blocked is not None and len(blocked):
                nxt = blocked.pop()
                if not len(blocked):
                    del shard.blocked[key]
                self._enqueue_locked(shard, nxt, nxt.type)

            if requeued is not None:
                # same (ns, job) — the requeued eval routes to THIS shard
                self._process_enqueue(shard, requeued, "")
        self._notify()
        # close the detached root OUTSIDE the broker lock: finishing a
        # trace does retention bookkeeping (ring/heap maintenance) that
        # has no business inside the scheduler's central serialization
        # point
        tracer.finish_root(finished_root)

    def nack(self, eval_id: str, token: str, from_timer: bool = False):
        """ref eval_broker.go:595-642. ``from_timer`` marks the nack-timeout
        path, which must yield to a concurrent pause: Timer.cancel() can't
        stop a callback already blocked on this lock, so the paused-set
        check (atomic under the same lock as pause) is the real guard."""
        shard = self._shard_of(eval_id)
        if shard is None:
            raise BrokerError("Evaluation ID not found")
        with shard.lock:
            if from_timer and eval_id in shard.paused:
                return
            shard.requeue.pop(token, None)
            unack = shard.unack.get(eval_id)
            if unack is None:
                raise BrokerError("Evaluation ID not found")
            ev, utoken, timer = unack
            if utoken != token:
                raise BrokerError("Token does not match for Evaluation ID")
            timer.cancel()
            del shard.unack[eval_id]

            dequeues = shard.evals.get(eval_id, 0)
            # marker on the eval's trace: the retry is visible in the
            # tree (a severed worker shows as nack → re-dequeue, one
            # connected trace, not two)
            tracer.eval_event(
                ev.id, "eval.nack",
                tags={"from_timer": from_timer, "dequeues": dequeues},
            )
            if dequeues >= self.delivery_limit:
                self._enqueue_locked(shard, ev, FAILED_QUEUE)
            else:
                delay = self._nack_reenqueue_delay(dequeues)
                if delay > 0:
                    shard.time_wait[ev.id] = _WHEEL.arm(
                        delay, self._enqueue_waiting, (ev,)
                    )
                else:
                    self._enqueue_locked(shard, ev, ev.type)
        self._notify()

    def _nack_reenqueue_delay(self, prev_dequeues: int) -> float:
        """ref eval_broker.go:644-655"""
        if prev_dequeues <= 0:
            return 0.0
        if prev_dequeues == 1:
            return self.initial_nack_delay
        return (prev_dequeues - 1) * self.subsequent_nack_delay

    # ------------------------------------------------------------------
    def flush(self):
        """Cancel timers and drop all state (ref eval_broker.go:692-749).
        ``enabled`` is already False when this runs off set_enabled, so an
        enqueue racing a shard's clear either observes the flag or loses
        the shard lock to us and is cleared."""
        for shard in self._shards:
            with shard.lock:
                for _, _, timer in shard.unack.values():
                    timer.cancel()
                for timer in shard.time_wait.values():
                    timer.cancel()
                for eval_id in shard.evals:
                    # leadership revoked: this process stops observing
                    # these evals; abandon their open roots instead of
                    # leaking them
                    tracer.discard_eval(eval_id)
                with self._route_lock:
                    for eval_id in shard.evals:
                        self._route.pop(eval_id, None)
                shard.evals.clear()
                shard.job_evals.clear()
                shard.blocked.clear()
                shard.ready.clear()
                shard.unack.clear()
                shard.requeue.clear()
                shard.paused.clear()
                shard.time_wait.clear()
        self._notify()

    def stats(self) -> dict:
        total_ready = 0
        total_unacked = 0
        total_blocked = 0
        total_waiting = 0
        by_scheduler: dict[str, int] = {}
        for shard in self._shards:
            with shard.lock:
                total_ready += sum(len(h) for h in shard.ready.values())
                total_unacked += len(shard.unack)
                total_blocked += sum(len(h) for h in shard.blocked.values())
                total_waiting += len(shard.time_wait)
                for k, h in shard.ready.items():
                    by_scheduler[k] = by_scheduler.get(k, 0) + len(h)
        return {
            "total_ready": total_ready,
            "total_unacked": total_unacked,
            "total_blocked": total_blocked,
            "total_waiting": total_waiting,
            "by_scheduler": by_scheduler,
            "ready_shards": len(self._shards),
        }
