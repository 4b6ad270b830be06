"""Trace-plane core: span contexts, spans, and the process tracer.

A ``trace_id``/``span_id`` context is minted at eval creation (and at
HTTP/CLI job submit) and carried through the broker, worker, planner,
RPC metadata (``_trace`` payload key), raft plan-entry annotations, FSM
apply, and ColumnarMirror patch application, so one eval's full
lifecycle — including cross-thread and cross-node hops — is a single
span tree (the Dapper model; PAPERS.md distributed-tracing entries).

Design constraints, in priority order:

1. **Zero behavior change**: tracing must never consume seeded RNG
   state, alter ordering, or fail a caller. Sampling decisions hash the
   trace id instead of drawing randomness; every recording path is
   exception-guarded.
2. **Low overhead**: the hot paths (broker enqueue/ack, plan verify)
   touch one dict and two ``time.monotonic()`` calls per span; when a
   span also carries a ``metric=`` name it REPLACES the old
   ``metrics.measure`` call instead of adding to it (the soak's enqueue→ack
   tap and the stage splits ride spans — one source of truth).
3. **Bounded memory**: every registry is capped; see
   :class:`~.store.TraceStore` for retention.

Span lifetimes come in three shapes, matching the ``span-hygiene``
checker's rules (analysis/span_hygiene.py):

- ``with tracer.span(name): ...`` — lexically scoped, always closed;
- ``tracer.record_span(name, ctx, t0, t1)`` — atomic after-the-fact
  record for cross-thread stages (queue waits, device compute) whose
  endpoints live in different functions;
- the eval root span, opened by :meth:`Tracer.eval_root` at first
  enqueue and closed by :meth:`Tracer.finish_eval` at ack — the ONE
  sanctioned cross-call open span, owned by the tracer itself.
"""

from __future__ import annotations

import threading
import time
import uuid
from contextlib import contextmanager
from typing import Optional

from .store import TraceStore

#: wall/monotonic anchor so span times (monotonic) render as wall clock
_ANCHOR_WALL = time.time()
_ANCHOR_MONO = time.monotonic()


def wall_of(mono: float) -> float:
    return _ANCHOR_WALL + (mono - _ANCHOR_MONO)


class SpanContext:
    """The propagated part of a span: enough to parent a child anywhere
    (another thread, another node via RPC metadata or a raft payload
    annotation)."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"SpanContext({self.trace_id[:8]}, {self.span_id[:8]})"


class Span:
    __slots__ = (
        "name", "trace_id", "span_id", "parent_id",
        "t0", "t1", "tags", "flags", "error", "_tracer", "sampled",
    )

    def __init__(self, name, trace_id, span_id, parent_id, t0, tracer,
                 tags=None, sampled=True):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled
        self.t0 = t0
        self.t1 = None
        self.tags = dict(tags) if tags else {}
        # nta: ignore[unbounded-cache] WHY: span-scoped; the flag
        # vocabulary is a handful of code-fixed names, dies at end()
        self.flags: list[str] = []
        self.error: Optional[str] = None
        self._tracer = tracer

    def ctx(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, self.sampled)

    def set_tag(self, key, value):
        self.tags[key] = value

    def flag(self, name: str):
        if name not in self.flags:
            self.flags.append(name)

    def set_error(self, message: str):
        self.error = str(message)

    def end(self, t1: Optional[float] = None):
        if self.t1 is not None:
            return  # idempotent: double-end must not double-record
        self.t1 = t1 if t1 is not None else time.monotonic()
        tracer = self._tracer
        if tracer is not None:
            self._tracer = None
            tracer._record(self)

    @property
    def duration_s(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": round(wall_of(self.t0), 6),
            "duration_ms": round(self.duration_s * 1e3, 3),
            "tags": self.tags,
            "flags": list(self.flags),
            "error": self.error,
        }


class _NoopSpan:
    """Returned on untraced paths so callers never branch."""

    __slots__ = ()

    def ctx(self):
        return None

    def set_tag(self, key, value):
        pass

    def flag(self, name):
        pass

    def set_error(self, message):
        pass

    def end(self, t1=None):
        pass


NOOP_SPAN = _NoopSpan()

#: registry caps: an eval that never acks (crash + lease churn under a
#: storm) must not pin its entry forever. Sized WELL above observed
#: in-flight eval counts (the 1M-alloc soak peaked around 10K): FIFO
#: eviction of a live root loses that eval's eval.e2e sample, so the
#: cap is a leak backstop, not a working set — evictions are counted
#: (trace.eval_root_evicted) so under-sampling is never silent
_MAX_EVAL_ENTRIES = 65536
_MAX_INDEX_ENTRIES = 4096


def _span_id() -> str:
    return uuid.uuid4().hex[:16]


class Tracer:
    """Process-wide tracer (the go-metrics-style module singleton:
    brokers/workers/servers come and go, the trace plane persists)."""

    def __init__(self):
        self.enabled = True
        #: head-sampling rate in [0, 1]; the decision is a hash of the
        #: trace id, so it is stable per trace and consumes no RNG
        self.sample_rate = 1.0
        self.store = TraceStore()
        self._tls = threading.local()
        self._lock = threading.Lock()
        #: eval id -> open root span ("eval.e2e"), enqueue → ack
        self._eval_roots: dict[str, Span] = {}
        #: eval id -> parent ctx adopted before the eval reached the
        #: broker (HTTP/CLI submit, RPC handler), or the root ctx after
        self._eval_ctx: dict[str, SpanContext] = {}
        #: raft index -> [ctx] of the plan entries committed at it (the
        #: mirror links its patch spans through this)
        self._index_ctx: dict[int, list[SpanContext]] = {}

    # -- configuration --------------------------------------------------
    def configure(self, **kw):
        """Apply a ``trace{}`` config stanza: enabled, sample_rate,
        retain, slow_keep, error_keep. Unknown keys are rejected so a
        typo'd stanza fails loudly at agent start, not silently at p99
        time."""
        for key, value in kw.items():
            if key == "enabled":
                self.enabled = bool(value)
            elif key == "sample_rate":
                self.sample_rate = min(max(float(value), 0.0), 1.0)
            elif key in ("retain", "slow_keep", "error_keep"):
                self.store.configure(**{key: int(value)})
            else:
                raise ValueError(f"unknown trace setting: {key}")

    def reset(self):
        """Test hook: drop every registry and retained trace."""
        with self._lock:
            self._eval_roots.clear()
            self._eval_ctx.clear()
            self._index_ctx.clear()
        self.store.reset()
        self.enabled = True
        self.sample_rate = 1.0

    def _sampled(self, trace_id: str) -> bool:
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        # stable per-trace decision without touching any RNG
        return (int(trace_id[:8], 16) % 10000) < self.sample_rate * 10000

    # -- thread-local context -------------------------------------------
    def current(self) -> Optional[SpanContext]:
        return getattr(self._tls, "ctx", None)

    @contextmanager
    def activate(self, ctx: Optional[SpanContext]):
        """Install ``ctx`` as the thread's current context (the RPC
        server handler path: extracted wire metadata becomes the parent
        of everything the handler does)."""
        prev = getattr(self._tls, "ctx", None)
        self._tls.ctx = ctx
        try:
            yield
        finally:
            self._tls.ctx = prev

    # -- span creation ---------------------------------------------------
    def _start(self, name, parent: Optional[SpanContext], tags) -> Span:
        span = Span(
            name, parent.trace_id, _span_id(), parent.span_id,
            time.monotonic(), self, tags,
        )
        return span

    def start_root(self, name: str, tags=None) -> Span:
        """Mint a new trace; the returned span is its root. The caller
        owns closing it (``span-hygiene`` checker enforced)."""
        trace_id = uuid.uuid4().hex
        sampled = self.enabled and self._sampled(trace_id)
        if not sampled:
            return NOOP_SPAN
        span = Span(name, trace_id, _span_id(), None, time.monotonic(),
                    self, tags)
        self.store.open_trace(trace_id)
        return span

    def start_span(self, name: str, parent=None, tags=None):
        """Manual child span; the caller MUST ``end()`` it on every exit
        path (``span-hygiene`` checker enforced). Prefer ``span()`` or
        ``record_span()``."""
        parent = parent if parent is not None else self.current()
        if not self.enabled or parent is None or not parent.sampled:
            return NOOP_SPAN
        return self._start(name, parent, tags)

    @contextmanager
    def root(self, name: str, tags=None):
        """Lexically-scoped new trace (HTTP/CLI submit surfaces)."""
        span = self.start_root(name, tags)
        ctx = span.ctx()
        prev = getattr(self._tls, "ctx", None)
        if ctx is not None:
            self._tls.ctx = ctx
        try:
            yield span
        except BaseException as e:
            span.set_error(repr(e))
            raise
        finally:
            self._tls.ctx = prev
            span.end()

    @contextmanager
    def span(self, name: str, parent=None, tags=None, metric: str = None):
        """Lexically-scoped span under ``parent`` (or the thread's
        current context). With ``metric=``, the block is ALSO sampled
        into that timer — with the trace id as exemplar — whether or not
        a trace is active: this is the unified replacement for
        ``metrics.measure`` on the stage-split paths."""
        parent = parent if parent is not None else self.current()
        recording = (
            self.enabled and parent is not None and parent.sampled
        )
        t0 = time.monotonic()
        span = self._start(name, parent, tags) if recording else NOOP_SPAN
        prev = getattr(self._tls, "ctx", None)
        if recording:
            self._tls.ctx = span.ctx()
        try:
            yield span
        except BaseException as e:
            span.set_error(repr(e))
            raise
        finally:
            if recording:
                self._tls.ctx = prev
            t1 = time.monotonic()
            span.end(t1)
            if metric is not None:
                from .. import metrics

                metrics.sample(
                    metric, t1 - t0,
                    exemplar=parent.trace_id if recording else None,
                )

    def record_span(
        self, name: str, ctx: Optional[SpanContext], t0: float, t1: float,
        tags=None, flags=(), metric: str = None, error: str = None,
    ):
        """Atomic after-the-fact span for stages whose endpoints live in
        different functions/threads (queue waits, device compute,
        barrier resolutions). With ``metric=``, also samples the timer
        (exemplar-linked) — even when ``ctx`` is None, so metrics keep
        flowing with tracing off."""
        if metric is not None:
            from .. import metrics

            metrics.sample(
                metric, t1 - t0,
                exemplar=ctx.trace_id
                if ctx is not None and ctx.sampled and self.enabled
                else None,
            )
        if not self.enabled or ctx is None or not ctx.sampled:
            return
        span = Span(name, ctx.trace_id, _span_id(), ctx.span_id, t0, None,
                    tags)
        span.t1 = t1
        for f in flags:
            span.flag(f)
        if error is not None:
            span.set_error(error)
        self._record(span)

    def _record(self, span: Span):
        try:
            self.store.add_span(span.to_dict())
        except Exception:  # recording must never fail a caller
            pass

    # -- eval lifecycle --------------------------------------------------
    def adopt_eval(self, eval_id: str, ctx: Optional[SpanContext] = None):
        """Pre-register the parent context for an eval about to be
        created (HTTP/CLI submit → raft apply → broker enqueue happens on
        another thread; the registry carries the link across)."""
        ctx = ctx if ctx is not None else self.current()
        if ctx is None or not self.enabled or not eval_id:
            return
        with self._lock:
            if len(self._eval_ctx) >= _MAX_EVAL_ENTRIES:
                self._eval_ctx.pop(next(iter(self._eval_ctx)))
            self._eval_ctx[eval_id] = ctx

    def eval_root(self, eval_id: str, tags=None):
        """Open the eval's root span ("eval.e2e") at first broker
        enqueue. Closed by finish_eval (ack) / discard_eval (flush) —
        the tracer-owned cross-call span. Even disabled/unsampled evals
        get a timing-only root (sampled=False, no spans stored): the
        ``eval.e2e`` metric must keep flowing with tracing off — it is
        the soak scorekeeper's SLO signal, and the trace plane replaced
        the broker's old side-table tap as its ONE source."""
        with self._lock:
            if eval_id in self._eval_roots:
                return  # re-enqueue of a live eval keeps the first root
            parent = self._eval_ctx.get(eval_id)
        if parent is not None:
            sampled = self.enabled and parent.sampled
            span = Span(
                "eval.e2e", parent.trace_id, _span_id(), parent.span_id,
                time.monotonic(), self, tags, sampled=sampled,
            )
        else:
            trace_id = uuid.uuid4().hex
            sampled = self.enabled and self._sampled(trace_id)
            span = Span("eval.e2e", trace_id, _span_id(), None,
                        time.monotonic(), self, tags, sampled=sampled)
            if sampled:
                self.store.open_trace(trace_id)
        span.set_tag("eval_id", eval_id)
        victim_root = None
        with self._lock:
            if len(self._eval_roots) >= _MAX_EVAL_ENTRIES:
                victim = next(iter(self._eval_roots))
                victim_root = self._eval_roots.pop(victim)
                self._eval_ctx.pop(victim, None)
            self._eval_roots[eval_id] = span
            self._eval_ctx[eval_id] = span.ctx()
        if victim_root is not None:
            # backstop eviction of a live root: release its open trace
            # (no leak) and count the lost eval.e2e sample loudly
            if victim_root.sampled:
                self.store.drop_trace(victim_root.trace_id)
            from .. import metrics

            metrics.incr("trace.eval_root_evicted")

    def ctx_for_eval(self, eval_id: str) -> Optional[SpanContext]:
        if not self.enabled or not eval_id:
            return None
        with self._lock:
            root = self._eval_roots.get(eval_id)
            if root is not None:
                return root.ctx()
            return self._eval_ctx.get(eval_id)

    def annotation_for_eval(self, eval_id: str) -> Optional[dict]:
        """Wire form of the eval's context for raft payload annotations
        (the FSM pops it; it never enters state-store objects, so traced
        and untraced runs produce byte-identical state). Unsampled evals
        annotate nothing — replicas would record spans no store keeps."""
        ctx = self.ctx_for_eval(eval_id)
        if ctx is None or not ctx.sampled:
            return None
        return ctx.to_dict()

    def ctx_from_annotation(self, doc) -> Optional[SpanContext]:
        if not self.enabled or not isinstance(doc, dict):
            return None
        trace_id = doc.get("trace_id")
        span_id = doc.get("span_id")
        if not trace_id or not span_id:
            return None
        return SpanContext(str(trace_id), str(span_id))

    def eval_dequeued(self, eval_id: str):
        """Record the broker ready-queue wait (first enqueue → first
        dequeue) as an ``eval.queue_wait`` span: without it the queue
        time is unattributed root self-time and the critical-path table
        can't separate 'waiting for a worker' from the stages below.
        Re-deliveries don't re-record — the nack markers already place
        them on the timeline. Called under the broker lock, which
        serializes the dequeue-count tag update."""
        with self._lock:
            root = self._eval_roots.get(eval_id)
        if root is None or not root.sampled:
            return
        if root.tags.get("dequeues"):
            root.tags["dequeues"] += 1
            return
        root.tags["dequeues"] = 1
        self.record_span(
            "eval.queue_wait", root.ctx(), root.t0, time.monotonic()
        )

    def eval_event(self, eval_id: str, name: str, tags=None):
        """Zero-duration marker span on the eval's trace (nacks, lease
        expiries) — the tree shows WHEN the retry happened."""
        ctx = self.ctx_for_eval(eval_id)
        if ctx is None:
            return
        now = time.monotonic()
        self.record_span(name, ctx, now, now, tags=tags)

    def detach_eval(self, eval_id: str):
        """Pop the eval's root from the registries WITHOUT finishing it
        — the broker's ack does this inside its lock (cheap: two dict
        pops) so a requeued eval re-enqueued in the same locked section
        mints a FRESH root, then finishes the detached one outside the
        lock via finish_root."""
        with self._lock:
            root = self._eval_roots.pop(eval_id, None)
            self._eval_ctx.pop(eval_id, None)
        return root

    def finish_eval(self, eval_id: str, error: Optional[str] = None):
        """Close the eval's root span (broker ack) and hand the trace to
        the store's retention policy; emits the ``eval.e2e`` timer with
        the trace id as exemplar (the soak's tap, span-sourced)."""
        self.finish_root(self.detach_eval(eval_id), error=error)

    def finish_root(self, root, error: Optional[str] = None):
        if root is None:
            return
        t1 = time.monotonic()
        if error is not None:
            root.set_error(error)
        root._tracer = None
        root.t1 = t1
        from .. import metrics

        metrics.sample(
            "eval.e2e", t1 - root.t0,
            exemplar=root.trace_id if root.sampled else None,
        )
        if not root.sampled:
            return
        try:
            self.store.finish_trace(root.trace_id, root.to_dict())
        except Exception:
            pass

    def discard_eval(self, eval_id: str):
        """Broker flush (leadership revoked): the eval's lifecycle is no
        longer this process's to observe; drop the open root."""
        with self._lock:
            root = self._eval_roots.pop(eval_id, None)
            self._eval_ctx.pop(eval_id, None)
        if root is not None:
            self.store.drop_trace(root.trace_id)

    # -- raft-index linking (mirror patch spans) ------------------------
    def link_index(self, index: int, ctx: Optional[SpanContext]):
        if ctx is None or not self.enabled:
            return
        with self._lock:
            if len(self._index_ctx) >= _MAX_INDEX_ENTRIES:
                self._index_ctx.pop(next(iter(self._index_ctx)))
            self._index_ctx.setdefault(index, []).append(ctx)

    def ctxs_for_index(self, index: int) -> list:
        if not self.enabled:
            return []
        with self._lock:
            return list(self._index_ctx.get(index, ()))

    def stats(self) -> dict:
        with self._lock:
            open_roots = len(self._eval_roots)
        out = self.store.stats()
        out.update(
            enabled=self.enabled,
            sample_rate=self.sample_rate,
            open_eval_roots=open_roots,
        )
        return out


#: the process tracer (metrics-registry idiom: one per process)
tracer = Tracer()
