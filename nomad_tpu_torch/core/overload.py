"""Overload control plane: deadlines, admission control, retry budgets,
and brownout degradation (OBSERVABILITY.md "The overload plane").

Nothing in the scheduler pipeline defends itself when demand exceeds
capacity: a request that has already blown its client deadline still
consumes broker/worker/applier/device time, and the retry ladders
(rpc/client.py leader chase, api/http.py forward loops) amplify load
exactly when the system can least afford it — the classic metastable
retry storm. This module is the one place that failure mode is answered:

- ``Deadline``: wall-clock unix-ns deadlines minted at the HTTP edge
  (``X-Nomad-Deadline`` header / ``?wait=``), carried through the RPC
  payload (``_deadline`` key, the ``_trace`` pattern) into
  ``Evaluation.deadline`` / ``Plan.deadline``, and enforced at every
  stage: broker dequeue, worker evaluate, applier verify/commit, and the
  drain plane's device dispatch. Expired work is failed terminal with a
  loud ``deadline_exceeded`` outcome — never silently dropped.
- ``AdmissionController``: bounded accept at the HTTP/RPC edge with
  priority-aware shedding (system > service > batch) driven by a cheap
  cached load signal (broker depth + plan.queue_wait p99). Reject-early
  with 429/``ErrOverloaded`` + a retry-after hint keeps queues short
  instead of metastable.
- ``RetryBudget``: a token bucket shared by every client-side retry
  ladder in the process. Retries beyond the budget fail fast — total
  retry volume is bounded no matter how many ladders are spinning.
- ``BrownoutController``: a deterministic ladder that degrades expensive
  optional work under sustained overload (wavefront→exact-scan, trace
  sampling→0, devprof off, snapshot-on-subscribe off) and restores every
  knob on recovery. With no overload stanza the controller is never
  constructed and no knob is ever touched (the A/B contract).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from .. import metrics
from ..structs.model import now_ns

logger = logging.getLogger("nomad_tpu.overload")


# ---------------------------------------------------------------------------
# Deadlines (wall-clock unix ns, 0 = no deadline)
# ---------------------------------------------------------------------------


class DeadlineExceeded(Exception):
    """Work refused because its deadline already passed. ``where`` names
    the stage that refused (edge/broker/worker/applier/drain) so the
    outcome is attributable, not just loud."""

    def __init__(self, message: str = "deadline exceeded", where: str = ""):
        super().__init__(message)
        self.where = where


def mint_deadline(ttl_s: float) -> int:
    """A deadline ``ttl_s`` seconds from now (unix ns)."""
    return now_ns() + int(ttl_s * 1e9)


def deadline_expired(deadline_ns: int) -> bool:
    return deadline_ns != 0 and now_ns() >= deadline_ns


def deadline_remaining_s(deadline_ns: int) -> Optional[float]:
    """Seconds until the deadline; None when there is no deadline."""
    if deadline_ns == 0:
        return None
    return (deadline_ns - now_ns()) / 1e9


_tls = threading.local()


class deadline_scope:
    """Thread-local current-deadline activation (the trace ``activate``
    pattern): the HTTP/RPC dispatch enters this around the handler call,
    and anything downstream on the same thread — ``Server.job_register``
    stamping ``Evaluation.deadline``, the RPC client injecting
    ``_deadline`` into forwarded payloads — reads it via
    ``current_deadline()``. Re-entrant: an inner scope with no deadline
    (0) inherits the outer one."""

    def __init__(self, deadline_ns: int):
        self.deadline_ns = int(deadline_ns or 0)
        self._prev = 0

    def __enter__(self):
        self._prev = getattr(_tls, "deadline", 0)
        if self.deadline_ns:
            _tls.deadline = self.deadline_ns
        return self

    def __exit__(self, *exc):
        _tls.deadline = self._prev
        return False


def current_deadline() -> int:
    """The active thread's deadline (unix ns), 0 when none."""
    return getattr(_tls, "deadline", 0)


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------


class ErrOverloaded(Exception):
    """Admission refused: the server is shedding this priority class.
    ``retry_after`` (seconds) is the client hint carried on the HTTP 429
    ``Retry-After`` header and the RPC ``overloaded`` error object."""

    def __init__(self, message: str = "server overloaded", retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = retry_after


#: priority classes, most sheddable first (system work — and node
#: heartbeats, which are exempted before classification — is never shed:
#: an overload burst must not cascade into mass node-down)
CLASS_BATCH = "batch"
CLASS_SERVICE = "service"
CLASS_SYSTEM = "system"
CLASSES = (CLASS_BATCH, CLASS_SERVICE, CLASS_SYSTEM)


def classify_priority(priority: int) -> str:
    """Map an eval/job priority to a shedding class (reusing the eval
    priority bands: system jobs register at >= 90, the default service
    priority is 50, batch work conventionally runs below it)."""
    if priority >= 90:
        return CLASS_SYSTEM
    if priority >= 50:
        return CLASS_SERVICE
    return CLASS_BATCH


class AdmissionController:
    """Reject-early at the edge, driven by a cheap cached load signal.

    ``load()`` is a unitless pressure number: 1.0 means a load-signal
    component is at its configured budget. Components (each normalized
    by its budget, the max wins):

    - broker ready+unacked depth vs ``depth_limit``
    - ``plan.queue_wait`` p99 vs ``queue_wait_budget_ms`` (the applier
      is the known saturation point; its queue wait is THE backpressure
      signal the flight recorder already samples)

    The signal is recomputed at most every ``cache_s`` seconds — an
    admission check on the hot path costs a clock read and a compare.
    Shedding is priority-aware: batch sheds at ``shed_batch`` load,
    service at ``shed_service``, system never."""

    def __init__(
        self,
        load_fn: Callable[[], float],
        shed_batch: float = 0.8,
        shed_service: float = 0.95,
        retry_after_s: float = 1.0,
        cache_s: float = 0.5,
    ):
        self._load_fn = load_fn
        self.shed_batch = float(shed_batch)
        self.shed_service = float(shed_service)
        self.retry_after_s = float(retry_after_s)
        self.cache_s = float(cache_s)
        self._lock = threading.Lock()
        self._cached_load = 0.0
        self._cached_at = 0.0
        #: monotonic counters mirrored into the flight recorder sample
        self.admitted = 0
        self.shed = {CLASS_BATCH: 0, CLASS_SERVICE: 0, CLASS_SYSTEM: 0}

    def load(self) -> float:
        now = time.monotonic()
        with self._lock:
            if now - self._cached_at < self.cache_s:
                return self._cached_load
            # claim the refresh slot under the lock, compute outside it
            self._cached_at = now
        try:
            load = float(self._load_fn())
        except Exception:
            load = 0.0  # a broken signal must not shed traffic
        with self._lock:
            self._cached_load = load
        return load

    def threshold(self, cls: str) -> Optional[float]:
        if cls == CLASS_BATCH:
            return self.shed_batch
        if cls == CLASS_SERVICE:
            return self.shed_service
        return None  # system: never shed

    def admit(self, cls: str):
        """Raise ``ErrOverloaded`` when ``cls`` should be shed now."""
        limit = self.threshold(cls)
        if limit is None:
            with self._lock:
                # counter increments share the load-cache lock: admit()
                # runs on every handler thread at once while stats() and
                # the flight recorder read the totals (lost increments
                # here silently understate shed rates — racedep-witnessed)
                self.admitted += 1
            return
        load = self.load()
        if load >= limit:
            with self._lock:
                self.shed[cls] += 1
            metrics.incr(f"overload.shed.{cls}")
            raise ErrOverloaded(
                f"server overloaded (load={load:.2f}); "
                f"shedding {cls} work",
                retry_after=self.retry_after_s,
            )
        with self._lock:
            self.admitted += 1

    def shed_total(self) -> int:
        with self._lock:
            return sum(self.shed.values())

    def stats(self) -> dict:
        load = self.load()
        with self._lock:
            return {
                "load": load,
                "admitted": self.admitted,
                "shed": dict(self.shed),
                "shed_batch_at": self.shed_batch,
                "shed_service_at": self.shed_service,
            }


# ---------------------------------------------------------------------------
# Retry budget
# ---------------------------------------------------------------------------


class RetryBudget:
    """Token-bucket retry budget shared across every client-side retry
    ladder (rpc/client.py leader chase + rotation, api/http.py leader and
    region forward loops). First attempts are free; each RETRY consumes a
    token. When the bucket is dry the ladder fails fast with whatever
    error it last saw — under a real outage every caller retrying to its
    individual limit multiplies offered load exactly when capacity is
    lowest, and this bucket is the process-wide bound on that product."""

    def __init__(self, capacity: int = 256, refill_per_s: float = 64.0):
        self.capacity = max(1, int(capacity))
        self.refill_per_s = float(refill_per_s)
        self._tokens = float(self.capacity)
        self._last = time.monotonic()
        self._lock = threading.Lock()
        #: monotonic counters (flight recorder + regression tests)
        self.spent = 0
        self.exhausted = 0

    def try_acquire(self, n: int = 1) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                float(self.capacity),
                self._tokens + (now - self._last) * self.refill_per_s,
            )
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                self.spent += n
                return True
            self.exhausted += 1
            metrics.incr("overload.retry_budget_exhausted")
            return False

    def remaining(self) -> float:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                float(self.capacity),
                self._tokens + (now - self._last) * self.refill_per_s,
            )
            self._last = now
            return self._tokens


_budget_lock = threading.Lock()
_budget: Optional[RetryBudget] = None


def retry_budget() -> RetryBudget:
    """The process-wide retry budget (lazily constructed with defaults;
    ``configure_retry_budget`` resizes it from the overload stanza)."""
    global _budget
    with _budget_lock:
        if _budget is None:
            _budget = RetryBudget()
        return _budget


def configure_retry_budget(capacity: int, refill_per_s: float) -> RetryBudget:
    global _budget
    with _budget_lock:
        _budget = RetryBudget(capacity=capacity, refill_per_s=refill_per_s)
        return _budget


def reset_retry_budget():
    """Test hook: back to the lazily-constructed default."""
    global _budget
    with _budget_lock:
        _budget = None


# ---------------------------------------------------------------------------
# Brownout ladder
# ---------------------------------------------------------------------------


class BrownoutController:
    """Deterministic degradation ladder for sustained overload.

    ``actions`` is an ordered list of ``(name, degrade_fn, restore_fn)``;
    level N means the first N actions are degraded. Transitions are
    streak-driven (``enter_streak`` consecutive samples at/above
    ``enter`` raise the level by one; ``exit_streak`` consecutive samples
    at/below ``exit`` lower it by one), so for a given sample sequence
    the level trajectory is a pure function — no timers, no randomness.
    Every transition is logged and counted, and ``restore_all`` (server
    stop) unwinds whatever is degraded so no knob leaks past the
    controller's life."""

    def __init__(
        self,
        actions: list,
        enter: float = 0.9,
        exit: float = 0.6,
        enter_streak: int = 3,
        exit_streak: int = 5,
    ):
        self.actions = list(actions)
        self.enter = float(enter)
        self.exit = float(exit)
        self.enter_streak = max(1, int(enter_streak))
        self.exit_streak = max(1, int(exit_streak))
        self._lock = threading.Lock()
        self.level = 0
        #: deepest level reached since construction (the storm report's
        #: proof the ladder actually engaged)
        self.peak_level = 0
        self._hot = 0
        self._cool = 0
        self.transitions = 0

    @property
    def max_level(self) -> int:
        return len(self.actions)

    def on_sample(self, load: float) -> int:
        """Feed one load sample; returns the (possibly new) level."""
        with self._lock:
            if load >= self.enter:
                self._hot += 1
                self._cool = 0
                if self._hot >= self.enter_streak and self.level < self.max_level:
                    self._hot = 0
                    self._step_locked(self.level + 1)
            elif load <= self.exit:
                self._cool += 1
                self._hot = 0
                if self._cool >= self.exit_streak and self.level > 0:
                    self._cool = 0
                    self._step_locked(self.level - 1)
            else:
                # between thresholds: hold, and break both streaks so a
                # flapping signal can't ratchet the ladder
                self._hot = 0
                self._cool = 0
            return self.level

    def _step_locked(self, new_level: int):
        old = self.level
        if new_level > old:
            for name, degrade, _restore in self.actions[old:new_level]:
                self._flip(name, degrade, "degrade")
        else:
            for name, _degrade, restore in reversed(
                self.actions[new_level:old]
            ):
                self._flip(name, restore, "restore")
        self.level = new_level
        self.peak_level = max(self.peak_level, new_level)
        self.transitions += 1
        direction = "enter" if new_level > old else "exit"
        metrics.incr(f"overload.brownout.{direction}")
        logger.warning(
            "brownout %s: level %d -> %d (%s)",
            direction, old, new_level,
            ", ".join(n for n, _, _ in self.actions[:new_level]) or "clear",
        )

    @staticmethod
    def _flip(name: str, fn, what: str):
        try:
            fn()
            metrics.incr(f"overload.brownout.{what}.{name}")
        except Exception:
            logger.exception("brownout %s of %s failed", what, name)

    def restore_all(self):
        with self._lock:
            if self.level:
                self._step_locked(0)
            self._hot = 0
            self._cool = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "level": self.level,
                "peak_level": self.peak_level,
                "max_level": self.max_level,
                "transitions": self.transitions,
                "degraded": [n for n, _, _ in self.actions[: self.level]],
            }


# ---------------------------------------------------------------------------
# The per-server umbrella
# ---------------------------------------------------------------------------


class OverloadController:
    """One server's overload plane: the admission controller, the retry
    budget sizing, the brownout ladder, and the deadline-exceeded
    accounting — constructed from the ``overload{}`` config stanza by
    ``Server.__init__`` (absent stanza → no controller → byte-identical
    pre-overload behavior)."""

    def __init__(
        self,
        config: dict,
        load_fn: Callable[[], float],
        brownout_actions: Optional[list] = None,
    ):
        self.config = dict(config)
        self.default_deadline_s = float(config.get("default_deadline_s", 0.0))
        self.admission = AdmissionController(
            load_fn,
            shed_batch=float(config.get("shed_batch", 0.8)),
            shed_service=float(config.get("shed_service", 0.95)),
            retry_after_s=float(config.get("retry_after_s", 1.0)),
            cache_s=float(config.get("load_cache_s", 0.5)),
        )
        if "retry_budget" in config or "retry_refill_per_s" in config:
            configure_retry_budget(
                int(config.get("retry_budget", 256)),
                float(config.get("retry_refill_per_s", 64.0)),
            )
        bo_cfg = dict(config.get("brownout") or {})
        self.brownout: Optional[BrownoutController] = None
        if brownout_actions and bo_cfg.get("enabled", True):
            self.brownout = BrownoutController(
                brownout_actions,
                enter=float(bo_cfg.get("enter", 0.9)),
                exit=float(bo_cfg.get("exit", 0.6)),
                enter_streak=int(bo_cfg.get("enter_streak", 3)),
                exit_streak=int(bo_cfg.get("exit_streak", 5)),
            )
        self._lock = threading.Lock()
        #: terminal deadline_exceeded outcomes by refusing stage
        # WHY: key space is the fixed stage set (edge/rpc/broker/worker/
        # applier/drain) — bounded by construction, no eviction needed
        self.deadline_exceeded: dict[str, int] = {}  # nta: ignore[unbounded-cache]

    def admit_request(self, priority: Optional[int] = None):
        """Edge admission: classify by eval/job priority (50 — the job
        default — when the request names none) and shed by class. Raises
        ``ErrOverloaded`` when the class is refused at current load."""
        self.admission.admit(
            classify_priority(50 if priority is None else int(priority))
        )

    def note_deadline_exceeded(self, where: str):
        """Ledger a terminal deadline_exceeded outcome. The REFUSING
        stage increments its own ``overload.deadline_exceeded.<where>``
        metric at the refusal point (broker/worker/applier/drain); this
        is only the controller-side ledger the flight recorder and the
        scorekeeper read — incrementing here too would double-count."""
        with self._lock:
            self.deadline_exceeded[where] = (
                self.deadline_exceeded.get(where, 0) + 1
            )

    def deadline_exceeded_total(self) -> int:
        with self._lock:
            return sum(self.deadline_exceeded.values())

    def on_sample(self, load: Optional[float] = None):
        """Drive the brownout ladder from the flight recorder cadence
        (one call per sample keeps transitions deterministic per run)."""
        if self.brownout is None:
            return
        self.brownout.on_sample(
            self.admission.load() if load is None else load
        )

    def stop(self):
        if self.brownout is not None:
            self.brownout.restore_all()

    def stats(self) -> dict:
        with self._lock:
            dl = dict(self.deadline_exceeded)
        out = {
            "admission": self.admission.stats(),
            "deadline_exceeded": dl,
            "retry_budget_remaining": retry_budget().remaining(),
        }
        if self.brownout is not None:
            out["brownout"] = self.brownout.stats()
        return out
