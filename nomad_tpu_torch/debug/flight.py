"""Flight recorder: a bounded ring of periodic whole-process snapshots.

The trace plane answers "where did THIS eval spend its time"; the
flight recorder answers "what did the PROCESS look like in the minutes
before an incident" — RSS, thread census, broker/plan-queue depths,
the hot-path timer percentiles, trace-store and mirror counters, and
(under lockdep) the accumulated lock-wait total. The watchdog
(watchdog.py) evaluates its rules against this ring; a debug bundle
(bundle.py) dumps it; the churn-soak Scorekeeper (loadgen/score.py)
reads its samples instead of running a private RSS sampler.

``sample_process`` is THE process sampler — one implementation, every
reader. A recorder can run its own thread (``start()``) or be driven
passively (``record()`` per external tick, the Scorekeeper mode); both
feed the same ring.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque

logger = logging.getLogger("nomad_tpu.debug.flight")

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096

#: timers surfaced per snapshot (the knee/leak diagnosis set)
TIMER_KEYS = {
    "eval.e2e": ("eval_e2e_p99_ms", "eval_e2e_mean_ms"),
    "plan.queue_wait": ("plan_queue_wait_p99_ms", None),
    "plan.submit": ("plan_submit_p99_ms", None),
    "plan.raft_apply": ("plan_raft_apply_p99_ms", None),
}


def rss_mb() -> float:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE / 1e6
    except OSError:  # non-linux fallback
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def sample_process(server) -> dict:
    """One snapshot of ``server``'s process health signals. Reads are
    in-process taps only (metrics registry, broker stats, store lens) —
    lock-free or O(1); safe at 1Hz forever."""
    from .. import metrics
    from ..testing import lockdep
    from .profiler import classify_thread

    snap_metrics = metrics.snapshot()
    timers = snap_metrics["timers"]
    counters = snap_metrics["counters"]
    gen = server.state._gen
    broker = server.event_broker
    broker_stats = broker.stats() if broker is not None else {}
    # O(subscribers) plain attribute reads — the one deliberate
    # exception to "O(1) only": ~1ms at 10K subscribers, and the
    # subscriber_lag watchdog rule is blind without it
    broker_lag = broker.lag_stats() if broker is not None else {}
    eval_stats = (
        server.eval_broker.stats()
        if getattr(server, "eval_broker", None) is not None
        else {}
    )
    classes: dict[str, int] = {}
    for t in threading.enumerate():
        cls = classify_thread(t.name)
        classes[cls] = classes.get(cls, 0) + 1
    sample = {
        "wall": round(time.time(), 3),
        "rss_mb": round(rss_mb(), 1),
        "index": server.state.latest_index(),
        "allocs": len(gen.allocs),
        "evals": len(gen.evals),
        "jobs": len(gen.jobs),
        "nodes": len(gen.nodes),
        "deployments": len(gen.deployments),
        "plan_queue_depth": (
            server.planner.queue.depth()
            if getattr(server, "planner", None) is not None
            else 0
        ),
        # verified-but-uncommitted batches in the applier's optimistic
        # overlay (core/plan_apply.py): the debug bundle's view of how
        # deep the commit pipeline actually runs
        "overlay_depth": (
            server.planner.overlay_depth()
            if getattr(server, "planner", None) is not None
            else 0
        ),
        "broker_ready": eval_stats.get("total_ready", 0),
        "broker_unacked": eval_stats.get("total_unacked", 0),
        "evals_processed": sum(
            v
            for k, v in counters.items()
            if k.startswith("worker.evals_processed.")
        ),
        "event_latest_index": broker_stats.get("latest_index", 0),
        "subscribers": broker_stats.get("subscribers", 0),
        "slow_consumers_closed": broker_stats.get(
            "slow_consumers_closed", 0
        ),
        "subscriber_lag_max": broker_lag.get("max", 0),
        "subscriber_lag_p99": broker_lag.get("p99", 0),
        "threads": sum(classes.values()),
        "thread_classes": classes,
        "watchdog_trips": counters.get("debug.watchdog_trips", 0),
    }
    for timer, (p99_key, mean_key) in TIMER_KEYS.items():
        stats = timers.get(timer, {})
        sample[p99_key] = stats.get("p99_ms", 0.0)
        if mean_key:
            sample[mean_key] = stats.get("mean_ms", 0.0)
    mirror = getattr(server, "columnar_mirror", None)
    if mirror is not None:
        ms = mirror.stats()
        sample["mirror_hits"] = ms.get("hits", 0)
        sample["mirror_rebuilds"] = ms.get("rebuilds", 0)
    # committed-plane audit: a rate-limited checksum of the dense planes
    # against a cold rebuild of the MVCC tables (state/planes.py). Zero
    # rows is the refactor's invariant; the plane_divergence watchdog
    # rule trips a bundle on anything else.
    planes = getattr(getattr(server, "state", None), "planes", None)
    if planes is not None:
        try:
            verdict = planes.audit_sample(server.state.snapshot()._gen)
        except Exception:
            verdict = None
        if verdict is not None:
            sample["plane_divergence_rows"] = verdict["rows"]
            sample["plane_divergence_recs"] = verdict["recs"]
            sample["plane_audit_version"] = verdict["version"]
    try:
        from ..trace import tracer

        ts = tracer.store.stats()
        sample["trace_open"] = ts.get("open", 0)
        sample["trace_retained"] = ts.get("retained", 0)
    except Exception:
        pass
    # overload plane (core/overload.py): keys appear ONLY when the
    # overload{} stanza constructed a controller, so the watchdog's
    # overload rule stays silent on unconfigured servers
    ov = getattr(server, "overload", None)
    if ov is not None:
        try:
            adm = ov.admission
            adm_stats = adm.stats()  # counters read under adm's lock
            sample["overload_load"] = round(adm_stats["load"], 4)
            sample["overload_admitted_total"] = adm_stats["admitted"]
            sample["overload_shed_total"] = sum(
                adm_stats["shed"].values()
            )
            sample["overload_dl_exceeded_total"] = (
                ov.deadline_exceeded_total()
            )
            bo = ov.brownout
            sample["brownout_level"] = bo.level if bo is not None else 0
        except Exception:
            pass
    # device plane: the JAX package samples its devprof ledger here
    # (compile cache, transfers, collective rounds, paged tiles); the
    # port has no device profiler yet (ROADMAP A9), so those keys stay out
    # federation signals: which region this process serves, cross-region
    # forwarding counters, and — on replicating (non-authoritative ACL)
    # servers only — how far behind the authoritative region this one is.
    # The keys appear ONLY where the feature is configured, so watchdog
    # rules keyed on them stay silent on single-region clusters.
    region = getattr(server, "region", None)
    if region is not None:
        sample["region"] = region
    sample["region_forward_failed"] = counters.get(
        "http.region_forward.failed", 0
    )
    lag_fn = getattr(server, "acl_replication_lag_s", None)
    lag = lag_fn() if lag_fn is not None else None
    if lag is not None:
        sample["acl_replication_lag_s"] = round(lag, 3)
        st = server.acl_replication_status
        sample["acl_replication_rounds"] = st.get("rounds", 0)
        sample["acl_replication_failures"] = st.get("failures", 0)
    if lockdep.installed():
        sample["lock_wait_s"] = round(
            sum(e["wait_s"] for e in lockdep.contention().values()), 4
        )
    return sample


def rss_slope(samples: list[dict], key: str = "rss_mb") -> float:
    """Least-squares growth slope in MB/min over ``samples`` (each
    carrying ``t`` seconds + ``key``) — the same fit the soak
    scorekeeper grades its bounded-growth SLO with, shared so the
    watchdog's rule and the soak's verdict can never disagree."""
    if len(samples) < 2 or samples[-1]["t"] <= samples[0]["t"]:
        return 0.0
    ts = [s["t"] / 60.0 for s in samples]
    ys = [float(s.get(key, 0.0)) for s in samples]
    n = len(samples)
    t_mean = sum(ts) / n
    y_mean = sum(ys) / n
    var = sum((t - t_mean) ** 2 for t in ts)
    cov = sum((t - t_mean) * (y - y_mean) for t, y in zip(ts, ys))
    return cov / max(var, 1e-9)


class FlightRecorder:
    """Bounded ring of :func:`sample_process` snapshots.

    Two drive modes, one ring: ``start()`` spawns the sampling thread
    (the agent's always-on recorder); ``record()`` takes one snapshot
    inline (the Scorekeeper's per-tick delegation). ``observer`` — when
    set — sees every new sample (the watchdog hook) and must not
    raise."""

    def __init__(self, server, interval: float = 1.0, retain: int = 512):
        self.server = server
        self.interval = float(interval)
        self.retain = int(retain)
        self._ring: deque[dict] = deque(maxlen=self.retain)
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: fn(sample) called after each record (watchdog.on_sample)
        self.observer = None
        self.errors = 0

    # ------------------------------------------------------------------
    def record(self) -> dict:
        """Take one snapshot into the ring and return it."""
        sample = sample_process(self.server)
        sample["t"] = round(time.monotonic() - self._t0, 2)
        with self._lock:
            self._ring.append(sample)
        observer = self.observer
        if observer is not None:
            try:
                observer(sample)
            except Exception:
                logger.exception("flight-recorder observer failed")
        return sample

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="debug-flight-recorder"
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.record()
            except Exception:  # one bad tick is data loss; a dead
                with self._lock:  # recorder is a blind incident; dump()
                    self.errors += 1  # reads the count live
                logger.exception("flight-recorder tick failed")

    # ------------------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None

    def depth(self) -> int:
        """O(1) ring depth (the /v1/metrics gauge — no ring copy)."""
        with self._lock:
            return len(self._ring)

    def samples(self, last: int | None = None) -> list[dict]:
        with self._lock:
            out = list(self._ring)
        return out[-last:] if last else out

    def latest(self) -> dict | None:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def dump(self) -> dict:
        """The bundle's ``flight.json`` payload: config + full ring."""
        samples = self.samples()
        with self._lock:  # _run increments errors under the same lock
            errors = self.errors
        return {
            "interval_s": self.interval,
            "retain": self.retain,
            "recorded": len(samples),
            "errors": errors,
            "span_s": (
                round(samples[-1]["t"] - samples[0]["t"], 2)
                if len(samples) >= 2
                else 0.0
            ),
            "samples": samples,
        }
