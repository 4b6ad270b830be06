"""Watchdog: cheap rules over the flight recorder, auto-capturing a
debug bundle when one trips.

Post-incident debugging starts with "what did it look like right
before" — which is exactly what nobody captured. The watchdog closes
that loop: every flight-recorder sample is evaluated against a handful
of O(window) rules, and the first breach (per rule, per cooldown)
snapshots a full debug bundle (bundle.py) while the incident is STILL
HAPPENING — profiles included, so the stuck thread's stack is in the
artifact, not reconstructed from folklore.

Rules (thresholds config-overridable via the ``debug.watchdog`` stanza):

- ``plan_queue_wait_p99`` — the applier saturation signal (ROADMAP
  item 1): p99 above threshold for N consecutive samples. Retuned for
  the pipelined applier: the pre-pipeline 2000ms default tolerated the
  serialized applier's normal convoying; with overlapped commits the
  bench target is p99 <50ms, so 500ms (10x the target) is a real
  anomaly, not noise. Kept (not retired): the rule still fires exactly
  when the pipeline saturates — overlay at depth, every worker parked
  in plan.submit — which is the bundle an operator wants;
- ``stalled_worker`` — ready evals with zero in-flight work and a flat
  evals-processed counter across N samples: the workers stopped
  consuming (the synthetic-refresh-index bug class);
- ``rss_slope`` — sustained least-squares RSS growth over the tail
  window (the ``_bad_http_addrs`` leak class, caught while leaking);
- ``lock_contention`` — lock-wait seconds accumulating faster than
  ``threshold`` per wall second across the window (lockdep installs
  only; a convoy collapse, not a single slow acquire);
- ``subscriber_lag`` — max event-stream subscriber lag (broker head
  index minus the subscriber's last drained index) above threshold for
  N consecutive samples while subscribers exist: fan-out overload
  becomes a debug bundle — whose findings carry the per-subscriber lag
  top-N and broker ring stats — not a pager;
- ``acl_replication_lag`` — seconds since this (non-authoritative,
  replicating) region last successfully mirrored the authoritative
  region's ACL state, above threshold for N consecutive samples: a
  severed WAN or dead authoritative leader becomes a bundle whose
  findings carry the per-region replication/forwarding stats. The rule
  keys off ``acl_replication_lag_s``, which only replicating servers
  emit — single-region clusters never see it;
- ``recompile_storm`` — planner compile-cache growth of ≥ ``growth``
  entries across the flight tail while the server is PAST its warmup
  (evals already processed before the window opened — the prewarm
  ladder's legitimate boot-time compiles never trip it): the
  51200-vs-50176 shape-drift class silently re-paying XLA compiles in
  steady state becomes a bundle whose device section names the shapes;
- ``h2d_thrash`` — paged-planner tile RE-upload bytes per committed
  placement sustained above ``bytes_per_placement`` across the window
  (plus an absolute ``min_reupload_mb`` floor): the device node budget
  is too tight for the working set and tiles are being evicted and
  re-streamed wholesale instead of staying resident. Keys ride the
  devprof transfer ledger, so servers that never page stay at 0;
- ``overload`` — sustained admission shedding above ``shed_per_s``
  across the window, or any brownout level above ``brownout_level``:
  the bundle captures the admission/brownout/retry-budget state while
  the storm is still in progress. Keys exist only on servers with an
  ``overload{}`` stanza, so unconfigured agents never trip it.

Trips are always recorded + counted (``debug.watchdog_trips``); the
bundle write additionally needs a configured ``bundle_dir`` so a
default agent never surprises an operator with disk writes.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from .flight import rss_slope

logger = logging.getLogger("nomad_tpu.debug.watchdog")

#: rule name -> default parameters (override via debug.watchdog.<rule>)
DEFAULT_RULES = {
    "plan_queue_wait_p99": {"threshold_ms": 500.0, "consecutive": 3},
    "stalled_worker": {"consecutive": 8},
    "rss_slope": {
        "threshold_mb_per_min": 512.0,
        "window": 120,
        "min_span_s": 60.0,
    },
    "lock_contention": {"threshold_frac": 0.5, "window": 30,
                        "min_span_s": 5.0},
    "subscriber_lag": {"threshold": 10_000, "consecutive": 5},
    "acl_replication_lag": {"threshold_s": 30.0, "consecutive": 3},
    "recompile_storm": {"growth": 4, "window": 60, "min_span_s": 10.0},
    "h2d_thrash": {
        "bytes_per_placement": 1_000_000.0,
        "min_reupload_mb": 16.0,
        "window": 60,
        "min_span_s": 10.0,
    },
    "plane_divergence": {"threshold": 1},
    "overload": {"shed_per_s": 50.0, "consecutive": 5, "brownout_level": 0},
}

MAX_TRIP_LOG = 64


class Watchdog:
    """Evaluates rules on every flight-recorder sample (installed as the
    recorder's ``observer``); thread-safe, never raises into the
    recorder."""

    def __init__(self, server, recorder, config=None, bundle_dir: str = "",
                 cooldown_s: float = 60.0, profile_seconds: float = 1.0):
        self.server = server
        self.recorder = recorder
        config = dict(config or {})
        self.rules: dict[str, dict] = {}
        for name, defaults in DEFAULT_RULES.items():
            override = config.get(name)
            if override is False:
                continue  # rule disabled
            merged = dict(defaults)
            if isinstance(override, dict):
                merged.update(override)
            self.rules[name] = merged
        self.bundle_dir = bundle_dir or str(config.get("bundle_dir") or "")
        #: newest on-disk auto-captured bundles kept; older watchdog-*
        #: dirs are pruned after each capture (the in-memory trip log is
        #: capped — the disk must be too, or a recurring trip fills it)
        self.bundle_keep = int(config.get("bundle_keep", 8))
        self.cooldown_s = float(config.get("cooldown_s", cooldown_s))
        self.profile_seconds = float(
            config.get("profile_seconds", profile_seconds)
        )
        self._lock = threading.Lock()
        # nta: ignore[unbounded-cache] WHY: keyed by rule name — the
        # code-fixed DEFAULT_RULES vocabulary
        self._last_trip: dict[str, float] = {}
        self.trip_log: list[dict] = []
        self.trip_count = 0
        self.bundles: list[str] = []
        self._capturing = False
        self._bundle_seq = 0

    # ------------------------------------------------------------------
    def on_sample(self, sample: dict):
        window = self.recorder.samples(
            last=max(
                r.get("window", r.get("consecutive", 1))
                for r in self.rules.values()
            )
            if self.rules
            else 1
        )
        if not window:
            return
        for name, params in self.rules.items():
            try:
                detail = getattr(self, f"_rule_{name}")(sample, window, params)
            except Exception:
                logger.exception("watchdog rule %s failed", name)
                continue
            if detail is not None:
                self._trip(name, detail, sample)

    # -- rules ----------------------------------------------------------
    def _rule_plan_queue_wait_p99(self, sample, window, p):
        tail = window[-int(p["consecutive"]):]
        if len(tail) < int(p["consecutive"]):
            return None
        # activity gate: the timer window never decays while idle, so a
        # historical spike would re-breach every cooldown forever. A
        # breach only counts while the plan plane is live — plans
        # queued now, or evals completing across the window (a stuck
        # applier with a flat counter is stalled_worker's rule)
        active = tail[-1].get("plan_queue_depth", 0) > 0 or (
            tail[-1].get("evals_processed", 0)
            > tail[0].get("evals_processed", 0)
        )
        if active and all(
            s.get("plan_queue_wait_p99_ms", 0.0) > p["threshold_ms"]
            for s in tail
        ):
            return {
                "p99_ms": sample.get("plan_queue_wait_p99_ms"),
                "threshold_ms": p["threshold_ms"],
            }
        return None

    def _rule_stalled_worker(self, sample, window, p):
        tail = window[-int(p["consecutive"]):]
        if len(tail) < int(p["consecutive"]):
            return None
        if all(
            s.get("broker_ready", 0) > 0 and s.get("broker_unacked", 0) == 0
            for s in tail
        ) and tail[-1].get("evals_processed", 0) == tail[0].get(
            "evals_processed", 0
        ):
            return {
                "broker_ready": sample.get("broker_ready"),
                "flat_for_samples": len(tail),
            }
        return None

    def _rule_subscriber_lag(self, sample, window, p):
        tail = window[-int(p["consecutive"]):]
        if len(tail) < int(p["consecutive"]):
            return None
        # the lag tap reads live subscribers only, so a breach can't
        # outlive its cause: a drained (or closed) consumer resets the
        # streak by construction — no idle-decay gate needed
        if all(
            s.get("subscribers", 0) > 0
            and s.get("subscriber_lag_max", 0) > p["threshold"]
            for s in tail
        ):
            return {
                "lag_max": sample.get("subscriber_lag_max"),
                "lag_p99": sample.get("subscriber_lag_p99"),
                "threshold": p["threshold"],
                "subscribers": sample.get("subscribers"),
            }
        return None

    def _rule_acl_replication_lag(self, sample, window, p):
        tail = window[-int(p["consecutive"]):]
        if len(tail) < int(p["consecutive"]):
            return None
        # the key exists only on replicating servers, so the rule is
        # structurally silent everywhere else; a successful round resets
        # the lag (and the streak) by construction
        if all(
            s.get("acl_replication_lag_s") is not None
            and s["acl_replication_lag_s"] > p["threshold_s"]
            for s in tail
        ):
            return {
                "lag_s": sample.get("acl_replication_lag_s"),
                "threshold_s": p["threshold_s"],
                "failures": sample.get("acl_replication_failures"),
                "region": sample.get("region"),
            }
        return None

    def _rule_recompile_storm(self, sample, window, p):
        tail = window[-int(p["window"]):]
        if (
            len(tail) < 2
            or tail[-1]["t"] - tail[0]["t"] < p["min_span_s"]
            or "compile_cache_size" not in tail[-1]
            or "compile_cache_size" not in tail[0]
        ):
            return None
        # warmup gate: the prewarm ladder legitimately compiles a burst
        # of programs at boot — growth only counts once the server had
        # ALREADY processed evals before this window opened (a storm in
        # steady state is drift, the same signal the trace plane's
        # [recompile]-flagged spans carry per-dispatch)
        if tail[0].get("evals_processed", 0) <= 0:
            return None
        growth = (
            tail[-1]["compile_cache_size"] - tail[0]["compile_cache_size"]
        )
        if growth >= p["growth"]:
            return {
                "cache_growth": growth,
                "cache_size": sample.get("compile_cache_size"),
                "threshold": p["growth"],
                "span_s": round(tail[-1]["t"] - tail[0]["t"], 2),
            }
        return None

    def _rule_h2d_thrash(self, sample, window, p):
        # paged node axis (tpu/paging.py): a healthy pager re-uploads a
        # tile's small dynamic planes when a commit dirtied it — thrash
        # is when the device budget is so tight relative to the working
        # set that tiles keep getting EVICTED and re-admitted wholesale,
        # and the signature is re-upload bytes growing far faster than
        # committed placements. The absolute-bytes floor keeps an idle
        # server (zero placements, one dirty refresh) from tripping.
        tail = window[-int(p["window"]):]
        if (
            len(tail) < 2
            or tail[-1]["t"] - tail[0]["t"] < p["min_span_s"]
            or "paged_tile_reupload_bytes" not in tail[-1]
            or "paged_tile_reupload_bytes" not in tail[0]
        ):
            return None
        re_bytes = (
            tail[-1]["paged_tile_reupload_bytes"]
            - tail[0]["paged_tile_reupload_bytes"]
        )
        if re_bytes < float(p["min_reupload_mb"]) * 1e6:
            return None
        placed = (
            tail[-1].get("placements_total", 0)
            - tail[0].get("placements_total", 0)
        )
        per = re_bytes / max(placed, 1)
        if per > float(p["bytes_per_placement"]):
            return {
                "reupload_bytes": re_bytes,
                "placements": placed,
                "bytes_per_placement": round(per, 1),
                "threshold": p["bytes_per_placement"],
                "reuploads_total": sample.get("paged_tile_reuploads"),
                "span_s": round(tail[-1]["t"] - tail[0]["t"], 2),
            }
        return None

    def _rule_plane_divergence(self, sample, window, p):
        # divergence between the committed planes and a cold rebuild of
        # the MVCC tables is impossible by construction (the same write
        # transaction patches both) — which is exactly why it is audited:
        # a single nonzero row means a write path bypassed the commit
        # protocol, and that warrants a bundle immediately, no
        # consecutive-sample streak required
        rows = sample.get("plane_divergence_rows", 0)
        recs = sample.get("plane_divergence_recs", 0)
        if rows >= p["threshold"] or recs >= p["threshold"]:
            return {
                "rows": rows,
                "recs": recs,
                "planes_version": sample.get("plane_audit_version"),
            }
        return None

    def _rule_overload(self, sample, window, p):
        # sustained shedding — or any brownout past the configured floor
        # — is an incident whose evidence (admission state, brownout
        # level, retry-budget depth) is exactly what vanishes once the
        # storm passes; the bundle captures it while it is happening.
        # Keys exist only when the overload{} stanza built a controller,
        # so unconfigured servers never evaluate past the gate.
        tail = window[-int(p["consecutive"]):]
        if (
            len(tail) < int(p["consecutive"])
            or "overload_shed_total" not in tail[-1]
            or "overload_shed_total" not in tail[0]
        ):
            return None
        level = sample.get("brownout_level", 0)
        if level > int(p["brownout_level"]):
            return {
                "brownout_level": level,
                "overload_load": sample.get("overload_load"),
                "shed_total": sample.get("overload_shed_total"),
                "dl_exceeded_total": sample.get("overload_dl_exceeded_total"),
            }
        span = tail[-1]["t"] - tail[0]["t"]
        if span <= 0:
            return None
        shed_rate = (
            tail[-1]["overload_shed_total"] - tail[0]["overload_shed_total"]
        ) / span
        if shed_rate > float(p["shed_per_s"]):
            return {
                "shed_per_s": round(shed_rate, 1),
                "threshold_per_s": p["shed_per_s"],
                "overload_load": sample.get("overload_load"),
                "shed_total": sample.get("overload_shed_total"),
                "dl_exceeded_total": sample.get("overload_dl_exceeded_total"),
            }
        return None

    def _rule_rss_slope(self, sample, window, p):
        tail = window[-int(p["window"]):]
        if (
            len(tail) < 2
            or tail[-1]["t"] - tail[0]["t"] < p["min_span_s"]
        ):
            return None
        slope = rss_slope(tail)
        if slope > p["threshold_mb_per_min"]:
            return {
                "slope_mb_per_min": round(slope, 2),
                "threshold_mb_per_min": p["threshold_mb_per_min"],
                "rss_mb": sample.get("rss_mb"),
            }
        return None

    def _rule_lock_contention(self, sample, window, p):
        tail = window[-int(p["window"]):]
        if (
            len(tail) < 2
            or "lock_wait_s" not in tail[-1]
            or "lock_wait_s" not in tail[0]
            or tail[-1]["t"] - tail[0]["t"] < p["min_span_s"]
        ):
            return None
        span = tail[-1]["t"] - tail[0]["t"]
        frac = (tail[-1]["lock_wait_s"] - tail[0]["lock_wait_s"]) / span
        if frac > p["threshold_frac"]:
            return {
                "lock_wait_frac": round(frac, 3),
                "threshold_frac": p["threshold_frac"],
            }
        return None

    # -- trip handling --------------------------------------------------
    def _trip(self, rule: str, detail: dict, sample: dict):
        from .. import metrics

        now = time.monotonic()
        with self._lock:
            last = self._last_trip.get(rule, 0.0)
            if last and now - last < self.cooldown_s:
                return
            self._last_trip[rule] = now
            self.trip_count += 1
            entry = {
                "rule": rule,
                "t": sample.get("t"),
                "wall": sample.get("wall"),
                "detail": detail,
            }
            self.trip_log.append(entry)
            if len(self.trip_log) > MAX_TRIP_LOG:
                del self.trip_log[: len(self.trip_log) - MAX_TRIP_LOG]
            capture = self.bundle_dir and not self._capturing
            if capture:
                self._capturing = True
                self._bundle_seq += 1
                seq = self._bundle_seq
        metrics.incr("debug.watchdog_trips")
        metrics.incr(f"debug.watchdog_trip.{rule}")
        logger.warning("watchdog trip: %s %s", rule, detail)
        if capture:
            # bundle capture profiles for profile_seconds — far too slow
            # for the recorder's sampling thread; one capture at a time
            try:
                threading.Thread(
                    target=self._capture,
                    args=(rule, seq, entry),
                    daemon=True,
                    name="debug-bundle-capture",
                ).start()
            except Exception:
                # thread exhaustion IS an incident condition — a failed
                # spawn must not latch _capturing and disable every
                # future capture
                with self._lock:
                    self._capturing = False
                logger.exception("watchdog bundle-capture spawn failed")

    def _capture(self, rule: str, seq: int, entry: dict):
        from .bundle import capture_bundle

        try:
            # wall-clock stamp + process-local seq: unique across agent
            # restarts (a restart must never overwrite a prior
            # incident's evidence) and never relied on for ordering —
            # _prune_bundles orders by mtime, not name
            stamp = time.strftime("%Y%m%d-%H%M%S")
            dest = os.path.join(
                self.bundle_dir, f"watchdog-{stamp}-{seq}-{rule}"
            )
            manifest = capture_bundle(
                self.server,
                dest,
                profile_seconds=self.profile_seconds,
                reason=f"watchdog:{rule}",
            )
            with self._lock:
                self.bundles.append(manifest["path"])
                if len(self.bundles) > MAX_TRIP_LOG:
                    del self.bundles[: len(self.bundles) - MAX_TRIP_LOG]
                entry["bundle"] = manifest["path"]
            self._prune_bundles()
        except Exception:
            logger.exception("watchdog bundle capture failed")
        finally:
            with self._lock:
                self._capturing = False

    def _prune_bundles(self):
        """Keep the newest ``bundle_keep`` auto-captured bundle dirs on
        disk; only watchdog-minted ``watchdog-*`` directories are ever
        deleted (operator-captured bundles in the same dir are not ours
        to reap)."""
        import shutil

        def _mtime(path):
            try:
                return os.path.getmtime(path)
            except OSError:
                return 0.0

        try:
            # oldest-first by mtime — names are identity, not order
            mine = sorted(
                (
                    os.path.join(self.bundle_dir, name)
                    for name in os.listdir(self.bundle_dir)
                    if name.startswith("watchdog-")
                    and os.path.isdir(os.path.join(self.bundle_dir, name))
                ),
                key=_mtime,
            )
        except OSError:
            return
        for path in mine[: max(0, len(mine) - self.bundle_keep)]:
            shutil.rmtree(path, ignore_errors=True)

    # ------------------------------------------------------------------
    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Block until no bundle capture is in flight (test/shutdown
        barrier); True when idle."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._capturing:
                    return True
            time.sleep(0.05)
        return False

    def stats(self) -> dict:
        with self._lock:
            return {
                "trips": self.trip_count,
                # entry dicts are copied, not shared: _capture adds the
                # "bundle" key to the live entry (under the lock) after
                # stats() may have handed the log to a json.dump running
                # outside it
                "trip_log": [dict(e) for e in self.trip_log],
                "bundles": list(self.bundles),
                "rules": {k: dict(v) for k, v in self.rules.items()},
                "bundle_dir": self.bundle_dir,
            }
