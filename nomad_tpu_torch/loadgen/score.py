"""Continuous scorekeeper: samples the cluster's health signals on an
interval for the whole storm, runs the incremental invariant checker
throughout (never just at the end), and grades the run against the
scenario's SLOs into a ``SOAK_r*.json`` artifact + one ``SOAK_SUMMARY``
trailing line (same log-tail-survival contract as BENCH_SUMMARY).

Sampled per tick:

- **RSS** (/proc/self/statm): the ceiling + the post-ramp growth slope —
  the signal that catches unbounded-growth classes like the r5
  ``_bad_http_addrs`` leak;
- **eval latency**: the ``eval.e2e`` timer p99 (sourced from the trace
  plane's root span, enqueue→ack — nomad_tpu/trace; the broker's old
  side-table tap is gone), a timeline because the timer window slides;
- **event-stream subscriber lag**: probe subscribers riding the real
  ``/v1/event/stream`` HTTP surface; lag = broker latest index − the
  probe's last delivered index;
- **plan plane**: ``plan.queue_wait`` / ``plan.submit`` p99, queue depth;
- **mirror**: committed-plane view counters (tpu/mirror.py) — sync hits
  plus a rebuild count that is structurally zero;
- **store shape**: object counts per table (alloc/eval/job/node).
"""

from __future__ import annotations

import json
import threading
import time

# ONE process sampler: the scorekeeper reads the debug plane's flight
# recorder instead of running a private RSS/queue sampler (rss_mb is
# re-exported — it moved to nomad_tpu/debug/flight.py with the rest of
# the sampling)
from ..debug.flight import FlightRecorder, rss_mb, rss_slope  # noqa: F401
from ..testing.invariants import (
    IncrementalInvariantChecker,
    check_cluster_invariants,
)


class _StreamProbe:
    """One event-stream consumer over the real HTTP surface; tracks the
    last index it has fully received so the scorekeeper can compute
    delivery lag against the broker's head."""

    def __init__(self, http_address: str, probe_id: int):
        self.http_address = http_address
        self.probe_id = probe_id
        self.last_index = 0
        self.frames = 0
        self.gaps = 0
        self.snapshots = 0
        self.reconnects = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"ldg-probe-{probe_id}", daemon=True
        )

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _run(self):
        from ..api.client import ApiClient

        client = ApiClient(address=self.http_address)
        while not self._stop.is_set():
            try:
                stream = client.event_stream(
                    index=self.last_index, heartbeat=0.5
                )
                for frame in stream:
                    if self._stop.is_set():
                        stream.close()
                        break
                    if frame.get("LostGap"):
                        self.gaps += 1
                        self.last_index = max(
                            self.last_index, frame.get("Index", 0)
                        )
                        continue
                    if frame.get("Snapshot") or frame.get("SnapshotDone"):
                        # snapshot-on-subscribe sync: state at index N,
                        # deltas follow — a re-sync, not a gap. Only the
                        # Done marker moves the resume point (a sever
                        # mid-snapshot must re-sync on reconnect).
                        if frame.get("SnapshotDone"):
                            self.snapshots += 1
                            self.last_index = max(
                                self.last_index, frame.get("Index", 0)
                            )
                        continue
                    if frame.get("Error"):
                        break
                    if frame.get("Index"):
                        self.last_index = max(
                            self.last_index, frame["Index"]
                        )
                        self.frames += 1
            except Exception:
                if self._stop.is_set():
                    return
                self.reconnects += 1
                self._stop.wait(0.5)


class Scorekeeper:
    """Samples ``server`` (the in-process core.Server) on ``interval``
    seconds; the *reads* use in-process taps (metrics registry, broker
    stats, store snapshots — all lock-free or O(1)), while the probe
    subscribers consume the real HTTP stream like external watchers."""

    def __init__(
        self,
        server,
        http_address: str | None = None,
        interval: float = 1.0,
        invariants_every: int = 5,
        probes: int = 2,
        max_fit_nodes: int = 512,
        seed: int = 0,
        recorder: FlightRecorder | None = None,
    ):
        self.server = server
        self.http_address = http_address
        self.interval = interval
        # process sampling delegates to the flight recorder (the debug
        # plane's ring): the server's own recorder when it has one, so
        # watchdog rules see the storm's samples too; a private passive
        # ring otherwise. The scorekeeper tick drives record() and keeps
        # the returned sample — one sampler, one reader, and the
        # SOAK_rNN.json field names unchanged (sample_process emits the
        # same keys the private sampler did).
        self.recorder = (
            recorder
            or getattr(server, "flight_recorder", None)
            or FlightRecorder(server, interval=interval)
        )
        self.invariants_every = max(1, invariants_every)
        self.samples: list[dict] = []
        self.checker = IncrementalInvariantChecker(
            server.state, max_fit_nodes=max_fit_nodes, seed=seed
        )
        # the checker is single-threaded state; stop() joins the sampler
        # with a bounded timeout, so a production-scale sweep still in
        # flight can outlive stop() and race final_check() without this.
        # _closed (flipped under the lock by stop()) makes stop() a real
        # barrier: a zombie tick that lost the race drops its results
        # instead of appending to a report already being built
        self._checker_lock = threading.Lock()
        self._closed = False
        self.violation_log: list[dict] = []
        self.rss_baseline_mb = rss_mb()
        self._probes = [
            _StreamProbe(http_address, i)
            for i in range(probes if http_address else 0)
        ]
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="ldg-scorekeeper", daemon=True
        )
        self._marks: list[tuple[float, str]] = []
        self._t0 = None

    # ------------------------------------------------------------------
    def start(self):
        # nta: ignore[unsynchronized-shared-write] WHY: written before
        # the scorekeeper thread spawns below — Thread.start() is the
        # happens-before edge (pre-spawn publication)
        self._t0 = time.monotonic()
        # exactly ONE driver for the shared ring: while the scorekeeper
        # ticks record() at the storm cadence, the server recorder's own
        # thread must not also sample — a mixed cadence halves the
        # wall-time the watchdog's consecutive/window rules think they
        # cover (restored on stop())
        self._recorder_was_running = self.recorder.running
        if self._recorder_was_running:
            self.recorder.stop()
        for p in self._probes:
            p.start()
        self._thread.start()

    def mark(self, label: str):
        """Annotate the timeline (phase boundaries land in the artifact)."""
        if self._t0 is not None:
            self._marks.append((round(time.monotonic() - self._t0, 2), label))

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10.0)
        with self._checker_lock:
            self._closed = True
        for p in self._probes:
            p.stop()
        if getattr(self, "_recorder_was_running", False):
            self.recorder.start()

    # ------------------------------------------------------------------
    def _run(self):
        ticks = 0
        while not self._stop.wait(self.interval):
            ticks += 1
            try:
                self._sample(ticks)
            except Exception:  # keep sampling; one bad tick is data loss,
                import logging  # a dead scorekeeper is a blind soak

                logging.getLogger("nomad_tpu.loadgen.score").exception(
                    "scorekeeper tick failed"
                )

    def _sample(self, ticks: int):
        t = round(time.monotonic() - self._t0, 2)
        # one sampler for the whole process: the flight recorder takes
        # the snapshot (into its ring, where the watchdog sees it) and
        # this tick keeps the same dict for the soak report — the
        # field names (rss_mb, plan_queue_wait_p99_ms, broker_ready,
        # mirror_hits, ...) are sample_process's contract
        sample = dict(self.recorder.record())
        head = sample.get("event_latest_index", 0)
        sample["t"] = t  # the storm timeline, not the recorder's epoch
        sample["probe_lag"] = [
            max(0, head - p.last_index) for p in self._probes
        ]
        sweep = ticks % self.invariants_every == 0
        with self._checker_lock:
            if self._closed:
                return
            if sweep:
                t_chk = time.monotonic()
                new = self.checker.check(quiesced=False)
                sample["invariant_check_s"] = round(
                    time.monotonic() - t_chk, 3
                )
                for v in new:
                    self.violation_log.append({"t": t, "violation": v})
            self.samples.append(sample)

    # ------------------------------------------------------------------
    def final_check(self, quiesced: bool = True) -> list[str]:
        """The trailing sweep after the cluster quiesced; with the
        incremental checker's state it completes coverage of everything
        the sampled sweeps deferred."""
        t = (
            round(time.monotonic() - self._t0, 2)
            if self._t0 is not None
            else 0.0
        )
        with self._checker_lock:
            new = self.checker.check(quiesced=quiesced)
        for v in new:
            self.violation_log.append({"t": t, "violation": v, "final": True})
        return new

    def full_check(self) -> list[str]:
        """One classic full-sweep check (the oracle the incremental mode
        is pinned against); used by the smoke storm's final assertion."""
        return check_cluster_invariants(self.server.state)

    # ------------------------------------------------------------------
    def report(self, scenario, seed: int, stream, driver_report) -> dict:
        samples = self.samples
        rss_series = [s["rss_mb"] for s in samples]
        p99_series = [s["eval_e2e_p99_ms"] for s in samples]
        lag_series = [
            max(s["probe_lag"]) for s in samples if s.get("probe_lag")
        ]
        # post-ramp growth slope: least-squares fit over the last 60% of
        # samples, so a one-tick RSS transient on either endpoint can't
        # flip the bounded-growth SLO (endpoint deltas are hostage to
        # single-sample noise). THE shared fit (debug/flight.py) — the
        # watchdog's rss_slope rule grades the identical math, so the
        # soak verdict and the watchdog can never disagree
        slope = rss_slope(samples[int(len(samples) * 0.4):])
        mirror = getattr(self.server, "columnar_mirror", None)
        report = {
            "scenario": scenario.name,
            "seed": seed,
            "stream_digest": stream.digest(),
            "stream_ops": len(stream.ops),
            "op_counts": stream.counts(),
            "driver": driver_report.to_dict(),
            "samples": samples,
            "marks": [{"t": t, "label": lbl} for t, lbl in self._marks],
            "rss_baseline_mb": round(self.rss_baseline_mb, 1),
            "rss_peak_mb": round(max(rss_series, default=0.0), 1),
            "rss_final_mb": rss_series[-1] if rss_series else 0.0,
            "rss_tail_slope_mb_per_min": round(slope, 2),
            "eval_e2e_p99_ms_max": max(p99_series, default=0.0),
            "subscriber_lag_max": max(lag_series, default=0),
            "subscriber_gaps": sum(p.gaps for p in self._probes),
            "subscriber_snapshots": sum(p.snapshots for p in self._probes),
            "subscriber_frames": sum(p.frames for p in self._probes),
            "invariants": {
                **self.checker.stats(),
                "violation_log": self.violation_log,
            },
            "mirror": mirror.stats() if mirror is not None else None,
            # watchdog verdicts over the same flight-recorder samples
            # this report is built from (nomad_tpu/debug/watchdog.py)
            "watchdog": (
                self.server.watchdog.stats()
                if getattr(self.server, "watchdog", None) is not None
                else None
            ),
            "final_state": samples[-1] if samples else {},
        }
        # per-stage attribution of the eval.e2e tail from RETAINED TRACES
        # (nomad_tpu/trace critical-path): the artifact carries the blame
        # table itself instead of hand-assembled stage splits
        try:
            from ..trace import attribute, tracer

            cp = attribute(tracer.store.records())
            report["critical_path"] = {
                "traces": cp["traces"],
                "bottleneck": cp["bottleneck"],
                "verdict": cp["verdict"],
                "tail_stages": (cp.get("tail") or {}).get("stages", {}),
            }
            report["trace_stats"] = tracer.stats()
        except Exception:
            report["critical_path"] = None
        report["slo"] = grade(report, scenario.slos)
        return report


# ---------------------------------------------------------------------------
# SLO grading
# ---------------------------------------------------------------------------

#: slo key -> (report path extractor, comparator description)
def grade(report: dict, slos: dict) -> dict:
    """Grade the report against the scenario's SLO targets. Known keys:

    - ``max_invariant_violations`` (almost always 0)
    - ``max_rss_tail_slope_mb_per_min`` — bounded-growth ceiling
    - ``max_rss_peak_mb``
    - ``max_eval_e2e_p99_ms``
    - ``max_subscriber_lag`` (indexes behind the broker head)
    - ``max_op_failure_rate`` (real failures / fired, shed+expected excluded)
    - ``max_shed_rate``

    Fan-out bench reports (loadgen/fanout.py) grade through the same
    table with their own keys:

    - ``max_fanout_lag_p99_ms`` — p99 publish→delivery latency
    - ``max_fanout_silent_gaps`` (always 0: a drop without a marker is
      the one unforgivable failure)
    - ``max_fanout_gaps`` — explicit lost-gap markers observed
    - ``max_fanout_slow_closes`` — slow-consumer closes

    Federated storm reports (loadgen/federation.py) likewise:

    - ``max_fed_invariant_violations`` — per-region + cross-region
      (always 0)
    - ``max_fed_lost_placements`` / ``max_fed_double_placements`` —
      oracle-checked cross-region submits that vanished or landed in
      two raft domains (always 0)
    - ``max_fed_heal_s`` — worst partition heal time
    - ``max_fed_fwd_err_rate`` — cross-region forwarding failures
      outside declared chaos windows / forwards attempted
    - ``max_fed_replication_lag_p99_s`` — ACL replication convergence
      lag p99

    Overload storm reports (loadgen/overload.py) likewise:

    - ``max_overload_goodput_drop`` — fractional goodput LOSS past
      saturation vs the capacity stage (0 when the burst stage completes
      at least as much work per second — the brownout/shedding dividend)
    - ``max_overload_unaccounted`` — ops missing from the
      ok+shed+server_shed+deadline_exceeded+expected+failed ledger
      (always 0: every op gets a loud outcome)
    - ``max_overload_failed`` — REAL op failures (shed and
      deadline-exceeded excluded; always 0)
    - ``max_overload_recovery_s`` — seconds from burst end until load is
      back under the brownout exit threshold at level 0
    - ``max_overload_admitted_p99_ms`` — p99 round-trip of ADMITTED ops
      during the burst (admitted work keeps its latency budget; shed
      work fails fast and is excluded)

    Returns {checks: {name: {target, actual, pass}}, passed, failed,
    score} where score is the passed fraction (0..1).
    """
    driver = report.get("driver") or {}
    fired = max(driver.get("fired", 0), 1)
    actuals = {
        "max_op_failure_rate": driver.get("failed", 0) / fired,
        "max_shed_rate": driver.get("shed", 0) / fired,
    }
    if "invariants" in report:
        actuals["max_invariant_violations"] = report["invariants"][
            "violations"
        ]
    for slo_key, report_key in (
        ("max_rss_tail_slope_mb_per_min", "rss_tail_slope_mb_per_min"),
        ("max_rss_peak_mb", "rss_peak_mb"),
        ("max_eval_e2e_p99_ms", "eval_e2e_p99_ms_max"),
        ("max_subscriber_lag", "subscriber_lag_max"),
        ("max_fanout_lag_p99_ms", "fanout_lag_p99_ms"),
        ("max_fanout_silent_gaps", "fanout_silent_gaps"),
        ("max_fanout_gaps", "fanout_gaps"),
        ("max_fanout_slow_closes", "fanout_slow_closes"),
        ("max_fed_invariant_violations", "fed_invariant_violations"),
        ("max_fed_lost_placements", "fed_lost_placements"),
        ("max_fed_double_placements", "fed_double_placements"),
        ("max_fed_heal_s", "fed_heal_s"),
        ("max_fed_fwd_err_rate", "fed_fwd_err_rate"),
        ("max_fed_replication_lag_p99_s", "fed_replication_lag_p99_s"),
        ("max_overload_goodput_drop", "overload_goodput_drop"),
        ("max_overload_unaccounted", "overload_unaccounted"),
        ("max_overload_failed", "overload_failed"),
        ("max_overload_recovery_s", "overload_recovery_s"),
        ("max_overload_admitted_p99_ms", "overload_admitted_p99_ms"),
    ):
        if report_key in report:
            actuals[slo_key] = report[report_key]
    checks = {}
    for name, target in sorted(slos.items()):
        actual = actuals.get(name)
        if actual is None:
            checks[name] = {"target": target, "actual": None, "pass": False}
            continue
        checks[name] = {
            "target": target,
            "actual": round(actual, 4) if isinstance(actual, float) else actual,
            "pass": actual <= target,
        }
    passed = sum(1 for c in checks.values() if c["pass"])
    return {
        "checks": checks,
        "passed": passed,
        "failed": len(checks) - passed,
        "score": round(passed / max(len(checks), 1), 3),
    }


def summary_line(report: dict) -> str:
    """The one trailing line that must survive a truncated log tail."""
    slo = report["slo"]
    inv = report["invariants"]
    parts = [
        f"scenario={report['scenario']}",
        f"seed={report['seed']}",
        f"ops={report['driver']['fired']}",
        f"ok={report['driver']['ok']}",
        f"failed={report['driver']['failed']}",
        f"shed={report['driver']['shed']}",
        f"allocs={report['final_state'].get('allocs', 0)}",
        f"nodes={report['final_state'].get('nodes', 0)}",
        f"invariant_violations={inv['violations']}",
        f"invariant_sweeps={inv['sweeps']}",
        f"rss_peak_mb={report['rss_peak_mb']}",
        f"rss_slope_mb_min={report['rss_tail_slope_mb_per_min']}",
        f"eval_p99_max_ms={report['eval_e2e_p99_ms_max']}",
        f"sub_lag_max={report['subscriber_lag_max']}",
        f"trace_bottleneck={(report.get('critical_path') or {}).get('bottleneck')}",
        f"watchdog_trips={(report.get('watchdog') or {}).get('trips', 0)}",
        f"slo={slo['passed']}/{slo['passed'] + slo['failed']}",
        f"score={slo['score']}",
        f"digest={report['stream_digest'][:12]}",
    ]
    return "SOAK_SUMMARY " + " ".join(parts)


def write_report(report: dict, path: str):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1)
        f.write("\n")
