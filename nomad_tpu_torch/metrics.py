"""In-process metrics registry (the armon/go-metrics role: the reference
wraps every RPC/scheduler stage in MeasureSince and publishes gauges;
ref command/agent/config.go:500-577 telemetry). Counters, gauges, and
windowed timers with count/mean/p99, exported by /v1/metrics in both JSON
and prometheus exposition."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

_LOCK = threading.Lock()
_COUNTERS: dict[str, float] = {}
_TIMERS: dict[str, list[float]] = {}
_HISTS: dict[str, dict[int, int]] = {}
# keyed by metric name (code-bounded); each entry is a bounded deque of
# the last few exemplar links — reset() clears it, which the
# unbounded-cache rule sees, so no suppression is needed
_EXEMPLARS: dict[str, list] = {}

TIMER_WINDOW = 512  # samples retained per timer
EXEMPLARS_PER_METRIC = 4  # most-recent trace links kept per timer


def incr(name: str, value: float = 1.0):
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0.0) + value


def _bucket_floor(value) -> int:
    """Base-2 bucket lower bound: 0, 1, 2, 4, 8, ... — at most ~64
    buckets per histogram regardless of the observed value range."""
    iv = int(value)
    if iv <= 0:
        return 0
    return 1 << (iv.bit_length() - 1)


def observe(name: str, value):
    """Bounded base-2 bucketed histogram (e.g. the plan.apply_batch_size
    distribution): counts per power-of-two bucket, keyed by the bucket's
    lower bound. The earlier exact-integer-value counting was unbounded
    cardinality under soak (one dict key per distinct observed value —
    the `unbounded-cache` checker's own blind spot); base-2 buckets cap
    every histogram at ~64 keys while keeping the /v1/metrics output
    shape ({name: {int: count}}) unchanged."""
    with _LOCK:
        hist = _HISTS.setdefault(name, {})
        key = _bucket_floor(value)
        hist[key] = hist.get(key, 0) + 1


def sample(name: str, seconds: float, exemplar: str = None):
    """Record one timer sample; ``exemplar`` links the sample to a
    retained trace id (hot-path histograms carry these so /v1/metrics
    p99s are one hop from the span trees that produced them)."""
    with _LOCK:
        bucket = _TIMERS.setdefault(name, [])
        bucket.append(seconds)
        if len(bucket) > TIMER_WINDOW:
            del bucket[: len(bucket) - TIMER_WINDOW]
        if exemplar:
            ex = _EXEMPLARS.setdefault(name, [])
            ex.append(
                {"trace_id": exemplar, "value_ms": round(seconds * 1e3, 3)}
            )
            if len(ex) > EXEMPLARS_PER_METRIC:
                del ex[: len(ex) - EXEMPLARS_PER_METRIC]


def percentile(name: str, q: float):
    """Approximate percentile ``q`` in [0, 1] for a timer (exact over
    the retained window, in seconds) or a bucketed histogram (the
    bucket's upper bound). Returns None for an unknown name."""
    with _LOCK:
        samples = list(_TIMERS.get(name, ()))
        hist = dict(_HISTS.get(name, ()))
    if samples:
        ordered = sorted(samples)
        return ordered[min(len(ordered) - 1, int(len(ordered) * q))]
    if hist:
        total = sum(hist.values())
        target = min(total - 1, int(total * q))
        seen = 0
        for key in sorted(hist):
            seen += hist[key]
            if seen > target:
                return key if key == 0 else 2 * key - 1
    return None


@contextmanager
def measure(name: str):
    """MeasureSince analog: times the with-block into ``name``."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        sample(name, time.monotonic() - t0)


def snapshot() -> dict:
    """{counters, timers: {name: {count, mean_ms, p99_ms, max_ms}},
    hists: {name: {bucket_floor: count}}, exemplars: {name: [...]}}"""
    with _LOCK:
        counters = dict(_COUNTERS)
        timers = {k: list(v) for k, v in _TIMERS.items()}
        hists = {k: dict(v) for k, v in _HISTS.items()}
        exemplars = {k: list(v) for k, v in _EXEMPLARS.items() if v}
    out_timers = {}
    for name, samples in timers.items():
        if not samples:
            continue
        ordered = sorted(samples)
        p99 = ordered[min(len(ordered) - 1, int(len(ordered) * 0.99))]
        out_timers[name] = {
            "count": len(ordered),
            "mean_ms": round(sum(ordered) / len(ordered) * 1e3, 3),
            "p99_ms": round(p99 * 1e3, 3),
            "max_ms": round(ordered[-1] * 1e3, 3),
        }
    return {
        "counters": counters,
        "timers": out_timers,
        "hists": hists,
        "exemplars": exemplars,
    }


def reset():
    """Test hook."""
    with _LOCK:
        _COUNTERS.clear()
        _TIMERS.clear()
        _HISTS.clear()
        _EXEMPLARS.clear()


# ---------------------------------------------------------------------------
# Push sinks (the go-metrics FanoutSink role: the reference fans every
# metric out to statsite/statsd/datadog/circonus sinks configured in the
# telemetry stanza, command/agent/config.go:500-577). Pull via /v1/metrics
# stays the primary surface; sinks PUSH the same registry on an interval.
# ---------------------------------------------------------------------------


class StatsdSink:
    """statsd line-protocol over UDP (the go-metrics statsd sink role):
    counters as ``name:delta|c``, timer means as ``name:ms|ms``. Deltas are
    tracked per sink so restarts of the receiver don't double-count.
    Datagrams are batched newline-separated under ~1400 bytes (one MTU)."""

    MAX_DATAGRAM = 1400

    def __init__(self, address: str, prefix: str = "nomad"):
        import socket

        host, _, port = address.rpartition(":")
        self.addr = (host or "127.0.0.1", int(port))
        self.prefix = prefix
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # nta: ignore[unbounded-cache] WHY: keyed by metric name — the
        # name set is code-bounded (no per-request interpolation)
        self._last_counters: dict[str, float] = {}

    def _fmt(self, name: str) -> str:
        return f"{self.prefix}.{name}".replace(":", "_").replace("|", "_")

    def _suffix(self) -> str:
        """Per-line suffix hook (dogstatsd appends its tag block)."""
        return ""

    def _lines(self, counters: dict, timers: dict) -> list[str]:
        suffix = self._suffix()
        lines = []
        for name, total in sorted(counters.items()):
            delta = total - self._last_counters.get(name, 0.0)
            self._last_counters[name] = total
            if delta:
                lines.append(f"{self._fmt(name)}:{delta:g}|c{suffix}")
        for name, stats in sorted(timers.items()):
            lines.append(
                f"{self._fmt(name)}.mean:{stats['mean_ms']:g}|ms{suffix}"
            )
            lines.append(
                f"{self._fmt(name)}.p99:{stats['p99_ms']:g}|ms{suffix}"
            )
        return lines

    def emit(self, counters: dict, timers: dict):
        batch = b""
        for line in self._lines(counters, timers):
            data = line.encode()
            if batch and len(batch) + 1 + len(data) > self.MAX_DATAGRAM:
                self._send(batch)
                batch = b""
            batch = batch + b"\n" + data if batch else data
        if batch:
            self._send(batch)

    def _send(self, payload: bytes):
        try:
            self._sock.sendto(payload, self.addr)
        except OSError:
            pass  # UDP telemetry is best-effort, never a failure source

    def close(self):
        self._sock.close()


class DogstatsdSink(StatsdSink):
    """dogstatsd: the statsd line protocol plus a ``|#key:value,...`` tag
    block on every line (the go-metrics datadog sink role, ref
    command/agent/config.go datadog_address/datadog_tags). Tags come from
    the telemetry stanza and ride every metric, so one receiver can split
    series by node/region without name-mangling."""

    def __init__(self, address: str, prefix: str = "nomad", tags=None):
        super().__init__(address, prefix=prefix)
        if isinstance(tags, dict):
            tags = [f"{k}:{v}" for k, v in sorted(tags.items())]
        self.tags = [str(t) for t in (tags or [])]

    def _suffix(self) -> str:
        if not self.tags:
            return ""
        # tag values must not smuggle protocol delimiters — ',' splits
        # tags, '|' splits fields, newline splits lines
        clean = [
            t.replace("|", "_").replace("\n", "_").replace(",", "_")
            for t in self.tags
        ]
        return "|#" + ",".join(clean)


class StatsiteSink(StatsdSink):
    """statsite line protocol over TCP (the go-metrics statsite sink
    role): the same ``name:value|type`` lines, newline-terminated on one
    persistent connection. TCP gives ordering + no datagram size limit;
    a broken pipe drops the connection and the next flush redials —
    telemetry stays best-effort, never a failure source."""

    def __init__(self, address: str, prefix: str = "nomad"):
        # reuse the statsd formatting/delta machinery; replace transport
        super().__init__(address, prefix=prefix)
        self._sock.close()
        self._sock = None
        self._conn = None

    def _connect(self):
        import socket

        if self._conn is None:
            self._conn = socket.create_connection(self.addr, timeout=2.0)
        return self._conn

    def emit(self, counters: dict, timers: dict):
        # _lines consumes the counter deltas; keep the pre-flush marks so
        # a fully-failed send re-carries the counts next interval instead
        # of undercounting the receiver after every transient outage.
        # Deliberately at-least-once: sendall can't report partial
        # progress, so a connection dying mid-send may double-count the
        # flushed prefix on retry — the rarer and more benign failure
        # than silently losing every delta across an outage.
        marks = dict(self._last_counters)
        lines = self._lines(counters, timers)
        if not lines:
            return
        payload = ("\n".join(lines) + "\n").encode()
        for _ in range(2):  # one redial after a stale-connection failure
            try:
                self._connect().sendall(payload)
                return
            except OSError:
                self._drop()
        self._last_counters = marks

    def _drop(self):
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def close(self):
        self._drop()


class SinkFlusher:
    """Periodically snapshots the registry into every configured sink
    (the collection_interval loop of the reference's telemetry setup)."""

    def __init__(self, sinks, interval: float = 10.0):
        self.sinks = list(sinks)
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="metrics-sink-flusher"
        )
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval):
            self.flush()

    def flush(self):
        snap = snapshot()
        for sink in self.sinks:
            try:
                sink.emit(snap["counters"], snap["timers"])
            except Exception:
                pass

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        for sink in self.sinks:
            try:
                sink.close()
            except Exception:
                pass


def configure_telemetry(config: dict):
    """Build + start the sink fan-out from an agent config's telemetry
    stanza (ref command/agent/config.go:500-577: statsd_address,
    statsite_address, datadog_address + datadog_tags,
    collection_interval). Returns a running SinkFlusher or None."""
    stanza = (config or {}).get("telemetry") or {}
    sinks = []
    addr = stanza.get("statsd_address")
    if addr:
        sinks.append(StatsdSink(str(addr)))
    addr = stanza.get("statsite_address")
    if addr:
        sinks.append(StatsiteSink(str(addr)))
    addr = stanza.get("datadog_address")
    if addr:
        sinks.append(
            DogstatsdSink(str(addr), tags=stanza.get("datadog_tags"))
        )
    if not sinks:
        return None
    interval = stanza.get("collection_interval", 10.0)
    if isinstance(interval, str):
        interval = _parse_duration(interval) / 1e9
    return SinkFlusher(sinks, interval=float(interval)).start()


_DURATION_NS = {"ns": 1, "us": 1_000, "µs": 1_000, "ms": 1_000_000,
                "s": 1_000_000_000, "m": 60_000_000_000, "h": 3_600_000_000_000}


def _parse_duration(v) -> int:
    """Go-style duration string to nanoseconds ('30s', '10m', '1.5h'): the
    port's copy of ``jobspec.hcl.parse_duration`` (the job spec parser is
    not ported)."""
    import re

    if isinstance(v, (int, float)):
        return int(v)
    total, pos, rest = 0, 0, v.strip()
    for m in re.finditer(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)", rest):
        if m.start() != pos:
            raise ValueError(f"invalid duration: {v!r}")
        total += int(float(m.group(1)) * _DURATION_NS[m.group(2)])
        pos = m.end()
    if pos == 0 or pos != len(rest):
        raise ValueError(f"invalid duration: {v!r}")
    return total
