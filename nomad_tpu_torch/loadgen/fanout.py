"""Scored event-plane fan-out bench: N concurrent ``/v1/event/stream``
watchers riding a live server under the smoke storm.

The measurement contract (BENCH_SUMMARY ``fanout_*`` fields, PERF.md
methodology):

- **publish throughput** — broker events published per storm second;
- **subscriber lag** — publish→delivery latency in ms, joined from an
  in-process oracle subscription that stamps every published frame index
  with its publish wall time, against a receipt-time reservoir sampled
  across all client connections (p50/p99 over the join);
- **gap accounting** — explicit gaps are LostGap markers received;
  SILENT gaps are frames the oracle saw that a marker-free subscriber's
  contiguous [first, last] window never delivered — the one unforgivable
  number, SLO-pinned to zero;
- **per-subscriber memory** — server-process RSS delta across the
  connection ramp divided by subscribers (broker queues + mux conns +
  kernel buffers; the storm hasn't started yet so nothing else moves).

The subscriber client multiplexes every connection over a few selector
reader threads (no thread-per-stream — the client must scale past the
server or it measures itself) and parses frames with prefix regexes
instead of ``json.loads`` — frame lines are byte-identical across
subscribers (encode-once), so full JSON decode per connection would make
the CLIENT the bottleneck at 10K.

At 10K subscribers the client runs as a SUBPROCESS: the per-process fd
ceiling (20K on the bench box) can't hold both sides' sockets, and the
split also gives the client its own GIL. The tier-1 scaled-down smoke
(200 subscribers, tests/test_fanout.py) drives the same class in-proc.

Run via ``scripts/fanout.sh`` (env knobs FANOUT_SUBS / FANOUT_TOPICS /
STORM_S) or ``python -m nomad_tpu_torch.loadgen --fanout``; bench.py embeds
it as the ``fanout`` section.

The port's copy of ``nomad_tpu/loadgen/fanout.py``: the server runs its
device tier on ``device``, the CUDA card unless the caller passes
``"cpu"``, and the subscriber fleet's subprocess runs this module
(``python -m nomad_tpu_torch.loadgen.fanout --client``), which needs no
card and imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import selectors
import socket
import subprocess
import sys
import threading
import time
import urllib.parse
from collections import deque

from ..debug.flight import rss_mb

#: compact-JSON frame classifiers (the broker's encode-once wire shapes)
_RE_DELTA = re.compile(rb'^\{"Index":(\d+)')
_RE_SNAP = re.compile(rb'^\{"Snapshot":true,"Index":(\d+)')
_RE_SNAP_DONE = re.compile(rb'^\{"SnapshotDone":true,"Index":(\d+)')
_RE_GAP = re.compile(rb'^\{"LostGap":true,"Index":(\d+)')

#: every Nth delta frame per connection lands in the lag reservoir
LAG_SAMPLE_EVERY = 8


def raise_nofile():
    """Lift the soft fd limit to the hard limit (10K sockets a side)."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    return hard


class _FanConn:
    __slots__ = (
        "sock",
        "buf",
        "headers_done",
        "floor",
        "first",
        "last",
        "frames",
        "gaps",
        "snap_batches",
        "errors",
        "eof",
    )

    def __init__(self, sock):
        self.sock = sock
        self.buf = bytearray()
        self.headers_done = False
        #: completeness floor: SnapshotDone stamp or LostGap index —
        #: delivery is owed only for frames past it
        self.floor = 0
        self.first = 0  # first delta index received
        self.last = 0  # newest delta index received
        self.frames = 0  # delta frames received
        self.gaps = 0  # explicit LostGap markers
        self.snap_batches = 0
        self.errors = 0  # Error frames (broker-side close)
        self.eof = False


class FanoutClient:
    """N multiplexed event-stream subscribers against one HTTP address."""

    def __init__(
        self,
        address: str,
        subs: int,
        topics=None,
        heartbeat: float = 10.0,
        snapshot=None,
        readers: int = 4,
        connectors: int = 16,
    ):
        self.address = address
        self.subs = int(subs)
        self.topics = list(topics or [])
        self.heartbeat = float(heartbeat)
        self.snapshot = snapshot
        self.readers = max(1, int(readers))
        self.connectors = max(1, int(connectors))
        self.conns: list[_FanConn] = []
        #: (frame index, receipt wall time) samples for the lag join
        self.lag_samples: deque = deque(maxlen=500_000)
        self.connect_failures = 0
        self._stop = threading.Event()
        self._shards: list[deque] = [deque() for _ in range(self.readers)]
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def _request_bytes(self) -> bytes:
        host = urllib.parse.urlparse(self.address)
        params: list = [("topic", t) for t in self.topics]
        params.append(("heartbeat", str(self.heartbeat)))
        if self.snapshot is not None:
            params.append(
                ("snapshot", "true" if self.snapshot else "false")
            )
        query = urllib.parse.urlencode(params)
        return (
            f"GET /v1/event/stream?{query} HTTP/1.1\r\n"
            f"Host: {host.netloc}\r\n"
            "Accept: application/json\r\n"
            "\r\n"
        ).encode()

    def connect(self, timeout: float = 300.0) -> int:
        """Ramp all subscribers (bounded connector parallelism), start the
        reader threads, return the connected count."""
        parsed = urllib.parse.urlparse(self.address)
        addr = (parsed.hostname, parsed.port)
        request = self._request_bytes()
        todo = deque(range(self.subs))
        deadline = time.monotonic() + timeout

        def connector(cid: int):
            while not self._stop.is_set():
                try:
                    i = todo.popleft()
                except IndexError:
                    return
                if time.monotonic() > deadline:
                    return
                for attempt in range(4):
                    try:
                        sock = socket.create_connection(addr, timeout=30)
                        sock.sendall(request)
                        sock.setblocking(False)
                        break
                    except OSError:
                        time.sleep(0.05 * (attempt + 1))
                else:
                    with self._lock:
                        self.connect_failures += 1
                    continue
                conn = _FanConn(sock)
                with self._lock:
                    self.conns.append(conn)
                self._shards[i % self.readers].append(conn)

        threads = [
            threading.Thread(
                target=connector, args=(c,), daemon=True,
                name=f"fanout-connect-{c}",
            )
            for c in range(self.connectors)
        ]
        for t in threads:
            t.start()
        for r in range(self.readers):
            t = threading.Thread(
                target=self._read_loop, args=(r,), daemon=True,
                name=f"fanout-reader-{r}",
            )
            t.start()
            self._threads.append(t)
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        return len(self.conns)

    # ------------------------------------------------------------------
    def _read_loop(self, shard: int):
        sel = selectors.DefaultSelector()
        pending = self._shards[shard]
        while not self._stop.is_set():
            while pending:
                conn = pending.popleft()
                try:
                    sel.register(conn.sock, selectors.EVENT_READ, conn)
                except (ValueError, OSError):
                    conn.eof = True
            for key, _ in sel.select(0.2):
                conn = key.data
                try:
                    data = conn.sock.recv(262144)
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError:
                    data = b""
                if not data:
                    conn.eof = True
                    try:
                        sel.unregister(conn.sock)
                        conn.sock.close()
                    except (KeyError, ValueError, OSError):
                        pass
                    continue
                conn.buf += data
                self._parse(conn)
        sel.close()

    def _parse(self, conn: _FanConn):
        buf = conn.buf
        if not conn.headers_done:
            end = buf.find(b"\r\n\r\n")
            if end < 0:
                return
            del buf[: end + 4]
            conn.headers_done = True
        # frames are whole NDJSON lines inside chunked framing; chunk
        # size/trailer lines never start with '{' so a line scan is a
        # complete parser (and frame bytes are shared across conns —
        # encode-once — so skipping json.loads costs nothing)
        while True:
            nl = buf.find(b"\n")
            if nl < 0:
                break
            line = bytes(buf[:nl])
            del buf[: nl + 1]
            if line.endswith(b"\r"):
                line = line[:-1]
            if not line.startswith(b"{") or line == b"{}":
                continue
            m = _RE_DELTA.match(line)
            if m:
                idx = int(m.group(1))
                if idx <= conn.floor:
                    # replayed ephemeral history at or below the
                    # snapshot/gap floor: real delivery, but outside the
                    # oracle-owed window the gap census counts
                    continue
                if not conn.first:
                    conn.first = idx
                if idx > conn.last:
                    conn.last = idx
                conn.frames += 1
                if conn.frames % LAG_SAMPLE_EVERY == 0:
                    self.lag_samples.append((idx, time.time()))
                continue
            m = _RE_SNAP_DONE.match(line)
            if m:
                conn.floor = max(conn.floor, int(m.group(1)))
                continue
            m = _RE_SNAP.match(line)
            if m:
                conn.snap_batches += 1
                continue
            m = _RE_GAP.match(line)
            if m:
                conn.gaps += 1
                conn.floor = max(conn.floor, int(m.group(1)))
                continue
            if line.startswith(b'{"Error"'):
                conn.errors += 1

    # ------------------------------------------------------------------
    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        for conn in self.conns:
            try:
                conn.sock.close()
            except OSError:
                pass

    def report(self) -> dict:
        return {
            "requested": self.subs,
            "connected": len(self.conns),
            "connect_failures": self.connect_failures,
            "frames": sum(c.frames for c in self.conns),
            "gaps": sum(c.gaps for c in self.conns),
            "snapshot_batches": sum(c.snap_batches for c in self.conns),
            "errors": sum(c.errors for c in self.conns),
            "eof": sum(1 for c in self.conns if c.eof),
            "lag_samples": [
                [idx, t] for idx, t in self.lag_samples
            ],
            # per-conn delivery windows for the silent-gap join:
            # [floor, first, last, frames, gaps, errors]
            "conns": [
                [c.floor, c.first, c.last, c.frames, c.gaps, c.errors]
                for c in self.conns
            ],
        }


class _Oracle:
    """In-process all-seeing subscription: stamps every published frame
    index with its publish wall time — the ground truth the client-side
    receipt samples join against, and the per-frame census the silent-gap
    accounting compares every subscriber's window to."""

    def __init__(self, broker, topics=None):
        # parse "Topic" / "Topic:key" specs EXACTLY like the HTTP layer
        # does for the subscribers: an oracle scoped wider than the fleet
        # would count legitimately key-filtered frames as silent gaps
        norm = None
        if topics:
            norm = {}
            for spec in topics:
                name, _, key = spec.partition(":")
                norm.setdefault(name, set()).add(key or "*")
        self._sub = broker.subscribe(topics=norm, max_queued=10_000_000)
        self.times: dict[int, float] = {}
        self.indexes: list[int] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="fanout-oracle"
        )
        self._thread.start()

    def _run(self):
        from ..events import SubscriptionClosedError

        while not self._stop.is_set():
            try:
                frame = self._sub.next(timeout=0.25)
            except SubscriptionClosedError:
                return
            if frame is None:
                continue
            index, events = frame
            if events is None:
                continue
            now = time.time()
            if index not in self.times:
                self.times[index] = now
                self.indexes.append(index)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._sub.close()


def _percentile(sorted_vals: list, q: float):
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, int(len(sorted_vals) * q))]


def _silent_gaps(oracle_indexes: list[int], conn_rows: list) -> dict:
    """Frames the oracle saw that a marker-free subscriber's contiguous
    delivery window never did. Subscribers that received an explicit
    LostGap marker are excluded here (their drop was DECLARED — counted
    under ``gaps``); duplicate delivery would surface as a negative
    deficit and is reported separately."""
    import bisect

    silent = 0
    dupes = 0
    checked = 0
    oracle_last = oracle_indexes[-1] if oracle_indexes else 0
    for floor, first, last, frames, gaps, errors in conn_rows:
        if gaps:
            continue
        # a conn with ZERO deltas is the worst silent gap, not an
        # exemption: it owes everything the oracle saw past its floor
        # (its join point — SnapshotDone stamp, or nothing at all for a
        # marker-free conn, which then owes the whole oracle window)
        start = floor if floor else (max(0, first - 1) if first else 0)
        end = last if last else oracle_last
        expected = bisect.bisect_right(
            oracle_indexes, end
        ) - bisect.bisect_right(oracle_indexes, start)
        deficit = expected - frames
        if deficit > 0:
            silent += deficit
        elif deficit < 0:
            dupes += -deficit
        checked += 1
    return {"silent": silent, "dupes": dupes, "checked_conns": checked}


def run_fanout(
    subs: int = 10000,
    topics=None,
    storm_s: float = 16.0,
    seed: int = 1,
    out: str | None = None,
    in_proc: bool = False,
    nodes: int = 48,
    settle_s: float = 60.0,
    heartbeat: float = 10.0,
    driver_workers: int = 6,
    connect_timeout: float = 600.0,
    slos: dict | None = None,
    device=None,
) -> dict:
    """Boot a live server, ramp ``subs`` stream watchers, run the smoke
    storm through the real RPC/HTTP surface, and score delivery. The
    server runs on ``device`` (CUDA unless ``"cpu"``), refused before any
    thread starts when CUDA is missing."""
    from .. import resolve_device
    from ..agent import ServerAgent
    from ..api.http import HTTPServer
    from .driver import StormDriver
    from .grammar import compile_stream
    from .score import grade
    from .scenarios import smoke

    device = resolve_device(device)
    raise_nofile()
    scenario = smoke(nodes=nodes, churn_s=storm_s)
    server_config = dict(scenario.server_config)
    # fan-out-tuned broker: deep ring + deep subscriber queues so lag is
    # MEASURED, not amputated by slow-consumer closes mid-storm; the cap
    # admits the fleet with headroom
    server_config["event_broker"] = {
        "event_buffer_size": 65536,
        "subscriber_buffer": 65536,
        "max_subscribers": subs + 64,
    }
    stream = compile_stream(scenario, seed)
    agent = ServerAgent("fanout", config=server_config, device=device)
    http = None
    oracle = None
    client = None
    proc = None
    try:
        agent.start(num_workers=scenario.n_workers, wait_for_leader=10.0)
        http = HTTPServer(agent.server, port=0)
        http.start()
        broker = agent.server.event_broker
        oracle = _Oracle(broker, topics)

        rss0 = rss_mb()
        t_ramp = time.monotonic()
        if in_proc:
            client = FanoutClient(
                http.address, subs, topics=topics, heartbeat=heartbeat
            )
            connected = client.connect(timeout=connect_timeout)
        else:
            proc = subprocess.Popen(
                [
                    sys.executable, "-m", "nomad_tpu_torch.loadgen.fanout",
                    "--client", "--addr", http.address,
                    "--subs", str(subs),
                    "--heartbeat", str(heartbeat),
                    "--out", (out or "FANOUT") + ".client.json",
                ]
                + sum((["--topic", t] for t in (topics or [])), []),
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
            )
            connected = _await_ready(proc, connect_timeout)
        ramp_s = time.monotonic() - t_ramp
        rss_ramped = rss_mb()

        pub0 = broker.stats()["events_published"]
        t0 = time.monotonic()
        driver = StormDriver(
            stream,
            rpc_servers=[agent.address],
            http_address=http.address,
            workers=driver_workers,
        )
        driver_report = driver.run()
        storm_wall = time.monotonic() - t0
        pub1 = broker.stats()["events_published"]

        # settle: let the fleet drain to the head before the census
        deadline = time.monotonic() + settle_s
        while time.monotonic() < deadline:
            if broker.lag_stats()["max"] == 0:
                break
            time.sleep(0.5)
        lag_after_settle = broker.lag_stats(top=5)

        if in_proc:
            client.stop()
            client_report = client.report()
        else:
            client_report = _stop_client(proc, (out or "FANOUT") + ".client.json")
        oracle.stop()

        lag_ms = sorted(
            (t_recv - oracle.times[idx]) * 1000.0
            for idx, t_recv in client_report.get("lag_samples", ())
            if idx in oracle.times
        )
        gap_info = _silent_gaps(
            oracle.indexes, client_report.get("conns", ())
        )
        broker_stats = broker.stats()
        report = {
            "fanout_subs": subs,
            "fanout_connected": client_report.get("connected", 0),
            "connect_failures": client_report.get("connect_failures", 0),
            "ramp_s": round(ramp_s, 2),
            "storm_s": round(storm_wall, 2),
            "fanout_pub_eps": round((pub1 - pub0) / max(storm_wall, 1e-9), 1),
            "events_published": pub1 - pub0,
            "frames_delivered": client_report.get("frames", 0),
            "snapshot_batches": client_report.get("snapshot_batches", 0),
            "snapshots_served": broker_stats.get("snapshots_served", 0),
            "fanout_lag_p50_ms": round(_percentile(lag_ms, 0.50), 1),
            "fanout_lag_p99_ms": round(_percentile(lag_ms, 0.99), 1),
            "lag_samples_joined": len(lag_ms),
            "fanout_gaps": client_report.get("gaps", 0),
            "fanout_silent_gaps": gap_info["silent"],
            "fanout_dupes": gap_info["dupes"],
            "gap_checked_conns": gap_info["checked_conns"],
            "fanout_slow_closes": broker_stats.get(
                "slow_consumers_closed", 0
            ),
            "stream_errors": client_report.get("errors", 0),
            "per_sub_server_kb": round(
                max(0.0, rss_ramped - rss0) * 1024.0 / max(subs, 1), 1
            ),
            "lag_after_settle": lag_after_settle,
            "driver": driver_report.to_dict(),
            "broker": broker_stats,
            "scenario": scenario.name,
            "seed": seed,
            "in_proc_client": in_proc,
        }
        report["slo"] = grade(
            report,
            slos
            if slos is not None
            else {
                "max_fanout_silent_gaps": 0,
                "max_fanout_slow_closes": 0,
                "max_fanout_lag_p99_ms": float(
                    os.environ.get("FANOUT_LAG_SLO_MS", "60000")
                ),
            },
        )
        if out:
            with open(out, "w", encoding="utf-8") as f:
                json.dump(report, f, indent=1)
                f.write("\n")
        return report
    finally:
        if client is not None:
            client.stop()
        if proc is not None and proc.poll() is None:
            proc.kill()
        if oracle is not None:
            oracle.stop()
        if http is not None:
            http.stop()
        agent.stop()


def _await_ready(proc, timeout: float) -> int:
    deadline = time.monotonic() + timeout
    line = b""
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError("fanout client exited before READY")
        if line.startswith(b"READY"):
            return int(line.split()[1])
    raise RuntimeError(f"fanout client not ready in {timeout}s: {line!r}")


def _stop_client(proc, report_path: str) -> dict:
    try:
        proc.stdin.write(b"STOP\n")
        proc.stdin.flush()
        proc.stdin.close()
    except OSError:
        pass
    proc.wait(timeout=180)
    with open(report_path, encoding="utf-8") as f:
        report = json.load(f)
    os.unlink(report_path)
    return report


def run_fanout_from_env(seed: int, out: str | None = None,
                        driver_workers: int = 6, device=None) -> dict:
    """The one env-knob parser (FANOUT_SUBS / FANOUT_TOPICS / STORM_S)
    shared by every entry point — scripts/fanout.sh via
    ``python -m nomad_tpu_torch.loadgen --fanout`` and bench.py's ``fanout``
    section must not each grow their own copy."""
    topics = [
        t for t in os.environ.get("FANOUT_TOPICS", "").split(",") if t
    ]
    return run_fanout(
        subs=int(os.environ.get("FANOUT_SUBS", "10000")),
        topics=topics,
        storm_s=float(os.environ.get("STORM_S", "16")),
        seed=seed,
        out=out,
        driver_workers=driver_workers,
        device=device,
    )


def summary_line(report: dict) -> str:
    """The trailing FANOUT_SUMMARY line (log-tail-survival contract)."""
    slo = report["slo"]
    parts = [
        f"fanout_subs={report['fanout_connected']}/{report['fanout_subs']}",
        f"fanout_pub_eps={report['fanout_pub_eps']}",
        f"fanout_lag_p50_ms={report['fanout_lag_p50_ms']}",
        f"fanout_lag_p99_ms={report['fanout_lag_p99_ms']}",
        f"fanout_gaps={report['fanout_gaps']}",
        f"fanout_silent_gaps={report['fanout_silent_gaps']}",
        f"fanout_slow_closes={report['fanout_slow_closes']}",
        f"snapshots={report['snapshots_served']}",
        f"per_sub_server_kb={report['per_sub_server_kb']}",
        f"slo={slo['passed']}/{slo['passed'] + slo['failed']}",
        f"score={slo['score']}",
    ]
    return "FANOUT_SUMMARY " + " ".join(parts)


# ---------------------------------------------------------------------------
# subprocess client entry: python -m nomad_tpu_torch.loadgen.fanout --client ...
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m nomad_tpu_torch.loadgen.fanout"
    )
    parser.add_argument("--client", action="store_true", required=True)
    parser.add_argument("--addr", required=True)
    parser.add_argument("--subs", type=int, required=True)
    parser.add_argument("--topic", action="append", default=[])
    parser.add_argument("--heartbeat", type=float, default=10.0)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    raise_nofile()
    client = FanoutClient(
        args.addr, args.subs, topics=args.topic, heartbeat=args.heartbeat
    )
    connected = client.connect()
    print(f"READY {connected}", flush=True)
    # the parent ends the run by writing STOP (or closing our stdin)
    sys.stdin.readline()
    client.stop()
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(client.report(), f)
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
