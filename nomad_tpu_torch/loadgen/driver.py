"""Open-loop storm driver: fires a compiled :class:`~.grammar.OpStream`
through the real RPC/HTTP server surface.

Open-loop means the arrival process never slows down because the cluster
fell behind (closed-loop generators hide saturation by self-throttling;
cf. the coordinated-omission literature): every op is released to the
firing pool at its scheduled time, and the pool's backlog + per-op
*lateness* are first-class measurements. When the backlog exceeds
``max_backlog`` further ops are counted as ``shed`` — recorded loss,
never silent.

All mutations travel the production paths: node and job ops over the
msgpack RPC surface (``ServerProxy``), dispatch / force-eval / GC over
the HTTP API (``ApiClient``) — the loadgen never touches the state
store directly.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field

from .grammar import (
    JOB_PREFIX,
    OpStream,
    World,
    build_job,
    build_node,
    job_id_for,
    node_id_for,
)

logger = logging.getLogger("nomad_tpu.loadgen.driver")

#: errors that are an expected consequence of racing the cluster (e.g.
#: scaling a job an earlier op stopped and the purge already landed) —
#: counted separately from real failures
_EXPECTED_SUBSTRINGS = (
    "job not found",
    "node not found",
    "not found:",
    "is stopped",
)


@dataclass
class OpResult:
    seq: int
    kind: str
    t_sched: float  # scheduled offset (stream time)
    t_start: float  # actual offset when the op began firing
    t_done: float
    ok: bool
    expected_miss: bool = False
    shed: bool = False
    #: server refused the op at admission (429/ErrOverloaded): recorded
    #: loss by design, not a failure — the overload plane's contract
    server_shed: bool = False
    #: server refused the op terminal deadline_exceeded: also recorded
    #: loss, the other accounted outcome past saturation
    dl_exceeded: bool = False
    error: str = ""

    @property
    def lateness(self) -> float:
        return max(0.0, self.t_start - self.t_sched)


@dataclass
class DriverReport:
    started: float
    wall_s: float
    fired: int = 0
    ok: int = 0
    failed: int = 0
    expected_miss: int = 0
    shed: int = 0
    server_shed: int = 0
    dl_exceeded: int = 0
    by_kind: dict = field(default_factory=dict)
    lateness_p99_s: float = 0.0
    lateness_max_s: float = 0.0
    errors: list = field(default_factory=list)  # first few distinct errors

    def to_dict(self) -> dict:
        return {
            "wall_s": round(self.wall_s, 3),
            "fired": self.fired,
            "ok": self.ok,
            "failed": self.failed,
            "expected_miss": self.expected_miss,
            "shed": self.shed,
            "server_shed": self.server_shed,
            "dl_exceeded": self.dl_exceeded,
            "by_kind": self.by_kind,
            "lateness_p99_s": round(self.lateness_p99_s, 4),
            "lateness_max_s": round(self.lateness_max_s, 4),
            "errors": self.errors[:10],
        }


class StormDriver:
    """Fires one compiled stream at a cluster.

    ``rpc_servers`` are RPC addresses for the ServerProxy; ``http_address``
    is the agent's HTTP base (``http://host:port``) for the ops only the
    HTTP surface exposes. ``time_scale`` stretches (>1) or compresses the
    schedule — determinism lives in the stream, pacing is a run knob.
    """

    def __init__(
        self,
        stream: OpStream,
        rpc_servers: list[str],
        http_address: str,
        workers: int = 8,
        max_backlog: int = 50_000,
        time_scale: float = 1.0,
        datacenters: tuple = ("dc1", "dc2"),
        node_resources: dict | None = None,
        token: str = "",
        job_prefix: str = JOB_PREFIX,
        deadline_s: float = 0.0,
    ):
        self.stream = stream
        self.rpc_servers = list(rpc_servers)
        self.http_address = http_address
        #: ACL secret the HTTP ops carry (federated storms run with ACLs
        #: enabled so replication has something to replicate)
        self.token = token
        #: job-id namespace; federated storms scope it per region so the
        #: cross-region oracle can tell the regions' jobs apart
        self.job_prefix = job_prefix
        #: per-op deadline TTL (seconds; 0 = none): each fired op runs
        #: under a deadline scope, so the RPC client injects ``_deadline``
        #: and the whole server pipeline can refuse the work once expired
        #: — the end-to-end propagation path, not a test shortcut
        self.deadline_s = float(deadline_s)
        self.workers = workers
        self.max_backlog = max_backlog
        self.time_scale = time_scale
        self.datacenters = datacenters
        self.node_resources = node_resources or {}
        self.results: list[OpResult] = []
        self._results_lock = threading.Lock()
        self._q: queue.Queue = queue.Queue()
        self._world = World()  # fire-time mirror, advanced by the pacer
        self._stop = threading.Event()

    # ------------------------------------------------------------------
    def run(self, abort: threading.Event | None = None) -> DriverReport:
        t_start = time.monotonic()
        threads = [
            threading.Thread(
                target=self._worker, name=f"ldg-worker-{i}", daemon=True,
                args=(t_start,),
            )
            for i in range(self.workers)
        ]
        for t in threads:
            t.start()
        try:
            for op in self.stream.ops:
                if abort is not None and abort.is_set():
                    self._stop.set()
                if self._stop.is_set():
                    # under backlog every remaining op is past due (delay
                    # <= 0), so the wait below never runs — cancellation
                    # must be checked per op, not only inside the sleep
                    break
                delay = op.t * self.time_scale - (time.monotonic() - t_start)
                if delay > 0:
                    if self._stop.wait(delay):
                        break
                # the world mirrors the COMPILED stream (shed ops
                # included — the grammar drew later ops assuming every
                # earlier one happened), and each enqueued op carries a
                # snapshot of the slot state its firing needs, taken here
                # at the op's own stream position: under backlog the
                # pacer runs ahead of the firing pool, so a worker
                # reading the live world would see the stream's future
                # (and race these writes)
                self._world.apply(op)
                if self._q.qsize() >= self.max_backlog:
                    t_shed = op.t * self.time_scale  # same base as fired ops
                    self._record(
                        OpResult(
                            seq=op.seq, kind=op.kind, t_sched=t_shed,
                            t_start=t_shed, t_done=t_shed, ok=False,
                            shed=True,
                        )
                    )
                    continue
                self._q.put((op, self._materialize(op)))
            if self._stop.is_set():
                # a cancelled run must not fire the queued backlog: drop
                # it, counting every dropped op as shed (the report
                # contract — nothing is ever silently skipped)
                self._drain_shed()
            self._q.join()
        finally:
            self._stop.set()
            for _ in threads:
                self._q.put(None)
        wall = time.monotonic() - t_start
        return self._report(t_start, wall)

    def stop(self):
        """Cancel the storm: the pacer stops scheduling, the queued
        backlog is shed, and run() returns after in-flight ops finish."""
        self._stop.set()

    def _drain_shed(self):
        while True:
            try:
                op, _ = self._q.get_nowait()
            except queue.Empty:
                return
            t_shed = op.t * self.time_scale
            self._record(
                OpResult(
                    seq=op.seq, kind=op.kind, t_sched=t_shed,
                    t_start=t_shed, t_done=t_shed, ok=False, shed=True,
                )
            )
            self._q.task_done()

    # ------------------------------------------------------------------
    def _worker(self, t_start: float):
        from ..api.client import ApiClient
        from ..rpc import ServerProxy

        # client construction failures must not kill the thread: run()
        # blocks on q.join() with no timeout, so a dead worker that left
        # ops without task_done() would hang the whole soak — keep
        # consuming and turn every dequeued op into a recorded failure
        proxy = http = None
        setup_err = ""
        try:
            proxy = ServerProxy(self.rpc_servers, max_retries=3)
            http = ApiClient(address=self.http_address, token=self.token)
        except Exception as e:  # noqa: BLE001
            setup_err = f"worker setup failed: {type(e).__name__}: {e}"
            logger.error(setup_err)
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                op, payload = item
                began = time.monotonic() - t_start
                ok, expected, err = True, False, ""
                srv_shed = dl_exc = False
                try:
                    if proxy is None:
                        raise RuntimeError(setup_err)
                    if self.deadline_s > 0:
                        from ..core.overload import (
                            deadline_scope,
                            mint_deadline,
                        )

                        with deadline_scope(
                            mint_deadline(self.deadline_s)
                        ):
                            self._fire(op, payload, proxy, http)
                    else:
                        self._fire(op, payload, proxy, http)
                except Exception as e:  # noqa: BLE001 — failures are data
                    ok = False
                    err = f"{type(e).__name__}: {e}"
                    # the overload plane's two ACCOUNTED refusals are not
                    # failures: both are the server's loud, by-design
                    # answer past saturation ("deadline exceeded" is the
                    # exception text; "deadline_exceeded" the wire code)
                    low = err.lower()
                    srv_shed = "overloaded" in low
                    dl_exc = (
                        "deadline_exceeded" in low
                        or "deadline exceeded" in low
                    )
                    expected = any(s in str(e) for s in _EXPECTED_SUBSTRINGS)
                    if not (expected or srv_shed or dl_exc):
                        logger.debug("op %s failed: %s", op.kind, err)
                self._record(
                    OpResult(
                        seq=op.seq, kind=op.kind,
                        t_sched=op.t * self.time_scale,
                        t_start=began, t_done=time.monotonic() - t_start,
                        ok=ok, expected_miss=expected,
                        server_shed=srv_shed, dl_exceeded=dl_exc,
                        error=err if not ok else "",
                    )
                )
            finally:
                self._q.task_done()

    def _materialize(self, op):
        """Pacer-thread snapshot of the job-slot state ``op``'s firing
        reads. Taken right after ``self._world.apply(op)`` — i.e. at the
        op's own position in the stream, the state the grammar compiled
        against — because by the time a worker dequeues the op the
        shared world may already be ops ahead. ``None`` for slot ops
        whose slot is gone/stopped (fired as the expected miss)."""
        a = op.args
        if op.kind in ("job.scale", "job.update", "job.evaluate"):
            slot = self._world.jobs.get(a["slot"])
            if slot is None or not slot.live:
                return None
            return {
                "slot": slot.slot, "category": slot.category,
                "count": slot.count, "cpu": slot.cpu,
                "memory_mb": slot.memory_mb, "version": slot.version,
            }
        if op.kind == "job.stop":
            slot = self._world.jobs.get(a["slot"])
            return {"category": slot.category if slot is not None else "svc"}
        return None

    def _fire(self, op, payload, proxy, http):
        a = op.args
        kind = op.kind
        if kind == "node.register":
            proxy.node_register(
                build_node(a["node"], self.datacenters, self.node_resources)
            )
            proxy.node_update_status(node_id_for(a["node"]), "ready")
        elif kind == "node.down":
            proxy.node_update_status(node_id_for(a["node"]), "down")
        elif kind == "node.up":
            # the flap's second half: the node comes back as the SAME node
            # (client restart), re-registers and turns ready
            proxy.node_register(
                build_node(a["node"], self.datacenters, self.node_resources)
            )
            proxy.node_update_status(node_id_for(a["node"]), "ready")
        elif kind == "node.drain":
            proxy.node_drain(
                node_id_for(a["node"]), True,
                deadline_ns=int(a.get("deadline_s", 10.0) * 1e9),
            )
        elif kind == "node.drain_off":
            proxy.node_drain(
                node_id_for(a["node"]), False, mark_eligible=True
            )
        elif kind in ("job.submit", "job.dispatch_register"):
            proxy.job_register(
                build_job(a, self.datacenters, self.job_prefix)
            )
        elif kind in ("job.scale", "job.update"):
            # post-apply snapshot: for scale, count is already the op's
            # target; for update, version is already the op's nonce
            if payload is None:
                raise KeyError(f"job not found: slot {a['slot']}")
            args = {
                "slot": payload["slot"], "category": payload["category"],
                "type": (
                    "batch" if payload["category"] == "bat" else "service"
                ),
                "count": payload["count"], "cpu": payload["cpu"],
                "memory_mb": payload["memory_mb"],
                "version": payload["version"],
            }
            proxy.job_register(
                build_job(args, self.datacenters, self.job_prefix)
            )
        elif kind == "job.stop":
            proxy.job_deregister(
                "default",
                job_id_for(a["slot"], payload["category"], self.job_prefix),
                purge=a.get("purge", False),
            )
        elif kind == "job.dispatch":
            for wave in range(a.get("fanout", 1)):
                http.job_dispatch(
                    job_id_for(a["slot"], "dsp", self.job_prefix),
                    meta={"wave": str(wave)},
                )
        elif kind == "job.evaluate":
            if payload is None:
                raise KeyError(f"job not found: slot {a['slot']}")
            http.put(
                "/v1/job/"
                + job_id_for(
                    payload["slot"], payload["category"], self.job_prefix
                )
                + "/evaluate"
            )
        elif kind == "system.gc":
            http.system_gc()
        else:
            raise ValueError(f"unknown op kind: {kind}")

    # ------------------------------------------------------------------
    def _record(self, r: OpResult):
        with self._results_lock:
            self.results.append(r)

    def _report(self, t_start: float, wall: float) -> DriverReport:
        with self._results_lock:
            results = list(self.results)
        rep = DriverReport(started=t_start, wall_s=wall)
        lateness = []
        errors: dict[str, int] = {}
        for r in results:
            rep.fired += 1
            bk = rep.by_kind.setdefault(
                r.kind,
                {
                    "ok": 0, "failed": 0, "expected_miss": 0, "shed": 0,
                    "server_shed": 0, "dl_exceeded": 0,
                },
            )
            if r.shed:
                rep.shed += 1
                bk["shed"] += 1
                continue
            lateness.append(r.lateness)
            if r.ok:
                rep.ok += 1
                bk["ok"] += 1
            elif r.server_shed:
                rep.server_shed += 1
                bk["server_shed"] += 1
            elif r.dl_exceeded:
                rep.dl_exceeded += 1
                bk["dl_exceeded"] += 1
            elif r.expected_miss:
                rep.expected_miss += 1
                bk["expected_miss"] += 1
            else:
                rep.failed += 1
                bk["failed"] += 1
                errors[r.error] = errors.get(r.error, 0) + 1
        if lateness:
            lateness.sort()
            rep.lateness_p99_s = lateness[
                min(len(lateness) - 1, int(len(lateness) * 0.99))
            ]
            rep.lateness_max_s = lateness[-1]
        rep.errors = [
            f"{n}x {msg}" for msg, n in sorted(
                errors.items(), key=lambda kv: -kv[1]
            )
        ]
        return rep
