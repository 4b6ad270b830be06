"""Federated storm plane: multi-region chaos at cluster-of-clusters
scale (ROADMAP item 5; ref the reference's e2e framework + Jepsen-style
partition testing, PAPERS.md).

The single-region machinery composes into regions:

- **topology** — 2–3 regions, each its own raft domain of
  ``ServerAgent``s (real RPC listeners, real HTTP surfaces) federated
  over gossip; region 0 is the ACL-authoritative region, every other
  region replicates policies and global tokens from it
  (core/server.py replicate_acl_once);
- **storm** — one seeded op stream per region (the load grammar; the
  region name is part of every named-RNG path, so streams are
  independent AND byte-reproducible per region), driven open-loop by a
  per-region :class:`FederatedDriver`. A seeded fraction of
  ``job.submit`` ops is routed *cross-region*: fired at a foreign
  region's HTTP surface with ``?region=<home>`` so they exercise the
  forwarding plane under load — the routing decision lands in the op
  args, inside the stream's digest;
- **chaos** — region-scale fault phases over the fault plane's region
  scope (testing/faults.py): full region partition + heal, leader kill
  mid-storm, asymmetric partial sever, rolling region restart
  ("upgrade": stop/rebuild each server in sequence on its data dir);
- **score** — per-region flight-recorder samples (the debug plane
  drives the watchdog, acl_replication_lag rule included), per-region
  incremental invariant sweeps mid-storm, ACL replication-lag probes
  (a nonce policy written to the authoritative region, convergence
  timed per replica region), partition heal timing, and a final
  cross-region oracle (testing/invariants.py
  check_federation_invariants): no lost or double-committed
  cross-region submits, ACL state converged.

Artifacts: scored ``FED_rNN.json`` + one trailing ``FED_SUMMARY`` line
(the log-tail-survival contract, same as SOAK/FANOUT). Run via
``python -m nomad_tpu_torch.loadgen --federation``; scale knobs are FED_*
env vars (see :func:`federation_config_from_env`).

The port's copy of ``nomad_tpu/loadgen/federation.py``. Every server's
device tier runs on ``device`` (``run_federation(..., device=None)``, the
CUDA card unless the caller passes ``"cpu"``), restarts included. One
field is the port's own: ``FederationConfig.server_settings``, empty by
default, is merged last into every server's config, so a storm can give
each region's servers the soak's device settings (``default_scheduler``
``tpu-batch`` and ``batch_drain``); the reference's storm sets none and
plans its evals with the generic schedulers. Empty, every server's config
is the JAX package's key for key. One behaviour is the port's own too:
``FederatedDriver`` fires the ops of one job slot in stream order, where
the reference's pool may reorder a stop and the resubmit after it.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..testing import faults as _faults
from ..testing.invariants import (
    IncrementalInvariantChecker,
    check_federation_invariants,
)
from .driver import StormDriver
from .grammar import Op, OpStream, Phase, Scenario, compile_stream, named_rng
from .score import grade, write_report

logger = logging.getLogger("nomad_tpu.loadgen.federation")

#: region names in topology order; region 0 is ACL-authoritative
REGION_NAMES = ("east", "west", "north")
#: seconds an op waits for the earlier ops of its job slot to finish
SLOT_WAIT_S = 120.0


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclass
class FederationConfig:
    """One federated storm: topology + per-region storm shape + chaos
    schedule + SLOs."""

    regions: int = 2
    servers_per_region: int = 3
    nodes_per_region: int = 100
    job_slots: int = 24
    churn_s: float = 60.0
    churn_rate: float = 6.0
    #: probability a job.submit routes through a foreign region's HTTP
    #: surface with ?region=<home> (the forwarding plane under load)
    cross_region_p: float = 0.25
    driver_workers: int = 4
    n_workers: int = 1
    sample_interval: float = 0.5
    invariants_every: int = 4
    #: ticks between ACL replication-lag probe writes
    repl_probe_every: int = 4
    quiesce_timeout: float = 90.0
    #: chaos events as (frac_of_churn, kind, args); fractions are offsets
    #: into the churn phase so one schedule scales with churn_s
    chaos: list = field(default_factory=list)
    #: the port's own: merged last into every server's config (empty: the
    #: JAX package's configs, which plan with the generic schedulers)
    server_settings: dict = field(default_factory=dict)
    slos: dict = field(
        default_factory=lambda: {
            "max_fed_invariant_violations": 0,
            "max_fed_lost_placements": 0,
            "max_fed_double_placements": 0,
            "max_fed_heal_s": 15.0,
            "max_fed_fwd_err_rate": 0.02,
            "max_fed_replication_lag_p99_s": 10.0,
            "max_op_failure_rate": 0.05,
            "max_shed_rate": 0.0,
        }
    )

    def region_names(self) -> list[str]:
        return list(REGION_NAMES[: self.regions])


def federation_smoke() -> FederationConfig:
    """The tier-1 shape: 2 regions x 1 server, a short mixed storm with
    one full partition + heal. Cheap enough for every suite; failover
    and rolling restart run in the full storm (and their own regression
    tests) — a 1-server region has no quorum to fail over."""
    return FederationConfig(
        regions=2,
        servers_per_region=1,
        nodes_per_region=24,
        job_slots=12,
        churn_s=12.0,
        churn_rate=6.0,
        cross_region_p=0.3,
        quiesce_timeout=60.0,
        chaos=[
            (0.2, "partition", {"a": "east", "b": "west"}),
            (0.55, "heal", {}),
        ],
    )


def federation_storm() -> FederationConfig:
    """The full storm: partition + heal, leader failover mid-storm,
    asymmetric partial sever, rolling region restart — the four
    region-scale chaos phases over a multi-server-per-region topology."""
    cfg = FederationConfig(
        regions=int(os.environ.get("FED_REGIONS", "2")),
        servers_per_region=int(os.environ.get("FED_SERVERS", "3")),
        nodes_per_region=int(os.environ.get("FED_NODES", "300")),
        job_slots=int(os.environ.get("FED_JOB_SLOTS", "32")),
        churn_s=float(os.environ.get("FED_CHURN_S", "90")),
        churn_rate=float(os.environ.get("FED_CHURN_RATE", "8")),
        cross_region_p=float(os.environ.get("FED_CROSS_P", "0.25")),
        quiesce_timeout=float(os.environ.get("FED_QUIESCE_S", "180")),
    )
    secondary = cfg.region_names()[1]
    restart_region = os.environ.get("FED_RESTART_REGION", secondary)
    cfg.chaos = [
        (0.10, "partition", {"a": "east", "b": secondary}),
        (0.28, "heal", {}),
        (0.40, "leader_kill", {"region": secondary}),
        (0.55, "partial_sever", {"a": "east", "b": secondary}),
        (0.70, "heal", {}),
        (0.80, "rolling_restart", {"region": restart_region}),
    ]
    return cfg


def federation_config_from_env() -> FederationConfig:
    """FED_PROFILE=smoke|storm (default storm for the CLI/script)."""
    profile = os.environ.get("FED_PROFILE", "storm")
    return federation_smoke() if profile == "smoke" else federation_storm()


# ---------------------------------------------------------------------------
# per-region storm grammar
# ---------------------------------------------------------------------------


def region_scenario(region: str, cfg: FederationConfig) -> Scenario:
    """The per-region storm: the smoke-storm op-class mass (submit /
    scale / update / stop / dispatch / flap / drain / GC) sized by the
    federation config. The scenario NAME embeds the region, so every
    named RNG stream — arrivals, mixes, args — is independent per
    region while staying byte-reproducible from (region, seed)."""
    nodes = cfg.nodes_per_region
    common = {
        "node_fleet": nodes,
        "job_slots": cfg.job_slots,
        "job_floor": 3,
        "ready_floor": max(4, nodes // 3),
        "count_range": (1, 4),
        "cpu_choices": (50, 100, 250),
        "memory_choices": (32, 64, 128),
        "job_categories": {"svc": 2.0, "bat": 1.0},
        "dispatch_slots": 2,
        "dispatch_fanout": (1, 3),
        "drain_deadline_s": (2.0, 8.0),
    }
    ramp_s = max(2.0, nodes / 40.0)
    return Scenario(
        name=f"fed-{region}",
        description=f"federated storm, region {region}",
        n_workers=cfg.n_workers,
        phases=[
            Phase(
                name="ramp_nodes",
                duration=ramp_s,
                rate=nodes / ramp_s,
                uniform=True,
                mix={"node.register": 1.0},
                params=common,
            ),
            Phase(
                name="ramp_jobs",
                duration=3.0,
                rate=max(2.0, cfg.job_slots / 2.0) / 3.0,
                uniform=True,
                mix={"job.submit": 1.0},
                params=common,
            ),
            Phase(
                name="ramp_dsp",
                duration=1.0,
                rate=2.0,
                uniform=True,
                mix={"job.dispatch_register": 1.0},
                params=common,
            ),
            Phase(
                name="churn",
                duration=cfg.churn_s,
                rate=cfg.churn_rate,
                mix={
                    "job.submit": 2.0,
                    "job.scale": 3.0,
                    "job.update": 2.0,
                    "job.stop": 1.0,
                    "job.dispatch": 1.0,
                    "job.evaluate": 0.5,
                    "node.down": 0.8,
                    "node.up": 1.0,
                    "node.drain": 0.6,
                    "node.drain_off": 0.8,
                    "system.gc": 0.3,
                },
                params=common,
            ),
            Phase(
                name="wind_down",
                duration=5.0,
                rate=4.0,
                mix={
                    "job.stop": 1.0,
                    "node.up": 2.0,
                    "node.drain_off": 2.0,
                },
                params=common,
            ),
        ],
        quiesce_timeout=cfg.quiesce_timeout,
        sample_interval=cfg.sample_interval,
        invariants_every=cfg.invariants_every,
        probes=0,
        slos={},
    )


def route_cross_region(
    stream: OpStream, region: str, others: list[str], seed: int, p: float
) -> OpStream:
    """Tag a seeded fraction of job.submit ops with ``via_region``: the
    op fires at that foreign region's HTTP surface with
    ``?region=<home>``, so it crosses the WAN through the forwarding
    plane. The tag lands in the op args — inside the encoded stream and
    its digest — so routing is part of the determinism contract."""
    if not others or p <= 0:
        return stream
    rng = named_rng(seed, stream.scenario_name, "cross-region-routing")
    ops = []
    for op in stream.ops:
        # every submit consumes exactly one draw, so adding/removing
        # other op kinds never perturbs the routing of existing submits
        if op.kind == "job.submit":
            roll = rng.random()
            pick = rng.randrange(len(others))
            if roll < p:
                op = Op(
                    t=op.t, seq=op.seq, kind=op.kind,
                    args={**op.args, "via_region": others[pick]},
                )
        ops.append(op)
    return OpStream(stream.scenario_name, stream.seed, ops)


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------


@dataclass
class FedServer:
    region: str
    index: int
    name: str
    agent: object = None
    http: object = None
    data_dir: str = ""
    rpc_port: int = 0
    http_port: int = 0
    gossip_port: int = 0
    alive: bool = False


class FederatedCluster:
    """Builds and owns the multi-region topology. Every server is a
    real ``ServerAgent`` (TCP RPC listener + raft on the same port) with
    an ``HTTPServer``, a file-backed raft log (so restarts recover), and
    a fixed port set (so a restarted server is reachable at the same
    addresses — the rolling-upgrade shape, and what keeps driver
    address lists valid across chaos)."""

    #: federation-tuned gossip: fast failure detection so a partition is
    #: *observed* within ~2s, suspect long enough that a GIL-stalled
    #: member under storm load can refute before a false dead verdict,
    #: reap long enough that heal-time refutation has live records to
    #: refute
    GOSSIP = {
        "probe_interval": 0.25,
        "ack_timeout": 0.4,
        "suspect_timeout": 1.5,
        "reap_timeout": 8.0,
    }

    #: multi-server raft timing: the in-tree dev defaults (50ms
    #: heartbeat / 150-300ms election) assume an idle box; this topology
    #: runs regions x servers full Python servers in ONE process under
    #: storm load, where GIL stalls alone exceed 300ms — followers would
    #: fire elections against a healthy leader all storm long. WAN-ish
    #: timing keeps failover inside the heal SLO with stall headroom.
    RAFT = {
        "heartbeat_interval": 0.2,
        "election_timeout_min": 0.8,
        "election_timeout_max": 1.6,
    }

    def __init__(self, cfg: FederationConfig, seed: int = 42, device=None):
        self.cfg = cfg
        self.seed = seed
        #: every server's device tier (restarts included)
        self.device = device
        self.regions = cfg.region_names()
        self.auth_region = self.regions[0]
        self.servers: list[FedServer] = []
        self.mgmt_token = ""
        self._tmpdir = tempfile.mkdtemp(prefix="nomad_tpu_fed_")
        self._lock = threading.Lock()

    # -- config assembly -------------------------------------------------
    def _server_config(self, region: str, index: int, seeds: list) -> dict:
        acl: dict = {"enabled": True}
        if region != self.auth_region:
            acl.update(
                authoritative_region=self.auth_region,
                replication_token=self.mgmt_token,
                replication_interval=0.5,
            )
        return {
            "seed": self.seed,
            "region": region,
            "heartbeat_ttl": 3600.0,
            "nack_timeout": 5.0,
            "initial_nack_delay": 0.1,
            "subsequent_nack_delay": 0.5,
            "acl": acl,
            "raft": dict(self.RAFT),
            # the federation scorekeeper drives each recorder's ring via
            # record() — one sampler per server, no second cadence
            "debug": {"flight_recorder": False},
            "gossip": {
                "bind": ("127.0.0.1", 0),
                "join": seeds,
                **self.GOSSIP,
            },
            # region 0's first server bootstraps the WHOLE region's raft
            # domain; everyone else joins voter-less through gossip
            "bootstrap": index == 0,
            **self.cfg.server_settings,
        }

    def _boot_server(self, fs: FedServer, seeds: list,
                     wait_leader: bool = False):
        from ..agent import ServerAgent
        from ..api.http import HTTPServer

        cfg = self._server_config(fs.region, fs.index, seeds)
        if fs.gossip_port:
            cfg["gossip"]["bind"] = ("127.0.0.1", fs.gossip_port)
        agent = ServerAgent(
            fs.name, port=fs.rpc_port, data_dir=fs.data_dir, config=cfg,
            device=self.device,
        )
        # a region's first server is its own voter set; joiners pass an
        # EXPLICITLY empty map and wait for the leader's CONFIG entry
        # (restarts recover the real voter map from their log, so the
        # initial voters value is only the cold-boot seed either way)
        voters = None if fs.index == 0 else {}
        agent.start(
            voters=voters,
            num_workers=self.cfg.n_workers,
            wait_for_leader=10.0 if wait_leader else None,
        )
        http = HTTPServer(agent.server, port=fs.http_port)
        http.start()
        fs.agent = agent
        fs.http = http
        fs.rpc_port = int(agent.address.rsplit(":", 1)[1])
        fs.http_port = int(http.address.rsplit(":", 1)[1].rstrip("/"))
        fs.gossip_port = agent.server.gossip.addr[1]
        fs.alive = True

    def start(self):
        gossip_seeds: list = []
        for region in self.regions:
            for i in range(self.cfg.servers_per_region):
                name = f"{region}-{i}"
                fs = FedServer(
                    region=region, index=i, name=name,
                    data_dir=os.path.join(self._tmpdir, name),
                )
                self._boot_server(fs, list(gossip_seeds), wait_leader=i == 0)
                self.servers.append(fs)
                if not gossip_seeds:
                    gossip_seeds.append(list(fs.agent.server.gossip.addr))
                if region == self.auth_region and i == 0:
                    boot = fs.agent.server.acl_bootstrap()
                    # nta: ignore[unsynchronized-shared-write] WHY: set
                    # during cluster start, before the chaos executor
                    # (the only cross-thread reader) is spawned —
                    # pre-spawn publication
                    self.mgmt_token = boot.secret_id

    def wait_ready(self, timeout: float = 30.0):
        """Readiness barrier: every region elected a leader, every
        region sees every other region's HTTP servers in its forwarding
        table, and the bootstrap token replicated everywhere (so
        cross-region submits authenticate from the first op)."""
        deadline = time.monotonic() + timeout

        def ready() -> bool:
            for region in self.regions:
                leader = self.leader_of(region)
                if leader is None:
                    return False
                for other in self.regions:
                    if other != region and not (
                        leader.agent.server.region_http_servers(other)
                    ):
                        return False
                if region != self.auth_region:
                    srv = leader.agent.server
                    if not list(srv.state.acl_tokens()):
                        return False
            return True

        while time.monotonic() < deadline:
            if ready():
                return
            time.sleep(0.1)
        raise TimeoutError("federated topology never became ready")

    # -- lookups ---------------------------------------------------------
    def live_servers(self, region: str) -> list[FedServer]:
        with self._lock:
            return [
                s for s in self.servers if s.region == region and s.alive
            ]

    def leader_of(self, region: str):
        for s in self.live_servers(region):
            try:
                if s.agent.server.is_leader():
                    return s
            except Exception:
                continue
        return None

    def anchor(self, region: str):
        """The server a scorekeeper should read: the leader when there
        is one, else any live server (state is raft-replicated)."""
        leader = self.leader_of(region)
        if leader is not None:
            return leader
        live = self.live_servers(region)
        return live[0] if live else None

    def http_address(self, region: str) -> str | None:
        s = self.anchor(region)
        return s.http.address if s is not None else None

    def rpc_addresses(self, region: str) -> list[str]:
        """ALL the region's server RPC addresses, dead ones included —
        ports are fixed, so a restarted server is reachable again at the
        same entry and the ServerProxy's rotation handles the rest."""
        return [
            f"127.0.0.1:{s.rpc_port}"
            for s in self.servers
            if s.region == region
        ]

    # -- chaos actions ---------------------------------------------------
    def kill(self, fs: FedServer):
        """Simulated crash: no gossip leave, listener torn down."""
        with self._lock:
            fs.alive = False
        fs.agent.stop(hard=True)
        try:
            fs.http.stop()
        except Exception:
            pass

    def graceful_stop(self, fs: FedServer):
        with self._lock:
            fs.alive = False
        try:
            fs.http.stop()
        except Exception:
            pass
        fs.agent.stop()

    def restart(self, fs: FedServer):
        """Bring a stopped server back on the same ports and data dir
        (the rolling-upgrade step): raft state recovers from its log,
        gossip rejoins through any live peer."""
        seeds = []
        for s in self.servers:
            if s.alive and s.name != fs.name:
                seeds.append(["127.0.0.1", s.gossip_port])
                break
        self._boot_server(fs, seeds)

    def wait_region_leader(self, region: str, timeout: float = 20.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.leader_of(region) is not None:
                return True
            time.sleep(0.05)
        return False

    def probe_forward(self, src_region: str, dst_region: str) -> bool:
        """One end-to-end forwarding probe: a request entering
        ``src_region``'s HTTP surface naming ``dst_region`` must come
        back answered by the other raft domain."""
        from ..api.client import ApiClient

        addr = self.http_address(src_region)
        if addr is None:
            return False
        try:
            regions, _ = ApiClient(
                address=addr, token=self.mgmt_token
            ).get("/v1/regions", region=dst_region)
            return bool(regions)
        except Exception:
            return False

    def rejoin_gossip(self, a: str, b: str):
        sa, sb = self.anchor(a), self.anchor(b)
        if sa is None or sb is None:
            return
        try:
            sa.agent.server.gossip_join(
                [f"127.0.0.1:{sb.gossip_port}"]
            )
        except Exception:
            logger.exception("gossip rejoin %s->%s failed", a, b)

    def stop(self):
        for fs in self.servers:
            if fs.alive:
                try:
                    self.graceful_stop(fs)
                except Exception:
                    logger.exception("stopping %s failed", fs.name)
        shutil.rmtree(self._tmpdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# driver: per-region storm with cross-region routing + oracle
# ---------------------------------------------------------------------------


class FederatedDriver(StormDriver):
    """One region's open-loop driver. ``via_region``-tagged submits fire
    at the foreign region's HTTP surface with ``?region=<home>`` (the
    forwarding plane); every acknowledged submit enters the shared
    cross-region ORACLE — job id, home region, and whether it crossed
    the WAN — and a later acknowledged stop retires its entry, so the
    final sweep checks exactly the jobs that must exist."""

    def __init__(self, *args, region: str, cluster: FederatedCluster,
                 oracle: dict, oracle_lock: threading.Lock, **kw):
        # region-scoped job ids: region A's slot 3 and region B's slot 3
        # must be DIFFERENT jobs, or the cross-region "present in exactly
        # its home region" oracle reads legitimate same-slot submits in
        # two raft domains as a double commit
        kw.setdefault("job_prefix", f"ldg-{region}")
        super().__init__(*args, **kw)
        self.region = region
        self.cluster = cluster
        self.oracle = oracle
        self._oracle_lock = oracle_lock
        # the oracle reads a slot's ops in stream order (a stop retires
        # the submit before it), but the firing pool runs queued ops
        # concurrently: a resubmit could commit before the slow stop
        # ahead of it (which then purges the acked job), or a stop could
        # retire an entry that the slow submit ahead of it records after.
        # Ops on one job slot therefore fire one at a time, in stream
        # order; ops on different slots still overlap freely
        self._slot_cv = threading.Condition()
        self._slot_queued: dict[int, deque] = {}

    def _materialize(self, op):
        # the pacer enqueues in stream order: register the op's place in
        # its slot's line before any worker can dequeue it
        slot = op.args.get("slot")
        if slot is not None:
            with self._slot_cv:
                self._slot_queued.setdefault(slot, deque()).append(op.seq)
        return super()._materialize(op)

    def _fire(self, op, payload, proxy, http):
        slot = op.args.get("slot")
        if slot is None:
            return self._fire_op(op, payload, proxy, http)
        with self._slot_cv:
            line = self._slot_queued[slot]
            if not self._slot_cv.wait_for(
                lambda: line[0] == op.seq, timeout=SLOT_WAIT_S
            ):
                # an earlier op of the slot never reached _fire: fail
                # this one loudly rather than fire it out of order
                line.remove(op.seq)
                self._slot_cv.notify_all()
                raise RuntimeError(
                    f"slot {slot}: op {op.seq} waited {SLOT_WAIT_S} s "
                    f"behind op {line[0] if line else None}"
                )
        try:
            return self._fire_op(op, payload, proxy, http)
        finally:
            with self._slot_cv:
                line.popleft()
                self._slot_cv.notify_all()

    def _fire_op(self, op, payload, proxy, http):
        from .grammar import build_job, job_id_for

        # re-anchor the HTTP surface per op: chaos kills/restarts the
        # server a worker's client was built against (the leader-kill
        # phase targets exactly it), and a fixed dead endpoint would
        # fail every later HTTP op in the region — an operator's LB
        # follows the live servers, so the driver does too
        addr = self.cluster.http_address(self.region)
        if addr and addr.rstrip("/") != http.address:
            from ..api.client import ApiClient

            http = ApiClient(address=addr, token=self.token)
        via = op.args.get("via_region")
        if op.kind == "job.submit" and via:
            from ..api.client import ApiClient

            addr = self.cluster.http_address(via)
            if addr is None:
                raise ConnectionError(f"no live server in region {via}")
            client = ApiClient(address=addr, token=self.token)
            job = build_job(op.args, self.datacenters, self.job_prefix)
            client.put(
                "/v1/jobs", body={"Job": job.to_dict()}, region=self.region
            )
            self._oracle_record(op, forwarded=True)
            return
        if op.kind == "job.stop" and payload is not None:
            # a stop ATTEMPT retires the oracle entry — before the call,
            # not after the ack: a stop that times out may still have
            # applied (the plan-commit indeterminacy class), and with
            # force-GC in the op mix the stopped job can then vanish —
            # the sweep must never demand presence of a job the storm
            # tried to remove. Retiring early only narrows lost-submit
            # coverage for that one job to its pre-stop lifetime.
            job_id = job_id_for(
                op.args["slot"], payload["category"], self.job_prefix
            )
            with self._oracle_lock:
                self.oracle.pop(("default", job_id), None)
        super()._fire(op, payload, proxy, http)
        if op.kind == "job.submit":
            self._oracle_record(op, forwarded=False)

    def _oracle_record(self, op, forwarded: bool):
        from .grammar import job_id_for

        job_id = job_id_for(
            op.args["slot"], op.args["category"], self.job_prefix
        )
        with self._oracle_lock:
            self.oracle[("default", job_id)] = {
                "namespace": "default",
                "job_id": job_id,
                "region": self.region,
                "forwarded": forwarded,
                "via": op.args.get("via_region"),
                "seq": op.seq,
                # dead batch jobs are legitimate force-GC prey
                # (core_sched job_gc: dead AND (stopped OR batch)), so
                # absence at sweep time is not evidence of loss for
                # them — the invariant checker skips their lost-check
                # (double-commit still applies: GC removes, never adds)
                "may_complete": op.args.get("type") == "batch",
            }


# ---------------------------------------------------------------------------
# chaos executor
# ---------------------------------------------------------------------------


class ChaosExecutor:
    """Fires the config's region-scale chaos events at their scheduled
    offsets into the churn phase, records a timeline (with measured heal
    times), and exposes the affected-link windows the scorer uses to
    classify forwarding failures."""

    def __init__(self, cluster: FederatedCluster, plane: _faults.FaultPlane,
                 cfg: FederationConfig, churn_start: float,
                 time_scale: float = 1.0):
        self.cluster = cluster
        self.plane = plane
        self.cfg = cfg
        self.time_scale = time_scale
        # absolute storm offsets: churn_start + frac * churn_s (key on
        # the offset alone — tuple fallthrough would compare the args
        # dicts when two same-kind events share an offset)
        self.events = sorted(
            [
                (
                    (churn_start + frac * cfg.churn_s) * time_scale,
                    kind,
                    dict(args),
                )
                for frac, kind, args in cfg.chaos
            ],
            key=lambda e: e[0],
        )
        self.timeline: list[dict] = []
        self.heal_times: list[float] = []
        #: (t_open, t_closed, frozenset({a,b})) per severed link window
        self.windows: list[tuple] = []
        #: currently-severed pairs: frozenset({a,b}) -> (t_open, rules).
        #: Keyed per pair so a schedule may sever several links before
        #: one heal — an overwrite would leak the first pair's rules
        #: (never expired, never window-recorded) past the heal
        self._open: dict = {}
        self._stop = threading.Event()
        self._t0: float | None = None
        self._thread = threading.Thread(
            target=self._run, name="fed-chaos", daemon=True
        )

    def start(self, t0: float):
        # nta: ignore[unsynchronized-shared-write] WHY: written before
        # the thread spawn on the next line — pre-spawn publication
        self._t0 = t0
        self._thread.start()

    def join(self, timeout: float = 120.0):
        self._thread.join(timeout=timeout)

    def abort(self):
        self._stop.set()

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _record(self, kind: str, detail: dict):
        entry = {"t": round(self._now(), 2), "kind": kind, **detail}
        self.timeline.append(entry)
        logger.info("chaos: %s %s", kind, detail)

    def _run(self):
        for at, kind, args in self.events:
            delay = at - self._now()
            if delay > 0 and self._stop.wait(delay):
                return
            if self._stop.is_set():
                return
            try:
                getattr(self, f"_do_{kind}")(args)
            except Exception:
                logger.exception("chaos event %s %s failed", kind, args)
        # a schedule must never end inside a partition: if the last heal
        # was omitted, heal now so quiescence and the final sweep run on
        # a connected federation
        if self._open:
            self._do_heal({})

    # -- events ----------------------------------------------------------
    def _sever(self, kind: str, args, symmetric: bool):
        a, b = args["a"], args["b"]
        pair = frozenset((a, b))
        prior = self._open.pop(pair, None)
        if prior is not None:
            # same link severed again (e.g. partition -> partial_sever
            # with no heal between): retire the superseded rules, keep
            # the ORIGINAL open time — the link has been dark throughout
            self.plane.expire_rules(prior[1])
        rules = self.plane.partition_regions(a, b, symmetric=symmetric)
        t_open = prior[0] if prior is not None else self._now()
        self._open[pair] = (t_open, rules)
        self._record(kind, {"a": a, "b": b})

    def _do_partition(self, args):
        self._sever("partition", args, symmetric=True)

    def _do_partial_sever(self, args):
        self._sever("partial_sever", args, symmetric=False)

    def _do_heal(self, args):
        if not self._open:
            return
        open_pairs, self._open = self._open, {}
        for _, rules in open_pairs.values():
            self.plane.expire_rules(rules)
        pairs = list(open_pairs)
        t_heal_start = self._now()
        self._record("heal_start", {"pairs": [sorted(p) for p in pairs]})
        # reconnect gossip both ways, then measure until forwarding
        # works end-to-end in both directions (the operator-visible
        # definition of "healed")
        for pair in pairs:
            a, b = sorted(pair)
            self.cluster.rejoin_gossip(a, b)
            self.cluster.rejoin_gossip(b, a)
        deadline = time.monotonic() + 30.0
        healed = False
        while time.monotonic() < deadline and not self._stop.is_set():
            if all(
                self.cluster.probe_forward(a, b)
                and self.cluster.probe_forward(b, a)
                for pair in pairs
                for a, b in [sorted(pair)]
            ):
                healed = True
                break
            time.sleep(0.05)
        heal_s = round(self._now() - t_heal_start, 2)
        if healed:
            self.heal_times.append(heal_s)
        t_closed = self._now()
        for pair, (t_open, _) in open_pairs.items():
            self.windows.append((t_open, t_closed, pair))
        self._record(
            "heal", {"heal_s": heal_s if healed else None, "ok": healed}
        )

    def disruption_windows(self, grace: float = 10.0) -> list[tuple]:
        """(t_lo, t_hi) storm-offset windows in which the cluster was
        being actively disrupted: severed-link windows plus a grace
        neighborhood around leader kills and rolling-restart steps. The
        scorer uses these to classify MID-STORM invariant violations: a
        failover can transiently double-run an alloc (the reconciler
        retires the extra — Nomad's replacement semantics), which is
        chaos-by-design as long as the final sweep comes back clean."""
        wins = [
            (t_open - grace, t_close + grace)
            for t_open, t_close, _ in self.windows
        ]
        for e in self.timeline:
            if e["kind"] in ("leader_kill", "rolling_restart_step"):
                # t stamps the END of the step; step_s covers its start
                lo = e["t"] - e.get("step_s", 0.0) - grace
                wins.append((lo, e["t"] + grace))
        return wins

    def _do_leader_kill(self, args):
        region = args["region"]
        leader = self.cluster.leader_of(region)
        if leader is None:
            self._record("leader_kill", {"region": region, "skipped": True})
            return
        self.cluster.kill(leader)
        elected = self.cluster.wait_region_leader(region)
        self._record(
            "leader_kill",
            {"region": region, "killed": leader.name,
             "reelected": elected},
        )

    def _do_rolling_restart(self, args):
        region = args["region"]
        for fs in list(self.cluster.live_servers(region)):
            if self._stop.is_set():
                return
            t_step = self._now()
            self.cluster.graceful_stop(fs)
            self.cluster.restart(fs)
            leader_ok = self.cluster.wait_region_leader(region)
            self._record(
                "rolling_restart_step",
                {
                    "region": region,
                    "server": fs.name,
                    "leader_after": leader_ok,
                    "step_s": round(self._now() - t_step, 2),
                },
            )


# ---------------------------------------------------------------------------
# scorekeeper
# ---------------------------------------------------------------------------


class FederationScorekeeper:
    """Samples every region on an interval: per-region flight-recorder
    snapshots (through each anchor server's own recorder, so the
    watchdog — acl_replication_lag rule included — rides the same
    samples), per-region incremental invariant sweeps (re-anchored when
    chaos replaces the server object), and ACL replication-lag probes —
    a nonce policy written to the authoritative region and timed until
    each replica region's state shows it."""

    def __init__(self, cluster: FederatedCluster, cfg: FederationConfig,
                 seed: int = 0):
        self.cluster = cluster
        self.cfg = cfg
        self.seed = seed
        self.samples: dict[str, list[dict]] = {
            r: [] for r in cluster.regions
        }
        self.violations: dict[str, list[dict]] = {
            r: [] for r in cluster.regions
        }
        #: measured replication convergence probes:
        #: {region, t_sent, t_obs (storm offsets), lag_s}. Kept per-probe
        #: so the report can classify partition-stalled probes (lag by
        #: design) apart from steady-state convergence lag
        self.repl_lags: list[dict] = []
        self._checkers: dict[str, tuple] = {}
        self._probe_nonce = 0
        #: region -> (nonce, t_sent) for the probe it hasn't seen yet
        self._pending_probe: dict[str, tuple] = {}
        self._stop = threading.Event()
        self._t0: float | None = None
        self._thread = threading.Thread(
            target=self._run, name="fed-scorekeeper", daemon=True
        )

    def start(self, t0: float):
        # nta: ignore[unsynchronized-shared-write] WHY: written before
        # the thread spawn on the next line — pre-spawn publication
        self._t0 = t0
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10.0)

    def _run(self):
        ticks = 0
        while not self._stop.wait(self.cfg.sample_interval):
            ticks += 1
            try:
                self._tick(ticks)
            except Exception:
                logger.exception("federation scorekeeper tick failed")

    def _tick(self, ticks: int):
        t = round(time.monotonic() - self._t0, 2)
        for region in self.cluster.regions:
            fs = self.cluster.anchor(region)
            if fs is None:
                continue
            server = fs.agent.server
            try:
                sample = dict(server.flight_recorder.record())
            except Exception:
                continue
            sample["t"] = t
            sample["server"] = fs.name
            self.samples[region].append(sample)
            if ticks % self.cfg.invariants_every == 0:
                self._sweep(region, server, t)
        if ticks % self.cfg.repl_probe_every == 0:
            self._probe_replication(t)
        self._check_probe_arrival(t)

    def _sweep(self, region: str, server, t: float):
        checker_entry = self._checkers.get(region)
        if checker_entry is None or checker_entry[0] is not server.state:
            # chaos replaced the anchor (restart / failover): re-anchor a
            # fresh incremental checker on the new replica's store
            checker_entry = (
                server.state,
                IncrementalInvariantChecker(
                    server.state, max_fit_nodes=256, seed=self.seed
                ),
            )
            self._checkers[region] = checker_entry
        for v in checker_entry[1].check(quiesced=False):
            self.violations[region].append({"t": t, "violation": v})

    def _probe_replication(self, t: float):
        from ..structs.model import AclPolicy

        auth = self.cluster.leader_of(self.cluster.auth_region)
        if auth is None:
            return
        self._probe_nonce += 1
        nonce = self._probe_nonce
        try:
            auth.agent.server.acl_upsert_policies(
                [
                    AclPolicy(
                        name="fed-replication-probe",
                        description="loadgen federation lag probe",
                        rules=f"# probe nonce {nonce}",
                    )
                ]
            )
        except Exception:
            return  # auth region mid-election: probe next tick
        now = time.monotonic()
        for region in self.cluster.regions:
            if region != self.cluster.auth_region:
                # one in-flight probe per region; a newer nonce replaces
                # an unobserved older one (the lag keeps accruing from
                # the OLD send time — replication is behind both)
                old = self._pending_probe.get(region)
                self._pending_probe[region] = (
                    nonce, old[1] if old else now
                )

    def _check_probe_arrival(self, t: float):
        for region, (nonce, t_sent) in list(self._pending_probe.items()):
            fs = self.cluster.anchor(region)
            if fs is None:
                continue
            try:
                policy = fs.agent.server.state.acl_policy_by_name(
                    "fed-replication-probe"
                )
            except Exception:
                continue
            if policy is not None and f"nonce {nonce}" in policy.rules:
                now = time.monotonic()
                self.repl_lags.append(
                    {
                        "region": region,
                        "t_sent": round(t_sent - self._t0, 2),
                        "t_obs": round(now - self._t0, 2),
                        "lag_s": round(now - t_sent, 3),
                    }
                )
                del self._pending_probe[region]

    def checker_stats(self) -> dict:
        return {
            region: entry[1].stats()
            for region, entry in self._checkers.items()
        }


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


def _percentile(xs: list[float], pct: float) -> float:
    if not xs:
        return 0.0
    ordered = sorted(xs)
    return ordered[min(len(ordered) - 1, int(len(ordered) * pct))]


def _chaos_event_windows(
    chaos: "ChaosExecutor", grace: float
) -> dict:
    """region -> [(lo, hi)] windows around leader kills and rolling-
    restart steps: chaos that disrupts a region's servers without a
    severed-link window to show for it."""
    event_windows: dict[str, list[tuple[float, float]]] = {}
    for e in chaos.timeline:
        if e["kind"] in ("leader_kill", "rolling_restart_step"):
            lo = e["t"] - e.get("step_s", 0.0) - grace
            event_windows.setdefault(e["region"], []).append(
                (lo, e["t"] + grace)
            )
    return event_windows


def _link_disrupted(
    t_lo: float, t_hi: float, a: str, b: str,
    chaos: "ChaosExecutor", event_windows: dict, grace: float,
) -> bool:
    """Was traffic between regions ``a`` and ``b`` over [t_lo, t_hi]
    subject to declared chaos — a severed-link window covering the pair,
    or a leader kill / restart step in EITHER endpoint region?"""
    if any(
        a in pair
        and b in pair
        and t_lo <= t_close + grace
        and t_hi >= t_open - grace
        for t_open, t_close, pair in chaos.windows
    ):
        return True
    return any(
        t_lo <= hi and t_hi >= lo
        for region in (a, b)
        for lo, hi in event_windows.get(region, ())
    )


def _replication_lag_split(
    probes: list[dict], chaos: "ChaosExecutor", auth: str,
    grace: float = 3.0,
) -> tuple[list[float], list[float]]:
    """→ (steady_lags, chaos_lags): a probe whose in-flight interval
    overlaps chaos that stalls replication was lagged by design — the
    SLO grades the steady-state tail, the chaos tail is reported
    separately. Replication-impacting chaos is (a) a severed-link
    window touching the (auth, region) WAN link, and (b) a leader kill
    or rolling-restart step in the REPLICA's region (its leader runs
    the replication loop; a kill stalls the pull until re-election) or
    in the authoritative region (its servers answer it)."""
    event_windows = _chaos_event_windows(chaos, grace)
    steady, chaotic = [], []
    for p in probes:
        in_window = _link_disrupted(
            p["t_sent"], p["t_obs"], p["region"], auth,
            chaos, event_windows, grace,
        )
        (chaotic if in_window else steady).append(p["lag_s"])
    return steady, chaotic


def _forward_failure_split(
    results, stream, chaos: "ChaosExecutor", home: str,
    grace: float = 3.0,
) -> tuple[int, int, int, list]:
    """→ (attempted, failed_outside_windows, failed_inside_windows,
    failure_details) for the cross-region submits of one region's
    driver (``home``). A failure whose firing interval overlaps
    declared chaos on its via→home hop — a severed-link window
    covering the pair, or a leader kill / rolling-restart step in
    either endpoint region (a restarting server resets in-flight
    forwards, which correctly surface as outcome-unknown) — is
    chaos-by-design; one outside every window is a forwarding bug.
    The details (timestamped, window-classified, error-tailed) land in
    the artifact per region."""
    ops_by_seq = {op.seq: op for op in stream.ops}
    event_windows = _chaos_event_windows(chaos, grace)
    attempted = failed_out = failed_in = 0
    details: list[dict] = []
    for r in results:
        op = ops_by_seq.get(r.seq)
        if op is None or op.kind != "job.submit":
            continue
        via = op.args.get("via_region")
        if not via:
            continue
        attempted += 1
        if r.ok or r.expected_miss or r.shed:
            continue
        # the WAN link exercised: via -> home (the forward direction)
        link_in_window = _link_disrupted(
            r.t_start, r.t_done, via, home, chaos, event_windows, grace,
        )
        if link_in_window:
            failed_in += 1
        else:
            failed_out += 1
        details.append(
            {
                "t_start": round(r.t_start, 2),
                "t_done": round(r.t_done, 2),
                "via": via,
                "home": home,
                "in_window": link_in_window,
                "error": r.error[:160],
            }
        )
    return attempted, failed_out, failed_in, details


def _wait_replication_settled(cluster, timeout: float = 15.0):
    """Settle barrier before the final cross-region sweep: the
    scorekeeper's LAST lag probe (and any late policy write) may still
    be mid-replication when it stops — the contract is convergence with
    *bounded* lag, so equality is asserted only after replication had
    one bounded window to drain. Times out silently: a genuinely stuck
    replica then fails the final sweep loudly, which is the point."""
    auth = cluster.anchor(cluster.auth_region)
    if auth is None:
        return
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            want = {
                p.name: p.rules
                for p in auth.agent.server.state.acl_policies()
            }
        except Exception:
            return
        settled = True
        for region in cluster.regions:
            if region == cluster.auth_region:
                continue
            fs = cluster.anchor(region)
            if fs is None:
                continue
            try:
                got = {
                    p.name: p.rules
                    for p in fs.agent.server.state.acl_policies()
                }
            except Exception:
                settled = False
                break
            if got != want:
                settled = False
                break
        if settled:
            return
        time.sleep(0.1)


def run_federation(
    cfg: FederationConfig | None = None,
    seed: int = 1,
    out: str | None = None,
    time_scale: float = 1.0,
    device=None,
) -> dict:
    """One federated storm end-to-end; returns the scored report (also
    written to ``out``). Grading is the caller's verdict, same contract
    as run_scenario. Every server runs on ``device`` (CUDA unless
    ``"cpu"``), which is resolved, and refused when CUDA is missing,
    before any stream compiles or any thread starts."""
    from .. import resolve_device
    from .runner import wait_quiescent

    device = resolve_device(device)
    cfg = cfg or federation_config_from_env()
    regions = cfg.region_names()

    # compile + route every region's stream FIRST: the determinism
    # contract (same seed -> same per-region digest) holds before any
    # cluster exists
    streams: dict[str, OpStream] = {}
    for region in regions:
        base = compile_stream(region_scenario(region, cfg), seed)
        streams[region] = route_cross_region(
            base, region, [r for r in regions if r != region], seed,
            cfg.cross_region_p,
        )
    for region, stream in streams.items():
        logger.info(
            "compiled %s: %d ops (digest %s)",
            stream.scenario_name, len(stream.ops), stream.digest()[:12],
        )

    churn_start = sum(
        p.duration for p in region_scenario(regions[0], cfg).phases[:3]
    )
    plane = _faults.install(_faults.FaultPlane(seed=seed))
    cluster = FederatedCluster(cfg, seed=42, device=device)
    scorekeeper = None
    chaos = None
    try:
        cluster.start()
        cluster.wait_ready()

        oracle: dict = {}
        oracle_lock = threading.Lock()
        drivers = {
            region: FederatedDriver(
                streams[region],
                cluster.rpc_addresses(region),
                cluster.http_address(region),
                workers=cfg.driver_workers,
                time_scale=time_scale,
                token=cluster.mgmt_token,
                region=region,
                cluster=cluster,
                oracle=oracle,
                oracle_lock=oracle_lock,
            )
            for region in regions
        }

        t0 = time.monotonic()
        scorekeeper = FederationScorekeeper(cluster, cfg, seed=seed)
        scorekeeper.start(t0)
        chaos = ChaosExecutor(
            cluster, plane, cfg, churn_start, time_scale=time_scale
        )
        chaos.start(t0)

        driver_reports: dict[str, object] = {}
        threads = []
        for region, driver in drivers.items():
            def _run(region=region, driver=driver):
                driver_reports[region] = driver.run()

            th = threading.Thread(
                target=_run, name=f"fed-driver-{region}", daemon=True
            )
            th.start()
            threads.append(th)
        for th in threads:
            th.join()
        chaos.join()

        # quiesce every region (on its current leader), then the final
        # cross-region oracle over every region's replicated state
        quiesced = {}
        for region in regions:
            fs = cluster.anchor(region)
            quiesced[region] = (
                wait_quiescent(fs.agent.server, cfg.quiesce_timeout)
                if fs is not None
                else False
            )
        scorekeeper.stop()
        _wait_replication_settled(cluster)

        region_states = {
            region: cluster.anchor(region).agent.server.state
            for region in regions
            if cluster.anchor(region) is not None
        }
        with oracle_lock:
            oracle_entries = list(oracle.values())
        final_violations = check_federation_invariants(
            region_states,
            oracle=oracle_entries,
            acl_authoritative=cluster.auth_region,
        )
        report = _assemble_report(
            cfg, seed, cluster, streams, drivers, driver_reports,
            scorekeeper, chaos, oracle_entries, final_violations, quiesced,
        )
        if out:
            write_report(report, out)
        return report
    finally:
        if scorekeeper is not None:
            scorekeeper.stop()
        if chaos is not None:
            chaos.abort()
        _faults.uninstall()
        cluster.stop()


def _assemble_report(
    cfg, seed, cluster, streams, drivers, driver_reports, scorekeeper,
    chaos, oracle_entries, final_violations, quiesced,
) -> dict:
    regions = cluster.regions
    lost = sum(
        1 for v in final_violations if "lost cross-region submit" in v
    )
    double = sum(
        1
        for v in final_violations
        if "double-committed cross-region submit" in v
    )
    # mid-storm violations inside an active disruption window are
    # transient-by-design IF the final sweep is clean (a failover window
    # can double-run an alloc until the reconciler retires the extra);
    # one outside every window — or any final violation — is a real bug
    disruption = chaos.disruption_windows()
    mid_storm = {}
    mid_storm_count = transient_count = 0
    for region in regions:
        entries = []
        for entry in scorekeeper.violations[region]:
            in_window = any(
                lo <= entry["t"] <= hi for lo, hi in disruption
            )
            entries.append({**entry, "in_disruption_window": in_window})
            if in_window:
                transient_count += 1
            else:
                mid_storm_count += 1
        mid_storm[region] = entries

    fwd_attempted = fwd_failed_out = fwd_failed_in = 0
    per_region = {}
    agg = {"fired": 0, "ok": 0, "failed": 0, "expected_miss": 0, "shed": 0}
    for region in regions:
        rep = driver_reports.get(region)
        drv = rep.to_dict() if rep is not None else {}
        for k in agg:
            agg[k] += drv.get(k, 0)
        # the window classification needs the raw per-op results (which
        # live on the driver, not its report): a forwarded submit that
        # failed INSIDE a severed-link window is chaos-by-design, one
        # outside every window is a forwarding bug
        att, out_w, in_w, fwd_details = _forward_failure_split(
            drivers[region].results, streams[region], chaos, region,
        )
        fwd_attempted += att
        fwd_failed_out += out_w
        fwd_failed_in += in_w
        samples = scorekeeper.samples[region]
        # per-failure timelines: cheap (failures only, capped) and the
        # difference between "debuggable artifact" and "rerun with logs"
        failed_ops = [
            {
                "t": round(r.t_start, 2),
                "kind": r.kind,
                "error": r.error[:160],
            }
            for r in drivers[region].results
            if not (r.ok or r.expected_miss or r.shed)
        ][:200]
        per_region[region] = {
            "servers": sum(1 for s in cluster.servers if s.region == region),
            "stream_digest": streams[region].digest(),
            "stream_ops": len(streams[region].ops),
            "driver": drv,
            "failed_ops": failed_ops,
            "fwd_failures": fwd_details,
            "quiesced": quiesced.get(region, False),
            "mid_storm_violations": mid_storm[region],
            "rss_peak_mb": max(
                (s.get("rss_mb", 0.0) for s in samples), default=0.0
            ),
            "acl_replication_lag_s_max": max(
                (
                    s["acl_replication_lag_s"]
                    for s in samples
                    if "acl_replication_lag_s" in s
                ),
                default=0.0,
            ),
            "watchdog": (
                cluster.anchor(region).agent.server.watchdog.stats()
                if cluster.anchor(region) is not None
                and cluster.anchor(region).agent.server.watchdog is not None
                else None
            ),
            "samples": samples,
        }

    total_violations = len(final_violations) + mid_storm_count
    unhealed = any(
        e["kind"] == "heal" and not e.get("ok") for e in chaos.timeline
    )
    # a partition that never measurably healed fails the heal SLO loudly
    # (finite sentinel: the artifact stays strict JSON)
    heal_s = (
        9999.0 if unhealed
        else (max(chaos.heal_times) if chaos.heal_times else 0.0)
    )
    steady_lags, chaos_lags = _replication_lag_split(
        scorekeeper.repl_lags, chaos, cluster.auth_region
    )
    repl_p99 = round(_percentile(steady_lags, 0.99), 3)
    report = {
        "scenario": "federation",
        "profile": "smoke" if cfg.servers_per_region == 1 else "storm",
        "seed": seed,
        "regions": per_region,
        "region_names": regions,
        "servers_total": len(cluster.servers),
        "driver": agg,
        "chaos": chaos.timeline,
        "oracle_checked_submits": len(oracle_entries),
        "oracle_forwarded_submits": sum(
            1 for e in oracle_entries if e.get("forwarded")
        ),
        "fed_fwd_attempted": fwd_attempted,
        "fed_fwd_failed": fwd_failed_out,
        "fed_fwd_failed_in_chaos": fwd_failed_in,
        "fed_fwd_err_rate": round(
            fwd_failed_out / max(fwd_attempted, 1), 4
        ),
        "fed_heal_s": heal_s,
        "fed_heal_times": chaos.heal_times,
        "fed_replication_lag_p99_s": repl_p99,
        "fed_replication_lag_chaos_max_s": round(max(chaos_lags, default=0.0), 3),
        "fed_replication_probes": len(scorekeeper.repl_lags),
        "fed_replication_probes_in_chaos": len(chaos_lags),
        "replication_probes": scorekeeper.repl_lags,
        "fed_lost_placements": lost,
        "fed_double_placements": double,
        "fed_invariant_violations": total_violations,
        "fed_transient_violations": transient_count,
        "disruption_windows": [
            [round(lo, 2), round(hi, 2)] for lo, hi in disruption
        ],
        "final_violations": final_violations,
        "invariant_checkers": scorekeeper.checker_stats(),
        "watchdog_trips": sum(
            (per_region[r]["watchdog"] or {}).get("trips", 0)
            for r in regions
        ),
        "quiesced": all(quiesced.get(r, False) for r in regions),
    }
    slo = grade(report, cfg.slos)
    # a federation that cannot quiesce failed no matter what the samples
    # say (same contract as the soak runner)
    ok = report["quiesced"]
    slo["checks"]["quiesced"] = {"target": True, "actual": ok, "pass": ok}
    slo["passed" if ok else "failed"] += 1
    slo["score"] = round(slo["passed"] / (slo["passed"] + slo["failed"]), 3)
    report["slo"] = slo
    return report


def summary_line(report: dict) -> str:
    """The trailing FED_SUMMARY line (log-tail-survival contract)."""
    slo = report["slo"]
    digests = ",".join(
        f"{r}:{report['regions'][r]['stream_digest'][:8]}"
        for r in report["region_names"]
    )
    parts = [
        f"regions={len(report['region_names'])}",
        f"servers={report['servers_total']}",
        f"seed={report['seed']}",
        f"ops={report['driver']['fired']}",
        f"ok={report['driver']['ok']}",
        f"failed={report['driver']['failed']}",
        f"fwd={report['fed_fwd_attempted']}",
        f"fwd_err_rate={report['fed_fwd_err_rate']}",
        f"fwd_chaos_failed={report['fed_fwd_failed_in_chaos']}",
        f"heal_s={report['fed_heal_s']}",
        f"repl_lag_p99_s={report['fed_replication_lag_p99_s']}",
        f"invariant_violations={report['fed_invariant_violations']}",
        f"transient_violations={report['fed_transient_violations']}",
        f"lost={report['fed_lost_placements']}",
        f"double={report['fed_double_placements']}",
        f"oracle_submits={report['oracle_checked_submits']}",
        f"watchdog_trips={report['watchdog_trips']}",
        f"slo={slo['passed']}/{slo['passed'] + slo['failed']}",
        f"score={slo['score']}",
        f"digests={digests}",
    ]
    return "FED_SUMMARY " + " ".join(parts)


def run_federation_from_env(
    seed: int, out: str | None = None, time_scale: float = 1.0, device=None
) -> dict:
    return run_federation(
        federation_config_from_env(), seed=seed, out=out,
        time_scale=time_scale, device=device,
    )
