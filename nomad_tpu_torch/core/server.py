"""Server core: raft-replicated control plane wiring state, FSM, broker,
plan applier, workers, heartbeats, and the RPC endpoint surface
(ref nomad/server.go, nomad/leader.go, nomad/*_endpoint.go).

Every state mutation flows through ``_apply`` → raft log → FSM → state
store, exactly as the reference routes writes through raftApply
(nomad/rpc.go). Leader-only subsystems (eval broker, blocked-evals
tracker, plan queue, heartbeat timers, failed-eval reaper) are enabled in
``_establish_leadership`` and disabled in ``_revoke_leadership``
(ref leader.go:180 establishLeadership / revokeLeadership). A single-node
server bootstraps itself as leader in milliseconds (the reference's
-dev mode with in-memory raft, server.go:105).

The port's copy of ``nomad_tpu/core/server.py``. ``Server(config,
device)`` runs its device tier (the workers' schedulers, the drain
collector, the mirror's device planes and the applier's dense verify) on
``device``: CUDA unless the caller passes ``"cpu"``; without a card it
raises. The ``prewarm_kernels`` stanza launches the warm-up ladder
(``tpu/warmup.py``) on ``device`` in a background thread. The stanzas that
reach modules not yet ported raise an error that names their ROADMAP item
(``gossip``, ACL and its replication client, ``shard_devices``).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Optional

from .. import metrics, resolve_device
from ..testing import faults as _faults
from ..raft import InmemTransport, NotLeaderError, Raft, RaftConfig
from ..raft.log import InmemLogStore, SnapshotStore, StableStore
from ..state.store import StateStore
from ..structs.model import (
    EVAL_STATUS_CANCELLED,
    EVAL_STATUS_PENDING,
    EVAL_TRIGGER_JOB_DEREGISTER,
    EVAL_TRIGGER_JOB_REGISTER,
    EVAL_TRIGGER_NODE_UPDATE,
    EVAL_TRIGGER_RETRY_FAILED_ALLOC,
    JOB_MAX_PRIORITY,
    JOB_MIN_PRIORITY,
    JOB_TYPE_BATCH,
    JOB_TYPE_CORE,
    JOB_TYPE_SERVICE,
    JOB_TYPE_SYSTEM,
    NODE_STATUS_DOWN,
    NODE_STATUS_READY,
    Allocation,
    Evaluation,
    Job,
    Node,
    fast_alloc_clone,
    generate_uuid,
    now_ns,
)
from ..structs.node_class import compute_class
from . import fsm as fsm_mod
from .blocked_evals import BlockedEvals
from .broker import EvalBroker, shared_timer_wheel
from .deployment_watcher import DeploymentsWatcher, install_deployment_endpoints
from .drainer import NodeDrainer
from . import overload as overload_mod
from .overload import OverloadController, current_deadline
from .periodic import PeriodicDispatch, derive_dispatch_job
from .fsm import FSM
from .plan_apply import Planner
from .worker import Worker

logger = logging.getLogger("nomad_tpu.server")

DEFAULT_HEARTBEAT_TTL = 30.0
#: seconds a failed proxy HTTP address stays quarantined
HTTP_ADDR_QUARANTINE = 10.0
#: seconds ``stop`` waits for a running warm-up to finish
PREWARM_STOP_S = 120.0


def _not_ported(what: str, item: str) -> NotImplementedError:
    """The error of a stanza or call that reaches a module the port does
    not have yet; ``item`` names its entry in ROADMAP.md's queue A."""
    return NotImplementedError(
        f"{what} is not ported to nomad_tpu_torch yet (ROADMAP queue A: {item})"
    )


class Server:
    """ref nomad/server.go:91"""

    def __init__(self, config: Optional[dict] = None, device=None):
        self.config = config or {}
        #: the device tier's device (nomad_tpu_torch.resolve_device)
        self.device = resolve_device(device)
        if self.acl_enabled():
            raise _not_ported("the acl stanza", "gossip, federation and ACL")
        # trace{} stanza (OBSERVABILITY.md): enabled, sample_rate,
        # retain, slow_keep, error_keep. The tracer is process-wide
        # (metrics-registry idiom); only keys present are applied, so
        # multiple in-process servers don't fight over defaults
        trace_cfg = self.config.get("trace")
        if trace_cfg:
            from ..trace import tracer as _tracer

            _tracer.configure(**trace_cfg)
        self.state = StateStore()
        # plan_pipeline{} stanza (OBSERVABILITY.md): the applier pipeline
        # depth, the device dense-verify gate, and the eval broker's
        # ready-queue shard count all tune the ROADMAP item 1 knee
        pp_cfg = dict(self.config.get("plan_pipeline") or {})
        self.eval_broker = EvalBroker(
            nack_timeout=self.config.get("nack_timeout", 60.0),
            delivery_limit=self.config.get("delivery_limit", 3),
            initial_nack_delay=self.config.get("initial_nack_delay", 1.0),
            subsequent_nack_delay=self.config.get("subsequent_nack_delay", 20.0),
            ready_shards=int(pp_cfg.get("ready_shards", 1)),
        )
        self.blocked_evals = BlockedEvals(self.eval_broker)
        self.periodic = None  # PeriodicDispatch attaches in agent wiring
        self.deployment_watcher = None  # set by DeploymentsWatcher below
        self.drainer = None
        # coarse time→index witness map feeding GC thresholds
        # (ref fsm.go TimeTable; not snapshot-persisted — after a restart
        # the table refills and GC conservatively pauses for one threshold)
        from .core_sched import TimeTable

        self.time_table = TimeTable(
            granularity=float(self.config.get("time_table_granularity", 60.0))
        )
        # cluster event stream (events/broker.py): FSM-sourced, so every
        # server — leader or follower — can serve /v1/event/stream.
        # Configured by the telemetry-style event_broker{} stanza; on by
        # default (the ring is a few thousand slim dicts).
        eb_cfg = self.config.get("event_broker") or {}
        self.event_broker = None
        if eb_cfg.get("enabled", True):
            from ..events import EventBroker

            self.event_broker = EventBroker(
                size=int(eb_cfg.get("event_buffer_size", 4096)),
                subscriber_buffer=int(eb_cfg.get("subscriber_buffer", 1024)),
                # snapshot-on-subscribe reads the store's COW generations
                # (state/store.py snapshot_events): cold watchers start
                # from a consistent snapshot at index N instead of full
                # blocking queries, and lost-gap resumes become
                # snapshot+deltas
                state=self.state,
                snapshot_on_subscribe=bool(
                    eb_cfg.get("snapshot_on_subscribe", True)
                ),
                max_subscribers=int(eb_cfg.get("max_subscribers", 0)),
                frame_batch=int(eb_cfg.get("frame_batch", 64)),
            )
        self.fsm = FSM(
            state=self.state,
            eval_broker=self.eval_broker,
            blocked_evals=self.blocked_evals,
            time_table=self.time_table,
            event_broker=self.event_broker,
        )
        # committed-plane columnar view (tpu/mirror.py): the TPU drain
        # path's dense state plane. The planes themselves live in the
        # state store and are patched by the same write transaction that
        # swaps the tables (state/planes.py), so the view needs no event
        # subscription and is constructed unconditionally.
        from ..tpu.mirror import ColumnarMirror

        self.columnar_mirror = ColumnarMirror(self.state, device=self.device)
        # operator debug plane (nomad_tpu/debug; OBSERVABILITY.md): the
        # flight recorder is the whole-process tape the watchdog rules
        # and debug bundles read. Constructed always (cheap: one deque),
        # its sampling thread starts with the server unless the debug{}
        # stanza disables it. Bundles auto-capture on watchdog trips
        # only when a bundle_dir is configured — a default agent never
        # surprises the operator with disk writes.
        dbg_cfg = dict(self.config.get("debug") or {})
        from ..debug import FlightRecorder, Watchdog

        self.flight_recorder = FlightRecorder(
            self,
            interval=float(dbg_cfg.get("flight_interval", 1.0)),
            retain=int(dbg_cfg.get("flight_retain", 512)),
        )
        self.watchdog = None
        wd_cfg = dbg_cfg.get("watchdog", {})
        if wd_cfg is not False:
            self.watchdog = Watchdog(
                self,
                self.flight_recorder,
                config=wd_cfg if isinstance(wd_cfg, dict) else {},
                bundle_dir=str(dbg_cfg.get("bundle_dir") or ""),
            )
            self.flight_recorder.observer = self.watchdog.on_sample
        self._flight_enabled = bool(dbg_cfg.get("flight_recorder", True))
        # overload control plane (core/overload.py; OBSERVABILITY.md "The
        # overload plane"): constructed ONLY when the overload{} stanza
        # is present — no stanza means no admission, no brownout, no
        # default deadline: byte-identical pre-overload behavior (the
        # A/B contract pinned by tests/test_overload.py)
        self.overload: Optional[OverloadController] = None
        # stream-shed hooks: the HTTP layer's StreamMux registers its
        # set_class_shed here (the core server doesn't own the HTTP
        # plane — the CLI wires them, so this is a callback seam). With
        # no overload plane the ladder never reaches the stream rungs
        # and registered hooks are never invoked.
        # nta: ignore[unbounded-cache] WHY: one registration per stream
        # mux, and a server wires at most one HTTP layer — growth is
        # O(process wiring), not O(traffic); hooks live for the server.
        self._stream_shed_hooks: list = []
        self._stream_shed_on: set = set()
        ov_cfg = dict(self.config.get("overload") or {})
        if ov_cfg and ov_cfg.get("enabled", True):
            self.overload = OverloadController(
                ov_cfg,
                load_fn=self._overload_load,
                brownout_actions=self._brownout_actions(),
            )
            # the broker refuses expired evals at dequeue; this callback
            # turns each refusal into a terminal failed-eval update so
            # the submitter sees a loud outcome, never a vanished eval
            self.eval_broker.on_deadline_exceeded = (
                lambda ev: self.eval_deadline_exceeded(ev, "broker")
            )
            # drive the brownout ladder at the flight recorder's cadence,
            # chained in FRONT of the watchdog observer so both see every
            # sample (brownout transitions are deterministic per run)
            prev_observer = self.flight_recorder.observer

            def _overload_observer(sample, _prev=prev_observer):
                try:
                    self.overload.on_sample()
                except Exception:
                    logger.exception("overload on_sample failed")
                if _prev is not None:
                    _prev(sample)

            self.flight_recorder.observer = _overload_observer
        self.planner = Planner(self.state)
        # max independently-verified plans folded into ONE raft entry
        # (server stanza `plan_apply_batch`; the observed fold sizes are
        # exported as the plan.apply_batch_size histogram in /v1/metrics)
        self.planner.max_apply_batch = max(
            1, int(self.config.get("plan_apply_batch",
                                   self.planner.max_apply_batch))
        )
        # applier pipeline knobs (plan_pipeline{}): commit-overlap depth
        # and the device-resident dense verify against the mirror planes
        self.planner.max_inflight = max(
            1, int(pp_cfg.get("max_inflight", self.planner.max_inflight))
        )
        self.planner.device_verify = bool(pp_cfg.get("device_verify", True))
        self.planner.device_verify_min = int(
            pp_cfg.get("device_verify_min", self.planner.device_verify_min)
        )
        # late-bound: the mirror is constructed above but may be closed/
        # absent; the applier degrades to the host oracle either way
        self.planner.mirror_fn = lambda: self.columnar_mirror
        self.planner.commit_fn = self._commit_plan
        self.planner.commit_batch_fn = self._commit_plan_batch
        self.planner.barrier_fn = self._plan_commit_barrier
        self.planner.preemption_evals_fn = self._make_preemption_evals
        self.planner.token_check_fn = self._plan_token_live
        self.workers: list[Worker] = []
        self.heartbeat_ttl = self.config.get("heartbeat_ttl", DEFAULT_HEARTBEAT_TTL)
        # node id -> cancelable handle on the SHARED timer wheel. These
        # were threading.Timer — one OS thread per tracked node for the
        # whole TTL, which capped the fleet at the environment's thread
        # limit (~4K); the 10K-node churn soak dies there instantly
        self._heartbeat_timers: dict = {}
        # expiry handoff: the wheel runs callbacks inline on its ONE
        # process-wide thread, and an expiry is two raft applies + eval
        # fan-out — thousands at once when a leader loses its clients —
        # so the wheel callback only enqueues here; a lazily-started
        # per-server drainer does the work
        self._hb_expire_q: queue.Queue = queue.Queue()
        self._hb_expire_thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._running = False
        self._leader = False
        self._leader_cond = threading.Condition()
        self._reaper: Optional[threading.Thread] = None
        self._gc_scheduler: Optional[threading.Thread] = None
        #: this server's advertised HTTP address (set by HTTPServer.start
        #: via advertise_http); served to peers over Status.HTTPAddr
        self.http_advertise_addr: Optional[str] = None
        #: rpc_addr → peer HTTP address learned over Status.HTTPAddr
        self._peer_http_addrs: dict[str, str] = {}
        #: http addr → monotonic time a proxy to it last failed
        self._bad_http_addrs: dict[str, float] = {}
        # both maps are touched from concurrent HTTP handler threads;
        # check-then-pop sequences need real mutual exclusion, and expired
        # quarantine entries are pruned so the map can't grow unboundedly
        self._http_addr_lock = threading.Lock()
        # secret → compiled ACL, invalidated by acl table indexes in the key
        self._acl_cache: dict = {}

        DeploymentsWatcher(self)  # installs itself as self.deployment_watcher
        NodeDrainer(self)  # installs itself as self.drainer
        PeriodicDispatch(self)  # attaches as self.periodic + FSM hook
        #: this server's region; regions are independent raft domains
        #: federated over gossip (ref regions_endpoint.go, serf.go WAN)
        self.region = self.config.get("region", "global")
        #: ACL-replication health, fed by replicate_acl_once and read by
        #: the flight recorder (debug/flight.py) so the per-region
        #: acl_replication_lag watchdog rule can see replication stall
        #: while it is happening. Keys: configured, authoritative_region,
        #: rounds, failures, last_success_wall, started_wall, last_error.
        self.acl_replication_status: dict = {"configured": False}
        self.raft = self._setup_raft()
        #: members with a grace-delayed voter-removal recheck in flight
        #: (one per member; see _remove_dead_server_after_grace)
        self._dead_server_pending: set = set()
        self._dead_server_lock = threading.Lock()
        self.gossip = self._setup_gossip()
        from .vault import VaultClient

        self.vault = VaultClient(self)

    # ------------------------------------------------------------------
    # raft wiring (ref server.go:1075 setupRaft)
    # ------------------------------------------------------------------
    def _setup_raft(self) -> Raft:
        rc = self.config.get("raft", {})
        node_id = rc.get("node_id", self.config.get("name", "server-1"))
        address = rc.get("address", node_id)
        if self.config.get("gossip") and not self.config.get("bootstrap"):
            # gossip auto-discovery (ref serf.go): non-bootstrap servers
            # start with no voters and wait for the leader to add them via
            # a raft CONFIG entry — they never self-elect
            voters = rc.get("voters", {})
        else:
            voters = rc.get("voters", {node_id: address})
        single = len(voters) == 1
        # timing knobs (``raft`` stanza): the dev defaults are tuned for
        # an idle box — multi-server clusters under real load (and the
        # federated chaos topology, which runs many servers in one
        # process) need election timeouts with GIL-stall headroom, or
        # followers fire elections against a perfectly healthy leader
        raft_config = rc.get("config") or RaftConfig(
            # single-voter dev servers elect in ~10ms (raftInmem dev mode)
            heartbeat_interval=rc.get(
                "heartbeat_interval", 0.02 if single else 0.05
            ),
            election_timeout_min=rc.get(
                "election_timeout_min", 0.01 if single else 0.15
            ),
            election_timeout_max=rc.get(
                "election_timeout_max", 0.03 if single else 0.30
            ),
            snapshot_threshold=rc.get("snapshot_threshold", 8192),
        )
        return Raft(
            node_id=node_id,
            address=address,
            voters=voters,
            fsm=self.fsm,
            transport=rc.get("transport") or InmemTransport(),
            log_store=rc.get("log_store") or InmemLogStore(),
            stable=rc.get("stable") or StableStore(),
            snapshots=rc.get("snapshots") or SnapshotStore(),
            config=raft_config,
            on_leadership=self._leadership_changed,
        )

    def _setup_gossip(self):
        """Gossip membership wiring (ref nomad/serf.go setupSerf +
        serf event handler feeding raft membership)."""
        gcfg = self.config.get("gossip")
        if not gcfg:
            return None
        raise _not_ported("the gossip stanza", "gossip, federation and ACL")

    def _gossip_event(self, event: str, member):
        """Serf events → raft membership, leader-side only (followers
        converge through the replicated CONFIG entries); ref serf.go
        nodeJoin/nodeFailed + autopilot dead-server cleanup."""
        if not self._leader:
            return
        # regions are independent raft domains joined only by gossip
        # (ref serf.go WAN federation): never add a foreign region's
        # server as a voter
        if member.tags.get("region", "global") != self.region:
            return
        try:
            if event == "join":
                raft_addr = member.tags.get("raft")
                if raft_addr and self.raft.voters.get(member.name) != raft_addr:
                    # new server, or a known server back with a different
                    # raft address (restart with dynamic bind): either way
                    # the CONFIG entry carries the current address
                    logger.info("gossip: adding server %s to raft", member.name)
                    self.raft.add_voter(member.name, raft_addr)
            elif event in ("dead", "leave", "reap"):
                # intentional leaves always deregister; crash-failures are
                # reaped only when autopilot dead-server cleanup is on
                # (ref autopilot.go pruneDeadServers)
                if event == "dead" and not self.autopilot_config().get(
                    "cleanup_dead_servers", True
                ):
                    return
                if member.name not in self.raft.voters:
                    return
                if event == "leave":
                    # a leave is the member's own statement — no stale-
                    # record race to absorb, remove immediately
                    logger.info(
                        "gossip: removing server %s from raft", member.name
                    )
                    self.raft.remove_voter(member.name)
                else:
                    self._remove_dead_server_after_grace(member.name)
        except NotLeaderError:
            pass
        except Exception:
            logger.exception("gossip membership change failed")

    # ------------------------------------------------------------------
    # Autopilot + operator membership surface (ref nomad/autopilot.go,
    # nomad/operator_endpoint.go, command/agent/agent_endpoint.go)
    # ------------------------------------------------------------------
    DEFAULT_AUTOPILOT = {
        "cleanup_dead_servers": True,
        "last_contact_threshold_s": 0.2,
        "max_trailing_logs": 250,
        "server_stabilization_time_s": 10.0,
        #: seconds a dead/reaped member must STAY dead before its voter
        #: record is removed (ref autopilot.go pruneDeadServers running
        #: on an interval, never instantly on the serf event). The grace
        #: absorbs stale death records: after a WAN partition heals, the
        #: far side's DEAD record for a live local server can arrive
        #: moments before that server's refutation — instant removal
        #: then splits the voter map and starts an election war.
        "dead_server_grace_s": 3.0,
    }

    def autopilot_config(self) -> dict:
        cfg = dict(self.DEFAULT_AUTOPILOT)
        cfg.update(self.state.autopilot_config() or {})
        return cfg

    def set_autopilot_config(self, config: dict):
        """Validate and persist the autopilot overrides. Only known keys
        with the right types are stored (a stray string duration would
        otherwise 500 every future health check), and defaults are NOT
        folded in — future default changes must still apply."""
        cleaned = {}
        for key, value in (config or {}).items():
            if key not in self.DEFAULT_AUTOPILOT:
                raise ValueError(f"unknown autopilot setting: {key}")
            default = self.DEFAULT_AUTOPILOT[key]
            if isinstance(default, bool):
                if not isinstance(value, bool):
                    raise ValueError(f"autopilot setting {key} must be a bool")
            elif isinstance(default, (int, float)):
                if isinstance(value, bool) or not isinstance(
                    value, (int, float)
                ):
                    raise ValueError(
                        f"autopilot setting {key} must be a number"
                    )
                value = float(value)
            cleaned[key] = value
        self._apply(fsm_mod.AUTOPILOT_CONFIG, {"config": cleaned})

    def members(self) -> list[dict]:
        """Gossip membership view (ref agent_endpoint.go AgentMembersRequest).
        Without gossip (dev/static clusters) synthesizes records from the
        raft voter map."""
        if self.gossip is not None:
            with self.gossip._lock:
                rows = [
                    {
                        "Name": m.name,
                        "Addr": m.host,
                        "Port": m.port,
                        "Status": m.status,
                        "Tags": dict(m.tags),
                    }
                    for m in self.gossip.members.values()
                ]
            return sorted(rows, key=lambda r: r["Name"])
        return [
            {
                "Name": node_id,
                "Addr": addr,
                "Port": 0,
                "Status": "alive",
                "Tags": {"raft": addr, "role": "server", "region": self.region},
            }
            for node_id, addr in sorted(self.raft.voters_snapshot().items())
        ]

    def gossip_join(self, addresses: list) -> int:
        """Join one or more gossip seeds; returns how many succeeded
        (ref agent.go Join)."""
        if self.gossip is None:
            raise RuntimeError("gossip is not enabled on this server")
        joined = 0
        for addr in addresses:
            host, _, port = str(addr).rpartition(":")
            if self.gossip.join((host or "127.0.0.1", int(port)), timeout=3.0):
                joined += 1
        return joined

    def gossip_force_leave(self, name: str) -> bool:
        """Force a failed member out of gossip (and, via the leave event,
        out of raft); ref agent.go ForceLeave → serf RemoveFailedNode."""
        if self.gossip is None:
            raise RuntimeError("gossip is not enabled on this server")
        return self.gossip.force_leave(name)

    def raft_configuration(self) -> dict:
        """ref operator_endpoint.go RaftGetConfiguration"""
        leader_id = getattr(self.raft, "leader_id", None)
        servers = []
        for node_id, addr in sorted(self.raft.voters_snapshot().items()):
            servers.append(
                {
                    "ID": node_id,
                    "Node": node_id,
                    "Address": addr,
                    "Leader": self.raft.is_leader()
                    and node_id == self.raft.node_id
                    or node_id == leader_id,
                    "Voter": True,
                }
            )
        return {"Servers": servers, "Index": self.state.latest_index()}

    def raft_remove_peer(self, node_id: str):
        """ref operator_endpoint.go RaftRemovePeerByID"""
        self._check_leader()
        if node_id not in self.raft.voters_snapshot():
            raise KeyError(f"no raft peer with id {node_id}")
        self.raft.remove_voter(node_id)

    def autopilot_health(self) -> dict:
        """Per-server health from leader replication progress + gossip
        status (ref autopilot ServerHealth/OperatorServerHealth)."""
        cfg = self.autopilot_config()
        progress = self.raft.peer_progress() if self.raft.is_leader() else {}
        gossip_status = {}
        if self.gossip is not None:
            with self.gossip._lock:
                gossip_status = {
                    m.name: m.status for m in self.gossip.members.values()
                }
        leader_last, _ = (
            self.raft._last_log() if self.raft.is_leader() else (0, 0)
        )
        servers = []
        healthy_all = True
        for node_id, addr in sorted(self.raft.voters_snapshot().items()):
            prog = progress.get(node_id, {})
            contact = prog.get("last_contact_s")
            trailing = (
                leader_last - prog.get("match_index", 0)
                if prog
                else None
            )
            alive = gossip_status.get(node_id, "alive") == "alive"
            healthy = alive and (
                node_id == self.raft.node_id
                or not self.raft.is_leader()
                or (
                    contact is not None
                    and contact <= cfg["last_contact_threshold_s"]
                    and trailing is not None
                    and trailing <= cfg["max_trailing_logs"]
                )
            )
            healthy_all = healthy_all and healthy
            servers.append(
                {
                    "ID": node_id,
                    "Name": node_id,
                    "Address": addr,
                    "SerfStatus": gossip_status.get(node_id, "alive"),
                    "LastContact": contact,
                    "TrailingLogs": trailing,
                    "Leader": prog.get("leader", False),
                    "Healthy": healthy,
                    "Voter": True,
                }
            )
        failure_tolerance = max(0, (len(servers) - 1) // 2) if servers else 0
        return {
            "Healthy": healthy_all,
            "FailureTolerance": failure_tolerance,
            "Servers": servers,
        }

    # ------------------------------------------------------------------
    # Regions (ref nomad/regions_endpoint.go + rpc.go region forwarding)
    # ------------------------------------------------------------------
    def regions(self) -> list[str]:
        """All regions known through gossip, self included."""
        out = {self.region}
        if self.gossip is not None:
            for member in self.gossip.alive_members():
                region = member.tags.get("region")
                if region:
                    out.add(region)
        return sorted(out)

    def region_http_servers(self, region: str) -> list[str]:
        """HTTP addresses of alive servers in ``region`` (from gossip
        tags) — the region-forwarding table."""
        if self.gossip is None:
            return []
        out = []
        for member in self.gossip.alive_members():
            if member.tags.get("region") == region and member.tags.get("http"):
                out.append(member.tags["http"])
        return out

    def advertise_http(self, address: str):
        """Publish this server's HTTP address: always recorded locally (the
        Status.HTTPAddr RPC serves it to peers, so leader forwarding works
        in voters-only topologies) and additionally into gossip tags so
        other regions can forward to it."""
        self.http_advertise_addr = address
        if self.gossip is None:
            return
        self.gossip.set_tags({"http": address})

    def _conn_pool(self):
        """The server's outbound RPC pool (client-fs forwarding, exec
        bridging, peer Status lookups), created on first use so the mTLS
        client context attached during agent wiring is picked up."""
        pool = getattr(self, "_outbound_pool", None)
        if pool is None:
            from ..rpc import ConnPool

            pool = self._outbound_pool = ConnPool(
                tls_context=getattr(self, "tls_client_context", None)
            )
        return pool

    def resolve_server_http_addr(
        self, server_id: Optional[str], rpc_addr: Optional[str]
    ) -> Optional[str]:
        """HTTP address of the peer server ``server_id``/``rpc_addr``, for
        follower→leader request forwarding (ref nomad/rpc.go:280-340
        forward(): the reference forwards over its server RPC connections
        and never needs an HTTP address map — here the HTTP proxy layer
        asks the peer for its HTTP address over that same RPC tier).

        Resolution order: gossip tags and the static ``server_http_addrs``
        config (both free, possibly absent), then a Status.HTTPAddr RPC to
        the peer's raft/RPC address — which every server always knows from
        its voter map, so this works with no gossip configured. RPC
        answers are cached per rpc_addr. A failed proxy reports back via
        ``forget_server_http_addr``, which quarantines the bad address for
        a few seconds so a stale gossip tag / static entry / cached answer
        can't shadow the live sources forever (a peer restarted onto a new
        HTTP port)."""

        def ok(addr):
            if not addr:
                return False
            with self._http_addr_lock:
                bad_at = self._bad_http_addrs.get(addr)
                if (
                    bad_at is not None
                    and time.monotonic() - bad_at > HTTP_ADDR_QUARANTINE
                ):
                    # quarantine served its term; stop tracking the addr
                    del self._bad_http_addrs[addr]
                    bad_at = None
            return bad_at is None

        if server_id:
            if self.gossip is not None:
                with self.gossip._lock:
                    member = self.gossip.members.get(server_id)
                if member is not None and ok(member.tags.get("http")):
                    return member.tags["http"]
            static = (self.config.get("server_http_addrs") or {}).get(
                server_id
            )
            if ok(static):
                return static
        if not rpc_addr:
            return None
        with self._http_addr_lock:
            cached = self._peer_http_addrs.get(rpc_addr)
        if ok(cached):
            return cached
        try:
            resp = self._conn_pool().call(
                rpc_addr, "Status.HTTPAddr", {}, timeout=5.0
            )
        except Exception:
            return None
        addr = (resp or {}).get("http_addr")
        if addr:
            with self._http_addr_lock:
                self._peer_http_addrs[rpc_addr] = addr
                self._bad_http_addrs.pop(addr, None)
        return addr

    def forget_server_http_addr(
        self, rpc_addr: Optional[str], http_addr: Optional[str] = None
    ):
        """Record a failed proxy target: drops the RPC-learned cache entry
        and quarantines ``http_addr`` so gossip/static sources holding the
        same stale value are skipped on the next resolution."""
        now = time.monotonic()
        with self._http_addr_lock:
            self._peer_http_addrs.pop(rpc_addr, None)
            if http_addr:
                self._bad_http_addrs[http_addr] = now
            # sweep quarantine entries past their term: failed addrs must
            # not accumulate forever (ADVICE r5 low)
            expired = [
                a
                for a, t0 in self._bad_http_addrs.items()
                if now - t0 > HTTP_ADDR_QUARANTINE
            ]
            for a in expired:
                del self._bad_http_addrs[a]

    def _reconcile_gossip_members(self):
        """On leadership: fold the current gossip view into raft membership
        both ways — joins a previous leader never applied AND removals it
        never committed (a follower drops dead/reap events at the leader
        guard, and swim reaps the record entirely, so without this sweep a
        dead server would stay a quorum-counted voter forever)."""
        if self.gossip is None:
            return
        alive = {m.name: m for m in self.gossip.alive_members()}
        for member in alive.values():
            if member.name == self.raft.node_id:
                continue
            self._gossip_event("join", member)
        for voter in self.raft.voters_snapshot():
            if voter == self.raft.node_id or voter in alive:
                continue
            with_status = self.gossip.members.get(voter)
            if with_status is not None and with_status.status == "suspect":
                continue  # possibly flapping; the dead event will decide
            # same grace as the dead event: a leadership change right
            # after a partition heal sees the far side's stale DEAD
            # records before the refutations arrive — removing on that
            # snapshot splits the voter map
            self._remove_dead_server_after_grace(voter)

    def _remove_dead_server_after_grace(self, name: str):
        """Schedule a voter removal that only fires if ``name`` is STILL
        not alive after ``autopilot.dead_server_grace_s`` (one pending
        recheck per member). Ref autopilot.go pruneDeadServers: cleanup
        is periodic, never instant on a serf event, exactly so a stale
        death record can be refuted before it costs a voter."""
        grace = float(
            self.autopilot_config().get("dead_server_grace_s", 3.0)
        )
        with self._dead_server_lock:
            if name in self._dead_server_pending:
                return
            self._dead_server_pending.add(name)

        def recheck():
            with self._dead_server_lock:
                self._dead_server_pending.discard(name)
            if not self._running or not self._leader:
                return
            member = (
                self.gossip.members.get(name)
                if self.gossip is not None
                else None
            )
            if member is not None and member.status == "alive":
                return  # refuted within the grace — a live server keeps its seat
            if name not in self.raft.voters:
                return
            try:
                logger.info(
                    "gossip: removing dead server %s from raft", name
                )
                self.raft.remove_voter(name)
            except NotLeaderError:
                pass
            except Exception:
                logger.exception("dead-server removal failed")

        def recheck_async():
            # remove_voter blocks on the CONFIG commit (up to its 5s
            # timeout when quorum is strained) — never on the shared
            # timer wheel's thread, where it would stall every broker
            # nack/heartbeat timer behind it
            threading.Thread(
                target=recheck, daemon=True, name=f"dead-server-rm-{name}"
            ).start()

        if grace <= 0:
            recheck_async()
        else:
            shared_timer_wheel().arm(grace, recheck_async, ())

    def _apply(self, msg_type: str, payload: dict):
        """Propose a write through consensus (ref nomad/rpc.go raftApply).
        Raises NotLeaderError with a leader hint; the RPC layer forwards."""
        return self.raft.apply(msg_type, payload)

    def _check_leader(self):
        """Forward-first semantics: leader-only endpoints reject on
        followers BEFORE reading local (possibly stale) state, so the RPC
        layer retries at the leader (ref nomad/rpc.go forward(), called at
        the top of every endpoint)."""
        if not self.raft.is_leader():
            raise NotLeaderError(
                self.raft.leader_address(), self.raft.leader_id
            )

    def attach_periodic(self, dispatcher):
        """Attach the leader's periodic dispatcher; the FSM tracks periodic
        jobs as registrations apply (ref fsm.go periodicDispatcher field)."""
        self.periodic = dispatcher
        self.fsm.periodic_dispatcher = dispatcher
        if self._leader:
            dispatcher.set_enabled(True)
            dispatcher.restore(self.state)

    def _commit_plan(self, plan, result, preemption_evals):
        """Replicate one verified plan result via consensus."""
        return self._apply(
            fsm_mod.APPLY_PLAN_RESULTS,
            self._plan_payload(plan, result, preemption_evals),
        )

    def _plan_commit_barrier(self, exc):
        """Resolve an INDETERMINATE plan commit (raft apply timeout): a
        barrier committed behind the timed-out entry applying in the same
        leadership proves — by log matching — that the entry applied too.
        Same leadership must be PROVEN, not assumed: if the term moved at
        any point since the entry was proposed (terms are monotonic, so a
        changed current term is conclusive), an intervening leader may
        have truncated the entry — the resolution fails and the applier
        falls back to flooring its snapshots past the entry. Generous
        timeout: under storm backlog the barrier waits out the same apply
        queue that made the commit slow in the first place."""
        self.raft.barrier(timeout=120.0)
        term = getattr(exc, "raft_term", 0)
        if term and self.raft.current_term != term:
            raise RuntimeError(
                f"plan commit entry {exc.raft_index} unresolvable: term "
                f"moved {term} -> {self.raft.current_term} during the wait"
            )

    def _commit_plan_batch(self, items):
        """Replicate several independently-verified plan results in ONE
        raft entry (one fsync + round-trip for the whole batch; the FSM
        applies them sequentially). ``items`` =
        [(plan, result, preemption_evals), ...] in verify order."""
        if len(items) == 1:
            return self._commit_plan(*items[0])
        return self._apply(
            fsm_mod.APPLY_PLAN_RESULTS_BATCH,
            {"plans": [self._plan_payload(*item) for item in items]},
        )

    def _plan_payload(self, plan, result, preemption_evals) -> dict:
        """The raft payload for a verified plan result — NORMALIZED (the
        reference's plan normalization for raft-log size, structs.go
        Plan.NormalizeAllocations):
        the plan ships without its alloc maps (the result carries the
        verified subset), and stopped/preempted allocs ship as id+field
        diffs the FSM rehydrates from each replica's own state, since the
        full documents are already replicated there. Only fresh placements
        travel whole."""
        import dataclasses

        slim_plan = dataclasses.replace(
            plan, node_update={}, node_allocation={}, node_preemptions={},
            annotations=None,
        )

        def diffs(alloc_map):
            return {
                node_id: [
                    {
                        "id": a.id,
                        "desired_status": a.desired_status,
                        "desired_description": a.desired_description,
                        "client_status": a.client_status,
                        "preempted_by_allocation": a.preempted_by_allocation,
                    }
                    for a in allocs
                ]
                for node_id, allocs in alloc_map.items()
            }

        # placements travel whole, but the (shared) Job document ships
        # exactly once per distinct job version, not once per alloc —
        # serializing 10K copies of the same job dominated commit time
        jobs_doc: dict[str, dict] = {}

        def placement_doc(a):
            job = a.job
            if job is None:
                return a.to_dict()
            jkey = f"{job.namespace}\x00{job.id}\x00{job.version}\x00{job.modify_index}"
            if jkey not in jobs_doc:
                jobs_doc[jkey] = job.to_dict()
            c = fast_alloc_clone(a)
            c.job = None
            d = c.to_dict()
            d["job_ref"] = jkey
            return d

        result_doc = {
            "node_update": diffs(result.node_update),
            "node_preemptions": diffs(result.node_preemptions),
            "node_allocation": {
                node_id: [placement_doc(a) for a in allocs]
                for node_id, allocs in result.node_allocation.items()
            },
            "jobs": jobs_doc,
            "deployment": (
                result.deployment.to_dict() if result.deployment else None
            ),
            "deployment_updates": [
                u.to_dict() for u in result.deployment_updates
            ],
            "refresh_index": result.refresh_index,
        }
        from ..trace import tracer as _tracer

        return {
            "plan": slim_plan.to_dict(),
            "result": result_doc,
            "normalized": True,
            "preemption_evals": [e.to_dict() for e in preemption_evals],
            # raft-entry trace annotation: the FSM pops it to span its
            # apply (leader AND followers) and to link the committed
            # index to the eval's trace for the mirror's patch spans.
            # It never enters state-store objects, so traced and
            # untraced runs commit byte-identical STATE
            "trace": _tracer.annotation_for_eval(plan.eval_id),
        }

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self, num_workers: int = 2, wait_for_leader: Optional[float] = None):
        self._running = True
        if self._flight_enabled:
            self.flight_recorder.start()
        if self.config.get("shard_devices"):
            # mesh-shard the planner node axis (the JAX package's
            # tpu/shard.py): not in the port yet
            raise _not_ported("the shard_devices stanza", "A12, the mesh")
        if self.config.get("wavefront"):
            # wavefront placement plane (tpu/wavefront.py): route the
            # exact-scan dispatch through conflict-free batched commits.
            # Applied before prewarm so the warmed ladder includes the
            # wavefront programs when the stanza enables them.
            from ..tpu import wavefront as _wavefront

            wf = dict(self.config["wavefront"])
            _wavefront.configure(
                enabled=wf.get("enabled", True),
                max_round=wf.get("max_round"),
                contention_top_m=wf.get("contention_top_m"),
            )
        if self.config.get("paging"):
            # paged node axis (tpu/paging.py): stream over-budget node
            # planes through device memory in tiles. Applied before
            # prewarm so the warmed ladder includes the tile shapes,
            # and before first commit so the committed planes stamp
            # dirtiness at the configured tile granularity.
            from ..tpu import paging as _paging

            pg = dict(self.config["paging"])
            _paging.configure(
                enabled=pg.get("enabled", True),
                device_node_budget_mb=pg.get("device_node_budget_mb"),
                tile_nodes=pg.get("tile_nodes"),
            )
        if self.config.get("prewarm_kernels"):
            # launch the planner shape ladder in the background so the
            # first real eval doesn't pay the kernels' first-launch cost
            # (tpu/warmup.py). With batch_drain + an expected cluster
            # size, the fused drain-batch shapes warm up too. The thread
            # launches on the default stream, like every server thread.
            from ..tpu.warmup import prewarm_async

            drain_shape = None
            drain_cfg = int(self.config.get("batch_drain", 0))
            nodes_hint = int(self.config.get("prewarm_drain_nodes", 0))
            if drain_cfg > 1 and nodes_hint > 0:
                drain_shape = (nodes_hint, drain_cfg)
            self._prewarm_thread = prewarm_async(drain=drain_shape, device=self.device)
        self.raft.start()
        if self.gossip is not None:
            self.gossip.start()
            seeds = self.config.get("gossip", {}).get("join", [])
            if seeds:
                # retry-join in the background until a seed answers
                # (ref agent retry_join): a seed binding late must not
                # strand a non-bootstrap server (it has no voters and
                # never self-elects, so a silent give-up is a hang)
                def _join():
                    delay = 0.5
                    while self._running:
                        for seed in seeds:
                            if self.gossip.join(tuple(seed)):
                                return
                        logger.warning(
                            "gossip: no seed answered (%s); retrying in %.1fs",
                            seeds, delay,
                        )
                        time.sleep(delay)
                        delay = min(delay * 2, 10.0)

                threading.Thread(
                    target=_join, daemon=True, name="gossip-retry-join"
                ).start()
        self.start_workers(num_workers)
        if wait_for_leader is None:
            # single-voter servers are their own leader; block briefly so
            # callers can write immediately (dev-mode ergonomics)
            wait_for_leader = 5.0 if len(self.raft.voters) == 1 else 0.0
        if wait_for_leader:
            self.wait_for_leader(wait_for_leader)

    def start_workers(self, num_workers: int):
        """Spawn scheduler workers (split from start() so a harness can
        bring the server up with zero workers, load the broker, and only
        then open the drain — the deterministic way to exercise fused
        multi-eval batches: with workers racing registration, whether two
        evals are ever simultaneously ready is a scheduling accident)."""
        drain_n = int(self.config.get("batch_drain", 0))
        for i in range(num_workers):
            if drain_n > 1:
                # north-star bridge: drain N evals per cycle into one fused
                # kernel batch (worker.go:105 + SURVEY §2.3 broker drain)
                from .worker import BatchDrainWorker

                w = BatchDrainWorker(
                    self, seed=self.config.get("seed"), batch_size=drain_n
                )
            else:
                w = Worker(self, seed=self.config.get("seed"))
            self.workers.append(w)
            w.start()

    # ------------------------------------------------------------------
    # overload plane (core/overload.py)
    # ------------------------------------------------------------------
    def _overload_load(self) -> float:
        """Cheap cached load signal in [0, ~∞): max of broker backlog
        against its depth limit and the plan queue-wait p99 against its
        budget. Deliberately two in-process taps — the admission check
        sits on every mutating request and must never itself become the
        bottleneck (AdmissionController caches the value for 0.5s)."""
        cfg = self.config.get("overload") or {}
        depth_limit = float(cfg.get("depth_limit", 4096))
        qw_budget_s = float(cfg.get("queue_wait_budget_ms", 500.0)) / 1e3
        st = self.eval_broker.stats()
        depth = st["total_ready"] + st["total_unacked"]
        load = depth / max(1.0, depth_limit)
        p99 = metrics.percentile("plan.queue_wait", 0.99)
        if p99:
            load = max(load, float(p99) / max(1e-9, qw_budget_s))
        return load

    def _brownout_actions(self) -> list:
        """The brownout ladder, in degradation order:
        wavefront→exact-scan dispatch, trace sampling→0, devprof
        off, snapshot-on-subscribe off. Every degrade captures the prior
        value so restore puts the PROCESS-WIDE knob back exactly — a
        brownout that outlives the storm would leak into the next test's
        baseline."""
        from ..debug import devprof as _devprof
        from ..tpu import wavefront as _wavefront
        from ..trace import tracer as _tracer

        prior: dict = {}

        def wf_degrade():
            prior["wavefront"] = _wavefront.enabled()
            _wavefront.configure(enabled=False)

        def wf_restore():
            _wavefront.configure(enabled=prior.pop("wavefront", True))

        def trace_degrade():
            prior["sample_rate"] = _tracer.sample_rate
            _tracer.sample_rate = 0.0

        def trace_restore():
            _tracer.sample_rate = prior.pop("sample_rate", 1.0)

        def devprof_degrade():
            prior["devprof"] = _devprof.enable(False)

        def devprof_restore():
            _devprof.enable(prior.pop("devprof", True))

        def snap_degrade():
            eb = self.event_broker
            if eb is not None:
                prior["snapshot_on_subscribe"] = eb.snapshot_on_subscribe
                eb.snapshot_on_subscribe = False

        def snap_restore():
            eb = self.event_broker
            if eb is not None:
                eb.snapshot_on_subscribe = prior.pop(
                    "snapshot_on_subscribe", True
                )

        def shed_batch_degrade():
            self._shed_stream_class(overload_mod.CLASS_BATCH, True)

        def shed_batch_restore():
            self._shed_stream_class(overload_mod.CLASS_BATCH, False)

        def shed_service_degrade():
            self._shed_stream_class(overload_mod.CLASS_SERVICE, True)

        def shed_service_restore():
            self._shed_stream_class(overload_mod.CLASS_SERVICE, False)

        return [
            ("wavefront", wf_degrade, wf_restore),
            ("trace_sampling", trace_degrade, trace_restore),
            ("devprof_census", devprof_degrade, devprof_restore),
            ("snapshot_on_subscribe", snap_degrade, snap_restore),
            # stream shedding rungs, most-sheddable class first; there is
            # deliberately NO rung for system streams — deployment
            # watchers and operator consoles ride out any brownout
            ("stream_shed_batch", shed_batch_degrade, shed_batch_restore),
            (
                "stream_shed_service",
                shed_service_degrade,
                shed_service_restore,
            ),
        ]

    def add_stream_shed_hook(self, fn) -> None:
        """Register ``fn(admission_class, shed)`` to receive stream-shed
        transitions from the brownout ladder. A mux created while a
        stream rung is already degraded gets the current state replayed
        at registration, so mid-brownout adoptions shed too."""
        self._stream_shed_hooks.append(fn)
        for cls in sorted(self._stream_shed_on):
            try:
                fn(cls, True)
            except Exception:
                logger.exception("stream shed hook failed (%s)", cls)

    def _shed_stream_class(self, admission_class: str, shed: bool) -> None:
        if shed:
            self._stream_shed_on.add(admission_class)
        else:
            self._stream_shed_on.discard(admission_class)
        for fn in list(self._stream_shed_hooks):
            try:
                fn(admission_class, shed)
            except Exception:
                logger.exception(
                    "stream shed hook failed (%s)", admission_class
                )

    def eval_deadline_exceeded(self, ev: Evaluation, where: str):
        """Terminal deadline_exceeded outcome for ``ev``: one raft-applied
        failed-eval update carrying the refusing stage, plus the overload
        ledger. Called by the broker's refuse-at-dequeue callback and the
        worker's refuse-to-evaluate path (core/worker.py) — the refusing
        stage increments its own ``overload.deadline_exceeded.<stage>``
        metric at the refusal point, so this never double-counts."""
        if self.overload is not None:
            self.overload.note_deadline_exceeded(where)
        updated = ev.copy()
        updated.status = "failed"
        updated.status_description = f"deadline_exceeded ({where})"
        updated.modify_time = now_ns()
        try:
            self._apply(fsm_mod.EVAL_UPDATE, {"evals": [updated.to_dict()]})
        except NotLeaderError:
            # leadership moved mid-refusal: the new leader's broker will
            # refuse the same expired eval and apply the update itself
            pass

    def stop(self, hard: bool = False):
        """``hard=True`` is a simulated crash (the chaos harness's
        leader kill): no gossip leave broadcast, so peers discover the
        death through the SWIM failure detector exactly as they would a
        kill -9 — intentional departures stay distinguishable from
        failures (serf leave vs. failed)."""
        self._running = False
        self.flight_recorder.stop()
        if self.overload is not None:
            # restore every browned-out PROCESS-WIDE knob (wavefront,
            # trace sampling, devprof, snapshot-on-subscribe) so a storm
            # that ended mid-brownout can't leak into the next run
            self.overload.stop()
        if self.watchdog is not None:
            # a bundle capture racing teardown reads dying subsystems;
            # bounded wait, capture errors are already swallowed
            self.watchdog.wait_idle(timeout=5.0)
        self._hb_expire_q.put(None)  # unpark the expiry drainer, if any
        if self.gossip is not None:
            if not hard:
                try:
                    self.gossip.leave()
                except Exception:
                    pass
            self.gossip.stop()
        for w in self.workers:
            w.stop()
        self.workers = []
        prewarm = getattr(self, "_prewarm_thread", None)
        if prewarm is not None:
            # the warm-up ends within its ladder; a process that exits
            # while it is inside a torch call aborts instead of exiting
            prewarm.join(timeout=PREWARM_STOP_S)
        self._revoke_leadership()
        self.raft.shutdown()
        if self.columnar_mirror is not None:
            self.columnar_mirror.close()
        if self.event_broker is not None:
            self.event_broker.shutdown()
        pool = getattr(self, "_outbound_pool", None)
        if pool is not None:
            pool.close()

    def is_leader(self) -> bool:
        return self.raft.is_leader()

    def leader_address(self) -> Optional[str]:
        return self.raft.leader_address()

    def wait_for_leader(self, timeout: float = 5.0) -> bool:
        """Wait until this server becomes the leader."""
        with self._leader_cond:
            return self._leader_cond.wait_for(lambda: self._leader, timeout)

    def _leadership_changed(self, leader: bool):
        if leader:
            self._establish_leadership()
        else:
            self._revoke_leadership()

    def _leadership_barrier(self) -> bool:
        """True once the FSM provably covers every entry committed by
        prior leaders. Rides the term-start noop raft already appended
        at election — commit of a current-term entry proves (by Log
        Matching) every prior committed entry is in this log, and its
        APPLY means the FSM replayed them all — so the barrier proposes
        nothing and adds no load; it just waits out the apply loop.
        Aborts only when leadership moves (the follower transition
        callback cleans up); it never gives up while still leader, which
        would leave a raft leader whose server never enables its
        planner — every write then fails not_leader forever."""
        target = self.raft.term_start_index
        while self._running and self.raft.is_leader():
            if self.raft.last_applied >= target:
                return True
            time.sleep(0.002)
        return False

    def _establish_leadership(self):
        """ref leader.go:180 establishLeadership"""
        if not self._running:
            return
        # barrier FIRST (ref leader.go: s.raft.Barrier()): commit + apply
        # a current-term noop so the FSM covers every entry committed by
        # prior leaders before ANY leader subsystem reads state. Without
        # it, _restore_evals re-enqueues evals whose ack is still in the
        # un-applied log suffix and the planner verifies plans against
        # snapshots missing the old leader's committed placements — the
        # "alloc placed twice after failover" class the federated storm
        # surfaced. Runs on the raft-lead-* callback thread, so blocking
        # here stalls no raft progress.
        if not self._leadership_barrier():
            return
        self.eval_broker.set_enabled(True)
        self.blocked_evals.set_enabled(True)
        self.planner.start()
        self._restore_evals()
        self._initialize_heartbeat_timers()
        if self.periodic is not None:
            self.periodic.set_enabled(True)
            self.periodic.restore(self.state)
        if self.deployment_watcher is not None:
            self.deployment_watcher.set_enabled(True)
        if self.drainer is not None:
            self.drainer.set_enabled(True)
        # the flag must be up before the leader loops launch — they check it
        # as their run condition and would otherwise race a one-iteration exit
        with self._leader_cond:
            self._leader = True
            self._leader_cond.notify_all()
        self._reaper = threading.Thread(
            target=self._reap_failed_evals, daemon=True,
            name="eval-failed-reaper",
        )
        self._reaper.start()
        threading.Thread(
            target=self._reap_dup_blocked_evals, daemon=True,
            name="blocked-dup-reaper",
        ).start()
        self._gc_scheduler = threading.Thread(
            target=self._schedule_core_gc, daemon=True,
            name="core-gc-scheduler",
        )
        self._gc_scheduler.start()
        if self._acl_replication_target():
            t = threading.Thread(
                target=self._acl_replication_loop, daemon=True,
                name="acl-replication",
            )
            t.start()
        self._reconcile_gossip_members()
        logger.info("server %s: leadership established", self.raft.node_id)

    def _revoke_leadership(self):
        with self._leader_cond:
            self._leader = False
        self.planner.stop()
        self.eval_broker.set_enabled(False)
        self.blocked_evals.set_enabled(False)
        if self.periodic is not None:
            self.periodic.set_enabled(False)
        if self.deployment_watcher is not None:
            self.deployment_watcher.set_enabled(False)
        if self.drainer is not None:
            self.drainer.set_enabled(False)
        with self._lock:
            for t in self._heartbeat_timers.values():
                t.cancel()
            self._heartbeat_timers.clear()

    def _restore_evals(self):
        """Re-populate the broker from replicated state on leadership
        (ref leader.go:295 restoreEvals)."""
        for ev in list(self.state.evals()):
            if ev.should_enqueue():
                self.eval_broker.enqueue(ev)
            elif ev.should_block():
                self.blocked_evals.block(ev)

    def _initialize_heartbeat_timers(self):
        """ref heartbeat.go:21 initializeHeartbeatTimers"""
        for node in list(self.state.nodes()):
            if node.status != NODE_STATUS_DOWN:
                self._reset_heartbeat(node.id)

    def _reap_failed_evals(self):
        """Drain the _failed queue: mark evals failed and schedule a delayed
        follow-up retry (ref leader.go:505 reapFailedEvaluations)."""
        from .broker import FAILED_QUEUE

        follow_up_wait = self.config.get("failed_eval_followup_wait", 60.0)
        unblock_interval = self.config.get("failed_eval_unblock_interval", 60.0)
        last_unblock = time.monotonic()
        while self._running and self._leader:
            if time.monotonic() - last_unblock >= unblock_interval:
                last_unblock = time.monotonic()
                self.blocked_evals.unblock_failed()
            ev, token = self.eval_broker.dequeue([FAILED_QUEUE], timeout=0.5)
            if ev is None:
                continue
            try:
                failed = ev.copy()
                failed.status = "failed"
                failed.status_description = "evaluation reached delivery limit"
                follow_up = failed.create_failed_follow_up_eval(
                    int(follow_up_wait * 1e9)
                )
                self._apply(
                    fsm_mod.EVAL_UPDATE,
                    {"evals": [failed.to_dict(), follow_up.to_dict()]},
                )
                self.eval_broker.ack(ev.id, token)
            except NotLeaderError:
                return
            except Exception:
                logger.exception("failed-eval reaping error for %s", ev.id)

    def _reap_dup_blocked_evals(self):
        """Cancel blocked evals superseded by a newer one for the same job
        (ref leader.go:524 reapDupBlockedEvaluations): BlockedEvals dedup
        keeps one eval per job; the losers must not sit 'blocked' in raft
        state forever."""
        while self._running and self._leader:
            dups = self.blocked_evals.get_duplicates(timeout=0.5)
            if not dups:
                continue
            try:
                cancelled = []
                for ev in dups:
                    c = ev.copy()
                    c.status = EVAL_STATUS_CANCELLED
                    c.status_description = (
                        "existing blocked evaluation exists for this job"
                    )
                    cancelled.append(c.to_dict())
                self._apply(fsm_mod.EVAL_UPDATE, {"evals": cancelled})
            except NotLeaderError:
                return
            except Exception:
                logger.exception("duplicate blocked eval reaping error")

    def _schedule_core_gc(self):
        """Leader cron enqueuing GC core-job evals on their intervals
        (ref leader.go:440-486 schedulePeriodic). Core evals live only in
        the leader's broker — they are never raft-persisted."""
        from .core_sched import (
            CORE_JOB_DEPLOYMENT_GC,
            CORE_JOB_EVAL_GC,
            CORE_JOB_JOB_GC,
            CORE_JOB_NODE_GC,
            core_job_eval,
        )

        this_thread = threading.current_thread()
        intervals = {
            CORE_JOB_EVAL_GC: float(self.config.get("eval_gc_interval", 300.0)),
            CORE_JOB_NODE_GC: float(self.config.get("node_gc_interval", 300.0)),
            CORE_JOB_JOB_GC: float(self.config.get("job_gc_interval", 300.0)),
            CORE_JOB_DEPLOYMENT_GC: float(
                self.config.get("deployment_gc_interval", 300.0)
            ),
        }
        next_fire = {job: time.monotonic() + iv for job, iv in intervals.items()}
        while (
            self._running and self._leader and self._gc_scheduler is this_thread
        ):
            # keep witnessing the head index as wall time passes; apply-time
            # witnesses alone never age the newest writes on an idle cluster
            self.time_table.witness(self.state.latest_index())
            now = time.monotonic()
            for job, fire_at in next_fire.items():
                if now >= fire_at:
                    next_fire[job] = now + intervals[job]
                    self.eval_broker.enqueue(
                        core_job_eval(job, self.state.latest_index())
                    )
            time.sleep(min(1.0, min(iv for iv in intervals.values())))

    # ------------------------------------------------------------------
    # ACL endpoints (ref nomad/acl_endpoint.go + nomad/acl.go)
    # ------------------------------------------------------------------
    def acl_enabled(self) -> bool:
        return bool(self.config.get("acl", {}).get("enabled"))

    def resolve_token(self, secret: str):
        """secret → compiled ACL (ref acl.go ResolveToken, with the
        reference's resolution cache). With ACLs off, everything is allowed;
        an empty secret is the anonymous ACL; an unknown secret is rejected.
        Resolutions cache on (secret, token-table index, policy-table
        index) so the hot path skips the token scan + policy parse until an
        ACL write invalidates it."""
        raise _not_ported("ACL token resolution", "gossip, federation and ACL")

    # ------------------------------------------------------------------
    # ACL replication (ref leader.go:277 replicateACLPolicies/Tokens:
    # non-authoritative region leaders mirror policies and global tokens
    # from the authoritative region over its HTTP surface)
    # ------------------------------------------------------------------
    def _acl_replication_target(self) -> Optional[str]:
        acl_cfg = self.config.get("acl", {})
        auth = acl_cfg.get("authoritative_region")
        if not acl_cfg.get("enabled") or not auth or auth == self.region:
            return None
        return auth

    def _acl_replication_loop(self):
        interval = float(
            self.config.get("acl", {}).get("replication_interval", 1.0)
        )
        # WHY: one replication round per interval per follower region —
        # fixed cadence, not per-request; budget-severing would stall
        # ACL convergence (staleness already surfaced as replication lag)
        while self._leader and self._running:  # nta: ignore[retry-without-budget]
            try:
                self.replicate_acl_once()
            except Exception as e:
                st = self.acl_replication_status
                st["failures"] = st.get("failures", 0) + 1
                st["last_error"] = f"{type(e).__name__}: {e}"
                logger.exception("acl replication round failed")
            time.sleep(interval)

    def acl_replication_lag_s(self) -> Optional[float]:
        """Seconds since the last successful replication round (None
        when this server doesn't replicate — authoritative regions and
        ACL-less clusters). A server that has NEVER succeeded reports
        lag since its first attempt, so a region that came up
        partitioned is visibly behind from the start."""
        st = self.acl_replication_status
        if not st.get("configured"):
            return None
        anchor = st.get("last_success_wall") or st.get("started_wall")
        if anchor is None:
            return None
        return max(0.0, time.time() - anchor)

    def replicate_acl_once(self) -> dict:
        """One replication round; returns {policies_upserted, policies_
        deleted, tokens_upserted, tokens_deleted} (exposed for tests and
        operator debugging)."""
        stats = {
            "policies_upserted": 0,
            "policies_deleted": 0,
            "tokens_upserted": 0,
            "tokens_deleted": 0,
        }
        auth = self._acl_replication_target()
        if auth is None:
            return stats
        st = self.acl_replication_status
        st["configured"] = True
        st["authoritative_region"] = auth
        st.setdefault("started_wall", time.time())
        st.setdefault("rounds", 0)
        st.setdefault("failures", 0)
        # inter-region fault seam: a partitioned WAN stalls replication
        # here exactly like an unreachable authoritative region — the
        # stall is counted so the acl_replication_lag watchdog sees it
        if _faults.region_link(self.region, auth, "acl.replication") in (
            "drop", "sever",
        ):
            st["failures"] += 1
            st["last_error"] = (
                f"region link {self.region}->{auth} severed"
            )
            return stats
        peers = self.region_http_servers(auth)
        if not peers:
            st["failures"] += 1
            st["last_error"] = f"no path to authoritative region {auth!r}"
            return stats
        raise _not_ported("ACL replication", "gossip, federation and ACL")

    def acl_bootstrap(self):
        """One-shot creation of the initial management token
        (ref acl_endpoint.go Bootstrap). Done-ness is a persisted index
        marker, NOT the existence of a management token — deleting all
        management tokens must not silently re-open anonymous bootstrap."""
        from ..structs.model import ACL_TOKEN_TYPE_MANAGEMENT, AclToken

        self._check_leader()
        if self.state.table_index("acl_bootstrap"):
            raise PermissionError("ACL bootstrap already done")
        token = AclToken(
            accessor_id=generate_uuid(),
            secret_id=generate_uuid(),
            name="Bootstrap Token",
            type=ACL_TOKEN_TYPE_MANAGEMENT,
            global_token=True,
            create_time=now_ns(),
        )
        self._apply(
            fsm_mod.ACL_TOKEN_UPSERT,
            {"tokens": [token.to_dict()], "bootstrap": True},
        )
        return token

    def acl_upsert_policies(self, policies: list):
        raise _not_ported("ACL policies", "gossip, federation and ACL")

    def acl_delete_policies(self, names: list[str]):
        self._check_leader()
        self._apply(fsm_mod.ACL_POLICY_DELETE, {"names": list(names)})

    def acl_create_token(self, token):
        from ..structs.model import ACL_TOKEN_TYPE_CLIENT, ACL_TOKEN_TYPE_MANAGEMENT

        self._check_leader()
        if token.type not in (ACL_TOKEN_TYPE_CLIENT, ACL_TOKEN_TYPE_MANAGEMENT):
            raise ValueError(f"invalid token type {token.type!r}")
        if token.type == ACL_TOKEN_TYPE_CLIENT and not token.policies:
            raise ValueError("client token requires policies")
        token.accessor_id = token.accessor_id or generate_uuid()
        token.secret_id = token.secret_id or generate_uuid()
        token.create_time = token.create_time or now_ns()
        self._apply(fsm_mod.ACL_TOKEN_UPSERT, {"tokens": [token.to_dict()]})
        return token

    def acl_delete_tokens(self, accessors: list[str]):
        self._check_leader()
        self._apply(fsm_mod.ACL_TOKEN_DELETE, {"accessors": list(accessors)})

    # ------------------------------------------------------------------
    # Search (ref nomad/search_endpoint.go: prefix matches across tables,
    # truncated at 20 per context)
    # ------------------------------------------------------------------
    def search(
        self,
        prefix: str,
        context: str = "all",
        namespace: str = "default",
        include_nodes: bool = True,
    ) -> dict:
        """Results are scoped to the request namespace (jobs/evals/allocs/
        deployments), and nodes only appear for callers holding node:read —
        matching the per-context ACL filtering of search_endpoint.go."""
        snap = self.state.snapshot()
        limit = 20
        contexts: dict[str, list[str]] = {}
        truncations: dict[str, bool] = {}

        def collect(name: str, ids):
            if context not in ("all", name):
                return
            matches = sorted(i for i in ids if i.startswith(prefix))
            truncations[name] = len(matches) > limit
            contexts[name] = matches[:limit]

        collect("jobs", (j.id for j in snap.jobs() if j.namespace == namespace))
        collect(
            "evals", (e.id for e in snap.evals() if e.namespace == namespace)
        )
        collect(
            "allocs", (a.id for a in snap.allocs() if a.namespace == namespace)
        )
        if include_nodes:
            collect("nodes", (n.id for n in snap.nodes()))
        collect(
            "deployments",
            (d.id for d in snap.deployments() if d.namespace == namespace),
        )
        return {"matches": contexts, "truncations": truncations}

    def catalog_service(self, name: str) -> list[dict]:
        """Service catalog lookup (the Consul-catalog role for Connect
        upstream resolution): plain service instances by name, plus
        client-published sidecar listeners under ``<svc>-sidecar-proxy``
        (ref Consul sidecar service registrations)."""
        snap = self.state.snapshot()
        out = []
        for alloc in snap.allocs():
            if alloc.terminal_status():
                continue
            for svc_name, ep in (alloc.connect_proxies or {}).items():
                if f"{svc_name}-sidecar-proxy" != name:
                    continue
                out.append(
                    {
                        "ServiceName": name,
                        "AllocID": alloc.id,
                        "NodeID": alloc.node_id,
                        "Address": ep.get("ip", ""),
                        "Port": int(ep.get("port", 0)),
                        "Status": "passing",
                    }
                )
            job = alloc.job
            tg = job.lookup_task_group(alloc.task_group) if job else None
            if tg is None:
                continue
            for task in tg.tasks:
                state = alloc.task_states.get(task.name)
                healthy = state is not None and state.state == "running"
                if healthy and any(
                    v != "passing" for v in state.check_status.values()
                ):
                    healthy = False
                for svc in task.services:
                    if svc.name != name:
                        continue
                    address, port = "", 0
                    resources = alloc.allocated_resources
                    tr = (
                        resources.tasks.get(task.name)
                        if resources is not None
                        else None
                    )
                    if tr is not None and svc.port_label:
                        for net in tr.networks:
                            for p in list(net.reserved_ports) + list(
                                net.dynamic_ports
                            ):
                                if p.label == svc.port_label:
                                    address, port = net.ip, p.value
                    out.append(
                        {
                            "ServiceName": svc.name,
                            "AllocID": alloc.id,
                            "NodeID": alloc.node_id,
                            "Address": address,
                            "Port": port,
                            "Status": "passing" if healthy else "critical",
                        }
                    )
        return out

    def _plan_token_live(self, plan) -> bool:
        """Dequeue-time re-validation of a plan's eval token (plans without
        tokens — direct planner users — pass)."""
        if not plan.eval_token:
            return True
        token, ok = self.eval_broker.outstanding(plan.eval_id)
        return ok and token == plan.eval_token

    def plan_submit(self, plan):
        """Plan submission with the EvalToken split-brain guard
        (ref plan_endpoint.go:19-52): the broker must still hold this eval
        outstanding under this token, else the worker is stale (its eval was
        nacked and re-dequeued elsewhere) and the plan is rejected before it
        can clobber the newer worker's. The nack timer pauses while the plan
        queues — it is making progress — and resumes when the result lands."""
        from .broker import BrokerError

        eval_id = plan.eval_id
        token = plan.eval_token
        self.eval_broker.pause_nack_timeout(eval_id, token)
        try:
            pending = self.planner.queue.enqueue(plan)
            return pending.wait(timeout=30.0)
        finally:
            try:
                self.eval_broker.resume_nack_timeout(eval_id, token)
            except BrokerError:
                pass  # acked/nacked while the plan was in flight

    def derive_vault_token(self, alloc_id: str, task_name: str) -> str:
        """ref node_endpoint.go DeriveVaultToken"""
        self._check_leader()
        return self.vault.derive_token(alloc_id, task_name)

    def upsert_node_events(self, events_by_node: dict[str, list]) -> int:
        """Replicate operational node events (ref node_endpoint.go
        EmitEvents → raft NodeEventsUpsertRequestType). Leader-only; event
        docs carry their own timestamps so replicas apply identically."""
        self._check_leader()
        return self._apply(
            fsm_mod.NODE_EVENTS_UPSERT, {"events": events_by_node}
        )

    #: node-event fanout cap for a single kernel fault: the witness needs
    #: a few TPU-plane nodes, not a raft write touching every device host
    MAX_KERNEL_FAULT_EVENT_NODES = 8

    def note_kernel_fault(self, ev: Optional[Evaluation], reason: str):
        """Witness a device-tier scheduler fault (TPU placement kernel
        error/NaN) that the scheduler degraded around: a metric for the
        telemetry surface plus a node event on the TPU device plane so
        operators see WHERE the accelerator tier is unhealthy — the eval
        itself completed on the exact-np host oracle."""
        metrics.incr("tpu.kernel_fault")
        targets = []
        for node in self.state.nodes():
            devices = getattr(node.node_resources, "devices", None) or []
            if any(getattr(d, "type", "") == "tpu" for d in devices):
                targets.append(node.id)
                if len(targets) >= self.MAX_KERNEL_FAULT_EVENT_NODES:
                    break
        if not targets:
            return
        event = {
            "timestamp": now_ns(),
            "subsystem": "TPU",
            "message": f"placement kernel fault: {reason}; "
            "degraded to exact-np planner",
            "details": {"eval_id": ev.id if ev is not None else ""},
        }
        self.upsert_node_events({node_id: [event] for node_id in targets})

    def system_gc(self):
        """Force-GC everything eligible (ref system_endpoint.go GarbageCollect
        → CoreJobForceGC). Leader-only."""
        from .core_sched import CORE_JOB_FORCE_GC, core_job_eval

        self._check_leader()
        self.eval_broker.enqueue(
            core_job_eval(CORE_JOB_FORCE_GC, self.state.latest_index())
        )

    @staticmethod
    def _adopt_eval_trace(ev: Evaluation):
        """Link the eval about to be created to the caller's trace
        context (HTTP/CLI submit span, RPC server span): the broker's
        root span — opened later on the raft apply thread — parents
        under it, so submit→device→ack is ONE tree."""
        from ..trace import tracer as _tracer

        _tracer.adopt_eval(ev.id)

    # ------------------------------------------------------------------
    # Job endpoints (ref nomad/job_endpoint.go:80 Register)
    # ------------------------------------------------------------------
    def job_register(self, job: Job) -> str:
        """Returns the eval id created (empty for periodic/parameterized)."""
        self._check_leader()
        self._validate_job(job)
        # stamp submission time before replication (ref job_endpoint.go
        # Register → job.SubmitTime = time.Now()); the FSM seeds the
        # periodic-launch checkpoint from it, so 0 would mean epoch-0 and
        # fire a spurious catch-up on the next leadership establishment
        job.submit_time = now_ns()
        self._apply(fsm_mod.JOB_REGISTER, {"job": job.to_dict()})
        stored = self.state.job_by_id(job.namespace, job.id)

        if stored.is_periodic() or stored.is_parameterized():
            return ""

        # direct-RPC submissions never pass the HTTP mint; when the
        # overload stanza sets default_deadline_s, stamp it here so the
        # whole pipeline stays bounded regardless of entry surface
        deadline_ns = current_deadline()
        if (
            not deadline_ns
            and self.overload is not None
            and self.overload.default_deadline_s > 0
        ):
            from .overload import mint_deadline

            deadline_ns = mint_deadline(self.overload.default_deadline_s)
        ev = Evaluation(
            id=generate_uuid(),
            namespace=job.namespace,
            priority=stored.priority,
            type=stored.type,
            triggered_by=EVAL_TRIGGER_JOB_REGISTER,
            job_id=stored.id,
            job_modify_index=stored.modify_index,
            status=EVAL_STATUS_PENDING,
            create_time=now_ns(),
            modify_time=now_ns(),
            # deadline propagation (core/overload.py): the HTTP/RPC edge
            # activated the caller's deadline scope; the eval carries it
            # so broker/worker/applier/drain can refuse expired work.
            # Server-initiated follow-ups deliberately do NOT inherit it.
            deadline=deadline_ns,
        )
        self._adopt_eval_trace(ev)
        self._apply(fsm_mod.EVAL_UPDATE, {"evals": [ev.to_dict()]})
        return ev.id

    def job_plan(self, job: Job, diff: bool = True) -> dict:
        """Dry-run the job against a scratch copy of current state and
        return the annotated plan + structural diff without mutating
        anything (ref job_endpoint.go Plan: snapshot + UpsertJob into the
        snapshot, scheduler.Harness dry-run with annotate, structs diff)."""
        from ..scheduler import Harness
        from ..structs.diff import job_diff

        self._validate_job(job)
        old_job = self.state.job_by_id(job.namespace, job.id)

        # scratch world adopting the immutable generation; never published
        scratch = StateStore()
        scratch._gen = self.state.snapshot()._gen
        planned = job.copy()
        planned.submit_time = now_ns()
        scratch.upsert_job(None, planned)

        harness = Harness(
            state=scratch, seed=self.config.get("seed"), device=self.device
        )
        # nta: ignore[raft-index-arith] — scratch dry-run world: this
        # index seeds the harness's private overlay and is never
        # published, compared, or waited on against a real store
        harness._next_index = scratch.latest_index() + 1
        ev = Evaluation(
            id=generate_uuid(),
            namespace=job.namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=EVAL_TRIGGER_JOB_REGISTER,
            job_id=job.id,
            status=EVAL_STATUS_PENDING,
            annotate_plan=True,
        )
        sched = harness.process(job.type, ev)

        plan = harness.plans[-1] if harness.plans else None
        annotations = None
        if plan is not None and plan.annotations is not None:
            annotations = plan.annotations.to_dict()
        failed = {
            name: metric.to_dict()
            for name, metric in (getattr(sched, "failed_tg_allocs", None) or {}).items()
        }
        return {
            "annotations": annotations,
            "failed_tg_allocs": failed,
            "diff": job_diff(old_job, job) if diff else None,
            "job_modify_index": old_job.modify_index if old_job is not None else 0,
        }

    def job_deregister(self, namespace: str, job_id: str, purge: bool = False) -> str:
        """ref job_endpoint.go Deregister"""
        self._check_leader()
        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            raise KeyError(f"job not found: {job_id}")
        self._apply(
            fsm_mod.JOB_DEREGISTER,
            {"namespace": namespace, "job_id": job_id, "purge": purge},
        )
        ev = Evaluation(
            id=generate_uuid(),
            namespace=namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=EVAL_TRIGGER_JOB_DEREGISTER,
            job_id=job_id,
            status=EVAL_STATUS_PENDING,
            create_time=now_ns(),
            modify_time=now_ns(),
        )
        self._apply(fsm_mod.EVAL_UPDATE, {"evals": [ev.to_dict()]})
        return ev.id

    def job_dispatch(
        self,
        namespace: str,
        job_id: str,
        payload: str = "",
        meta: Optional[dict] = None,
    ) -> dict:
        """Instantiate a parameterized job (ref job_endpoint.go:1523
        Dispatch): validates payload/meta against the job's parameterized
        config, registers a derived child, and evaluates it."""
        self._check_leader()
        parent = self.state.job_by_id(namespace, job_id)
        if parent is None:
            raise KeyError(f"job not found: {job_id}")
        if not parent.is_parameterized():
            raise ValueError(f"job {job_id} is not parameterized")
        if parent.stopped():
            raise ValueError(f"job {job_id} is stopped")

        cfg = parent.parameterized_job
        meta = dict(meta or {})
        if cfg.payload == "required" and not payload:
            raise ValueError("payload is required by the job")
        if cfg.payload == "forbidden" and payload:
            raise ValueError("payload is forbidden by the job")
        if len(payload) > 16 * 1024:
            raise ValueError("payload exceeds maximum size (16KiB)")
        missing = [k for k in cfg.meta_required if k not in meta]
        if missing:
            raise ValueError(f"missing required dispatch meta: {missing}")
        allowed = set(cfg.meta_required) | set(cfg.meta_optional)
        unknown = [k for k in meta if k not in allowed]
        if unknown:
            raise ValueError(f"dispatch meta not allowed by job: {unknown}")

        child = derive_dispatch_job(parent, payload, meta)
        self._apply(fsm_mod.JOB_REGISTER, {"job": child.to_dict()})
        stored = self.state.job_by_id(namespace, child.id)
        ev = Evaluation(
            id=generate_uuid(),
            namespace=namespace,
            priority=stored.priority,
            type=stored.type,
            triggered_by=EVAL_TRIGGER_JOB_REGISTER,
            job_id=stored.id,
            job_modify_index=stored.modify_index,
            status=EVAL_STATUS_PENDING,
            create_time=now_ns(),
            modify_time=now_ns(),
        )
        self._adopt_eval_trace(ev)
        self._apply(fsm_mod.EVAL_UPDATE, {"evals": [ev.to_dict()]})
        return {"DispatchedJobID": child.id, "EvalID": ev.id}

    def job_evaluate(
        self, namespace: str, job_id: str, force_reschedule: bool = False
    ) -> str:
        """Force a fresh evaluation of a job (ref job_endpoint.go Evaluate):
        used by `job eval` to re-drive placement after manual fixes. With
        force_reschedule, failed allocs get desired-transition
        ForceReschedule so the reconciler replaces them immediately."""
        self._check_leader()
        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            raise KeyError(f"job not found: {job_id}")
        if job.is_periodic():
            raise ValueError("can't evaluate a periodic job directly")
        ev = Evaluation(
            id=generate_uuid(),
            namespace=namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=EVAL_TRIGGER_JOB_REGISTER,
            job_id=job_id,
            status=EVAL_STATUS_PENDING,
            create_time=now_ns(),
            modify_time=now_ns(),
        )
        self._adopt_eval_trace(ev)
        if force_reschedule:
            failed = {
                a.id: {"force_reschedule": True}
                for a in self.state.allocs_by_job(namespace, job_id)
                if a.client_status == "failed" and not a.next_allocation
            }
            self._apply(
                fsm_mod.ALLOC_DESIRED_TRANSITION,
                {"allocs": failed, "evals": [ev.to_dict()]},
            )
        else:
            self._apply(fsm_mod.EVAL_UPDATE, {"evals": [ev.to_dict()]})
        return ev.id

    def periodic_force(self, namespace: str, job_id: str) -> str:
        """ref periodic_endpoint.go Force"""
        self._check_leader()
        if self.periodic is None:
            raise ValueError("periodic dispatcher not available")
        return self.periodic.force_launch(namespace, job_id)

    @staticmethod
    def _validate_job(job: Job):
        """Minimal admission checks (ref job_endpoint.go validateJob)."""
        if not job.id:
            raise ValueError("missing job ID")
        if not job.task_groups and not job.stop:
            raise ValueError("job requires at least one task group")
        if job.type == JOB_TYPE_CORE:
            raise ValueError("job type cannot be core")
        if not (JOB_MIN_PRIORITY <= job.priority <= JOB_MAX_PRIORITY):
            # priority drives eval ordering AND overload admission
            # classes; out-of-band values would make a user job outrank
            # core GC or dodge shedding (ref structs.go Job.Validate)
            raise ValueError(
                f"job priority must be between {JOB_MIN_PRIORITY} "
                f"and {JOB_MAX_PRIORITY}, got {job.priority}"
            )
        if job.periodic is not None and job.periodic.enabled:
            if job.type != JOB_TYPE_BATCH:
                # the dispatcher stamps child copies per tick; a periodic
                # service would accrete immortal children (ref structs.go:
                # periodic is batch-only)
                raise ValueError(
                    "periodic can only be used with batch jobs, got "
                    f"type {job.type!r}"
                )
            if job.parameterized_job is not None:
                # both are job factories; composing them is ambiguous
                # (does the cron tick dispatch, or template a dispatch?)
                raise ValueError(
                    "a periodic job cannot also be parameterized"
                )
        if job.is_periodic():
            # reject bad cron specs at admission: the dispatcher would
            # otherwise silently never launch (ref structs.go
            # PeriodicConfig.Validate)
            from .periodic import CronSpec

            if job.periodic.spec_type != "cron":
                raise ValueError(
                    f"unknown periodic spec type {job.periodic.spec_type!r}"
                )
            CronSpec(job.periodic.spec)
        for tg in job.task_groups:
            if tg.count < 0:
                raise ValueError(f"task group {tg.name} count must be >= 0")
            if not tg.tasks:
                raise ValueError(f"task group {tg.name} requires at least one task")

    # ------------------------------------------------------------------
    # Node endpoints (ref nomad/node_endpoint.go:79 Register, :362
    # UpdateStatus, :894 GetClientAllocs)
    # ------------------------------------------------------------------
    def node_register(self, node: Node) -> dict:
        self._check_leader()
        if not node.computed_class:
            compute_class(node)
        existed = self.state.node_by_id(node.id) is not None
        if not node.status:
            node.status = NODE_STATUS_READY
        # stamp before replication: event timestamps must be identical on
        # every replica and across log replays (like job.submit_time)
        node.status_updated_at = now_ns()
        self._apply(fsm_mod.NODE_REGISTER, {"node": node.to_dict()})
        self._reset_heartbeat(node.id)

        if not existed or node.status == NODE_STATUS_READY:
            self._create_node_evals(node.id)
        return {"heartbeat_ttl": self.heartbeat_ttl}

    def node_deregister(self, node_id: str):
        self._check_leader()
        self._apply(fsm_mod.NODE_DEREGISTER, {"node_id": node_id})
        with self._lock:
            t = self._heartbeat_timers.pop(node_id, None)
            if t is not None:
                t.cancel()

    def node_purge(self, node_id: str) -> list[str]:
        """Force-remove a node and create evals so its allocations are
        rescheduled (ref node_endpoint.go Deregister: the raft deregister
        applies FIRST, then createNodeEvals — evals created before the
        deregister commits would schedule against a state where the node
        still looks healthy and no-op, stranding its allocs)."""
        self._check_leader()
        node_id = self._node_id_by_prefix(node_id)
        self.node_deregister(node_id)
        return self._create_node_evals(node_id) or []

    def alloc_stop(self, alloc_id: str) -> str:
        """Stop one allocation: desired-transition migrate=true plus an
        alloc-stop eval in a single raft apply (ref alloc_endpoint.go:211
        Stop). The scheduler reconciles the stop and replaces the alloc."""
        from ..structs.model import EVAL_TRIGGER_ALLOC_STOP

        self._check_leader()
        alloc = self.state.alloc_by_id(alloc_id)
        if alloc is None:
            matches = [
                a for a in self.state.allocs() if a.id.startswith(alloc_id)
            ]
            if len(matches) == 1:
                alloc = matches[0]
        if alloc is None:
            raise KeyError(f"alloc not found: {alloc_id}")
        job = alloc.job or self.state.job_by_id(alloc.namespace, alloc.job_id)
        ev = Evaluation(
            id=generate_uuid(),
            namespace=alloc.namespace,
            priority=job.priority if job is not None else 50,
            type=job.type if job is not None else JOB_TYPE_SERVICE,
            triggered_by=EVAL_TRIGGER_ALLOC_STOP,
            job_id=alloc.job_id,
            status=EVAL_STATUS_PENDING,
            create_time=now_ns(),
            modify_time=now_ns(),
        )
        self._apply(
            fsm_mod.ALLOC_DESIRED_TRANSITION,
            {
                "allocs": {alloc.id: {"migrate": True}},
                "evals": [ev.to_dict()],
            },
        )
        return ev.id

    def alloc_get(self, alloc_id: str) -> Optional[dict]:
        """Alloc document by id (ref alloc_endpoint.go GetAlloc); used by
        clients awaiting a previous allocation during disk migration."""
        alloc = self.state.alloc_by_id(alloc_id)
        return None if alloc is None else alloc.to_dict()

    def forward_client_fs(self, alloc_id: str, method: str, params: dict):
        """Server-side hop of the client→server→client fs path
        (ref client_fs_endpoint.go): resolve the alloc's node and forward
        to its client RPC listener with the node secret. This is how a
        replacement alloc migrates ephemeral disk off another node without
        ever holding that node's secret itself."""
        alloc = self.state.alloc_by_id(alloc_id)
        if alloc is None:
            raise KeyError(f"alloc not found: {alloc_id}")
        node = self.state.node_by_id(alloc.node_id)
        addr = (
            node.attributes.get("unique.advertise.client_rpc")
            if node is not None
            else None
        )
        if not addr:
            raise KeyError(
                f"alloc {alloc_id} is on a node without a client RPC address"
            )
        payload = dict(
            params or {}, alloc_id=alloc_id, secret=node.secret_id
        )
        return self._conn_pool().call(
            addr, f"ClientFS.{method}", payload, timeout=30.0
        )

    def _client_rpc_target(self, alloc_id: str):
        """(client rpc addr, node secret) for the node hosting an alloc."""
        alloc = self.state.alloc_by_id(alloc_id)
        if alloc is None:
            raise KeyError(f"alloc not found: {alloc_id}")
        node = self.state.node_by_id(alloc.node_id)
        addr = (
            node.attributes.get("unique.advertise.client_rpc")
            if node is not None
            else None
        )
        if not addr:
            raise KeyError(
                f"alloc {alloc_id} is on a node without a client RPC address"
            )
        return addr, node.secret_id

    def open_client_exec(self, alloc_id: str, params: dict):
        """Dial the hosting node and open the duplex exec stream (the
        server hop of agent→server→client exec forwarding — the path the
        reference serves via client_alloc_endpoint.go exec streaming).
        Returns the live client-side stream for the caller to bridge."""
        addr, secret = self._client_rpc_target(alloc_id)
        payload = dict(params or {}, alloc_id=alloc_id, secret=secret)
        return self._conn_pool().call_duplex(
            addr, "ClientAllocations.Exec", payload
        )

    def reconcile_summaries(self):
        """Rebuild job summaries from the alloc table through raft
        (ref system_endpoint.go ReconcileJobSummaries)."""
        self._check_leader()
        self._apply(fsm_mod.RECONCILE_SUMMARIES, {})

    def node_update_status(self, node_id: str, status: str) -> dict:
        self._check_leader()
        node = self.state.node_by_id(node_id)
        if node is None:
            raise KeyError(f"node not found: {node_id}")
        if node.status != status:
            self._apply(
                fsm_mod.NODE_STATUS_UPDATE,
                {"node_id": node_id, "status": status, "updated_at": now_ns()},
            )
            self._create_node_evals(node_id)
        if status != NODE_STATUS_DOWN:
            self._reset_heartbeat(node_id)
        return {"heartbeat_ttl": self.heartbeat_ttl}

    def node_heartbeat(self, node_id: str) -> dict:
        """ref node_endpoint.go UpdateStatus heartbeat path + heartbeat.go"""
        self._check_leader()
        node = self.state.node_by_id(node_id)
        if node is None:
            raise KeyError(f"node not found: {node_id}")
        if node.status == NODE_STATUS_DOWN:
            # heartbeat revives a down node
            return self.node_update_status(node_id, NODE_STATUS_READY)
        self._reset_heartbeat(node_id)
        return {"heartbeat_ttl": self.heartbeat_ttl}

    def node_drain(
        self,
        node_id: str,
        drain: bool,
        deadline_ns: int = 0,
        ignore_system_jobs: bool = False,
        mark_eligible: Optional[bool] = None,
    ):
        """ref node_endpoint.go UpdateDrain: the drainer subsystem paces the
        actual migrations; a deadline forces whatever remains."""
        self._check_leader()
        node_id = self._node_id_by_prefix(node_id)
        payload = {"node_id": node_id, "drain": drain, "updated_at": now_ns()}
        if drain:
            payload["drain_strategy"] = {
                "deadline": deadline_ns,
                "force_deadline": (now_ns() + deadline_ns) if deadline_ns > 0 else 0,
                "ignore_system_jobs": ignore_system_jobs,
            }
        else:
            # cancelling a drain re-marks eligible unless told otherwise
            payload["mark_eligible"] = (
                True if mark_eligible is None else mark_eligible
            )
        self._apply(fsm_mod.NODE_DRAIN_UPDATE, payload)
        if drain and self.drainer is not None:
            self.drainer.notify()
        self._create_node_evals(node_id)

    def node_update_eligibility(self, node_id: str, eligibility: str):
        self._check_leader()
        self._apply(
            fsm_mod.NODE_ELIGIBILITY_UPDATE,
            {
                "node_id": self._node_id_by_prefix(node_id),
                "eligibility": eligibility,
                "updated_at": now_ns(),
            },
        )

    def _node_id_by_prefix(self, node_id: str) -> str:
        """Resolve a short node ID to the full ID (the CLI prints 8-char
        prefixes, matching the reference's prefix-tolerant lookups)."""
        if self.state.node_by_id(node_id) is not None:
            return node_id
        matches = self.state.node_by_prefix(node_id)
        if len(matches) > 1:
            raise ValueError(
                f"ambiguous node prefix {node_id!r} ({len(matches)} matches)"
            )
        if not matches:
            raise KeyError(f"node not found: {node_id}")
        return matches[0].id

    def _reset_heartbeat(self, node_id: str):
        """ref heartbeat.go:33-212 resetHeartbeatTimer (leader-only)"""
        if not self._running or not self._leader:
            return
        with self._lock:
            old = self._heartbeat_timers.pop(node_id, None)
            if old is not None:
                old.cancel()
            handle_box: list = []
            handle = shared_timer_wheel().arm(
                self.heartbeat_ttl,
                self._enqueue_heartbeat_expiry,
                (node_id, handle_box),
            )
            # the callback identity-checks against the map under this
            # same lock, so it can't observe the box empty
            handle_box.append(handle)
            self._heartbeat_timers[node_id] = handle

    def _enqueue_heartbeat_expiry(self, node_id: str, handle_box: list):
        """Wheel callback: never do raft work on the wheel thread — a
        mass expiry would serialize there and freeze every other timer
        in the process (nack timeouts, other in-process servers). A
        queued expiry can't be retracted the way a timer cancel() could,
        so the map entry is claimed HERE, under the lock, only if this
        firing's handle is still the node's current one — and the
        drainer re-checks before acting."""
        with self._lock:
            if not self._running:
                return
            if self._heartbeat_timers.get(node_id) is not handle_box[0]:
                return  # stale fire: a heartbeat re-armed this node
            del self._heartbeat_timers[node_id]
            t = self._hb_expire_thread
            if t is None or not t.is_alive():
                t = threading.Thread(
                    target=self._drain_heartbeat_expirations,
                    name="heartbeat-expiry",
                    daemon=True,
                )
                self._hb_expire_thread = t
                t.start()
        self._hb_expire_q.put(node_id)

    def _drain_heartbeat_expirations(self):
        while True:
            node_id = self._hb_expire_q.get()
            if node_id is None:
                # stop() sentinel. A server can stop()+start() again,
                # and stop() enqueues unconditionally — a sentinel from
                # a PREVIOUS life must not kill the new life's drainer
                # (stranding that batch's expirations behind it)
                if not self._running:
                    return
                continue
            self._invalidate_heartbeat(node_id)

    def _invalidate_heartbeat(self, node_id: str):
        """Heartbeat missed → node down → node evals (ref heartbeat.go:150)."""
        with self._lock:
            if node_id in self._heartbeat_timers:
                # the node heartbeated between the expiry firing and this
                # drain — it is alive and freshly armed; downing it now
                # would flap a healthy node
                return
        try:
            node = self.state.node_by_id(node_id)
            if node is not None and node.status != NODE_STATUS_DOWN:
                logger.warning("node %s missed heartbeat; marking down", node_id[:8])
                self.node_update_status(node_id, NODE_STATUS_DOWN)
        except NotLeaderError:
            pass
        except Exception:
            logger.exception("heartbeat invalidation failed for %s", node_id)

    def _create_node_evals(self, node_id: str):
        """Create evals for all jobs with allocs on the node + system jobs
        (ref node_endpoint.go:1056 createNodeEvals)."""
        node = self.state.node_by_id(node_id)
        jobs: dict[tuple[str, str], Job] = {}
        for alloc in self.state.allocs_by_node(node_id):
            if alloc.job is not None and not alloc.terminal_status():
                jobs[(alloc.namespace, alloc.job_id)] = alloc.job
        for job in self.state.jobs_by_scheduler(JOB_TYPE_SYSTEM):
            if node is not None and node.datacenter in job.datacenters:
                jobs[(job.namespace, job.id)] = job

        evals = []
        for (ns, job_id), job in jobs.items():
            evals.append(
                Evaluation(
                    id=generate_uuid(),
                    namespace=ns,
                    priority=job.priority,
                    type=job.type,
                    triggered_by=EVAL_TRIGGER_NODE_UPDATE,
                    job_id=job_id,
                    node_id=node_id,
                    status=EVAL_STATUS_PENDING,
                    create_time=now_ns(),
                    modify_time=now_ns(),
                )
            )
        if evals:
            self._apply(
                fsm_mod.EVAL_UPDATE, {"evals": [e.to_dict() for e in evals]}
            )
        return [e.id for e in evals]

    # ------------------------------------------------------------------
    # Client alloc sync (ref node_endpoint.go:894 GetClientAllocs, :362
    # UpdateAlloc)
    # ------------------------------------------------------------------
    def get_client_allocs(
        self, node_id: str, min_index: int = 0, timeout: float = 30.0
    ) -> tuple[list[Allocation], int]:
        """Blocking query the client long-polls for its allocs."""
        def query(snap):
            return snap.allocs_by_node(node_id)

        return self.state.blocking_query(query, min_index=min_index, timeout=timeout)

    def update_allocs(self, allocs: list[Allocation]):
        """Client-reported alloc status; failed allocs trigger new evals in
        the same log entry (ref node_endpoint.go UpdateAlloc:1006-1053)."""
        self._check_leader()
        evals = []
        seen = set()
        for update in allocs:
            stored = self.state.alloc_by_id(update.id)
            job = stored.job if stored is not None else None
            if job is None:
                continue
            if update.client_terminal_status() and not stored.server_terminal_status():
                key = (stored.namespace, stored.job_id)
                if key in seen:
                    continue
                seen.add(key)
                evals.append(
                    Evaluation(
                        id=generate_uuid(),
                        namespace=stored.namespace,
                        priority=job.priority,
                        type=job.type,
                        triggered_by=EVAL_TRIGGER_RETRY_FAILED_ALLOC,
                        job_id=stored.job_id,
                        status=EVAL_STATUS_PENDING,
                        create_time=now_ns(),
                        modify_time=now_ns(),
                    )
                )
        self._apply(
            fsm_mod.ALLOC_CLIENT_UPDATE,
            {
                "allocs": [a.to_dict() for a in allocs],
                "evals": [e.to_dict() for e in evals],
            },
        )
        if self.vault.enabled():
            terminal = [a.id for a in allocs if a.client_terminal_status()]
            if terminal:
                # alloc done → its vault tokens die with it (vault.go
                # RevokeTokens on terminal allocations)
                self.vault.revoke_for_allocs(terminal)

    # ------------------------------------------------------------------
    # Eval endpoints (ref nomad/eval_endpoint.go)
    # ------------------------------------------------------------------
    def eval_dequeue(self, schedulers: list[str], timeout: float = 1.0):
        self._check_leader()
        return self.eval_broker.dequeue(schedulers, timeout)

    def eval_ack(self, eval_id: str, token: str):
        self._check_leader()
        self.eval_broker.ack(eval_id, token)

    def eval_nack(self, eval_id: str, token: str):
        self._check_leader()
        self.eval_broker.nack(eval_id, token)

    def update_evals(self, evals: list[Evaluation]):
        """Worker-side eval status writes (ref eval_endpoint.go Update)."""
        self._apply(
            fsm_mod.EVAL_UPDATE, {"evals": [e.to_dict() for e in evals]}
        )

    # ------------------------------------------------------------------
    def _make_preemption_evals(self, result) -> list[Evaluation]:
        """Follow-up evals for jobs whose allocs were preempted
        (ref plan_apply.go preemption eval creation)."""
        jobs = {}
        for allocs in result.node_preemptions.values():
            for alloc in allocs:
                stored = self.state.alloc_by_id(alloc.id)
                job = stored.job if stored is not None else None
                if job is not None:
                    jobs[(alloc.namespace, alloc.job_id)] = job
        evals = []
        for (ns, job_id), job in jobs.items():
            evals.append(
                Evaluation(
                    id=generate_uuid(),
                    namespace=ns,
                    priority=job.priority,
                    type=job.type,
                    triggered_by="preemption",
                    job_id=job_id,
                    status=EVAL_STATUS_PENDING,
                    create_time=now_ns(),
                    modify_time=now_ns(),
                )
            )
        return evals


# Deployment RPC surface (ref nomad/deployment_endpoint.go) lives in
# deployment_watcher.py; attach its methods to Server here.
install_deployment_endpoints(Server)
