"""MVCC state store with immutable snapshots and blocking queries.

The reference stores server state in go-memdb (13 tables, nomad/state/
schema.go:72-611) with watch-set blocking queries (state_store.go:188) and
atomic plan commits (UpsertPlanResults, :227). This implementation keeps the
same table set and semantics but uses table-level copy-on-write generations:
every write transaction swaps in a new immutable ``Generation``, so a snapshot
is one pointer read and readers never block writers — the property the TPU
batch scheduler relies on to build columnar mirrors without locking.

Objects stored here are treated as immutable; mutators must insert copies.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Iterable, Optional

from ..structs.model import (
    ALLOC_CLIENT_STATUS_COMPLETE,
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_LOST,
    ALLOC_CLIENT_STATUS_PENDING,
    AclPolicy,
    AclToken,
    ALLOC_CLIENT_STATUS_RUNNING,
    ALLOC_DESIRED_STATUS_EVICT,
    ALLOC_DESIRED_STATUS_STOP,
    EVAL_STATUS_BLOCKED,
    JOB_STATUS_DEAD,
    JOB_STATUS_PENDING,
    JOB_STATUS_RUNNING,
    JOB_TYPE_SYSTEM,
    NODE_SCHED_ELIGIBLE,
    NODE_SCHED_INELIGIBLE,
    NODE_STATUS_DOWN,
    DEPLOYMENT_STATUS_DESC_RUNNING,
    DEPLOYMENT_STATUS_SUCCESSFUL,
    Allocation,
    Deployment,
    DeploymentStatus,
    DeploymentStatusUpdate,
    Evaluation,
    Job,
    fast_alloc_clone,
    JobSummary,
    Node,
    Plan,
    PlanResult,
    TaskGroupSummary,
)

from .planes import CommittedPlanes

JOB_TRACKED_VERSIONS = 6


@dataclass(frozen=True)
class Generation:
    """One immutable version of all tables. Table maps must never be mutated
    after publication — writers copy, modify, and publish a new Generation."""

    index: int = 0
    nodes: dict[str, Node] = field(default_factory=dict)
    jobs: dict[tuple[str, str], Job] = field(default_factory=dict)
    job_versions: dict[tuple[str, str, int], Job] = field(default_factory=dict)
    job_summaries: dict[tuple[str, str], JobSummary] = field(default_factory=dict)
    evals: dict[str, Evaluation] = field(default_factory=dict)
    allocs: dict[str, Allocation] = field(default_factory=dict)
    deployments: dict[str, Deployment] = field(default_factory=dict)
    periodic_launch: dict[tuple[str, str], dict] = field(default_factory=dict)
    scheduler_config: Optional[dict] = None
    autopilot_config: Optional[dict] = None
    acl_policies: dict[str, "AclPolicy"] = field(default_factory=dict)
    acl_tokens: dict[str, "AclToken"] = field(default_factory=dict)  # by accessor
    vault_accessors: dict[str, dict] = field(default_factory=dict)  # by accessor
    table_indexes: dict[str, int] = field(default_factory=dict)


class StateReader:
    """Read methods shared by live store and snapshots. Mirrors the accessor
    surface of the reference StateStore (AllocsByNode, JobByID, ...)."""

    _gen: Generation

    # -- indexes ----------------------------------------------------------
    def latest_index(self) -> int:
        return self._gen.index

    def table_index(self, table: str) -> int:
        return self._gen.table_indexes.get(table, 0)

    # -- nodes ------------------------------------------------------------
    def node_by_id(self, node_id: str) -> Optional[Node]:
        return self._gen.nodes.get(node_id)

    def nodes(self) -> Iterable[Node]:
        return self._gen.nodes.values()

    def node_by_prefix(self, prefix: str) -> list[Node]:
        return [n for nid, n in self._gen.nodes.items() if nid.startswith(prefix)]

    # -- jobs -------------------------------------------------------------
    def job_by_id(self, namespace: str, job_id: str) -> Optional[Job]:
        return self._gen.jobs.get((namespace, job_id))

    def jobs(self) -> Iterable[Job]:
        return self._gen.jobs.values()

    def jobs_by_namespace(self, namespace: str) -> list[Job]:
        return [j for (ns, _), j in self._gen.jobs.items() if ns == namespace]

    def jobs_by_scheduler(self, scheduler_type: str) -> list[Job]:
        return [j for j in self._gen.jobs.values() if j.type == scheduler_type]

    def jobs_by_periodic(self) -> list[Job]:
        return [j for j in self._gen.jobs.values() if j.is_periodic()]

    def job_by_id_and_version(
        self, namespace: str, job_id: str, version: int
    ) -> Optional[Job]:
        return self._gen.job_versions.get((namespace, job_id, version))

    def job_versions(self, namespace: str, job_id: str) -> list[Job]:
        versions = [
            j
            for (ns, jid, _), j in self._gen.job_versions.items()
            if ns == namespace and jid == job_id
        ]
        versions.sort(key=lambda j: j.version, reverse=True)
        return versions

    def job_summaries(self) -> Iterable[JobSummary]:
        return self._gen.job_summaries.values()

    def job_summary_by_id(self, namespace: str, job_id: str) -> Optional[JobSummary]:
        return self._gen.job_summaries.get((namespace, job_id))

    # -- evals ------------------------------------------------------------
    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        return self._gen.evals.get(eval_id)

    def evals(self) -> Iterable[Evaluation]:
        return self._gen.evals.values()

    def evals_by_job(self, namespace: str, job_id: str) -> list[Evaluation]:
        return [
            e
            for e in self._gen.evals.values()
            if e.namespace == namespace and e.job_id == job_id
        ]

    # -- allocs -----------------------------------------------------------
    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        return self._gen.allocs.get(alloc_id)

    def allocs(self) -> Iterable[Allocation]:
        return self._gen.allocs.values()

    def _alloc_node_index(self) -> dict[str, list[Allocation]]:
        """Lazy per-generation secondary index node_id → allocs (the memdb
        ``alloc.node_id`` index, schema.go:472). Generations are immutable
        after publication, so the index is built at most once per generation
        on first by-node read and shared by every snapshot of it; one build
        costs the same single table scan a lone allocs_by_node() used to,
        after which lookups are O(allocs on node) — the difference between
        O(A) and O(A²) for per-node sweeps like the port/device post-passes.
        Benign if two threads race: both build identical maps and the
        attribute publish is atomic."""
        gen = self._gen
        idx = gen.__dict__.get("_by_node")
        if idx is None:
            idx = {}
            for a in gen.allocs.values():
                bucket = idx.get(a.node_id)
                if bucket is None:
                    bucket = idx[a.node_id] = []
                bucket.append(a)
            object.__setattr__(gen, "_by_node", idx)
        return idx

    def _alloc_job_index(self) -> dict[tuple[str, str], list[Allocation]]:
        """Lazy per-generation index (namespace, job_id) → allocs; same
        contract as ``_alloc_node_index``."""
        gen = self._gen
        idx = gen.__dict__.get("_by_job")
        if idx is None:
            idx = {}
            for a in gen.allocs.values():
                key = (a.namespace, a.job_id)
                bucket = idx.get(key)
                if bucket is None:
                    bucket = idx[key] = []
                bucket.append(a)
            object.__setattr__(gen, "_by_job", idx)
        return idx

    def allocs_by_node(self, node_id: str) -> list[Allocation]:
        return list(self._alloc_node_index().get(node_id, ()))

    def allocs_by_node_terminal(
        self, node_id: str, terminal: bool
    ) -> list[Allocation]:
        return [
            a
            for a in self._alloc_node_index().get(node_id, ())
            if a.terminal_status() == terminal
        ]

    def allocs_by_job(
        self, namespace: str, job_id: str, any_create_index: bool = True
    ) -> list[Allocation]:
        """Allocs for a job; with any_create_index=False only allocs belonging
        to the currently registered incarnation of the job are returned
        (ref state_store.go AllocsByJob)."""
        out = list(self._alloc_job_index().get((namespace, job_id), ()))
        if not any_create_index:
            job = self._gen.jobs.get((namespace, job_id))
            if job is not None:
                out = [
                    a
                    for a in out
                    if a.job is None or a.job.create_index == job.create_index
                ]
        return out

    def allocs_by_eval(self, eval_id: str) -> list[Allocation]:
        return [a for a in self._gen.allocs.values() if a.eval_id == eval_id]

    def allocs_by_deployment(self, deployment_id: str) -> list[Allocation]:
        return [
            a for a in self._gen.allocs.values() if a.deployment_id == deployment_id
        ]

    # -- deployments ------------------------------------------------------
    def deployment_by_id(self, deployment_id: str) -> Optional[Deployment]:
        return self._gen.deployments.get(deployment_id)

    def deployments(self) -> Iterable[Deployment]:
        return self._gen.deployments.values()

    def deployments_by_job(self, namespace: str, job_id: str) -> list[Deployment]:
        return [
            d
            for d in self._gen.deployments.values()
            if d.namespace == namespace and d.job_id == job_id
        ]

    def latest_deployment_by_job_id(
        self, namespace: str, job_id: str
    ) -> Optional[Deployment]:
        ds = self.deployments_by_job(namespace, job_id)
        if not ds:
            return None
        return max(ds, key=lambda d: d.create_index)

    # -- periodic launches -----------------------------------------------
    def periodic_launch_by_id(self, namespace: str, job_id: str) -> Optional[dict]:
        return self._gen.periodic_launch.get((namespace, job_id))

    def periodic_launches(self) -> Iterable[dict]:
        return self._gen.periodic_launch.values()

    # -- config -----------------------------------------------------------
    def scheduler_config(self) -> Optional[dict]:
        return self._gen.scheduler_config

    def autopilot_config(self) -> Optional[dict]:
        return self._gen.autopilot_config

    # -- vault ------------------------------------------------------------
    def vault_accessors(self) -> list[dict]:
        return list(self._gen.vault_accessors.values())

    # -- acl --------------------------------------------------------------
    def acl_policies(self) -> Iterable["AclPolicy"]:
        return self._gen.acl_policies.values()

    def acl_policy_by_name(self, name: str) -> Optional["AclPolicy"]:
        return self._gen.acl_policies.get(name)

    def acl_tokens(self) -> Iterable["AclToken"]:
        return self._gen.acl_tokens.values()

    def acl_token_by_accessor(self, accessor: str) -> Optional["AclToken"]:
        return self._gen.acl_tokens.get(accessor)

    def acl_token_by_secret(self, secret: str) -> Optional["AclToken"]:
        for t in self._gen.acl_tokens.values():
            if t.secret_id == secret:
                return t
        return None

    # -- event-plane snapshot extraction ----------------------------------
    def snapshot_events(self, topics=None) -> list:
        """Synthetic ``<Topic>Snapshot`` events for every live object in
        this generation — the event stream's snapshot-on-subscribe source
        (events/broker.py). Each event's payload is the object's
        canonical ``to_dict()`` document, byte-identical to what a store
        query at this generation's index serves, and its ``index`` is the
        object's own modify_index (the raft index that last changed it);
        the broker stamps the enclosing snapshot frame with this
        generation's ``latest_index()``. ``topics`` (a set) narrows the
        extraction; None extracts every snapshot-able topic. NodeEvent
        and PlanResult have no standing state objects, so they
        contribute nothing here — their history lives only in the
        ring."""
        from ..events import (
            TOPIC_ALLOC,
            TOPIC_DEPLOYMENT,
            TOPIC_EVAL,
            TOPIC_JOB,
            TOPIC_NODE,
            Event,
        )

        gen = self._gen
        out: list = []

        def want(topic: str) -> bool:
            return topics is None or topic in topics

        if want(TOPIC_NODE):
            for n in gen.nodes.values():
                out.append(
                    Event(
                        topic=TOPIC_NODE,
                        type="NodeSnapshot",
                        key=n.id,
                        index=n.modify_index,
                        payload=n.to_dict(),
                    )
                )
        if want(TOPIC_JOB):
            for (ns, _), j in gen.jobs.items():
                out.append(
                    Event(
                        topic=TOPIC_JOB,
                        type="JobSnapshot",
                        key=j.id,
                        index=j.modify_index,
                        namespace=ns,
                        payload=j.to_dict(),
                    )
                )
        if want(TOPIC_EVAL):
            for e in gen.evals.values():
                out.append(
                    Event(
                        topic=TOPIC_EVAL,
                        type="EvalSnapshot",
                        key=e.id,
                        index=e.modify_index,
                        namespace=e.namespace,
                        payload=e.to_dict(),
                        filter_keys=tuple(
                            k
                            for k in (e.job_id, e.deployment_id)
                            if k
                        ),
                    )
                )
        if want(TOPIC_ALLOC):
            for a in gen.allocs.values():
                out.append(
                    Event(
                        topic=TOPIC_ALLOC,
                        type="AllocationSnapshot",
                        key=a.id,
                        index=a.modify_index,
                        namespace=a.namespace,
                        payload=a.to_dict(),
                        filter_keys=tuple(
                            k
                            for k in (
                                a.job_id,
                                a.eval_id,
                                a.deployment_id,
                            )
                            if k
                        ),
                    )
                )
        if want(TOPIC_DEPLOYMENT):
            for d in gen.deployments.values():
                out.append(
                    Event(
                        topic=TOPIC_DEPLOYMENT,
                        type="DeploymentSnapshot",
                        key=d.id,
                        index=d.modify_index,
                        namespace=d.namespace,
                        payload=d.to_dict(),
                        filter_keys=(d.job_id,) if d.job_id else (),
                    )
                )
        return out

    # -- ready nodes ------------------------------------------------------
    def ready_nodes_in_dcs(self, datacenters: list[str]) -> tuple[list[Node], dict[str, int]]:
        """Ready nodes in any of the given datacenters + per-DC availability
        counts (ref scheduler/util.go:224)."""
        dcs = set(datacenters)
        out = []
        by_dc: dict[str, int] = {}
        for n in self._gen.nodes.values():
            if not n.ready():
                continue
            if n.datacenter not in dcs:
                continue
            out.append(n)
            by_dc[n.datacenter] = by_dc.get(n.datacenter, 0) + 1
        return out, by_dc


class StateSnapshot(StateReader):
    """An immutable point-in-time view."""

    def __init__(self, gen: Generation):
        self._gen = gen


def _write_txn(method):
    """Serialize a whole read-copy-publish write transaction. In the
    reference, writes are serialized by the raft FSM apply loop; here the
    store enforces it so any caller layering is safe.

    Every write method takes ``index`` as its first argument; passing None
    allocates the next index *inside* the mutex (callers computing
    latest_index()+1 outside the lock would race and publish two writes
    under one index, starving blocking queries)."""

    @functools.wraps(method)
    def wrapper(self, index=None, *args, **kwargs):
        with self._write_mutex:
            if index is None:
                index = self._gen.index + 1
            return method(self, index, *args, **kwargs)

    return wrapper


class StateStore(StateReader):
    """The live, writable store."""

    def __init__(self):
        self._gen = Generation()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._write_mutex = threading.RLock()
        #: the dense columnar planes, patched by the SAME write transaction
        #: that swaps the tables and stamped at every publish — see
        #: state/planes.py for the commit protocol
        self.planes = CommittedPlanes()
        # commit the (empty) planes so readers are served from birth
        self.planes.commit(self._gen, self._gen.index)

    # ------------------------------------------------------------------
    # snapshots + blocking queries
    # ------------------------------------------------------------------
    def snapshot(self) -> StateSnapshot:
        return StateSnapshot(self._gen)

    def snapshot_min_index(self, index: int, timeout: float = 5.0) -> StateSnapshot:
        """Wait until the store has applied at least ``index`` then snapshot
        (ref state_store.go:114 SnapshotMinIndex)."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._gen.index >= index, timeout):
                raise TimeoutError(
                    f"timed out waiting for index {index} (at {self._gen.index})"
                )
            return StateSnapshot(self._gen)

    def blocking_query(
        self,
        run: Callable[[StateSnapshot], Any],
        min_index: int = 0,
        timeout: float = 300.0,
    ) -> tuple[Any, int]:
        """Long-poll: run ``run`` against snapshots until the store index
        exceeds min_index (or timeout), then return (result, index)
        (ref state_store.go:188 BlockingQuery)."""
        deadline = threading.TIMEOUT_MAX if timeout is None else timeout
        with self._cond:
            self._cond.wait_for(lambda: self._gen.index > min_index, deadline)
            gen = self._gen
        return run(StateSnapshot(gen)), gen.index

    def _publish(self, **updates):
        """Swap in a new generation (must hold no external refs to mutated
        tables) and wake blocked queries. The committed planes are stamped
        with the new generation in the same critical section — plane
        freshness IS generation identity, never an event subscription."""
        with self._cond:
            self._gen = replace(self._gen, **updates)
            self.planes.commit(self._gen, self._gen.index)
            self._cond.notify_all()

    @staticmethod
    def _bump(gen: Generation, index: int, *tables: str) -> dict[str, int]:
        ti = dict(gen.table_indexes)
        for t in tables:
            ti[t] = index
        return ti

    # ------------------------------------------------------------------
    # nodes
    # ------------------------------------------------------------------
    @_write_txn
    def upsert_node(self, index: int, node: Node):
        self.upsert_nodes(index, [node])

    #: events retained per node (ref structs.go MaxRetainedNodeEvents)
    MAX_NODE_EVENTS = 10

    @staticmethod
    def _node_event(node: Node, subsystem: str, message: str, at_ns: int):
        """Append to the node's bounded event ring (ref state_store.go
        appendNodeEvents + UpsertNodeEventsType). ``at_ns`` comes from the
        raft payload, never local wall clock — replicas and log replays
        must produce identical state."""
        node.events = (list(node.events) + [
            {
                "timestamp": at_ns,
                "subsystem": subsystem,
                "message": message,
            }
        ])[-StateStore.MAX_NODE_EVENTS :]

    @_write_txn
    def upsert_nodes(self, index: int, nodes: list[Node]):
        """Bulk node insert: one generation swap for the whole batch (used by
        simulation/benchmark cluster bootstrap; avoids O(N²) COW copies)."""
        gen = self._gen
        table = dict(gen.nodes)
        for node in nodes:
            node = node.copy()
            existing = table.get(node.id)
            if existing is not None:
                node.create_index = existing.create_index
                node.drain = existing.drain
                # strategy must survive re-registration too, or a draining
                # client restart loses its force deadline and the drain can
                # never force-complete (ref state_store.go upsertNodeTxn)
                node.drain_strategy = existing.drain_strategy
                node.scheduling_eligibility = existing.scheduling_eligibility
                node.events = list(existing.events)
                self._node_event(
                    node, "Cluster", "Node re-registered", node.status_updated_at
                )
            else:
                node.create_index = index
                self._node_event(
                    node, "Cluster", "Node registered", node.status_updated_at
                )
            node.modify_index = index
            table[node.id] = node
        # join / re-register may change resources or attributes: the node
        # axis (and every plane keyed to it) rebuilds at commit time
        self.planes.invalidate_axis()
        self._publish(
            index=index, nodes=table, table_indexes=self._bump(gen, index, "nodes")
        )

    @_write_txn
    def upsert_node_events(self, index: int, events_by_node: dict[str, list[dict]]):
        """Append operational events to nodes' bounded event rings
        (ref state_store.go UpsertNodeEvents). Unknown node ids are
        skipped — an event for a node GC'd between emission and apply is
        not an error."""
        gen = self._gen
        table = dict(gen.nodes)
        changed = False
        for node_id, events in events_by_node.items():
            node = table.get(node_id)
            if node is None or not events:
                continue
            node = node.copy()
            node.events = (list(node.events) + list(events))[
                -self.MAX_NODE_EVENTS:
            ]
            node.modify_index = index
            table[node_id] = node
            # resources unchanged: the committed planes just swap the
            # node object so identity reads stay current
            self.planes.swap_node(node)
            changed = True
        # publish even when nothing matched: the raft index must land in
        # the store so min-index waiters see this entry applied
        self._publish(
            index=index,
            nodes=table if changed else gen.nodes,
            table_indexes=(
                self._bump(gen, index, "nodes")
                if changed
                else self._bump(gen, index)
            ),
        )

    @_write_txn
    def delete_node(self, index: int, node_id: str):
        gen = self._gen
        nodes = dict(gen.nodes)
        if nodes.pop(node_id, None) is not None:
            self.planes.invalidate_axis()
        self._publish(
            index=index, nodes=nodes, table_indexes=self._bump(gen, index, "nodes")
        )

    @_write_txn
    def update_node_status(
        self,
        index: int,
        node_id: str,
        status: str,
        updated_at_ns: int = 0,
        event: Optional[dict] = None,
    ):
        self._update_node(
            index, node_id, status=status, status_updated_at=updated_at_ns,
            _event=("Cluster", f"Node status changed to {status}", updated_at_ns),
        )

    @_write_txn
    def update_node_drain(
        self,
        index: int,
        node_id: str,
        drain: bool,
        strategy=None,
        mark_eligible: bool = False,
        updated_at_ns: int = 0,
    ):
        """ref state_store.go UpdateNodeDrain: entering drain makes the node
        ineligible; completing a drain keeps it ineligible unless the caller
        explicitly re-marks it eligible."""
        if drain:
            elig = NODE_SCHED_INELIGIBLE
        elif mark_eligible:
            elig = NODE_SCHED_ELIGIBLE
        else:
            existing = self._gen.nodes.get(node_id)
            elig = (
                existing.scheduling_eligibility
                if existing is not None
                else NODE_SCHED_INELIGIBLE
            )
        self._update_node(
            index,
            node_id,
            drain=drain,
            drain_strategy=strategy if drain else None,
            scheduling_eligibility=elig,
            _event=(
                "Drain",
                "Node drain strategy set" if drain else "Node drain complete",
                updated_at_ns,
            ),
        )

    @_write_txn
    def update_node_eligibility(
        self, index: int, node_id: str, eligibility: str, updated_at_ns: int = 0
    ):
        self._update_node(
            index, node_id, scheduling_eligibility=eligibility,
            _event=("Cluster", f"Node marked as {eligibility}", updated_at_ns),
        )

    def _update_node(self, index: int, node_id: str, _event=None, **attrs):
        gen = self._gen
        existing = gen.nodes.get(node_id)
        if existing is None:
            raise KeyError(f"node not found: {node_id}")
        node = existing.copy()
        for k, v in attrs.items():
            setattr(node, k, v)
        if _event is not None:
            self._node_event(node, *_event)
        node.modify_index = index
        nodes = dict(gen.nodes)
        nodes[node_id] = node
        # status / drain / eligibility flap: same resources — O(1) object
        # swap in the committed planes, no dense-plane mutation
        self.planes.swap_node(node)
        self._publish(
            index=index, nodes=nodes, table_indexes=self._bump(gen, index, "nodes")
        )

    # ------------------------------------------------------------------
    # jobs
    # ------------------------------------------------------------------
    @_write_txn
    def upsert_job(self, index: int, job: Job, keep_version: bool = False):
        gen = self._gen
        jobs = dict(gen.jobs)
        versions = dict(gen.job_versions)
        summaries = dict(gen.job_summaries)
        job = job.copy()
        self._upsert_job_impl(gen, jobs, versions, summaries, index, job, keep_version)
        self._publish(
            index=index,
            jobs=jobs,
            job_versions=versions,
            job_summaries=summaries,
            table_indexes=self._bump(gen, index, "jobs", "job_summary", "job_version"),
        )

    def _upsert_job_impl(self, gen, jobs, versions, summaries, index, job, keep_version):
        """ref state_store.go:1005 upsertJobImpl"""
        key = (job.namespace, job.id)
        existing = jobs.get(key)
        if existing is not None:
            job.create_index = existing.create_index
            job.modify_index = index
            if not keep_version:
                job.job_modify_index = index
                job.version = existing.version + 1
            job.status = self._job_status(job, gen.allocs, gen.evals)
        else:
            job.create_index = index
            job.modify_index = index
            job.job_modify_index = index
            job.version = 0
            if not job.status:
                job.status = JOB_STATUS_PENDING
            job.status = self._job_status(job, gen.allocs, gen.evals)

        # Job summary (ref updateSummaryWithJob)
        summary = summaries.get(key)
        if summary is None or summary.create_index != job.create_index:
            summary = JobSummary(
                job_id=job.id,
                namespace=job.namespace,
                create_index=job.create_index,
            )
        else:
            summary = summary.copy()
        for tg in job.task_groups:
            if tg.name not in summary.summary:
                summary.summary[tg.name] = TaskGroupSummary()
        summary.modify_index = index
        summaries[key] = summary

        # Version history (ref upsertJobVersion): keep most recent N versions
        versions[(job.namespace, job.id, job.version)] = job
        all_versions = sorted(
            (k for k in versions if k[0] == job.namespace and k[1] == job.id),
            key=lambda k: k[2],
            reverse=True,
        )
        for stale in all_versions[JOB_TRACKED_VERSIONS:]:
            del versions[stale]

        jobs[key] = job

    @_write_txn
    def delete_job(self, index: int, namespace: str, job_id: str):
        gen = self._gen
        key = (namespace, job_id)
        if key not in gen.jobs:
            raise KeyError(f"job not found: {key}")
        jobs = dict(gen.jobs)
        del jobs[key]
        versions = {
            k: v
            for k, v in gen.job_versions.items()
            if not (k[0] == namespace and k[1] == job_id)
        }
        summaries = dict(gen.job_summaries)
        summaries.pop(key, None)
        launches = dict(gen.periodic_launch)
        launches.pop(key, None)
        self._publish(
            index=index,
            jobs=jobs,
            job_versions=versions,
            job_summaries=summaries,
            periodic_launch=launches,
            table_indexes=self._bump(
                gen, index, "jobs", "job_summary", "job_version", "periodic_launch"
            ),
        )

    @staticmethod
    def _job_status(job: Job, allocs_map: dict, evals_map: dict) -> str:
        """ref state_store.go:3264 getJobStatus. Takes the in-transaction
        alloc/eval tables so status reflects this write's edits."""
        if job.type == JOB_TYPE_SYSTEM or job.is_parameterized() or job.is_periodic():
            return JOB_STATUS_DEAD if job.stop else JOB_STATUS_RUNNING

        has_alloc = False
        for a in allocs_map.values():
            if a.namespace == job.namespace and a.job_id == job.id:
                has_alloc = True
                if not a.terminal_status():
                    return JOB_STATUS_RUNNING

        has_eval = False
        for e in evals_map.values():
            if e.namespace == job.namespace and e.job_id == job.id:
                has_eval = True
                if not e.terminal_status():
                    return JOB_STATUS_PENDING

        if has_eval or has_alloc:
            return JOB_STATUS_DEAD
        return JOB_STATUS_PENDING

    @_write_txn
    def upsert_job_summary(self, index: int, summary: JobSummary):
        gen = self._gen
        summaries = dict(gen.job_summaries)
        summary = summary.copy()
        summary.modify_index = index
        summaries[(summary.namespace, summary.job_id)] = summary
        self._publish(
            index=index,
            job_summaries=summaries,
            table_indexes=self._bump(gen, index, "job_summary"),
        )

    @_write_txn
    def reconcile_job_summaries(self, index: int):
        """Rebuild every job summary from the allocation table (ref
        state_store.go ReconcileJobSummaries / fsm.go reconcileSummaries):
        the repair path behind PUT /v1/system/reconcile/summaries."""
        gen = self._gen
        summaries: dict[tuple[str, str], JobSummary] = {}
        for (ns, jid), job in gen.jobs.items():
            old = gen.job_summaries.get((ns, jid))
            s = JobSummary(
                namespace=ns,
                job_id=jid,
                create_index=job.create_index,
                modify_index=index,
                children_pending=old.children_pending if old else 0,
                children_running=old.children_running if old else 0,
                children_dead=old.children_dead if old else 0,
            )
            for tg in job.task_groups:
                s.summary[tg.name] = TaskGroupSummary()
            summaries[(ns, jid)] = s
        for a in gen.allocs.values():
            s = summaries.get((a.namespace, a.job_id))
            tg = s.summary.get(a.task_group) if s is not None else None
            if tg is None:
                continue
            cs = a.client_status
            if cs == ALLOC_CLIENT_STATUS_PENDING:
                tg.starting += 1
            elif cs == ALLOC_CLIENT_STATUS_RUNNING:
                tg.running += 1
            elif cs == ALLOC_CLIENT_STATUS_COMPLETE:
                tg.complete += 1
            elif cs == ALLOC_CLIENT_STATUS_FAILED:
                tg.failed += 1
            elif cs == ALLOC_CLIENT_STATUS_LOST:
                tg.lost += 1
        self._publish(
            index=index,
            job_summaries=summaries,
            table_indexes=self._bump(gen, index, "job_summary"),
        )

    # ------------------------------------------------------------------
    # evals
    # ------------------------------------------------------------------
    @_write_txn
    def upsert_evals(self, index: int, evals: list[Evaluation]):
        gen = self._gen
        table = dict(gen.evals)
        jobs_touched: dict[tuple[str, str], str] = {}
        for e in evals:
            self._nested_upsert_eval(gen, table, index, e.copy(), jobs_touched)
        jobs = self._set_job_statuses(
            dict(gen.jobs), gen.allocs, table, index, jobs_touched
        )
        self._publish(
            index=index,
            evals=table,
            jobs=jobs,
            table_indexes=self._bump(gen, index, "evals", "jobs"),
        )

    def _nested_upsert_eval(self, gen, table, index, ev, jobs_touched):
        """ref state_store.go:1647 nestedUpsertEvaluation"""
        existing = table.get(ev.id)
        if existing is not None:
            ev.create_index = existing.create_index
            ev.modify_index = index
        else:
            ev.create_index = index
            ev.modify_index = index

        # Update blocked-queued counts in the job summary when a blocked
        # eval records queued allocations (simplified from the reference's
        # job_summary queue accounting).
        table[ev.id] = ev
        jobs_touched.setdefault((ev.namespace, ev.job_id), "")

    @_write_txn
    def delete_evals(self, index: int, eval_ids: list[str], alloc_ids: list[str]):
        gen = self._gen
        evals = dict(gen.evals)
        allocs = dict(gen.allocs)
        for eid in eval_ids:
            evals.pop(eid, None)
        for aid in alloc_ids:
            if allocs.pop(aid, None) is not None:
                self.planes.remove_alloc(aid)
        self._publish(
            index=index,
            evals=evals,
            allocs=allocs,
            table_indexes=self._bump(gen, index, "evals", "allocs"),
        )

    # ------------------------------------------------------------------
    # allocs
    # ------------------------------------------------------------------
    @_write_txn
    def upsert_allocs(self, index: int, allocs: list[Allocation]):
        gen = self._gen
        table = dict(gen.allocs)
        summaries = dict(gen.job_summaries)
        deployments = dict(gen.deployments)
        jobs_touched: dict[tuple[str, str], str] = {}
        for a in allocs:
            stored = self._upsert_alloc_impl(
                gen, table, summaries, deployments, index, a.copy(), jobs_touched
            )
            self.planes.apply_alloc(stored)
        jobs = self._set_job_statuses(
            dict(gen.jobs), table, gen.evals, index, jobs_touched
        )
        self._publish(
            index=index,
            allocs=table,
            jobs=jobs,
            job_summaries=summaries,
            deployments=deployments,
            table_indexes=self._bump(
                gen, index, "allocs", "jobs", "job_summary", "deployment"
            ),
        )

    # shallow clone for plan-apply inserts: the upsert mutates only
    # top-level bookkeeping fields plus deployment_status.modify_index
    _fast_alloc_clone = staticmethod(fast_alloc_clone)

    def _upsert_alloc_impl(
        self, gen, table, summaries, deployments, index, alloc, jobs_touched
    ):
        """ref state_store.go:2050 upsertAllocsImpl"""
        exist = table.get(alloc.id)
        if exist is None:
            alloc.create_index = index
            alloc.modify_index = index
            alloc.alloc_modify_index = index
            if alloc.deployment_status is not None:
                alloc.deployment_status.modify_index = index
            if alloc.job is None:
                raise ValueError(
                    f"attempting to upsert allocation {alloc.id} without a job"
                )
        else:
            alloc.create_index = exist.create_index
            alloc.modify_index = index
            alloc.alloc_modify_index = index
            # Keep the client's task states
            alloc.task_states = exist.task_states
            # Unless the scheduler is marking the alloc lost, retain the
            # client-reported status
            if alloc.client_status != ALLOC_CLIENT_STATUS_LOST:
                alloc.client_status = exist.client_status
                alloc.client_description = exist.client_description
            if alloc.job is None:
                alloc.job = exist.job

        self._update_summary_with_alloc(gen, summaries, index, alloc, exist)
        self._update_deployment_with_alloc(deployments, index, alloc, exist)

        table[alloc.id] = alloc

        if alloc.previous_allocation:
            prev = table.get(alloc.previous_allocation)
            if prev is not None:
                prev = self._fast_alloc_clone(prev)
                prev.next_allocation = alloc.id
                prev.modify_index = index
                table[prev.id] = prev

        # Force job running while the alloc runs (ref: forceStatus)
        force = ""
        if not alloc.terminal_status():
            force = JOB_STATUS_RUNNING
        jobs_touched[(alloc.namespace, alloc.job_id)] = force
        return alloc

    @_write_txn
    def update_allocs_from_client(self, index: int, allocs: list[Allocation]):
        """Apply client status updates (ref state_store.go:1933). Only
        client-owned fields are taken from the update."""
        gen = self._gen
        table = dict(gen.allocs)
        summaries = dict(gen.job_summaries)
        deployments = dict(gen.deployments)
        jobs_touched: dict[tuple[str, str], str] = {}
        for update in allocs:
            exist = table.get(update.id)
            if exist is None:
                continue
            alloc = exist.copy()
            alloc.client_status = update.client_status
            alloc.client_description = update.client_description
            alloc.task_states = update.task_states
            # sidecar listener endpoints are client-owned (the client binds
            # them); the catalog serves them for Connect upstream resolution
            alloc.connect_proxies = update.connect_proxies
            # The client may only set deployment health + timestamp
            # (ref state_store.go:1977-1992)
            if alloc.deployment_status is not None and update.deployment_status is not None:
                old_has = alloc.deployment_status.healthy is not None
                new_has = update.deployment_status.healthy is not None
                if new_has and (
                    not old_has
                    or alloc.deployment_status.healthy != update.deployment_status.healthy
                ):
                    alloc.deployment_status.healthy = update.deployment_status.healthy
                    alloc.deployment_status.timestamp = update.deployment_status.timestamp
                    alloc.deployment_status.modify_index = index
            elif update.deployment_status is not None:
                alloc.deployment_status = update.deployment_status.copy()
                alloc.deployment_status.modify_index = index
            alloc.modify_index = index
            alloc.modify_time = update.modify_time
            self._update_summary_with_alloc(gen, summaries, index, alloc, exist)
            self._update_deployment_with_alloc(deployments, index, alloc, exist)
            table[alloc.id] = alloc
            self.planes.apply_alloc(alloc)
            force = "" if alloc.terminal_status() else JOB_STATUS_RUNNING
            jobs_touched[(alloc.namespace, alloc.job_id)] = force
        jobs = self._set_job_statuses(
            dict(gen.jobs), table, gen.evals, index, jobs_touched
        )
        self._publish(
            index=index,
            allocs=table,
            jobs=jobs,
            job_summaries=summaries,
            deployments=deployments,
            table_indexes=self._bump(
                gen, index, "allocs", "jobs", "job_summary", "deployment"
            ),
        )

    @staticmethod
    def _fast_summary_clone(summary):
        """Shallow clone of a JobSummary: only top-level bookkeeping and the
        per-task-group counters mutate, so rebind those instead of the deep
        dict-roundtrip copy() (which dominated bulk plan commits at ~100µs
        × one call per placed alloc)."""
        c = type(summary).__new__(type(summary))
        c.__dict__ = dict(summary.__dict__)
        c.summary = {k: replace(v) for k, v in summary.summary.items()}
        return c

    def _update_summary_with_alloc(self, gen, summaries, index, alloc, exist):
        """ref state_store.go:3469 updateSummaryWithAlloc"""
        if alloc.job is None:
            return
        key = (alloc.namespace, alloc.job_id)
        summary = summaries.get(key)
        if summary is None:
            return
        if summary.create_index != alloc.job.create_index:
            return
        summary = self._fast_summary_clone(summary)
        tg = summary.summary.get(alloc.task_group)
        if tg is None:
            return
        changed = False
        if exist is None:
            if alloc.client_status == ALLOC_CLIENT_STATUS_PENDING:
                tg.starting += 1
                if tg.queued > 0:
                    tg.queued -= 1
                changed = True
        elif exist.client_status != alloc.client_status:
            if alloc.client_status == ALLOC_CLIENT_STATUS_RUNNING:
                tg.running += 1
            elif alloc.client_status == ALLOC_CLIENT_STATUS_FAILED:
                tg.failed += 1
            elif alloc.client_status == ALLOC_CLIENT_STATUS_PENDING:
                tg.starting += 1
            elif alloc.client_status == "complete":
                tg.complete += 1
            elif alloc.client_status == ALLOC_CLIENT_STATUS_LOST:
                tg.lost += 1
            if exist.client_status == ALLOC_CLIENT_STATUS_RUNNING and tg.running > 0:
                tg.running -= 1
            elif exist.client_status == ALLOC_CLIENT_STATUS_PENDING and tg.starting > 0:
                tg.starting -= 1
            elif exist.client_status == ALLOC_CLIENT_STATUS_LOST and tg.lost > 0:
                tg.lost -= 1
            changed = True
        if changed:
            summary.modify_index = index
            summaries[key] = summary

    def _update_deployment_with_alloc(self, deployments, index, alloc, exist):
        """Track placed/healthy/unhealthy counts on the alloc's deployment
        (ref state_store.go updateDeploymentWithAlloc)."""
        if not alloc.deployment_id:
            return
        d = deployments.get(alloc.deployment_id)
        if d is None or not d.active():
            return
        placed = healthy = unhealthy = 0
        if exist is None:
            placed += 1
        existing_healthy = exist is not None and exist.deployment_status is not None and exist.deployment_status.healthy is not None
        new_healthy = alloc.deployment_status is not None and alloc.deployment_status.healthy is not None
        if not existing_healthy and new_healthy:
            if alloc.deployment_status.is_healthy():
                healthy += 1
            else:
                unhealthy += 1
        if placed == 0 and healthy == 0 and unhealthy == 0:
            return
        d = d.copy()
        d.modify_index = index
        state = d.task_groups.get(alloc.task_group)
        if state is None:
            return
        state.placed_allocs += placed
        state.healthy_allocs += healthy
        state.unhealthy_allocs += unhealthy
        if (
            alloc.deployment_status is not None
            and alloc.deployment_status.canary
            and exist is None
        ):
            state.placed_canaries = list(state.placed_canaries) + [alloc.id]
        deployments[d.id] = d

    def _set_job_statuses(self, jobs, allocs_map, evals_map, index, jobs_touched):
        """Recompute job statuses after alloc/eval writes, against the
        in-transaction tables (ref state_store.go:3139 setJobStatuses)."""
        for key, force in jobs_touched.items():
            job = jobs.get(key)
            if job is None:
                continue
            new_status = force or self._job_status(job, allocs_map, evals_map)
            old_status = job.status if index != job.create_index else ""
            if new_status == old_status:
                continue
            job = job.copy()
            job.status = new_status
            job.modify_index = index
            jobs[key] = job
        return jobs

    # ------------------------------------------------------------------
    # deployments
    # ------------------------------------------------------------------
    @_write_txn
    def upsert_deployment(self, index: int, deployment: Deployment):
        gen = self._gen
        deployments = dict(gen.deployments)
        self._upsert_deployment_impl(deployments, index, deployment.copy())
        self._publish(
            index=index,
            deployments=deployments,
            table_indexes=self._bump(gen, index, "deployment"),
        )

    @staticmethod
    def _upsert_deployment_impl(deployments, index, deployment):
        existing = deployments.get(deployment.id)
        if existing is not None:
            deployment.create_index = existing.create_index
            deployment.modify_index = index
        else:
            deployment.create_index = index
            deployment.modify_index = index
        deployments[deployment.id] = deployment

    @_write_txn
    def update_deployment_status(self, index: int, update: DeploymentStatusUpdate):
        gen = self._gen
        deployments = dict(gen.deployments)
        jobs = dict(gen.jobs)
        versions = dict(gen.job_versions)
        stabilized = self._apply_deployment_update(
            deployments, jobs, versions, index, update
        )
        if stabilized:
            self._publish(
                index=index,
                deployments=deployments,
                jobs=jobs,
                job_versions=versions,
                table_indexes=self._bump(
                    gen, index, "deployment", "jobs", "job_version"
                ),
            )
        else:
            self._publish(
                index=index,
                deployments=deployments,
                table_indexes=self._bump(gen, index, "deployment"),
            )

    @classmethod
    def _apply_deployment_update(cls, deployments, jobs, versions, index, update):
        """Returns True when the jobs/job_versions tables were touched."""
        d = deployments.get(update.deployment_id)
        if d is None:
            return False
        d = d.copy()
        d.status = update.status
        d.status_description = update.status_description
        d.modify_index = index
        deployments[d.id] = d
        # A successful deployment marks its job version stable
        # (ref state_store.go updateDeploymentStatusImpl → UpdateJobStability)
        if update.status == DEPLOYMENT_STATUS_SUCCESSFUL:
            cls._stabilize_job_impl(
                jobs, versions, index, d.namespace, d.job_id, d.job_version, True
            )
            return True
        return False

    @staticmethod
    def _stabilize_job_impl(jobs, versions, index, namespace, job_id, version, stable):
        """Flip the stable flag on a job version in-transaction (shared by
        deployment success and explicit UpdateJobStability)."""
        vj = versions.get((namespace, job_id, version))
        if vj is not None:
            vj = vj.copy()
            vj.stable = stable
            vj.modify_index = index
            versions[(namespace, job_id, version)] = vj
        cur = jobs.get((namespace, job_id))
        if cur is not None and cur.version == version:
            cur = cur.copy()
            cur.stable = stable
            cur.modify_index = index
            jobs[(namespace, job_id)] = cur

    @_write_txn
    def update_deployment_promotion(
        self, index: int, deployment_id: str, groups: list[str], all_groups: bool
    ):
        """Promote canaries for the requested groups (ref state_store.go
        UpdateDeploymentPromotion): each promoted group needs at least one
        healthy canary; when no group still requires promotion the
        deployment returns to plain running."""
        gen = self._gen
        deployments = dict(gen.deployments)
        d = deployments.get(deployment_id)
        if d is None:
            raise KeyError(f"deployment not found: {deployment_id}")
        if not d.active():
            raise ValueError(f"deployment {deployment_id} is terminal")
        d = d.copy()

        healthy_canaries: dict[str, int] = {}
        for alloc in gen.allocs.values():
            if alloc.deployment_id != deployment_id:
                continue
            ds = alloc.deployment_status
            if ds is not None and ds.canary and ds.is_healthy():
                healthy_canaries[alloc.task_group] = (
                    healthy_canaries.get(alloc.task_group, 0) + 1
                )

        unhealthy_err = []
        for group_name, state in d.task_groups.items():
            if not all_groups and group_name not in groups:
                continue
            if state.desired_canaries == 0 or state.promoted:
                continue
            healthy = healthy_canaries.get(group_name, 0)
            if healthy < state.desired_canaries:
                unhealthy_err.append(
                    f'Task group "{group_name}" has {healthy}/'
                    f"{state.desired_canaries} healthy canaries"
                )
                continue
            state.promoted = True
        if unhealthy_err:
            raise ValueError("; ".join(unhealthy_err))

        if not d.requires_promotion():
            d.status_description = DEPLOYMENT_STATUS_DESC_RUNNING
        d.modify_index = index
        deployments[d.id] = d
        self._publish(
            index=index,
            deployments=deployments,
            table_indexes=self._bump(gen, index, "deployment"),
        )

    @_write_txn
    def update_deployment_alloc_health(
        self,
        index: int,
        deployment_id: str,
        healthy_ids: list[str],
        unhealthy_ids: list[str],
        timestamp_ns: int = 0,
    ):
        """Record alloc deployment health + bump the deployment's per-group
        healthy/unhealthy counters (ref state_store.go
        UpdateDeploymentAllocHealth)."""
        gen = self._gen
        deployments = dict(gen.deployments)
        d = deployments.get(deployment_id)
        if d is None:
            raise KeyError(f"deployment not found: {deployment_id}")
        if not d.active():
            raise ValueError(f"deployment {deployment_id} is terminal")
        d = d.copy()
        allocs_table = dict(gen.allocs)

        def mark(alloc_id: str, healthy: bool):
            alloc = allocs_table.get(alloc_id)
            if alloc is None or alloc.deployment_id != deployment_id:
                return
            alloc = alloc.copy()
            prev = (
                alloc.deployment_status.healthy
                if alloc.deployment_status is not None
                else None
            )
            if alloc.deployment_status is None:
                alloc.deployment_status = DeploymentStatus()
            alloc.deployment_status.healthy = healthy
            alloc.deployment_status.timestamp = timestamp_ns
            alloc.deployment_status.modify_index = index
            alloc.modify_index = index
            allocs_table[alloc_id] = alloc
            state = d.task_groups.get(alloc.task_group)
            if state is not None and prev != healthy:
                if healthy:
                    state.healthy_allocs += 1
                    if prev is False:
                        state.unhealthy_allocs -= 1
                else:
                    state.unhealthy_allocs += 1
                    if prev is True:
                        state.healthy_allocs -= 1

        for aid in healthy_ids:
            mark(aid, True)
        for aid in unhealthy_ids:
            mark(aid, False)

        d.modify_index = index
        deployments[d.id] = d
        self._publish(
            index=index,
            allocs=allocs_table,
            deployments=deployments,
            table_indexes=self._bump(gen, index, "allocs", "deployment"),
        )

    @_write_txn
    def update_job_stability(
        self, index: int, namespace: str, job_id: str, version: int, stable: bool
    ):
        """Flip the stable flag on a job version (ref state_store.go
        UpdateJobStability) — used by deployment auto-revert and
        `job revert`."""
        gen = self._gen
        versions = dict(gen.job_versions)
        jobs = dict(gen.jobs)
        self._stabilize_job_impl(
            jobs, versions, index, namespace, job_id, version, stable
        )
        self._publish(
            index=index,
            jobs=jobs,
            job_versions=versions,
            table_indexes=self._bump(gen, index, "jobs", "job_version"),
        )

    @_write_txn
    def delete_deployment(self, index: int, deployment_ids: list[str]):
        gen = self._gen
        deployments = dict(gen.deployments)
        for did in deployment_ids:
            deployments.pop(did, None)
        self._publish(
            index=index,
            deployments=deployments,
            table_indexes=self._bump(gen, index, "deployment"),
        )

    # ------------------------------------------------------------------
    # periodic launches / scheduler config
    # ------------------------------------------------------------------
    @_write_txn
    def upsert_periodic_launch(self, index: int, namespace: str, job_id: str, launch_ns: int):
        gen = self._gen
        launches = dict(gen.periodic_launch)
        launches[(namespace, job_id)] = {
            "namespace": namespace,
            "job_id": job_id,
            "launch": launch_ns,
            "modify_index": index,
        }
        self._publish(
            index=index,
            periodic_launch=launches,
            table_indexes=self._bump(gen, index, "periodic_launch"),
        )

    @_write_txn
    def upsert_vault_accessors(self, index: int, accessors: list[dict]):
        """ref state_store.go UpsertVaultAccessor"""
        gen = self._gen
        table = dict(gen.vault_accessors)
        for a in accessors:
            table[a["accessor"]] = dict(a, create_index=index)
        self._publish(
            index=index,
            vault_accessors=table,
            table_indexes=self._bump(gen, index, "vault_accessors"),
        )

    @_write_txn
    def delete_vault_accessors(self, index: int, accessors: list[str]):
        gen = self._gen
        drop = set(accessors)
        table = {
            k: v for k, v in gen.vault_accessors.items() if k not in drop
        }
        self._publish(
            index=index,
            vault_accessors=table,
            table_indexes=self._bump(gen, index, "vault_accessors"),
        )

    @_write_txn
    def upsert_acl_policies(self, index: int, policies: list):
        """ref state_store.go UpsertACLPolicies"""
        gen = self._gen
        table = dict(gen.acl_policies)
        for p in policies:
            policy = AclPolicy.from_dict(p) if isinstance(p, dict) else p
            existing = table.get(policy.name)
            policy.create_index = (
                existing.create_index if existing is not None else index
            )
            policy.modify_index = index
            table[policy.name] = policy
        self._publish(
            index=index,
            acl_policies=table,
            table_indexes=self._bump(gen, index, "acl_policy"),
        )

    @_write_txn
    def delete_acl_policies(self, index: int, names: list[str]):
        gen = self._gen
        table = {k: v for k, v in gen.acl_policies.items() if k not in set(names)}
        self._publish(
            index=index,
            acl_policies=table,
            table_indexes=self._bump(gen, index, "acl_policy"),
        )

    @_write_txn
    def upsert_acl_tokens(self, index: int, tokens: list, bootstrap: bool = False):
        """ref state_store.go UpsertACLTokens; ``bootstrap`` also stamps the
        one-shot bootstrap marker (BootstrapACLTokens' index record)."""
        gen = self._gen
        table = dict(gen.acl_tokens)
        for t in tokens:
            token = AclToken.from_dict(t) if isinstance(t, dict) else t
            existing = table.get(token.accessor_id)
            token.create_index = (
                existing.create_index if existing is not None else index
            )
            token.modify_index = index
            table[token.accessor_id] = token
        bumped = ("acl_token", "acl_bootstrap") if bootstrap else ("acl_token",)
        self._publish(
            index=index,
            acl_tokens=table,
            table_indexes=self._bump(gen, index, *bumped),
        )

    @_write_txn
    def delete_acl_tokens(self, index: int, accessors: list[str]):
        gen = self._gen
        table = {
            k: v for k, v in gen.acl_tokens.items() if k not in set(accessors)
        }
        self._publish(
            index=index,
            acl_tokens=table,
            table_indexes=self._bump(gen, index, "acl_token"),
        )

    @_write_txn
    def set_scheduler_config(self, index: int, config: dict):
        gen = self._gen
        self._publish(
            index=index,
            scheduler_config=dict(config),
            table_indexes=self._bump(gen, index, "scheduler_config"),
        )

    @_write_txn
    def set_autopilot_config(self, index: int, config: dict):
        gen = self._gen
        self._publish(
            index=index,
            autopilot_config=dict(config),
            table_indexes=self._bump(gen, index, "autopilot_config"),
        )

    # ------------------------------------------------------------------
    # plan apply (the atomic commit; ref state_store.go:227)
    # ------------------------------------------------------------------
    @_write_txn
    def upsert_plan_results(self, index: int, plan: Plan, result: PlanResult,
                            preemption_evals: Optional[list[Evaluation]] = None):
        """Atomically apply a verified plan result."""
        gen = self._gen
        allocs_table = dict(gen.allocs)
        summaries = dict(gen.job_summaries)
        deployments = dict(gen.deployments)
        evals_table = dict(gen.evals)
        jobs_table = dict(gen.jobs)
        versions_table = dict(gen.job_versions)
        jobs_touched: dict[tuple[str, str], str] = {}

        if result.deployment is not None:
            self._upsert_deployment_impl(deployments, index, result.deployment.copy())
        for update in result.deployment_updates:
            self._apply_deployment_update(
                deployments, jobs_table, versions_table, index, update
            )

        if plan.eval_id and plan.eval_id in evals_table:
            ev = evals_table[plan.eval_id].copy()
            ev.modify_index = index
            evals_table[plan.eval_id] = ev

        to_upsert: list[Allocation] = []
        for allocs in result.node_update.values():
            to_upsert.extend(allocs)
        for allocs in result.node_allocation.values():
            to_upsert.extend(allocs)
        for allocs in result.node_preemptions.values():
            to_upsert.extend(allocs)

        for a in to_upsert:
            a = self._fast_alloc_clone(a)
            # Re-attach the job pulled out of the plan payload
            if a.job is None:
                a.job = plan.job
            stored = self._upsert_alloc_impl(
                gen, allocs_table, summaries, deployments, index, a, jobs_touched
            )
            self.planes.apply_alloc(stored)

        for ev in preemption_evals or []:
            self._nested_upsert_eval(gen, evals_table, index, ev.copy(), jobs_touched)

        jobs = self._set_job_statuses(
            jobs_table, allocs_table, evals_table, index, jobs_touched
        )
        self._publish(
            index=index,
            allocs=allocs_table,
            jobs=jobs,
            job_versions=versions_table,
            evals=evals_table,
            job_summaries=summaries,
            deployments=deployments,
            table_indexes=self._bump(
                gen, index, "allocs", "jobs", "job_version", "evals",
                "job_summary", "deployment"
            ),
        )
        return index

    # ------------------------------------------------------------------
    # whole-store persistence (ref nomad/fsm.go:1059 Snapshot / :1073
    # Restore — the FSM serializes every table into the raft snapshot)
    # ------------------------------------------------------------------
    def persist(self) -> dict:
        """Serialize the current generation into a plain (msgpack-able)
        dict. Tuple-keyed tables are emitted as object lists; keys are
        rebuilt on restore."""
        gen = self._gen
        return {
            "index": gen.index,
            "nodes": [n.to_dict() for n in gen.nodes.values()],
            "jobs": [j.to_dict() for j in gen.jobs.values()],
            "job_versions": [j.to_dict() for j in gen.job_versions.values()],
            "job_summaries": [s.to_dict() for s in gen.job_summaries.values()],
            "evals": [e.to_dict() for e in gen.evals.values()],
            "allocs": [a.to_dict() for a in gen.allocs.values()],
            "deployments": [d.to_dict() for d in gen.deployments.values()],
            "periodic_launch": list(gen.periodic_launch.values()),
            "scheduler_config": gen.scheduler_config,
            "autopilot_config": gen.autopilot_config,
            "acl_policies": [p.to_dict() for p in gen.acl_policies.values()],
            "acl_tokens": [t.to_dict() for t in gen.acl_tokens.values()],
            "vault_accessors": list(gen.vault_accessors.values()),
            "table_indexes": dict(gen.table_indexes),
            # the committed dense planes ride the same snapshot: restore
            # installs them instead of cold-rebuilding O(N + A) state
            "planes": self.planes.persist_for(gen),
        }

    def restore(self, data: dict):
        """Replace all tables with the persisted snapshot (ref fsm.go:1073
        Restore: blows away current state, installs the snapshot)."""
        with self._write_mutex:
            gen = Generation(
                index=data.get("index", 0),
                nodes={
                    n.id: n
                    for n in (Node.from_dict(d) for d in data.get("nodes", []))
                },
                jobs={
                    (j.namespace, j.id): j
                    for j in (Job.from_dict(d) for d in data.get("jobs", []))
                },
                job_versions={
                    (j.namespace, j.id, j.version): j
                    for j in (Job.from_dict(d) for d in data.get("job_versions", []))
                },
                job_summaries={
                    (s.namespace, s.job_id): s
                    for s in (
                        JobSummary.from_dict(d)
                        for d in data.get("job_summaries", [])
                    )
                },
                evals={
                    e.id: e
                    for e in (
                        Evaluation.from_dict(d) for d in data.get("evals", [])
                    )
                },
                allocs={
                    a.id: a
                    for a in (
                        Allocation.from_dict(d) for d in data.get("allocs", [])
                    )
                },
                deployments={
                    d.id: d
                    for d in (
                        Deployment.from_dict(x) for x in data.get("deployments", [])
                    )
                },
                periodic_launch={
                    (pl["namespace"], pl["job_id"]): pl
                    for pl in data.get("periodic_launch", [])
                },
                scheduler_config=data.get("scheduler_config"),
                autopilot_config=data.get("autopilot_config"),
                acl_policies={
                    p.name: p
                    for p in (
                        AclPolicy.from_dict(d)
                        for d in data.get("acl_policies", [])
                    )
                },
                acl_tokens={
                    t.accessor_id: t
                    for t in (
                        AclToken.from_dict(d) for d in data.get("acl_tokens", [])
                    )
                },
                vault_accessors={
                    a["accessor"]: a for a in data.get("vault_accessors", [])
                },
                table_indexes=dict(data.get("table_indexes", {})),
            )
            # stage the snapshot's planes for installation at the publish
            # below (an old snapshot without them cold-rebuilds instead)
            self.planes.stage_restore(data.get("planes"))
            self._publish(**{f: getattr(gen, f) for f in (
                "index", "nodes", "jobs", "job_versions", "job_summaries",
                "evals", "allocs", "deployments", "periodic_launch",
                "scheduler_config", "autopilot_config",
                "acl_policies", "acl_tokens",
                "vault_accessors", "table_indexes",
            )})
