"""Columnar mirror of cluster state for the batched kernel.

Extracts device-friendly arrays from a state snapshot: int32 capacity/usage
matrices, per-task-group boolean feasibility rows (evaluated once per
computed node class — the same memoization the reference uses in
feasible.go:787), static affinity score planes, and spread value tables.
String-world constraint evaluation happens here, host-side, exactly once per
(task group, node class); the device only ever sees dense numerics.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

from ..scheduler.context import EvalContext
from ..scheduler.feasible import (
    ConstraintChecker,
    DeviceChecker,
    DriverChecker,
    HostVolumeChecker,
)
from ..scheduler.rank import matches_affinity
from ..scheduler.propertyset import get_property
from ..scheduler.stack import task_group_constraints
from ..structs.model import Job, Node, TaskGroup
from ..structs.node_class import escaped_constraints

# spread sentinel indices
NO_VALUE = -1


@dataclass
class GroupPlanes:
    """Per-task-group static planes."""

    name: str
    feasible: np.ndarray  # bool[N]
    affinity: np.ndarray  # f32[N]
    affinity_present: np.ndarray  # bool[N]
    count: int = 1
    # spread (at most one attribute in the fast path; more → fallback)
    node_value: Optional[np.ndarray] = None  # i32[N] value ids, NO_VALUE if missing
    desired: Optional[np.ndarray] = None  # f32[V]; -1 = absent
    implicit: float = -1.0
    weight_frac: float = 0.0
    even: bool = False
    values: list[str] = field(default_factory=list)
    counts0: Optional[np.ndarray] = None  # i32[V]
    present0: Optional[np.ndarray] = None  # bool[V]


#: small LRU of (nodes_table_index, node-identity fingerprint, cluster),
#: bounded by estimated BYTE size, not entry count — four 10K-node
#: clusters whose planes caches each hold hundreds of per-group rows can
#: pin hundreds of MB, while dozens of toy-cluster entries are harmless
_SHARED_CLUSTERS: list = []
_SHARED_CLUSTERS_MAX_BYTES = (
    int(os.environ.get("NOMAD_TPU_CLUSTER_CACHE_MB", "256")) << 20
)
#: secondary guard so thousands of byte-tiny toy clusters (test suites)
#: can't make the lookup scan linear-slow
_SHARED_CLUSTERS_MAX_ENTRIES = 64


def _cluster_nbytes(cluster: "ColumnarCluster") -> int:
    """Estimated resident bytes of one cached cluster: the dense node-axis
    arrays plus everything its planes/device caches accumulated (those
    grow per (job version, group) and dominate on busy clusters)."""
    total = (
        cluster.capacity.nbytes
        + cluster.reserved.nbytes
        + cluster.usable.nbytes
        + cluster.single_nic.nbytes
    )
    try:
        # other scheduler threads insert into these caches concurrently;
        # a torn iteration just under-estimates this sweep — it's a size
        # heuristic, not an inventory
        for planes in list(cluster.planes_cache.values()):
            for arr in (
                planes.feasible, planes.affinity, planes.affinity_present,
                planes.node_value, planes.desired, planes.counts0,
                planes.present0,
            ):
                if arr is not None:
                    total += arr.nbytes
        for entry in list(cluster.device_planes_cache.values()):
            total += entry[0].nbytes
    except RuntimeError:
        pass
    return total


# R_COLS and the per-node row derivations live with the committed planes
# (state/planes.py) — the single definition shared with the state store's
# in-commit plane maintenance, so the two can never disagree on a column
from ..state.planes import R_COLS, node_capacity_row, node_reserved_row


class ColumnarCluster:
    """Dense arrays for a set of candidate nodes."""

    def __init__(self, nodes: list[Node]):
        self.nodes = nodes
        self.index = {n.id: i for i, n in enumerate(nodes)}
        n = len(nodes)
        self.capacity = np.zeros((n, R_COLS), dtype=np.int64)
        self.reserved = np.zeros((n, R_COLS), dtype=np.int64)
        for i, node in enumerate(nodes):
            self.capacity[i] = node_capacity_row(node)
            self.reserved[i] = node_reserved_row(node)
        # Scoring denominators (ScoreFit: total - reserved; funcs.go:160-165)
        self.usable = (self.capacity[:, :2] - self.reserved[:, :2]).astype(np.float32)
        # AssignNetwork enforces bandwidth PER DEVICE; the dense sum is
        # exact only for single-NIC nodes. Network-asking groups mask
        # multi-NIC nodes out of kernel feasibility (conservative: the
        # oracle may still use them via its per-device accounting).
        self.single_nic = np.array(
            [
                sum(1 for net in n.node_resources.networks if net.device) <= 1
                for n in nodes
            ],
            dtype=bool,
        )
        # per-(job version, group) feasibility/affinity/spread planes —
        # valid for this cluster's exact node set (see build_group_planes)
        self.planes_cache: dict = {}
        # per-ask-ID dense device capacity planes (see device_plane)
        # nta: ignore[unbounded-cache] WHY: per-cluster cache; the
        # _SHARED_CLUSTERS byte-cap evicts whole clusters, bounding it
        self.device_planes_cache: dict = {}

    @classmethod
    def shared(cls, state, nodes: list[Node]) -> "ColumnarCluster":
        """Cross-eval cluster cache — the incremental columnar mirror
        (SURVEY §7: avoid re-materializing 10K-node matrices per eval).

        Keyed by the nodes-table index plus the identity fingerprint of the
        node list: COW generations republish unchanged Node objects, so an
        identical fingerprint under an identical table index proves the
        candidate set is byte-for-byte the one the cached arrays were built
        from (the cached cluster pins the node objects, so their ids can't
        be reused while the entry lives). Any node change bumps the table
        index and rebuilds."""
        key = state.table_index("nodes")
        fingerprint = tuple(map(id, nodes))
        for entry in _SHARED_CLUSTERS:
            if entry[0] == key and entry[1] == fingerprint:
                return entry[2]
        cluster = cls(nodes)
        _SHARED_CLUSTERS.insert(0, (key, fingerprint, cluster))
        # evict by estimated byte size from the LRU tail (the newest entry
        # always survives, even when it alone exceeds the budget)
        total = 0
        cut = min(len(_SHARED_CLUSTERS), _SHARED_CLUSTERS_MAX_ENTRIES)
        for i, entry in enumerate(_SHARED_CLUSTERS[:cut]):
            total += _cluster_nbytes(entry[2])
            if total > _SHARED_CLUSTERS_MAX_BYTES and i > 0:
                cut = i
                break
        del _SHARED_CLUSTERS[cut:]
        return cluster

    @staticmethod
    def sum_alloc_usage(allocs, into=None) -> np.ndarray:
        """Σ (cpu, memory_mb, disk_mb) over non-terminal allocs — THE
        resource accumulation (AllocsFit's summation, funcs.go:104-117);
        single definition shared by the plane builders and the fallback
        recompute paths."""
        used = into if into is not None else np.zeros(R_COLS, dtype=np.int64)
        for a in allocs:
            if a.allocated_resources is None:
                continue
            c = a.comparable_cached()
            used[0] += c.flattened.cpu.cpu_shares
            used[1] += c.flattened.memory.memory_mb
            used[2] += c.shared.disk_mb
            # bandwidth (NetworkIndex.AddAllocs' used-bandwidth sum)
            res = a.allocated_resources
            for tr in res.tasks.values():
                for net in tr.networks:
                    used[3] += net.mbits
            for net in res.shared.networks:
                used[3] += net.mbits
        return used

    def _live_allocs_by_node(self, state) -> dict[str, list]:
        """One pass over the alloc table bucketing non-terminal allocs by
        node (allocs_by_node_terminal is O(total allocs) PER CALL, which
        made the plane builds quadratic on loaded clusters). Cached per
        state generation — generations are copy-on-write and immutable
        after publication, so holding the gen object and comparing by
        identity is sound (the held reference also pins it against id
        reuse)."""
        gen = getattr(state, "_gen", state)
        cached = getattr(self, "_live_cache", None)
        if cached is not None and cached[0] is gen:
            return cached[1]
        buckets: dict[str, list] = {n.id: [] for n in self.nodes}
        for a in state.allocs():
            if a.node_id in buckets and not a.terminal_status():
                buckets[a.node_id].append(a)
        self._live_cache = (gen, buckets)
        return buckets

    def initial_used(self, state, plan=None) -> np.ndarray:
        """used = reserved + Σ non-terminal alloc resources per node (the
        accumulation AllocsFit performs per check, funcs.go:104-117),
        including any plan overlays."""
        used = self.reserved.copy()
        by_node = self._live_allocs_by_node(state)
        for i, node in enumerate(self.nodes):
            allocs = by_node[node.id]
            if plan is not None:
                from ..structs.model import remove_allocs

                update = plan.node_update.get(node.id, [])
                if update:
                    allocs = remove_allocs(allocs, update)
            self.sum_alloc_usage(allocs, into=used[i])
        return used

    def device_plane(self, ask) -> tuple[np.ndarray, list, bool]:
        """Dense device capacity for one constraint-free ask: per node, the
        count of healthy instances in device groups whose ID matches the
        ask (feasible.go:1007-1012 ID match only — constraint-bearing asks
        never reach this path), plus per-node {matching DeviceIdTuple →
        healthy instance-id set} for the usage counter. Also returns
        whether any node has MORE THAN ONE matching group: the summed
        column is exact there only for count-1 asks (total free ≥ 1 ⇒ some
        single group has a free instance), while assign_device requires all
        ``count`` instances from one group — multi-instance asks on such
        clusters must escape to the oracle. Cached per cluster by the
        ask's ID tuple; node devices are static for the cluster's life."""
        key = ask.device_id()
        cached = self.device_planes_cache.get(key)
        if cached is not None:
            return cached
        n = len(self.nodes)
        capacity = np.zeros(n, dtype=np.int32)
        match_sets: list = [None] * n
        multi_group = False
        for i, node in enumerate(self.nodes):
            res = node.node_resources
            if res is None or not res.devices:
                continue
            matched = None
            total = 0
            for dev in res.devices:
                if not dev.device_id().matches(key):
                    continue
                if matched is None:
                    matched = {}
                elif dev.device_id() not in matched:
                    multi_group = True
                healthy = {
                    inst.id for inst in dev.instances if inst.healthy
                }
                matched.setdefault(dev.device_id(), set()).update(healthy)
                total += len(healthy)
            capacity[i] = total
            match_sets[i] = matched
        self.device_planes_cache[key] = (capacity, match_sets, multi_group)
        return capacity, match_sets, multi_group

    def device_used(self, state, match_sets: list, plan=None) -> np.ndarray:
        """Per-node count of matching HEALTHY device instances consumed by
        live allocs (DeviceAccounter.add_allocs' accounting, devices.go:
        35-55 — instances held on now-unhealthy devices don't count, since
        the accounter drops them from its table and the capacity column
        above counts healthy only), minus any plan-stopped allocs and plus
        the plan's earlier grants."""
        used = np.zeros(len(self.nodes), dtype=np.int32)
        by_node = self._live_allocs_by_node(state)

        def count(alloc, i) -> int:
            res = alloc.allocated_resources
            if res is None:
                return 0
            c = 0
            for tr in res.tasks.values():
                for dr in tr.devices:
                    healthy = match_sets[i].get(dr.device_id())
                    if healthy:
                        c += sum(1 for iid in dr.device_ids if iid in healthy)
            return c

        for i, node in enumerate(self.nodes):
            if match_sets[i] is None:
                continue
            allocs = by_node[node.id]
            if plan is not None:
                from ..structs.model import remove_allocs

                update = plan.node_update.get(node.id, [])
                if update:
                    allocs = remove_allocs(allocs, update)
            for a in allocs:
                used[i] += count(a, i)
            if plan is not None:
                for a in plan.node_allocation.get(node.id, []):
                    used[i] += count(a, i)
        return used

    def collision_counts(self, state, job_id: str, tg_name: str) -> np.ndarray:
        """Existing same-job/same-group alloc counts per node (the
        JobAntiAffinityIterator's collision input, rank.go:498-505)."""
        counts = np.zeros(len(self.nodes), dtype=np.int32)
        by_node = self._live_allocs_by_node(state)
        for i, node in enumerate(self.nodes):
            for a in by_node[node.id]:
                if a.job_id == job_id and a.task_group == tg_name:
                    counts[i] += 1
        return counts


def kernel_supported(
    job: Job,
    tg: TaskGroup,
    allow_networks: bool = False,
    allow_devices: bool = False,
) -> bool:
    """Whether the fast kernel covers this group; anything else falls back
    to the scalar oracle (distinct_*, sticky disk, multi-spread).

    With ``allow_networks`` (the tpu-batch path), network asks ride the
    kernel too: bandwidth is the 4th dense resource column and DYNAMIC
    ports are assigned host-side after node choice (SURVEY §7's port
    post-pass). Reserved-port asks still fall back — their collisions
    constrain node choice itself, which the dense planes don't model.

    With ``allow_devices``, constraint- and affinity-free device asks ride
    the kernel as an eval-local 5th resource column (free matching
    instances per node; SURVEY §7's device post-pass assigns concrete
    instance IDs host-side on the winner). Asks with device constraints or
    affinities fall back — they filter/score per device *group*, which one
    dense count column can't express (ref scheduler/device.go:40-131)."""
    if tg.networks:
        return False
    for task in tg.tasks:
        for dev in task.resources.devices:
            if not allow_devices:
                return False
            if dev.constraints or dev.affinities:
                return False
        nets = task.resources.networks
        if nets and not allow_networks:
            return False
        if len(nets) > 1:
            return False
        for net in nets:
            if net.reserved_ports:
                return False
    if tg.ephemeral_disk.sticky:
        return False
    constraints = list(job.constraints) + list(tg.constraints)
    for task in tg.tasks:
        constraints.extend(task.constraints)
    for c in constraints:
        if c.operand in ("distinct_hosts", "distinct_property"):
            return False
    spreads = list(job.spreads) + list(tg.spreads)
    if len(spreads) > 1:
        return False
    return True


def build_group_planes(
    ctx: EvalContext,
    cluster: ColumnarCluster,
    state,
    job: Job,
    tg: TaskGroup,
) -> GroupPlanes:
    """Evaluate the string-world checks into dense planes, memoizing
    feasibility by computed node class — and memoizing the finished static
    planes per (job version, group) on the cluster, so repeat evals of an
    unchanged job skip the O(N) python sweeps entirely. Spread's existing-
    alloc counts (counts0/present0) are state-dependent and recomputed on
    every call."""
    cache_key = (
        job.namespace,
        job.id,
        job.modify_index,
        job.version,
        tg.name,
        tg.count,
    )
    cached = cluster.planes_cache.get(cache_key)
    if cached is not None:
        return _attach_spread_counts(cached, state, job, tg)
    nodes = cluster.nodes
    n = len(nodes)

    job_checker = ConstraintChecker(ctx, job.constraints)
    constraints, drivers = task_group_constraints(tg)
    tg_checkers = [
        DriverChecker(ctx, drivers),
        ConstraintChecker(ctx, constraints),
        HostVolumeChecker(ctx),
        DeviceChecker(ctx),
    ]
    tg_checkers[2].set_volumes(tg.volumes)
    tg_checkers[3].set_task_group(tg)

    # class-level memoization; escaped constraints force per-node checks
    escaped = bool(
        escaped_constraints(list(job.constraints) + constraints)
    )
    cache: dict[str, bool] = {}
    elig = ctx.get_eligibility()
    feasible = np.zeros(n, dtype=bool)
    for i, node in enumerate(nodes):
        key = node.computed_class
        if not escaped and key in cache:
            feasible[i] = cache[key]
            continue
        ok = job_checker.feasible(node) and all(
            c.feasible(node) for c in tg_checkers
        )
        feasible[i] = ok
        if not escaped:
            cache[key] = ok
            elig.set_job_eligibility(job_checker.feasible(node), key)
            elig.set_task_group_eligibility(ok, tg.name, key)

    # static affinity plane (rank.go:619-646)
    affinities = list(job.affinities) + list(tg.affinities)
    for task in tg.tasks:
        affinities.extend(task.affinities)
    affinity = np.zeros(n, dtype=np.float32)
    affinity_present = np.zeros(n, dtype=bool)
    if affinities:
        sum_weight = sum(abs(float(a.weight)) for a in affinities)
        for i, node in enumerate(nodes):
            total = 0.0
            for a in affinities:
                if matches_affinity(ctx, a, node):
                    total += float(a.weight)
            if total != 0.0:
                affinity[i] = total / sum_weight
                affinity_present[i] = True

    planes = GroupPlanes(
        name=tg.name,
        feasible=feasible,
        affinity=affinity,
        affinity_present=affinity_present,
        count=tg.count,
    )

    # spread planes (spread.go:110-257); single attribute in the fast path
    spreads = list(tg.spreads) + list(job.spreads)
    if spreads:
        spread = spreads[0]
        sum_weights = sum(s.weight for s in spreads)
        planes.weight_frac = float(spread.weight) / float(sum_weights)
        values: dict[str, int] = {}
        node_value = np.full(n, NO_VALUE, dtype=np.int32)
        for i, node in enumerate(nodes):
            val, ok = get_property(node, spread.attribute)
            if not ok:
                continue
            if val not in values:
                values[val] = len(values)
            node_value[i] = values[val]

        total_count = tg.count
        if spread.spread_target:
            desired_map = {}
            sum_desired = 0.0
            for st in spread.spread_target:
                desired_count = (float(st.percent) / 100.0) * float(total_count)
                desired_map[st.value] = desired_count
                sum_desired += desired_count
                if st.value not in values:
                    values[st.value] = len(values)
            if 0 < sum_desired < float(total_count):
                planes.implicit = float(total_count) - sum_desired
            desired = np.full(len(values), -1.0, dtype=np.float32)
            for val, dc in desired_map.items():
                desired[values[val]] = dc
            planes.desired = desired
        else:
            planes.even = True
            planes.desired = np.full(max(len(values), 1), -1.0, dtype=np.float32)

        # re-size node_value table if targets introduced new values
        planes.node_value = node_value
        planes.values = list(values)
    if len(cluster.planes_cache) > 256:
        cluster.planes_cache.clear()
    cluster.planes_cache[cache_key] = planes
    return _attach_spread_counts(planes, state, job, tg)


def _attach_spread_counts(static: GroupPlanes, state, job, tg) -> GroupPlanes:
    """Overlay the state-dependent spread inputs onto cached static planes:
    existing per-value alloc counts for this TG's job (propertyset
    semantics). Returns a shallow copy so the cached template stays
    state-free; no-spread groups are fully static and shared as-is."""
    if static.node_value is None:
        return static
    spreads = list(tg.spreads) + list(job.spreads)
    spread = spreads[0]
    values = {v: i for i, v in enumerate(static.values)}
    counts0 = np.zeros(max(len(values), 1), dtype=np.int32)
    present0 = np.zeros(max(len(values), 1), dtype=bool)
    for a in state.allocs_by_job(job.namespace, job.id):
        if a.terminal_status() or a.task_group != tg.name:
            continue
        node = state.node_by_id(a.node_id)
        val, ok = get_property(node, spread.attribute)
        if ok and val in values:
            counts0[values[val]] += 1
            present0[values[val]] = True
    planes = replace(static, counts0=counts0, present0=present0)
    return planes


def compute_limit(num_nodes: int, batch: bool, has_affinity_or_spread: bool) -> int:
    """Candidate-scan bound (ref stack.go:74-87, :148-150)."""
    if has_affinity_or_spread:
        return 2**31 - 1
    limit = 2
    if not batch and num_nodes > 0:
        log_limit = int(math.ceil(math.log2(num_nodes)))
        if log_limit > limit:
            limit = log_limit
    return limit
