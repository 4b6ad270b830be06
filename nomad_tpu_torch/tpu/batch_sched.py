"""The ``tpu-batch`` scheduler: a drop-in GenericScheduler whose placement
loop runs on the port's planners (``planner.launch_eval``: the exact scan,
the run planner, the windowed planner, the wavefront and the paged route,
each a hand-written CUDA kernel on the card and its plain PyTorch version
on the CPU).

The port's copy of ``nomad_tpu/tpu/batch_sched.py``. Registered in the
factory map alongside service/batch (scheduler/scheduler.py). The
reconciler, plan bookkeeping, blocked evals and retries are shared with
the oracle; only computePlacements (generic_sched.go:426-566) is replaced —
the per-alloc Select walk becomes one planner call over all pending
placements. Anything the kernel does not model (reserved ports,
distinct_* constraints, reschedules with penalty nodes, sticky disk,
destructive updates) transparently falls back to the scalar oracle path,
so behavior is complete while the hot path is dense.

The planners run on ``device`` (CUDA unless the caller passes ``"cpu"``;
without a card a kernel-sized eval raises). The only degrade is explicit:
a ``KernelFault`` (a wrapper's refusal of an input its kernel does not
take, or an error injected at the ``tpu.kernel`` fault point) replans the
eval on the exact-np host oracle, counted in
``scheduler.kernel_fault_degrade``; a CUDA build, launch or sync error
propagates and fails the eval. A solo eval's planner runs inside an
``eval.plan_kernel`` span tagged with its mode and its device ledger
entry. Under an active mesh (``tpu/shard.py``) the planner runs over
the node axis split into shards (``planner.launch_eval``); the span and
the stats carry the shard count, as the JAX scheduler's do.

Preemption semantics are preserved without a device-side pick: at this
reference version only the SYSTEM scheduler preempts (service/batch
preemption was enterprise-gated, stack.go:231).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np

from .. import metrics
from ..scheduler.feasible import shuffle_nodes
from ..scheduler.generic import GenericScheduler
from ..structs.model import (
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_STATUS_RUN,
    AllocatedCpuResources,
    AllocatedMemoryResources,
    AllocatedResources,
    AllocatedSharedResources,
    AllocatedTaskResources,
    Allocation,
    AllocMetric,
    DesiredTransition,
    generate_uuids,
)
from . import planner as _planner
from .columnar import (
    R_COLS,
    ColumnarCluster,
    build_group_planes,
    compute_limit,
    kernel_supported,
)
from .kernel import KernelFault


logger = logging.getLogger("nomad_tpu_torch.tpu.batch_sched")


_ALLOC_CLASS_DEFAULTS: Optional[dict] = None


def _compact_template(d: dict) -> dict:
    """Drop template keys whose value equals the Allocation class-level
    default (dataclass scalar defaults live on the class, so attribute
    lookup still returns them; default_factory fields have no class
    attribute and are always kept). Shrinks the per-alloc __dict__ copy.
    Semantics are unchanged for every read path — to_dict/copy/eq iterate
    dataclass fields via getattr, and any setattr simply shadows the class
    default in the instance dict."""
    global _ALLOC_CLASS_DEFAULTS
    if _ALLOC_CLASS_DEFAULTS is None:
        from dataclasses import fields

        defaults = {}
        for f in fields(Allocation):
            if hasattr(Allocation, f.name):
                defaults[f.name] = getattr(Allocation, f.name)
        _ALLOC_CLASS_DEFAULTS = defaults
    defaults = _ALLOC_CLASS_DEFAULTS
    out = {}
    miss = _MISS
    for k, v in d.items():
        dv = defaults.get(k, miss)
        if dv is miss or dv != v:
            out[k] = v
    return out


_MISS = object()

#: the device ledger's planner name of each launch mode
_PLANNER_OF_MODE = {"runs": "runs", "windowed": "windowed", "paged": "paged",
                    "exact-scan": "exact", "wavefront": "wavefront"}


def _tag_device_span(span, planner: str, mode: str):
    """Stamp a solo eval.plan_kernel span with the dispatched mode and
    the launch's device ledger tags (none today: a hand-written kernel
    has no cost figures and one device no collective census)."""
    from ..debug import devprof

    span.set_tag("mode", mode)
    for k, v in devprof.dispatch_tags(planner).items():
        span.set_tag(k, v)


def _to_host(x) -> np.ndarray:
    """Placements or a usage plane as numpy: the sync point of a device
    tensor handed back by the drain collector (an error there propagates).
    A usage base split over a mesh comes back as one array, its slabs in
    shard order, as the JAX consumer's ``np.asarray`` gathers it."""
    from .shard import Sharded

    if isinstance(x, Sharded):
        return np.concatenate([_to_host(t) for t in x.slabs], axis=x.axis)
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


#: timing of the most recent kernel invocation, for the benchmark harness.
#: On the planner path: ``columnar_s`` (cluster, planes, shuffle);
#: ``dispatch_s`` from the planes to the synced placements (padding,
#: upload, launch, the overlapped template and id build, the sync);
#: within it ``kernel_s``, the planner from launch to sync, and
#: ``device_s``, its launches by CUDA events on the card (None on the
#: CPU); ``materialize_s`` after the sync
# nta: ignore[unbounded-cache] WHY: fixed stat-name keys, overwritten
# per invocation (update/[k]= on a handful of literal keys)
LAST_KERNEL_STATS: dict = {}

#: cumulative kernel-vs-oracle routing counts (surfaced at /v1/metrics so
#: operators can see what fraction of production evals actually ride the
#: TPU path, and why the rest fall back; VERDICT r1 weak #10)
SCHED_COUNTERS: dict = {
    "kernel_evals": 0,
    "fallback_evals": 0,
    "drain_evals": 0,
    "modes": {},  # runs / windowed / exact-scan counts
    "fallback_reasons": {},
}


import threading as _threading

_COUNTER_LOCK = _threading.Lock()


def _count_fallback(reason: str):
    with _COUNTER_LOCK:
        SCHED_COUNTERS["fallback_evals"] += 1
        reasons = SCHED_COUNTERS["fallback_reasons"]
        reasons[reason] = reasons.get(reason, 0) + 1


def _count_mode(mode: str):
    with _COUNTER_LOCK:
        modes = SCHED_COUNTERS["modes"]
        modes[mode] = modes.get(mode, 0) + 1


def _count_kernel(drain: bool = False):
    with _COUNTER_LOCK:
        SCHED_COUNTERS["kernel_evals"] += 1
        if drain:
            SCHED_COUNTERS["drain_evals"] += 1


def counters_snapshot() -> dict:
    """Deep-copied, lock-consistent view for the metrics endpoint (the
    nested dicts grow from worker threads)."""
    with _COUNTER_LOCK:
        snap = dict(SCHED_COUNTERS)
        snap["modes"] = dict(SCHED_COUNTERS["modes"])
        snap["fallback_reasons"] = dict(SCHED_COUNTERS["fallback_reasons"])
        return snap

#: when True, skip the runs/windowed fast paths and use the exact
#: sequential-scan kernel for every placement. The benchmark flips this to
#: measure fast-path parity at full scale (the exact scan is the
#: one-step-per-placement program validated against the scalar oracle).
EXACT_ONLY = False

#: solo evals at or below this many placements use the scalar oracle
#: (device-launch latency dominates tiny problems); 0 disables the gate
SMALL_EVAL_ORACLE_MAX = int(os.environ.get("NOMAD_TPU_SMALL_EVAL_MAX", "8"))


class TPUBatchScheduler(GenericScheduler):
    """GenericScheduler with the batched placement kernel."""

    def __init__(self, state, planner, rng=None, batch: bool = False, device=None):
        super().__init__(state, planner, batch=batch, rng=rng)
        #: the planners' device (``nomad_tpu_torch.resolve_device``)
        self.device = device
        # when set, the first placement pass routes through the multi-eval
        # drain collector (tpu/drain.py); refresh retries run solo
        self.drain_collector = None
        # when True (the "oracle-np" factory), every placement runs the
        # float64 numpy exact stepper instead of the device kernel — the
        # vectorized oracle for bench parity windows (tpu/exact_np.py)
        self.exact_numpy = False

    # ------------------------------------------------------------------
    def _batchable(self, destructive: list, place: list) -> bool:
        """Whether this eval's placements can join a fused kernel batch:
        fresh placements only, kernel-supported groups, and no plan overlays
        (stopped/lost allocs would make the shared usage plane wrong)."""
        if destructive or not place:
            return False
        if any(p.previous_alloc is not None or p.canary for p in place):
            return False
        groups = {p.task_group.name: p.task_group for p in place}
        if not all(
            kernel_supported(self.job, tg, allow_networks=True)
            for tg in groups.values()
        ):
            return False
        if self.plan.node_update:
            return False
        return True

    # ------------------------------------------------------------------
    def _compute_placements(self, destructive: list, place: list):
        collector = self.drain_collector
        if collector is not None:
            self.drain_collector = None
            if self._batchable(destructive, place):
                prep = self._prepare_drain(place, collector.shared)
                if prep is not None:
                    eligible = np.zeros(len(collector.shared.nodes), dtype=bool)
                    eligible[prep.perm_eligible] = True
                    try:
                        # placements/used0 are device tensors handed back at
                        # dispatch; _materialize's _to_host is the sync
                        # point, overlapping template/id prep with device
                        # compute. A batch refused by a kernel wrapper
                        # raises KernelFault in every parked eval.
                        placements, used0 = collector.submit(prep)
                        self._materialize(
                            place,
                            placements,
                            collector.shared.nodes,
                            prep.by_dc,
                            prep.planes_list,
                            prep.g_index,
                            prep.gid_real,
                            used0,
                            collector.shared.capacity,
                            prep.g_demand,
                            eligible=eligible,
                            shared_net_indexes=collector.net_indexes,
                            shared_net_lock=collector.net_lock,
                        )
                    except KernelFault as e:
                        # a kernel wrapper refused the fused batch:
                        # degrade THIS eval to the scalar oracle so it
                        # completes normally, one tier slower
                        logger.warning(
                            "drain kernel fault (%s); eval %s degrades to "
                            "the oracle path",
                            e,
                            self.eval.id if self.eval is not None else "?",
                        )
                        metrics.incr("scheduler.kernel_fault_degrade")
                        _count_fallback("kernel_fault")
                        note = getattr(self.planner, "note_kernel_fault", None)
                        if note is not None:
                            note(str(e))
                        return super()._compute_placements([], place)
                    # counted only on success so an eval degraded by a
                    # device fault isn't attributed to both tiers
                    _count_kernel(drain=True)
                    return
            collector.leave(self.eval.id)

        if destructive or not place:
            if destructive:
                _count_fallback("destructive_update")
            return super()._compute_placements(destructive, place)

        # One pass over the placements collects everything the routing
        # decisions below need (groups, reschedule/canary flags) — separate
        # any()/dict-comp sweeps were ~40ms of pure iteration at 50K allocs
        groups: dict = {}
        has_prev = has_canary = False
        for p in place:
            tg = p.task_group
            if tg.name not in groups:
                groups[tg.name] = tg
            if p.previous_alloc is not None:
                has_prev = True
            elif p.canary:
                has_canary = True

        # The kernel covers fresh placements only
        if has_prev or has_canary:
            _count_fallback("reschedule" if has_prev else "canary")
            return super()._compute_placements(destructive, place)
        if not all(
            kernel_supported(self.job, tg, allow_networks=True, allow_devices=True)
            for tg in groups.values()
        ):
            _count_fallback("unsupported_group")  # reserved ports/distinct_*
            return super()._compute_placements(destructive, place)

        nodes, by_dc = self.state.ready_nodes_in_dcs(self.job.datacenters)
        if not nodes:
            _count_fallback("no_ready_nodes")
            return super()._compute_placements(destructive, place)

        # Tiny solo evals ride the scalar oracle: a device launch costs
        # ~100ms regardless of size, while the oracle places a handful of
        # allocs over a log2-bounded candidate ring in well under a
        # millisecond. Fused drain batches amortize the launch and keep the
        # kernel; this gate only affects the solo path (e.g. the refresh
        # retry after a partial commit, which replans 1-4 allocs).
        if len(place) <= SMALL_EVAL_ORACLE_MAX and not EXACT_ONLY:
            _count_fallback("small_eval")
            return super()._compute_placements(destructive, place)

        _count_kernel()
        # the solo planner's stage of the eval's span tree (the fused
        # drain path records its spans in drain.py)
        from ..trace import tracer
        from . import shard as _shard

        # sharded dispatches tag their topology so a trace reader can tell
        # a mesh run from a single-card one span-locally
        span_tags = {"allocs": len(place)}
        span_mesh = _shard.active_mesh(len(nodes))
        if span_mesh is not None:
            span_tags.update(_shard.shard_tags(span_mesh))
        with tracer.span("eval.plan_kernel", tags=span_tags) as kspan:
            self._kernel_placements(place, nodes, by_dc, groups, kernel_span=kspan)

    # ------------------------------------------------------------------
    def _assemble_groups(
        self, cluster, place: list, n_limit_nodes: int, groups=None
    ):
        """Group planes, demands, candidate limits, collision counts and the
        per-alloc group-id vector for this eval's placements, evaluated
        against ``cluster`` — the eval's own candidate set on the solo path,
        or the batch's shared cluster on the drain path. One definition so
        the two paths can't drift."""
        ctx = self.ctx
        tg_by_name = (
            groups
            if groups is not None
            else {p.task_group.name: p.task_group for p in place}
        )
        group_names = list(tg_by_name)
        planes_list = [
            build_group_planes(ctx, cluster, self.state, self.job, tg_by_name[n])
            for n in group_names
        ]
        g_index = {n: i for i, n in enumerate(group_names)}
        G = len(group_names)
        n_nodes = len(cluster.nodes)

        g_demand = np.zeros((G, R_COLS), dtype=np.int32)
        g_limit = np.zeros(G, dtype=np.int32)
        collisions0 = np.zeros((G, n_nodes), dtype=np.int32)
        for name, gi in g_index.items():
            tg = tg_by_name[name]
            g_demand[gi] = (
                sum(t.resources.cpu for t in tg.tasks),
                sum(t.resources.memory_mb for t in tg.tasks),
                tg.ephemeral_disk.size_mb,
                # bandwidth ask (AssignNetwork's mbits dimension)
                sum(
                    net.mbits
                    for t in tg.tasks
                    for net in t.resources.networks
                ),
            )
            planes = planes_list[gi]
            g_limit[gi] = min(
                compute_limit(
                    n_limit_nodes,
                    self.batch,
                    bool(planes.affinity_present.any())
                    or planes.node_value is not None,
                ),
                n_limit_nodes,
            )
            collisions0[gi] = cluster.collision_counts(
                self.state, self.job.id, planes.name
            )
        if G == 1:
            gid_real = np.zeros(len(place), dtype=np.int32)
        else:
            gid_real = np.fromiter(
                (g_index[p.task_group.name] for p in place),
                dtype=np.int32,
                count=len(place),
            )
        return planes_list, g_index, g_demand, g_limit, gid_real, collisions0

    # ------------------------------------------------------------------
    def _prepare_drain(self, place: list, shared):
        """Build this eval's contribution to a fused drain batch: group
        planes over the shared cluster, demands/limits, and the shuffled
        ring of datacenter-eligible node indices."""
        from .drain import DrainPrep

        ctx = self.ctx
        nodes_elig, by_dc = self.state.ready_nodes_in_dcs(self.job.datacenters)
        if not nodes_elig:
            return None
        groups = {p.task_group.name: p.task_group for p in place}
        index = shared.cluster.index
        try:
            elig_rows = np.fromiter(
                (index[n.id] for n in nodes_elig),
                dtype=np.int32,
                count=len(nodes_elig),
            )
        except KeyError:
            # eligible node missing from the shared cluster (snapshot skew)
            return None
        if self._group_asks_network(groups) and not bool(
            shared.cluster.single_nic[elig_rows].all()
        ):
            # per-device bandwidth: the solo path's oracle escape — BEFORE
            # the seeded shuffle so the fallback replays the same rng
            # stream. Checked over THIS eval's eligible ring only: the
            # mirror's cluster spans all nodes, and a down multi-NIC node
            # that can never be placed on must not unbatch every
            # network-asking eval.
            return None

        shuffled = list(nodes_elig)
        shuffle_nodes(ctx, shuffled)
        perm_eligible = np.fromiter(
            (index[n.id] for n in shuffled), dtype=np.int32, count=len(shuffled)
        )

        planes_list, g_index, g_demand, g_limit, gid_real, collisions0 = (
            self._assemble_groups(
                shared.cluster, place, len(nodes_elig), groups=groups
            )
        )
        return DrainPrep(
            eval_id=self.eval.id,
            priority=self.eval.priority,
            create_index=self.eval.create_index,
            planes_list=planes_list,
            g_index=g_index,
            g_demand=g_demand,
            g_limit=g_limit,
            gid_real=gid_real,
            perm_eligible=perm_eligible,
            collisions0=collisions0,
            by_dc=by_dc,
            deadline=self.eval.deadline,
        )

    # ------------------------------------------------------------------
    def _kernel_placements(
        self, place: list, nodes: list, by_dc: dict, groups: dict,
        kernel_span=None,
    ):
        from ..trace.span import NOOP_SPAN

        if kernel_span is None:
            kernel_span = NOOP_SPAN
        t_start = time.monotonic()
        ctx = self.ctx
        n_real = len(nodes)

        # escape hatches must fire BEFORE the seeded shuffle: the oracle
        # fallback replays the same rng stream the pure-oracle run uses
        cluster = ColumnarCluster.shared(self.state, nodes)
        if self._multi_nic_network_escape(groups, cluster):
            return super()._compute_placements([], place)
        dev_entries, dev_escape = self._device_asks(groups)
        if dev_escape:
            _count_fallback("device_mixed_signature")
            return super()._compute_placements([], place)
        dev_plane = None
        if dev_entries:
            ask0 = next(iter(dev_entries.values()))[1][0][1]
            dev_plane = cluster.device_plane(ask0)
            max_count = max(
                d.count
                for _, (tg, asks) in dev_entries.items()
                for _, d in asks
            )
            if dev_plane[2] and max_count > 1:
                # the summed column can't promise ``count`` instances from
                # one group (assign_device's contract) when a node carries
                # several matching groups — those evals ride the oracle
                _count_fallback("device_multi_group")
                return super()._compute_placements([], place)

        # Same seeded shuffle the oracle's stack.set_nodes performs
        shuffled = list(nodes)
        shuffle_nodes(ctx, shuffled)
        perm_real = np.array([cluster.index[n.id] for n in shuffled], dtype=np.int32)

        planes_list, g_index, g_demand, g_limit, gid_real, collisions0_real = (
            self._assemble_groups(cluster, place, n_real, groups=groups)
        )
        G = len(planes_list)

        capacity_real = cluster.capacity
        used0_real = cluster.initial_used(self.state, self.plan)
        dev_match_sets = None
        if dev_entries:
            # dense device column (SURVEY §7: feasibility/accounting on
            # device, instance-ID arbitration host-side per winner): free
            # matching instances become the 5th resource column and each
            # group's ask count its demand entry
            dev_capacity, dev_match_sets, _ = dev_plane
            dev_used0 = cluster.device_used(
                self.state, dev_match_sets, self.plan
            )
            capacity_real = np.concatenate(
                [capacity_real, dev_capacity[:, None].astype(np.int64)], axis=1
            )
            used0_real = np.concatenate(
                [used0_real, dev_used0[:, None].astype(np.int64)], axis=1
            )
            dev_counts = np.zeros(G, dtype=np.int32)
            for name, (tg, asks) in dev_entries.items():
                if name in g_index:
                    dev_counts[g_index[name]] = sum(d.count for _, d in asks)
            g_demand = np.concatenate([g_demand, dev_counts[:, None]], axis=1)

        # the planes at the eval's real size: planner.pad_planes pads the
        # node and alloc axes up the same bucket ladder, with the same
        # fills and ring tail, as the JAX scheduler's _pad_to/_bucket
        N = n_real
        capacity = capacity_real.astype(np.int32)
        usable = cluster.usable.astype(np.float32)
        used0 = used0_real.astype(np.int32)

        V = max(
            max((len(p.values) for p in planes_list), default=1), 1
        )
        feasible = np.zeros((G, N), dtype=bool)
        affinity = np.zeros((G, N), dtype=np.float32)
        affinity_present = np.zeros((G, N), dtype=bool)
        group_count = np.zeros(G, dtype=np.int32)
        node_value = np.full((G, N), -1, dtype=np.int32)
        spread_desired = np.full((G, V), -1.0, dtype=np.float32)
        spread_implicit = np.full(G, -1.0, dtype=np.float32)
        spread_weight_frac = np.zeros(G, dtype=np.float32)
        spread_even = np.zeros(G, dtype=bool)
        spread_active = np.zeros(G, dtype=bool)
        counts0 = np.zeros((G, V), dtype=np.int32)
        present0 = np.zeros((G, V), dtype=bool)
        collisions0 = np.zeros((G, N), dtype=np.int32)
        collisions0[:, :n_real] = collisions0_real

        for gi, planes in enumerate(planes_list):
            feasible[gi, :n_real] = planes.feasible
            affinity[gi, :n_real] = planes.affinity
            affinity_present[gi, :n_real] = planes.affinity_present
            group_count[gi] = planes.count
            if planes.node_value is not None:
                node_value[gi, :n_real] = planes.node_value
                nv = len(planes.counts0)
                counts0[gi, :nv] = planes.counts0
                present0[gi, :nv] = planes.present0
                spread_desired[gi, : len(planes.desired)] = planes.desired
                spread_implicit[gi] = planes.implicit
                spread_weight_frac[gi] = planes.weight_frac
                spread_even[gi] = planes.even
                spread_active[gi] = True

        # per-alloc arrays, built per-group then gathered (the per-alloc
        # Python loop was ~0.3s of pure overhead at 50K allocs)
        a_real = len(place)
        group_ids = gid_real
        demands = g_demand[gid_real].astype(np.int32)
        limits = g_limit[gid_real]
        valid = np.ones(a_real, dtype=bool)

        def run_exact_np():
            """The float64 numpy stepper: one dense pass per placement
            with the scalar chain's exact semantics, no device. Shared by
            the oracle-np factory and the kernel-fault degrade path."""
            from .exact_np import plan_exact_np

            return plan_exact_np(
                capacity_real.astype(np.int64),
                cluster.usable.astype(np.float64),
                feasible[:, :n_real],
                affinity[:, :n_real].astype(np.float64),
                affinity_present[:, :n_real],
                group_count.astype(np.int64),
                node_value[:, :n_real].astype(np.int64),
                spread_desired.astype(np.float64),
                spread_implicit.astype(np.float64),
                spread_weight_frac.astype(np.float64),
                spread_even,
                spread_active,
                perm_real.astype(np.int64),
                demands[:a_real].astype(np.int64),
                group_ids[:a_real].astype(np.int64),
                limits[:a_real].astype(np.int64),
                used0_real.astype(np.int64),
                collisions0[:, :n_real].astype(np.int64),
                counts0.astype(np.int64),
                present0,
            )

        # Vectorized-oracle path: the float64 numpy stepper, one dense pass
        # per placement with the scalar chain's exact semantics (no device)
        if self.exact_numpy:
            t_columnar = time.monotonic()
            placements = run_exact_np()
            LAST_KERNEL_STATS.update(
                columnar_s=t_columnar - t_start,
                kernel_s=time.monotonic() - t_columnar,
                n_nodes=n_real,
                n_allocs=a_real,
                mode="exact-np",
            )
            _count_mode("exact-np")
            self._materialize(
                place, placements, nodes, by_dc, planes_list, g_index,
                gid_real, used0, capacity, g_demand,
                dev_entries=dev_entries, groups=groups,
            )
            return

        def degrade_to_exact(reason: str):
            """A kernel wrapper refused the eval's planes (or a test
            injected the refusal): replan the SAME columnar problem on the
            host oracle so the eval completes normally, one tier slower —
            a counted fallback, not a failed eval. Safe to re-enter because
            _materialize mutates no scheduler state before its placement
            sync point."""
            logger.warning(
                "kernel fault (%s); degrading eval %s to exact-np",
                reason,
                self.eval.id if self.eval is not None else "?",
            )
            metrics.incr("scheduler.kernel_fault_degrade")
            _count_fallback("kernel_fault")
            note = getattr(self.planner, "note_kernel_fault", None)
            if note is not None:
                note(reason)
            t_degrade = time.monotonic()
            placements = run_exact_np()
            LAST_KERNEL_STATS.update(
                kernel_s=time.monotonic() - t_degrade,
                n_nodes=n_real,
                n_allocs=a_real,
                mode="exact-np-degraded",
            )
            _count_mode("exact-np-degraded")
            self._materialize(
                place, placements, nodes, by_dc, planes_list, g_index,
                gid_real, used0, capacity, g_demand,
                dev_entries=dev_entries, groups=groups,
            )

        # One dispatch, shared with planner.plan_eval: the planes under its
        # field names, the same mode choice (runs for one group with
        # affinity/spread and an unbounded limit; windowed, or paged past
        # the paging budget, for one group with a bounded limit and
        # neither; else the exact scan, or the wavefront with its stanza
        # on) and the same launch code
        planes = dict(
            capacity=capacity,
            usable=usable,
            feasible=feasible,
            affinity=affinity,
            affinity_present=affinity_present,
            group_count=group_count,
            group_eval=np.zeros(G, dtype=np.int32),
            node_value=node_value,
            spread_desired=spread_desired,
            spread_implicit=spread_implicit,
            spread_weight_frac=spread_weight_frac,
            spread_even=spread_even,
            spread_active=spread_active,
            perm=perm_real[None, :],
            ring=np.array([n_real], dtype=np.int32),
            demands=demands,
            groups=group_ids,
            limits=limits,
            valid=valid,
            used0=used0,
            collisions0=collisions0,
            counts0=counts0,
            present0=present0,
            n_real=n_real,
            a_real=a_real,
        )
        t_columnar = time.monotonic()
        try:
            pending = _planner.launch_eval(
                planes, device=self.device, exact_only=EXACT_ONLY
            )
        except KernelFault as e:
            return degrade_to_exact(f"dispatch: {e}")
        mode = pending.mode
        LAST_KERNEL_STATS.update(
            columnar_s=t_columnar - t_start,
            n_nodes=n_real,
            n_allocs=a_real,
            n_padded_nodes=pending.n_pad,
            n_padded_allocs=pending.a_pad,
            mode=mode,
            launches=pending.launches,
            shards=pending.shards,
        )
        if mode == "paged":
            pstats = pending.extra
            LAST_KERNEL_STATS.update(
                paged_tiles=pstats["tiles"],
                paged_tile_nodes=pstats["tile_nodes"],
                paged_reuploads=pstats["reuploads"],
                paged_budget_bytes=pstats["limit_bytes"],
            )
        _count_mode(mode)
        _tag_device_span(kernel_span, _PLANNER_OF_MODE[mode], mode)
        # the launch is async: _materialize builds templates/ids while the
        # device runs, then blocks on the placements
        self._materialize(
            place, pending, nodes, by_dc, planes_list, g_index,
            gid_real, used0, capacity, g_demand, t_dispatch=t_columnar,
            dev_entries=dev_entries, groups=groups,
        )
        LAST_KERNEL_STATS["materialize_s"] = (
            time.monotonic() - t_columnar - LAST_KERNEL_STATS["dispatch_s"]
        )

    # ------------------------------------------------------------------
    def _failed_group_metric(
        self, gi, planes_list, by_dc, used_final, capacity, demand, n_real,
        eligible=None,
    ) -> AllocMetric:
        """Measured failure accounting for one task group: a feasible node is
        exhausted if one more alloc of this group's demand overflows some
        dimension of the node's capacity at the usage the scan had reached
        when this group first failed; the recorded dimension is the first
        failing of cpu/memory/disk (the superset-check order,
        structs.go:3199-3210). Measured from the kernel's actual state
        rather than guessed. ``eligible`` restricts the node universe to the
        eval's datacenter-eligible ring on the drain path, so metrics match
        what the same eval would report solo."""
        metrics = AllocMetric()
        feasible = planes_list[gi].feasible
        if eligible is not None:
            metrics.nodes_evaluated = int(eligible.sum())
            feasible = feasible & eligible
            metrics.nodes_filtered = int((eligible & ~feasible).sum())
        else:
            metrics.nodes_evaluated = n_real
            metrics.nodes_filtered = int((~feasible).sum())
        metrics.nodes_available = by_dc
        over = used_final + demand[None, :] > capacity[:n_real]
        exhausted = feasible & over.any(axis=1)
        metrics.nodes_exhausted = int(exhausted.sum())
        # first failing dimension in superset-check order (argmax = first
        # True; rows with no True are masked out by ``exhausted``)
        first_dim = np.argmax(over, axis=1)
        names = ("cpu", "memory", "disk", "network: bandwidth exceeded", "devices")
        for d in range(over.shape[1]):
            c = int((exhausted & (first_dim == d)).sum())
            if c:
                metrics.dimension_exhausted[names[d]] = c
        return metrics

    # ------------------------------------------------------------------
    @staticmethod
    def _group_asks_network(groups: dict) -> bool:
        return any(
            t.resources.networks
            for tg in groups.values()
            for t in tg.tasks
        )

    @staticmethod
    def _device_asks(groups: dict):
        """Collect device asks per task group for the dense 5th-column path:
        returns ({tg_name: (tg, [(task_name, ask), ...])}, escape). Escape is
        True when the eval's groups ask for more than one distinct device
        signature — one shared count column can't account two different
        device populations, so those (rare) evals ride the oracle."""
        entries = {}
        sigs = set()
        for tg in groups.values():
            asks = [
                (t.name, d)
                for t in tg.tasks
                for d in t.resources.devices
            ]
            if asks:
                entries[tg.name] = (tg, asks)
                for _, d in asks:
                    sigs.add(d.device_id())
        return entries, len(sigs) > 1

    def _multi_nic_network_escape(self, groups: dict, cluster) -> bool:
        """AssignNetwork enforces bandwidth PER DEVICE; the dense sum is
        exact only on single-NIC nodes. Network-asking evals over clusters
        containing multi-NIC nodes ride the oracle (its per-device
        accounting), the same escape-hatch pattern as devices/distinct_*."""
        if not self._group_asks_network(groups):
            return False
        if bool(cluster.single_nic.all()):
            return False
        _count_fallback("multi_nic_network")
        return True

    def _assign_networks(self, node, entry, net_indexes):
        """Per-alloc dynamic-port assignment on the kernel's chosen node
        (the oracle's rank.go:292-338 ask, replayed host-side post-choice).
        One NetworkIndex per touched node, fed lazily with the node's live
        allocs + this plan's earlier grants; returns (AllocatedResources,
        None) or (None, error) when assignment fails. ``net_indexes`` may
        be shared across a fused drain batch (the collector's map), so
        sibling evals can't double-book ports on a node."""
        from ..structs.model import remove_allocs
        from ..structs.network import NetworkIndex

        tg, asks = entry
        idx = net_indexes.get(node.id)
        if idx is None:
            idx = NetworkIndex(rng=self.ctx.rng)
            idx.set_node(node)
            existing = self.state.allocs_by_node_terminal(node.id, False)
            stops = self.plan.node_update.get(node.id, [])
            if stops:
                existing = remove_allocs(existing, stops)
            idx.add_allocs(existing)
            for prior in self.plan.node_allocation.get(node.id, []):
                if prior.allocated_resources is not None:
                    for tr in prior.allocated_resources.tasks.values():
                        for net in tr.networks:
                            idx.add_reserved(net)
            net_indexes[node.id] = idx
        offers = {}
        for task_name, ask in asks:
            offer, err = idx.assign_network(ask.copy())
            if offer is None:
                return None, err
            idx.add_reserved(offer)
            offers[task_name] = offer
        tasks = {
            t.name: AllocatedTaskResources(
                cpu=AllocatedCpuResources(cpu_shares=t.resources.cpu),
                memory=AllocatedMemoryResources(memory_mb=t.resources.memory_mb),
                networks=[offers[t.name]] if t.name in offers else [],
            )
            for t in tg.tasks
        }
        return (
            AllocatedResources(
                tasks=tasks,
                shared=AllocatedSharedResources(
                    disk_mb=tg.ephemeral_disk.size_mb
                ),
            ),
            None,
        )

    def _assign_devices(self, node, entry, accounters):
        """Concrete device-instance arbitration on the kernel's chosen node
        (the oracle's device.go:40-131 assignment, replayed host-side
        post-choice). One DeviceAllocator per touched node, lazily fed the
        node's live allocs + this plan's earlier grants; returns
        ({task_name: [AllocatedDeviceResource]}, None) or (None, error)."""
        from ..scheduler.device import DeviceAllocator
        from ..structs.model import remove_allocs

        tg, asks = entry
        acc = accounters.get(node.id)
        if acc is None:
            acc = DeviceAllocator(self.ctx, node)
            existing = self.state.allocs_by_node_terminal(node.id, False)
            stops = self.plan.node_update.get(node.id, [])
            if stops:
                existing = remove_allocs(existing, stops)
            acc.add_allocs(existing)
            for prior in self.plan.node_allocation.get(node.id, []):
                if prior.allocated_resources is not None:
                    for tr in prior.allocated_resources.tasks.values():
                        for dr in tr.devices:
                            acc.add_reserved(dr)
            accounters[node.id] = acc
        offers: dict[str, list] = {}
        granted: list = []
        for task_name, ask in asks:
            offer, _score, err = acc.assign_device(ask)
            if offer is None:
                # roll back earlier grants of this alloc — the accounter is
                # shared by every later winner on this node, and phantom
                # usage from a half-assigned alloc would cascade failures
                for prior in granted:
                    inst = acc.devices.get(prior.device_id())
                    if inst is not None:
                        for iid in prior.device_ids:
                            if iid in inst.instances:
                                inst.instances[iid] -= 1
                return None, err
            acc.add_reserved(offer)
            granted.append(offer)
            offers.setdefault(task_name, []).append(offer)
        return offers, None

    def _materialize(
        self, place, placements, nodes, by_dc, planes_list, g_index,
        gid_real, used0, capacity, g_demand, t_dispatch=None, eligible=None,
        shared_net_indexes=None, shared_net_lock=None, dev_entries=None,
        groups=None,
    ):
        n_real = len(nodes)
        n_evaluated = int(eligible.sum()) if eligible is not None else n_real
        deployment_id = ""
        if self.deployment is not None and self.deployment.active():
            deployment_id = self.deployment.id
        tg_by_name = (
            groups
            if groups is not None
            else {p.task_group.name: p.task_group for p in place}
        )

        # Templates and ids don't depend on the placements, so when the
        # kernel launch was asynchronous (t_dispatch set) this prep work
        # overlaps device execution; the wait below is the sync point.
        template_by_group = self._build_templates(
            tg_by_name, g_index, by_dc, n_evaluated, deployment_id
        )
        ids = generate_uuids(len(place))

        # the device sync point, BEFORE any scheduler state is mutated: a
        # CUDA error surfacing here propagates and fails the eval
        if isinstance(placements, _planner.PendingPlan):
            placements, stats = placements.wait()
            for k in ("rounds", "kernel_s", "device_s"):
                LAST_KERNEL_STATS[k] = stats[k]
        else:
            placements = _to_host(placements)
        if t_dispatch is not None:
            LAST_KERNEL_STATS["dispatch_s"] = time.monotonic() - t_dispatch

        placed_idx = placements[: len(place)]
        valid_mask = (placed_idx >= 0) & (placed_idx < n_real)
        if not valid_mask.all():
            # failure accounting needs the usage plane, which on the drain
            # path is a SEPARATE device tensor from the placements: sync
            # it here, BEFORE the loops below mutate failed_tg_allocs
            used0 = _to_host(used0)

        def used_at(fail_idx: int) -> np.ndarray:
            """Per-node usage as of placement ``fail_idx`` (placements are in
            scan order, so the prefix of granted demands reconstructs the
            usage the oracle would have seen at that failure moment — later
            placements of other groups don't leak in)."""
            # used0 was synced to a host array above, before any failure
            # bookkeeping ran
            used = np.asarray(used0)[:n_real].astype(np.int64).copy()
            prior = valid_mask.copy()
            prior[fail_idx:] = False
            for gj in range(len(planes_list)):
                m = prior & (gid_real == gj)
                if m.any():
                    counts = np.bincount(placed_idx[m], minlength=n_real)
                    used += counts[:, None] * g_demand[gj][None, :].astype(np.int64)
            return used

        node_alloc = self.plan.node_allocation
        placed_list = placed_idx.tolist()
        alloc_new = Allocation.__new__

        # failures first (rare): each gets the full AllocMetric treatment
        for i in np.flatnonzero(~valid_mask).tolist():
            tg = place[i].task_group
            if tg.name in self.failed_tg_allocs:
                self.failed_tg_allocs[tg.name].coalesced_failures += 1
                continue
            gi = g_index[tg.name]
            self.failed_tg_allocs[tg.name] = self._failed_group_metric(
                gi, planes_list, by_dc, used_at(i), capacity, g_demand[gi],
                n_real, eligible=eligible,
            )

        # successes: tight loop over precomputed flat fields — per-iteration
        # attribute chains and bound-method lookups priced out at 50K
        # placements/eval, so everything is hoisted
        node_ids = [n.id for n in nodes]
        node_names = [n.name for n in nodes]
        all_valid = bool(valid_mask.all())
        success = (
            range(len(place))
            if all_valid
            else np.flatnonzero(valid_mask).tolist()
        )
        # dynamic-port post-pass (SURVEY §7: bandwidth rides the kernel's
        # 4th resource column; exact port assignment happens host-side on
        # the chosen node only): groups with network asks get per-alloc
        # NetworkIndex offers instead of the shared template resources
        net_asks = {}
        for name, tg in tg_by_name.items():
            asks = [
                (t.name, t.resources.networks[0])
                for t in tg.tasks
                if t.resources.networks
            ]
            if asks:
                net_asks[name] = (tg, asks)
        # fused drain batches share one per-node index (+lock) across all
        # participating evals; solo evals get a private map
        net_indexes = (
            shared_net_indexes if shared_net_indexes is not None else {}
        )
        net_lock = shared_net_lock
        dev_accounters: dict = {}
        DT = DesiredTransition
        # One DesiredTransition is shared by every alloc in the plan: store
        # objects are immutable (every mutator path goes through
        # Allocation.copy(), a deep copy — fsm.py desired-transition apply),
        # so the shared instance is never written in place. Constructing 50K
        # dataclass instances was ~100ms of the headline eval.
        shared_dt = DT()

        def record_exhaustion(tg_name: str, label: str):
            # post-pass assignment failed on the chosen node — record the
            # oracle's label (rank.py exhausted_node)
            metric = self.failed_tg_allocs.get(tg_name)
            if metric is None:
                metric = AllocMetric()
                metric.nodes_evaluated = n_evaluated
                metric.nodes_available = dict(by_dc)
                metric.nodes_exhausted = 1
                metric.dimension_exhausted = {label: 1}
                self.failed_tg_allocs[tg_name] = metric
            else:
                metric.coalesced_failures += 1

        if all_valid and not net_asks and not dev_entries:
            # the common shape (every placement granted, no host post-pass):
            # the C batch loop when the toolchain built it, else a zip loop
            # with only the per-alloc fields rebound (~2x the general loop)
            single = (
                template_by_group[place[0].task_group.name]
                if len(template_by_group) == 1
                else None
            )
            from ..native import fastobj

            fo = fastobj()
            if fo is not None:
                tmpl_arg = (
                    single
                    if single is not None
                    else [
                        template_by_group[p.task_group.name] for p in place
                    ]
                )
                fo.materialize(
                    Allocation, tmpl_arg, ids, place, placed_list,
                    node_ids, node_names, shared_dt, node_alloc,
                )
                return
            for p, node_idx, aid in zip(place, placed_list, ids):
                node_id = node_ids[node_idx]
                a = alloc_new(Allocation)
                a.__dict__ = dict(
                    single
                    if single is not None
                    else template_by_group[p.task_group.name],
                    id=aid,
                    name=p.name,
                    node_id=node_id,
                    node_name=node_names[node_idx],
                    task_states={},
                    desired_transition=shared_dt,
                    preempted_allocations=[],
                )
                bucket = node_alloc.get(node_id)
                if bucket is None:
                    bucket = node_alloc[node_id] = []
                bucket.append(a)
            return

        for i in success:
            p = place[i]
            node_idx = placed_list[i]
            node_id = node_ids[node_idx]
            overrides = {}
            if net_asks:
                entry = net_asks.get(p.task_group.name)
                if entry is not None:
                    if net_lock is not None:
                        with net_lock:
                            resources, err = self._assign_networks(
                                nodes[node_idx], entry, net_indexes
                            )
                    else:
                        resources, err = self._assign_networks(
                            nodes[node_idx], entry, net_indexes
                        )
                    if resources is None:
                        record_exhaustion(p.task_group.name, f"network: {err}")
                        continue
                    overrides["allocated_resources"] = resources
            if dev_entries:
                entry = dev_entries.get(p.task_group.name)
                if entry is not None:
                    offers, err = self._assign_devices(
                        nodes[node_idx], entry, dev_accounters
                    )
                    if offers is None:
                        record_exhaustion(p.task_group.name, f"devices: {err}")
                        continue
                    resources = overrides.get("allocated_resources")
                    if resources is None:
                        tg = entry[0]
                        resources = AllocatedResources(
                            tasks={
                                t.name: AllocatedTaskResources(
                                    cpu=AllocatedCpuResources(
                                        cpu_shares=t.resources.cpu
                                    ),
                                    memory=AllocatedMemoryResources(
                                        memory_mb=t.resources.memory_mb
                                    ),
                                )
                                for t in tg.tasks
                            },
                            shared=AllocatedSharedResources(
                                disk_mb=tg.ephemeral_disk.size_mb
                            ),
                        )
                        overrides["allocated_resources"] = resources
                    for task_name, offer_list in offers.items():
                        resources.tasks[task_name].devices.extend(offer_list)
            alloc = alloc_new(Allocation)
            alloc.__dict__ = dict(
                template_by_group[p.task_group.name],
                id=ids[i],
                name=p.name,
                node_id=node_id,
                node_name=node_names[node_idx],
                task_states={},
                desired_transition=shared_dt,
                preempted_allocations=[],
                **overrides,
            )
            bucket = node_alloc.get(node_id)
            if bucket is None:
                bucket = node_alloc[node_id] = []
            bucket.append(alloc)

    # ------------------------------------------------------------------
    def _build_templates(
        self, tg_by_name, g_index, by_dc, n_evaluated, deployment_id
    ):
        # Per-group template allocation: every placement of a group carries
        # identical AllocatedResources and (successful) AllocMetric content,
        # so one nested instance per group is shared by reference across the
        # plan's allocations — they are immutable after scheduling (MVCC
        # copies on any later write path), and constructing 50K deep object
        # trees was the single largest end-to-end cost. New allocations are
        # minted by __dict__-cloning the template (3x cheaper than the
        # dataclass __init__ at this scale); per-alloc mutable containers
        # (task_states, preempted_allocations) are re-bound fresh on every
        # clone below so no plan alloc aliases another's mutable state.
        # Templates are COMPACTED: keys whose value equals the dataclass
        # class-level default are dropped — attribute lookup falls through
        # to the class, so reads/serialization/copy are identical while the
        # per-alloc dict copy shrinks ~3x (to_dict iterates fields via
        # getattr, never __dict__).
        template_by_group: dict[str, dict] = {}
        for name, gi in g_index.items():
            tg = tg_by_name[name]
            tasks = {
                t.name: AllocatedTaskResources(
                    cpu=AllocatedCpuResources(cpu_shares=t.resources.cpu),
                    memory=AllocatedMemoryResources(memory_mb=t.resources.memory_mb),
                )
                for t in tg.tasks
            }
            resources = AllocatedResources(
                tasks=tasks,
                shared=AllocatedSharedResources(disk_mb=tg.ephemeral_disk.size_mb),
            )
            metrics = AllocMetric()
            metrics.nodes_evaluated = n_evaluated
            metrics.nodes_available = by_dc
            template_by_group[name] = _compact_template(
                Allocation(
                    namespace=self.job.namespace,
                    eval_id=self.eval.id,
                    job_id=self.job.id,
                    task_group=name,
                    metrics=metrics,
                    deployment_id=deployment_id,
                    allocated_resources=resources,
                    desired_status=ALLOC_DESIRED_STATUS_RUN,
                    client_status=ALLOC_CLIENT_STATUS_PENDING,
                ).__dict__
            )
        return template_by_group
