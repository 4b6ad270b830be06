"""Plan queue + plan applier: the optimistic-concurrency arbiter
(ref nomad/plan_queue.go:40-260, plan_apply.go:49-689).

Many schedulers plan in parallel against snapshots; this single serialized
applier re-checks every touched node's allocations against the latest state
(AllocsFit with devices), commits fully or partially, and hands back a
RefreshIndex so the scheduler can retry against fresher state. The per-node
verification is a dense check over the plan's touched nodes — the same masked
fit-matrix the TPU kernel computes, evaluated host-side at commit time.

The port's copy of ``nomad_tpu/core/plan_apply.py``. Plans of at least
``device_verify_min`` placements verify on the server's ``ColumnarMirror``
planes through :func:`dense_verify` (the dense verify kernel on the card,
its plain version on the CPU); the host oracle confirms every failure.
The counted degrades are the reference's: a stale or closed mirror, a
row the planes cannot model, and ``kernel.KernelFault`` (the ``tpu.kernel``
fault point). A CUDA error in the verify is not a degrade: it fails the
plan.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import metrics
from ..state.store import StateSnapshot, StateStore
from ..testing import faults as _faults
from .overload import DeadlineExceeded
from ..trace import tracer
from ..structs.funcs import allocs_fit
from ..tpu import kernel
from ..tpu.columnar import R_COLS
from ..tpu.mirror import DeviceState
from ..structs.model import (
    NODE_SCHED_INELIGIBLE,
    NODE_STATUS_READY,
    Evaluation,
    Plan,
    PlanResult,
    remove_allocs,
)


class PendingPlan:
    """A queued plan + its completion future (ref plan_queue.go pendingPlan)."""

    def __init__(self, plan: Plan):
        self.plan = plan
        self.result: Optional[PlanResult] = None
        self.error: Optional[Exception] = None
        self.enqueued_at = time.monotonic()
        # the submitting eval's trace context, resolved once at enqueue:
        # the applier's queue-wait/verify/commit spans attach to it from
        # the applier thread without another registry lookup. The
        # CURRENT span (the worker's plan.submit, active on the
        # enqueuing thread) wins over the eval root so the applier
        # stages nest INSIDE plan.submit — critical-path attribution
        # then splits submit into queue-wait/verify/commit instead of
        # double-counting two parallel branches of the same wall time;
        # direct callers (Planner.apply, tests) fall back to the root
        self.trace_ctx = tracer.current() or tracer.ctx_for_eval(
            plan.eval_id
        )
        self._done = threading.Event()

    def respond(self, result: Optional[PlanResult], error: Optional[Exception]):
        self.result = result
        self.error = error
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> tuple[Optional[PlanResult], Optional[Exception]]:
        self._done.wait(timeout)
        return self.result, self.error


class PlanQueue:
    """Priority queue of pending plans (ref plan_queue.go:40-260)."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._heap: list = []
        self._counter = itertools.count()

    def set_enabled(self, enabled: bool):
        with self._lock:
            self.enabled = enabled
            if not enabled:
                # fail queued plans so submitting workers unblock immediately
                for _, _, pending in self._heap:
                    pending.respond(None, RuntimeError("plan queue is disabled"))
                self._heap = []
            self._cond.notify_all()

    def enqueue(self, plan: Plan) -> PendingPlan:
        pending = PendingPlan(plan)
        with self._lock:
            if not self.enabled:
                pending.respond(None, RuntimeError("plan queue is disabled"))
                return pending
            heapq.heappush(
                self._heap, (-plan.priority, next(self._counter), pending)
            )
            self._cond.notify_all()
        return pending

    def depth(self) -> int:
        """Plans waiting for the applier (observability: the bench's
        worker-scaling curve samples this to show where the control plane
        saturates; ref plan_queue.go Stats)."""
        with self._lock:
            return len(self._heap)

    def dequeue(self, timeout: Optional[float] = None) -> Optional[PendingPlan]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._heap:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining if remaining is not None else 1.0)
            return heapq.heappop(self._heap)[2]

    def drain(self, max_n: int) -> list[PendingPlan]:
        """Pop up to ``max_n`` already-queued plans without waiting — the
        applier batches whatever has accumulated behind the plan it just
        dequeued into one consensus round."""
        out: list[PendingPlan] = []
        with self._lock:
            while self._heap and len(out) < max_n:
                out.append(heapq.heappop(self._heap)[2])
        return out

    def requeue(self, pendings: list[PendingPlan]):
        """Return unprocessed plans to the queue (rare applier bail-out)."""
        with self._lock:
            if not self.enabled:
                for p in pendings:
                    p.respond(None, RuntimeError("plan queue is disabled"))
                return
            for p in pendings:
                heapq.heappush(
                    self._heap, (-p.plan.priority, next(self._counter), p)
                )
            self._cond.notify_all()


def evaluate_node_plan(
    snap: StateSnapshot, plan: Plan, node_id: str
) -> tuple[bool, str]:
    """Re-check one node's proposed allocs against latest state
    (ref plan_apply.go:628-681)."""
    if not plan.node_allocation.get(node_id):
        return True, ""

    node = snap.node_by_id(node_id)
    if node is None:
        return False, "node does not exist"
    if node.status != NODE_STATUS_READY:
        return False, "node is not ready for placements"
    if node.scheduling_eligibility == NODE_SCHED_INELIGIBLE:
        return False, "node is not eligible for draining"

    existing = snap.allocs_by_node_terminal(node_id, False)
    remove = []
    remove.extend(plan.node_update.get(node_id, []))
    remove.extend(plan.node_preemptions.get(node_id, []))
    remove.extend(plan.node_allocation.get(node_id, []))
    proposed = remove_allocs(existing, remove)
    proposed = proposed + plan.node_allocation.get(node_id, [])

    fit, reason, _ = allocs_fit(node, proposed, None, True)
    return fit, reason


#: plans with at least this many placements verify through the dense path
DENSE_VERIFY_THRESHOLD = 256


def _alloc_triple(alloc) -> tuple[int, int, int]:
    """(cpu, memory_mb, disk_mb) of an allocation without materializing
    ComparableResources objects (the allocs_fit summation, funcs.go:104-117,
    done as plain ints for the dense verify path)."""
    resources = alloc.allocated_resources
    cpu = 0
    mem = 0
    for tr in resources.tasks.values():
        cpu += tr.cpu.cpu_shares
        mem += tr.memory.memory_mb
    return cpu, mem, resources.shared.disk_mb


def _alloc_exotic(alloc) -> bool:
    """Whether the alloc carries ports/bandwidth or devices — dimensions the
    dense verify doesn't model, forcing the exact per-node check. Delegates
    to the mirror plane's single definition (tpu/mirror.py exotic_flag) so
    the host dense path, the device verify, and the mirror's per-row
    exotic counts can never disagree."""
    from ..state.planes import exotic_flag

    return exotic_flag(alloc)


def _dense_node_fit(snap: StateSnapshot, plan: Plan, node_ids: list[str]) -> dict[str, tuple[bool, str]]:
    """Batched fit verdicts for the plan's touched nodes. Two wins over the
    per-node exact path: the alloc table is scanned ONCE (not once per
    node), and usage sums are plain int triples instead of
    ComparableResources object math. Nodes whose allocs carry ports or
    devices, and nodes that fail this check (which need the exact failing
    reason), fall back to evaluate_node_plan."""
    # one pass over the alloc table instead of one scan per touched node
    # (allocs_by_node_terminal is O(total allocs) per call)
    touched = set(node_ids)
    existing_by_node: dict[str, list] = {nid: [] for nid in node_ids}
    for a in snap.allocs():
        if a.node_id in touched and not a.terminal_status():
            existing_by_node[a.node_id].append(a)

    verdicts: dict[str, tuple[bool, str]] = {}
    for node_id in node_ids:
        if not plan.node_allocation.get(node_id):
            verdicts[node_id] = (True, "")
            continue
        node = snap.node_by_id(node_id)
        if node is None:
            verdicts[node_id] = (False, "node does not exist")
            continue
        if node.status != NODE_STATUS_READY:
            verdicts[node_id] = (False, "node is not ready for placements")
            continue
        if node.scheduling_eligibility == NODE_SCHED_INELIGIBLE:
            verdicts[node_id] = (False, "node is not eligible for draining")
            continue

        res = node.node_resources
        cap = (res.cpu.cpu_shares, res.memory.memory_mb, res.disk.disk_mb)
        cpu = mem = disk = 0
        if node.reserved_resources is not None:
            rr = node.reserved_resources
            cpu, mem, disk = (
                rr.cpu.cpu_shares, rr.memory.memory_mb, rr.disk.disk_mb
            )

        removed = {
            a.id
            for a in (
                plan.node_update.get(node_id, [])
                + plan.node_preemptions.get(node_id, [])
                + plan.node_allocation.get(node_id, [])
            )
        }
        exotic = False
        for a in existing_by_node[node_id]:
            if a.id in removed or a.allocated_resources is None:
                continue
            if _alloc_exotic(a):
                exotic = True
                break
            c, m, d = _alloc_triple(a)
            cpu += c
            mem += m
            disk += d
        if not exotic:
            for a in plan.node_allocation.get(node_id, []):
                if a.allocated_resources is None:
                    continue
                if _alloc_exotic(a):
                    exotic = True
                    break
                c, m, d = _alloc_triple(a)
                cpu += c
                mem += m
                disk += d

        if exotic or cpu > cap[0] or mem > cap[1] or disk > cap[2]:
            # exact path: exotic dimensions, or failure needing the precise
            # failing reason (and a double-check)
            verdicts[node_id] = evaluate_node_plan(snap, plan, node_id)
        else:
            verdicts[node_id] = (True, "")
    return verdicts


def _plan_node_ids(plan: Plan) -> list[str]:
    return list(dict.fromkeys(
        list(plan.node_update.keys()) + list(plan.node_allocation.keys())
    ))


def _assemble_result(plan: Plan, node_ids: list[str], fit_fn,
                     refresh_index: int) -> PlanResult:
    """Build the committable subset from per-node fit verdicts — THE
    shared tail of the host and device verify paths (ref
    plan_apply.go:399-560). One implementation so the two oracles can
    never drift on assembly semantics (all_at_once, preempt-only
    pass-through, canary correction)."""
    result = PlanResult(
        deployment=plan.deployment.copy() if plan.deployment else None,
        deployment_updates=plan.deployment_updates,
    )
    partial_commit = False
    for node_id in node_ids:
        fit, _reason = fit_fn(node_id)
        if not fit:
            partial_commit = True
            if plan.all_at_once:
                return PlanResult(refresh_index=refresh_index)
            continue
        if plan.node_update.get(node_id):
            result.node_update[node_id] = plan.node_update[node_id]
        if plan.node_allocation.get(node_id):
            result.node_allocation[node_id] = plan.node_allocation[node_id]
        if plan.node_preemptions.get(node_id):
            result.node_preemptions[node_id] = plan.node_preemptions[node_id]

    # evict/preempt-only nodes always commit
    for node_id, preempted in plan.node_preemptions.items():
        if node_id not in node_ids and preempted:
            result.node_preemptions[node_id] = preempted

    if partial_commit:
        result.refresh_index = refresh_index
        _correct_deployment_canaries(result)
    return result


def evaluate_plan(snap: StateSnapshot, plan: Plan) -> PlanResult:
    """Determine the committable subset of a plan
    (ref plan_apply.go:399-560)."""
    node_ids = _plan_node_ids(plan)

    total_placements = sum(len(v) for v in plan.node_allocation.values())
    dense = None
    if total_placements >= DENSE_VERIFY_THRESHOLD:
        dense = _dense_node_fit(snap, plan, node_ids)

    def fit_for(node_id):
        if dense is not None:
            return dense[node_id]
        return evaluate_node_plan(snap, plan, node_id)

    return _assemble_result(plan, node_ids, fit_for, snap.latest_index())


def _correct_deployment_canaries(result: PlanResult):
    """Drop canaries that were not actually placed after a partial commit
    (ref plan_apply.go:592-625)."""
    if result.deployment is None:
        return
    placed = {
        a.id for allocs in result.node_allocation.values() for a in allocs
    }
    for group in result.deployment.task_groups.values():
        group.placed_canaries = [c for c in group.placed_canaries if c in placed]


#: minimum placements before a plan takes the DEVICE dense verify — below
#: this the host paths win outright (a jit dispatch costs more than the
#: whole host check for a handful of rows); shares the spirit (and scale)
#: of DENSE_VERIFY_THRESHOLD. Tunable via plan_pipeline{device_verify_min}.
DEVICE_VERIFY_MIN_PLACEMENTS = 256


def _usage_vec(alloc) -> tuple:
    from ..state.planes import usage_vec

    return usage_vec(alloc) or (0, 0, 0, 0)


class _OverlayEpoch:
    """One verified-but-uncommitted batch's contribution to the in-flight
    overlay: the ADD side of its used-plane deltas, the placed-alloc
    vectors (so a later plan stopping an uncommitted alloc can cancel the
    credited add), the adds-only results for host-snapshot replay, and —
    once the commit thread is harvested — the entry's committed raft
    index, which is the ONLY prune authority. Content-based pruning
    ("the placed alloc id is in the snapshot, so the entry applied") is
    UNSOUND: in-place updates and refresh/nack retries legitimately
    reuse alloc ids, so an id's presence can come from an EARLIER entry
    — dropping the epoch then loses its sibling plans' uncommitted adds
    (observed as real over-commits in the e2e drive)."""

    __slots__ = ("deltas", "placed", "replay", "index")

    def __init__(self):
        # epoch lifetime is ONE batch (≤ max_apply_batch plans): the
        # whole object leaves the overlay at prune (entry committed and
        # visible in the base) or rollback (entry failed/unresolved), so
        # per-epoch growth is bounded by the batch fold cap
        #: node_id -> accumulated (cpu, mem, disk, mbits) ADD delta
        self.deltas: dict[str, list] = {}  # nta: ignore[unbounded-cache] WHY: bounded by one batch's placements; epoch dropped at prune/rollback
        #: alloc_id -> (node_id, usage vec) for uncommitted placements
        self.placed: dict[str, tuple] = {}  # nta: ignore[unbounded-cache] WHY: bounded by one batch's placements; epoch dropped at prune/rollback
        #: [(plan, adds-only PlanResult)] — host verify replays these onto
        #: its base snapshot (upsert_plan_results consumes only the result
        #: maps, so a result carrying just node_allocation replays exactly
        #: the ADD side)
        self.replay: list = []  # nta: ignore[unbounded-cache] WHY: ≤ max_apply_batch entries; epoch dropped at prune/rollback
        #: the entry's committed raft index, stamped at harvest; None
        #: while the commit is still in flight (never prunable)
        self.index: Optional[int] = None

    def absorb(self, plan: Plan, result: PlanResult):
        """Record ``result``'s placements. ONLY the add side: an
        uncommitted batch's REMOVALS are never credited to later batches —
        a later plan relying on capacity freed by a stop that then fails
        to commit would over-commit the node (the stop-then-place over-commit
        class, resurrected via pipelining). Within one batch/raft entry stops DO
        credit (the entry is atomic) — that is the stacked-snapshot /
        batch-delta accounting in _verify_batch, not this overlay."""
        if not result.node_allocation:
            return
        self.replay.append(
            (plan, PlanResult(node_allocation=result.node_allocation))
        )
        for node_id, allocs in result.node_allocation.items():
            slot = self.deltas.setdefault(node_id, [0, 0, 0, 0])
            for a in allocs:
                vec = _usage_vec(a)
                for i in range(4):
                    slot[i] += vec[i]
                self.placed[a.id] = (node_id, vec)

    def empty(self) -> bool:
        return not self.replay


class InFlightOverlay:
    """Used-plane ADD deltas of every verified batch whose raft entry has
    not yet been proven committed (ROADMAP item 1b): the applier verifies
    new batches against base-snapshot + overlay instead of blocking the
    loop on each ``raft.apply``.

    Outcome contract (enforced tree-wide by the ``overlay-unresolved``
    analysis rule): every consumer of this overlay must also handle the
    ``plan.commit_timeout_unresolved`` outcome — a commit that failed
    with its entry outcome UNKNOWN (ApplyTimeout + failed barrier) is
    rolled back here like any failure, but its ``raft_index`` floor must
    still gate the apply loop's snapshots: the entry may yet land, and
    only a snapshot at-or-past it can be trusted not to miss it."""

    def __init__(self):
        self._epochs: list[_OverlayEpoch] = []

    def push(self, epoch: _OverlayEpoch):
        if not epoch.empty():
            self._epochs.append(epoch)

    def rollback(self, epoch: _OverlayEpoch) -> bool:
        """Drop a failed (or unresolved) batch's phantom adds. For the
        unresolved case the caller ALSO keeps the floor from the raised
        error's ``raft_index`` — rollback alone is not outcome handling."""
        try:
            self._epochs.remove(epoch)
            return True
        except ValueError:
            return False

    def prune(self, snap: StateSnapshot) -> int:
        """Drop epochs whose HARVESTED commit index ``snap`` provably
        covers (their adds now live in the base). Un-harvested epochs
        (index None) are never pruned even if the entry already applied
        to the store — keeping one is merely conservative (double-counted
        adds reject, never over-commit) and the window is one loop
        iteration, while any content-based shortcut is unsound (alloc ids
        recur across entries via in-place updates and retries)."""
        before = len(self._epochs)
        latest = snap.latest_index()
        self._epochs = [
            e for e in self._epochs
            if e.index is None or e.index > latest
        ]
        return before - len(self._epochs)

    def depth(self) -> int:
        return len(self._epochs)

    def deltas(self) -> dict[str, list]:
        """Merged node_id -> (cpu, mem, disk, mbits) add deltas."""
        out: dict[str, list] = {}
        for epoch in self._epochs:
            for node_id, vec in epoch.deltas.items():
                slot = out.setdefault(node_id, [0, 0, 0, 0])
                for i in range(4):
                    slot[i] += vec[i]
        return out

    def placed_vec(self, alloc_id: str, node_id: str) -> Optional[tuple]:
        """Usage vec of an uncommitted placement on ``node_id``, if any."""
        for epoch in self._epochs:
            rec = epoch.placed.get(alloc_id)
            if rec is not None and rec[0] == node_id:
                return rec[1]
        return None

    def replay_onto(self, snap: StateSnapshot, stack_fn) -> StateSnapshot:
        """Host-path base: stack every epoch's adds-only results onto
        ``snap`` (the same accounting the device path reads numerically)."""
        for epoch in self._epochs:
            for plan, adds in epoch.replay:
                snap = stack_fn(snap, plan, adds)
        return snap


class Planner:
    """The leader's pipelined plan-apply loop (ref plan_apply.go:71-180;
    ROADMAP item 1): verify batches against base-snapshot + in-flight
    overlay while up to ``max_inflight`` prior batches' raft entries are
    still committing, with the dense verify running against the
    ColumnarMirror's device-resident planes when a mirror is wired."""

    def __init__(self, state: StateStore):
        self.state = state
        self.queue = PlanQueue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.preemption_evals_fn = None  # hook: build follow-up evals for preempted allocs
        self.on_preemption_evals = None  # hook: enqueue them after commit
        # hook: (plan) -> bool; re-validates the plan's eval token at
        # dequeue time — a worker that timed out waiting leaves its plan
        # orphaned in the queue, and committing it after the eval moved on
        # would double-place (the enqueue-time guard alone can't catch it)
        self.token_check_fn = None
        # consensus commit hook: (plan, result, preemption_evals) -> index.
        # When set (server wiring), the verified result is replicated via
        # raft ApplyPlanResults instead of written directly (plan_apply.go
        # applyPlan → raftApplyFuture).
        self.commit_fn = None
        # batch commit hook: ([(plan, result, preemption_evals)]) -> index;
        # commits several independently-verified plans in ONE raft entry.
        self.commit_batch_fn = None
        # hook: (timeout_exc) -> None; commits+applies a consensus barrier
        # (raft noop) and PROVES the timed-out entry applied, raising if it
        # cannot. A raft apply that timed out has already stored its entry,
        # which may yet commit — a barrier proposed behind it applying in
        # the SAME TERM (exc.raft_term; terms are monotonic, so an
        # unchanged current term means leadership was never lost) proves by
        # log matching that the entry applied too.
        self.barrier_fn = None
        # per-instance fold cap (server stanza `plan_apply_batch`); the
        # class constant stays as the default so direct constructions and
        # old call sites keep the historical behavior
        self.max_apply_batch = self.MAX_APPLY_BATCH
        # pipeline depth: verified batches whose commits may be in flight
        # simultaneously (plan_pipeline{max_inflight}). 1 = the classic
        # join-before-dispatch applier; the default overlaps verify(N+1)
        # with commit(N) without ever joining on the hot path
        self.max_inflight = self.MAX_INFLIGHT
        # hook: () -> ColumnarMirror | None (server wiring); enables the
        # device-resident dense verify for big plans
        self.mirror_fn = None
        # device verify enable + size gate (plan_pipeline{device_verify,
        # device_verify_min})
        self.device_verify = True
        self.device_verify_min = DEVICE_VERIFY_MIN_PLACEMENTS
        #: ADD deltas of uncommitted batches; the verify base rides
        #: base-snapshot + this (mutated only by the apply loop; depth()
        #: is sampled cross-thread by the flight recorder)
        self.overlay = InFlightOverlay()

    def start(self):
        self.queue.set_enabled(True)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._apply_loop, daemon=True, name="plan-applier"
        )
        self._thread.start()

    def stop(self):
        self._stop.set()
        self.queue.set_enabled(False)
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    #: default max plans folded into one consensus round; bounded so a
    #: commit failure (which fails the whole batch) stays cheap to retry.
    #: Tunable per server via the `plan_apply_batch` stanza key (set on
    #: ``max_apply_batch``); observed fold sizes land in the
    #: plan.apply_batch_size histogram so the knob can be tuned against
    #: the worker-scaling knee without a code change.
    MAX_APPLY_BATCH = 16

    #: default pipeline depth (concurrent uncommitted raft entries). Safe
    #: by the overlay's adds-only credit discipline: concurrently-proposed
    #: entries upsert ABSOLUTE alloc docs, so their log order never
    #: changes final state, and a batch verified against an in-flight
    #: sibling's adds is conservative whichever entry lands first.
    MAX_INFLIGHT = 2

    def _device_ctx(self, base_snap, live):
        """Per-batch handles for the dense device verify, or None when it
        can't/shouldn't run (no mirror wired, every plan under the size
        gate, or the mirror already moved past this snapshot). The
        context: (mirror, cluster, device arrays, gen)."""
        if not self.device_verify or self.mirror_fn is None:
            return None
        if not any(
            sum(len(v) for v in p.plan.node_allocation.values())
            >= self.device_verify_min
            for p in live
        ):
            return None
        mirror = self.mirror_fn()
        if mirror is None:
            return None
        from ..tpu.problems import bucket

        # the node bucket the drain batches pad to: both consumers must
        # agree per n_pad or the mirror's DeviceState cache rebuilds the
        # full planes on every alternation. A CUDA error in the upload or
        # the dirty-row scatter propagates (no mesh here: ROADMAP A12)
        n_real = len(base_snap.nodes())
        handles = mirror.verify_handles(base_snap, bucket(n_real))
        if handles is None:
            metrics.incr("plan.verify_device_degrade.stale")
            return None
        cluster, arrays, gen = handles
        return (mirror, cluster, arrays, gen)

    def _evaluate_plan_device(
        self, dev_ctx, base_snap, plan, overlay_deltas, epoch, stacked_fn
    ):
        """Dense device verify of one plan against the mirror's
        device-resident planes + the in-flight overlay (ROADMAP item 1a):
        a vectorized node-axis fit check shaped exactly like the planner
        kernel. Parity with the host oracle by construction: the device
        only ever CONFIRMS fits — rows it cannot model (ports/devices,
        int32-clip range, unknown allocs) and rows that fail the dense
        check are answered by the exact host path (``stacked_fn`` hands
        back the same stacked snapshot the host verify would use).
        Returns a PlanResult, or None to degrade the whole plan to the
        host path."""
        total_placements = sum(
            len(v) for v in plan.node_allocation.values()
        )
        if total_placements < self.device_verify_min:
            return None

        node_ids = _plan_node_ids(plan)
        mirror, _cluster, (cap_dev, _usable, used_dev), gen = dev_ctx

        #: per-node verdicts decided host-side (status checks and hard
        #: failures); rows absent here ride the kernel or the exact path
        verdicts: dict[str, tuple] = {}
        exact_nodes: list[str] = []
        rows: list[int] = []
        row_nodes: list[str] = []
        row_deltas: list = []
        import numpy as np

        clip = 2**30
        with mirror.locked_cluster(gen) as cluster:
            if cluster is None:
                # a drain batch synced the mirror forward mid-batch: the
                # device planes no longer match this snapshot
                metrics.incr("plan.verify_device_degrade.stale")
                return None
            for node_id in node_ids:
                if not plan.node_allocation.get(node_id):
                    verdicts[node_id] = (True, "")
                    continue
                row = cluster.index.get(node_id)
                if row is None:
                    # node outside the mirror's axis (not in state):
                    # degrade — the host path mints the exact reason
                    metrics.incr("plan.verify_device_degrade.rows")
                    return None
                node = cluster.nodes[row]
                if node.status != NODE_STATUS_READY:
                    verdicts[node_id] = (
                        False, "node is not ready for placements"
                    )
                    continue
                if node.scheduling_eligibility == NODE_SCHED_INELIGIBLE:
                    verdicts[node_id] = (
                        False, "node is not eligible for draining"
                    )
                    continue
                if cluster.exotic_live[row] > 0:
                    exact_nodes.append(node_id)
                    continue
                # THIS plan's removals credit (stop + place commit in the
                # same raft entry); sub vectors resolve against base-live
                # allocs, uncommitted overlay placements, and this
                # batch's own placements — anything else is already gone
                # and contributes nothing (matching remove_allocs)
                removed = {
                    a.id
                    for a in (
                        plan.node_update.get(node_id, [])
                        + plan.node_preemptions.get(node_id, [])
                        + plan.node_allocation.get(node_id, [])
                    )
                }
                delta = np.zeros(4, dtype=np.int64)
                exotic = False
                for a in plan.node_allocation.get(node_id, []):
                    if a.allocated_resources is not None and _alloc_exotic(a):
                        exotic = True
                        break
                    delta += np.asarray(_usage_vec(a), dtype=np.int64)
                if exotic:
                    exact_nodes.append(node_id)
                    continue
                for aid in removed:
                    rec = cluster._alloc_rec.get(aid)
                    if rec is not None and rec[0] == node_id:
                        delta -= np.asarray(rec[1], dtype=np.int64)
                        continue
                    vec = None
                    pr = epoch.placed.get(aid)
                    if pr is not None and pr[0] == node_id:
                        vec = pr[1]
                    elif overlay_deltas is not None:
                        vec = self.overlay.placed_vec(aid, node_id)
                    if vec is not None:
                        delta -= np.asarray(vec, dtype=np.int64)
                if overlay_deltas:
                    ov = overlay_deltas.get(node_id)
                    if ov is not None:
                        delta += np.asarray(ov, dtype=np.int64)
                bv = epoch.deltas.get(node_id)
                if bv is not None:
                    delta += np.asarray(bv, dtype=np.int64)
                used_row = cluster.mirror_used[row]
                if (
                    used_row.max() >= clip
                    or used_row.min() < 0
                    or np.abs(delta).max() >= clip
                ):
                    # outside the device planes' int32-clip range: the
                    # clipped plane could mask a real overflow — exact
                    exact_nodes.append(node_id)
                    continue
                rows.append(row)
                row_nodes.append(node_id)
                row_deltas.append(delta)

        if rows:
            from ..tpu.kernel import KernelFault

            try:
                fits = dense_verify((cap_dev, _usable, used_dev), rows, row_deltas)
            except KernelFault:
                # the planner-kernel degradation contract (a wrapper's
                # refusal or the tpu.kernel fault point): whole plan to
                # the host oracle. A CUDA error is not caught here
                metrics.incr("plan.verify_device_degrade.kernel_fault")
                return None
            for node_id, fit in zip(row_nodes, fits):
                if bool(fit):
                    verdicts[node_id] = (True, "")
                else:
                    # dense failure: the exact host check mints the
                    # failing reason (and double-checks) — identical to
                    # the host dense path's failure handling
                    exact_nodes.append(node_id)

        for node_id in exact_nodes:
            verdicts[node_id] = evaluate_node_plan(
                stacked_fn(), plan, node_id
            )

        # the SAME assembly as the host oracle (shared helper), with
        # refresh indexes minted from the REAL base snapshot
        return _assemble_result(
            plan, node_ids, verdicts.__getitem__, base_snap.latest_index()
        )

    class _StackFailure(Exception):
        """_optimistic_snapshot raised while building the host verify
        base: the remaining plans can't be verified safely this round."""

    def _verify_batch(self, live, base_snap, dev_ctx=None):
        """Verify each plan against base-snapshot + in-flight overlay +
        the CUMULATIVE results of this batch, so neither a sibling in this
        batch nor an uncommitted in-flight batch can be double-booked.
        Returns (entries, leftovers, noops, epoch): entries = [(pending,
        result)] to commit in one raft entry, leftovers = plans to
        requeue when optimistic stacking fails mid-batch (verifying them
        against a base missing an accepted sibling would double-book),
        noops = fully-rejected plans whose response must carry a REAL
        index (see _respond_refreshed — a stacked snapshot's latest_index
        is synthetic), and epoch = the batch's overlay contribution (the
        caller pushes it when dispatching the commit)."""
        entries = []
        noops = []
        epoch = _OverlayEpoch()
        overlay_deltas = (
            self.overlay.deltas() if dev_ctx is not None else None
        )
        stacked_box: list = [None]

        def stacked_fn():
            # lazy host verify base: base + overlay adds + accepted
            # siblings; built once, then kept current by post-accept
            # stacking below
            if stacked_box[0] is None:
                try:
                    s = self.overlay.replay_onto(
                        base_snap, self._optimistic_snapshot
                    )
                    for p2, r2 in entries:
                        s = self._optimistic_snapshot(s, p2.plan, r2)
                except Exception as e:
                    raise Planner._StackFailure() from e
                stacked_box[0] = s
            return stacked_box[0]

        for i, p in enumerate(live):
            try:
                with tracer.span(
                    "plan.evaluate", parent=p.trace_ctx,
                    metric="plan.evaluate",
                ):
                    result = None
                    if dev_ctx is not None:
                        with tracer.span(
                            "plan.verify_device",
                            metric="plan.verify_device",
                        ):
                            result = self._evaluate_plan_device(
                                dev_ctx, base_snap, p.plan,
                                overlay_deltas, epoch, stacked_fn,
                            )
                    if result is None:
                        result = evaluate_plan(stacked_fn(), p.plan)
            except Planner._StackFailure:
                # can't build a safe verify base mid-flight: requeue this
                # plan and the rest; the apply loop resynchronizes
                return entries, live[i:], noops, epoch
            except Exception as e:
                p.respond(None, e)
                continue
            if result.is_no_op() and result.refresh_index:
                noops.append((p, result))
                continue
            entries.append((p, result))
            epoch.absorb(p.plan, result)
            if stacked_box[0] is not None:
                try:
                    stacked_box[0] = self._optimistic_snapshot(
                        stacked_box[0], p.plan, result
                    )
                except Exception:
                    # entry i IS being committed but the stacked base is
                    # missing its placements: requeue the rest — verifying
                    # them against it would double-book entry i's capacity
                    return entries, live[i + 1:], noops, epoch
        return entries, [], noops, epoch

    def _commit_resolving(self, commit, trace_ctxs=()):
        """Run a consensus commit, resolving indeterminate timeouts.

        A raft apply that times out has ALREADY stored its entry in the
        log — the entry may still commit seconds later. Treating the
        timeout as "nothing happened" lets every subsequent batch verify
        against snapshots missing the in-flight entry, double-booking its
        capacity when it lands (the over-commit class the first full-scale
        soak surfaced: raft-apply p99 was ~4x the apply timeout under
        storm backlog). On timeout, a barrier committed BEHIND the entry
        proves by log matching that the entry applied; the commit then
        reports the entry's real index. If the barrier itself fails, the
        original timeout propagates — still carrying ``raft_index`` so the
        apply loop can floor its snapshots past the unresolved entry."""
        try:
            return commit()
        except TimeoutError as e:
            index = getattr(e, "raft_index", None)
            if index is None or self.barrier_fn is None:
                raise
            tb0 = time.monotonic()
            try:
                self.barrier_fn(e)
            except Exception:
                metrics.incr("plan.commit_timeout_unresolved")
                tb1 = time.monotonic()
                for ctx in trace_ctxs:
                    # the indeterminacy resolution is a real stage of the
                    # eval's lifecycle: FAILED barrier visible in the tree
                    tracer.record_span(
                        "plan.commit_barrier", ctx, tb0, tb1,
                        tags={"resolved": False, "index": index},
                        error="barrier failed; entry outcome unknown",
                    )
                raise e
            metrics.incr("plan.commit_timeout_resolved")
            tb1 = time.monotonic()
            for ctx in trace_ctxs:
                tracer.record_span(
                    "plan.commit_barrier", ctx, tb0, tb1,
                    tags={"resolved": True, "index": index},
                )
            return index

    def _respond_refreshed(self, noops, index: Optional[int] = None):
        """Answer fully-rejected plans with a refresh index that is REAL:
        the just-committed batch's index when one exists (it contains the
        whole optimistic world the rejection was computed against), else
        the store's current index. Never the synthetic optimistic index —
        a worker must not block on an index that only exists inside the
        applier's scratch overlay."""
        if not noops:
            return
        real = index if index is not None else self.state.latest_index()
        for p, result in noops:
            result.refresh_index = min(result.refresh_index, real)
            p.respond(result, None)

    def _harvest(self, outstanding: list, block: bool = False):
        """Collect finished commits off the pipeline: fold their committed
        indexes into ``prev_index`` (returned), fold any unresolved-entry
        floor, and roll the overlay back for batches whose commit FAILED
        (their adds were phantoms). A commit that failed with
        ``plan.commit_timeout_unresolved`` (ApplyTimeout + failed barrier)
        also rolls back — but its entry may still land, so its
        ``raft_index`` rides the returned floor and gates every later
        snapshot. With ``block``, the OLDEST commit is joined first (the
        pipeline-depth backpressure point)."""
        prev_index = 0
        floor = 0
        if block and outstanding:
            outstanding[0][0].join()
        done = [o for o in outstanding if not o[0].is_alive()]
        for t, box, epoch in done:
            t.join()
            outstanding.remove((t, box, epoch))
            index = box.get("index", 0)
            if index:
                prev_index = max(prev_index, index)
                # stamp the entry's real index: prune drops the epoch
                # once a base snapshot provably covers it (the ONLY
                # sound prune authority — see _OverlayEpoch)
                epoch.index = index
            else:
                # failed (or unresolved) commit: the epoch's adds never
                # materialized — later batches must stop verifying
                # against them
                if self.overlay.rollback(epoch):
                    metrics.incr("plan.overlay_rollback")
            floor = max(floor, box.get("floor", 0))
        return prev_index, floor

    def _apply_loop(self):
        """The pipelined applier (ref plan_apply.go:49-180; ROADMAP item
        1b): queued plans fold into one raft entry (MAX_APPLY_BATCH), the
        batch verifies against base-snapshot + the in-flight overlay
        (adds of up to ``max_inflight`` uncommitted batches), and its
        commit dispatches WITHOUT joining the previous one — the loop
        never blocks on ``raft.apply`` until the pipeline is full. The
        submitting workers are still answered only after their commit
        really lands (_async_commit_batch). Safety: the overlay credits
        only the ADD side of uncommitted batches (conservative whichever
        entries land), failed commits roll their epochs back at harvest,
        and unresolved outcomes floor every later snapshot past the
        in-flight entry."""
        outstanding: list = []  # [(thread, box, epoch)], dispatch order
        prev_index = 0
        # snapshots must never be taken below this index: a commit that
        # failed INDETERMINATELY (apply timeout + failed barrier) may still
        # land at its entry index — verifying any batch against state below
        # it risks double-booking the in-flight entry's capacity
        floor = 0

        while not self._stop.is_set():
            head = self.queue.dequeue(timeout=0.2)
            if head is None:
                if outstanding:
                    hi, hf = self._harvest(outstanding)
                    prev_index = max(prev_index, hi)
                    floor = max(floor, hf)
                if self.overlay.depth():
                    # idle housekeeping: without this, committed epochs
                    # (and their Plan/Allocation graphs) outlive the
                    # burst that created them, and overlay_depth()
                    # reports in-flight batches on a quiesced server
                    self.overlay.prune(self.state.snapshot())
                continue
            batch = [head] + self.queue.drain(self.max_apply_batch - 1)
            now = time.monotonic()
            live = []
            for p in batch:
                # time spent waiting for the applier: the stage that names
                # the saturation point when workers outrun the commit
                tracer.record_span(
                    "plan.queue_wait", p.trace_ctx, p.enqueued_at, now,
                    metric="plan.queue_wait",
                )
                if self.token_check_fn is not None and not self.token_check_fn(
                    p.plan
                ):
                    # the submitting worker gave up (timeout) and its eval
                    # moved on — committing the orphan would double-place
                    p.respond(
                        None,
                        RuntimeError("plan rejected: eval token no longer live"),
                    )
                elif p.plan.deadline and time.time_ns() >= p.plan.deadline:
                    # the overload plane's applier gate (core/overload.py):
                    # the eval's deadline passed while its plan queued —
                    # verifying and paying a consensus round for work
                    # nobody is waiting on would deepen the backlog that
                    # expired it. The worker turns this into a terminal
                    # deadline_exceeded eval outcome.
                    metrics.incr("overload.deadline_exceeded.applier")
                    p.respond(
                        None,
                        DeadlineExceeded(
                            "plan rejected: deadline exceeded before "
                            "verify/commit",
                            where="applier",
                        ),
                    )
                else:
                    live.append(p)
            if not live:
                continue

            # harvest finished commits; block on the oldest only when the
            # pipeline is at depth (the backpressure that bounds overlay
            # growth and worker-visible commit latency)
            hi, hf = self._harvest(outstanding)
            prev_index = max(prev_index, hi)
            floor = max(floor, hf)
            while len(outstanding) >= max(1, self.max_inflight):
                hi, hf = self._harvest(outstanding, block=True)
                prev_index = max(prev_index, hi)
                floor = max(floor, hf)

            batch_min = max(p.plan.snapshot_index for p in live)
            min_index = max(prev_index, batch_min, floor)
            try:
                snap = self.state.snapshot_min_index(min_index, timeout=5.0)
            except Exception as e:
                for p in live:
                    p.respond(None, e)
                continue
            # drop overlay epochs the snapshot provably contains: their
            # adds are in the base now (keeping one is conservative, but
            # systematically double-counts)
            t_ov = time.monotonic()
            pruned = self.overlay.prune(snap)
            tracer.record_span(
                "plan.overlay", live[0].trace_ctx, t_ov, time.monotonic(),
                tags={"depth": self.overlay.depth(), "pruned": pruned,
                      "inflight": len(outstanding)},
            )

            try:
                dev_ctx = self._device_ctx(snap, live)
            except Exception as e:
                # a CUDA error uploading or refreshing the mirror's device
                # planes is not a degrade: it fails this batch's plans (the
                # workers nack their evals), as a failed snapshot does
                for p in live:
                    p.respond(None, e)
                continue
            entries, leftovers, noops, epoch = self._verify_batch(
                live, snap, dev_ctx
            )
            if leftovers:
                # stacking failed mid-batch: requeue and resynchronize —
                # join the whole pipeline so the next round verifies
                # against committed reality
                self.queue.requeue(leftovers)
                while outstanding:
                    hi, hf = self._harvest(outstanding, block=True)
                    prev_index = max(prev_index, hi)
                    floor = max(floor, hf)
            if not entries:
                self._respond_refreshed(noops)
                continue

            self.overlay.push(epoch)
            box: dict = {}
            t = threading.Thread(
                target=self._async_commit_batch,
                args=(entries, noops, box),
                daemon=True,
                name="plan-commit",
            )
            t.start()
            outstanding.append((t, box, epoch))

        for t, _box, _epoch in outstanding:
            t.join(timeout=2.0)

    def overlay_depth(self) -> int:
        """In-flight verified-but-uncommitted batches (the flight
        recorder's ``overlay_depth`` sample key)."""
        return self.overlay.depth()

    def _optimistic_snapshot(
        self, snap: StateSnapshot, plan: Plan, result: PlanResult
    ) -> StateSnapshot:
        """A snapshot with ``result`` applied on top of ``snap`` without
        publishing anything: a scratch store adopts the immutable generation
        and copy-on-writes a private one (the reference's optimistic
        snapshot, plan_apply.go:72-76)."""
        scratch = StateStore()
        scratch._gen = snap._gen
        scratch.upsert_plan_results(None, plan, result)
        return scratch.snapshot()

    def _async_commit_batch(
        self, entries: list[tuple[PendingPlan, PlanResult]], noops: list,
        box: dict,
    ):
        """Commit a batch of verified results in one consensus round and
        answer every submitting worker (ref plan_apply.go:367
        asyncPlanWait; batching amortizes the raft fsync). Fully-rejected
        siblings (``noops``) are answered here too, carrying the commit's
        REAL index as their refresh point — the optimistic index they were
        verified at exists only inside the applier's scratch overlay."""
        tc0 = time.monotonic()
        ctxs = [p.trace_ctx for p, _ in entries if p.trace_ctx is not None]
        try:
            # chaos seam: a rule here fails/partitions the leader at the
            # worst moment — results verified, consensus not yet reached
            _faults.fault_point("plan.raft_apply")
            # observed fold size (how many plans actually share this
            # consensus round) — the histogram operators tune
            # `plan_apply_batch` against
            metrics.observe("plan.apply_batch_size", len(entries))
            items = []
            for pending, result in entries:
                preemption_evals: list[Evaluation] = []
                if (
                    self.preemption_evals_fn is not None
                    and result.node_preemptions
                ):
                    preemption_evals = self.preemption_evals_fn(result)
                items.append((pending.plan, result, preemption_evals))
            if self.commit_batch_fn is not None:
                with metrics.measure("plan.raft_apply"):
                    index = self._commit_resolving(
                        lambda: self.commit_batch_fn(items),
                        trace_ctxs=ctxs,
                    )
            elif self.commit_fn is not None:
                with metrics.measure("plan.raft_apply"):
                    index = 0
                    for (pending, _), (plan, result, pevals) in zip(
                        entries, items
                    ):
                        # per-plan commits: a barrier resolution belongs
                        # to THIS plan's trace only, not the whole batch
                        index = self._commit_resolving(
                            lambda p=plan, r=result, pe=pevals: self.commit_fn(
                                p, r, pe
                            ),
                            trace_ctxs=(
                                (pending.trace_ctx,)
                                if pending.trace_ctx is not None
                                else ()
                            ),
                        )
            else:
                index = 0
                for plan, result, pevals in items:
                    index = self.state.upsert_plan_results(
                        None, plan, result, preemption_evals=pevals
                    )
                    if pevals and self.on_preemption_evals is not None:
                        self.on_preemption_evals(
                            [self.state.eval_by_id(e.id) for e in pevals]
                        )
            box["index"] = index
            tc1 = time.monotonic()
            for pending, result in entries:
                result.alloc_index = index
                if result.refresh_index:
                    # partial commits carry a refresh point: clamp the
                    # synthetic optimistic index to the real committed one
                    result.refresh_index = min(result.refresh_index, index)
                tracer.record_span(
                    "plan.commit", pending.trace_ctx, tc0, tc1,
                    tags={"batch": len(entries), "index": index},
                )
                pending.respond(result, None)
            self._respond_refreshed(noops, index)
        except _faults.SimulatedCrash:
            # injected leader death mid-commit: the entry never reached
            # consensus. Answer the workers with failure so their evals
            # nack-requeue — the same outcome a real dead leader produces
            # for them via RPC failure — instead of leaving them parked on
            # a 30s wait with a dead commit thread
            err = RuntimeError("plan commit crashed (injected leader death)")
            for pending, _ in entries:
                pending.respond(None, err)
            for pending, _ in noops:
                pending.respond(None, err)
        except Exception as e:
            # an unresolved in-flight entry (timeout + failed barrier) may
            # still land: floor the apply loop's snapshots past it so no
            # batch is ever verified against state that could be missing it
            floor = getattr(e, "raft_index", 0)
            if floor:
                box["floor"] = max(box.get("floor", 0), floor)
            tc1 = time.monotonic()
            for pending, _ in entries:
                tracer.record_span(
                    "plan.commit", pending.trace_ctx, tc0, tc1,
                    tags={"batch": len(entries)}, error=repr(e),
                )
                pending.respond(None, e)
            for pending, _ in noops:
                pending.respond(None, e)

    def _async_commit(self, pending: PendingPlan, result: PlanResult, box: dict):
        """Commit the verified result via consensus and answer the worker
        (ref plan_apply.go:367 asyncPlanWait)."""
        try:
            plan = pending.plan
            preemption_evals: list[Evaluation] = []
            if self.preemption_evals_fn is not None and result.node_preemptions:
                preemption_evals = self.preemption_evals_fn(result)
            if self.commit_fn is not None:
                with metrics.measure("plan.raft_apply"):
                    index = self._commit_resolving(
                        lambda: self.commit_fn(plan, result, preemption_evals)
                    )
            else:
                index = self.state.upsert_plan_results(
                    None, plan, result, preemption_evals=preemption_evals
                )
                if preemption_evals and self.on_preemption_evals is not None:
                    self.on_preemption_evals(
                        [self.state.eval_by_id(e.id) for e in preemption_evals]
                    )
            result.alloc_index = index
            box["index"] = index
            pending.respond(result, None)
        except Exception as e:
            if getattr(e, "raft_index", 0):
                box["floor"] = max(box.get("floor", 0), e.raft_index)
            pending.respond(None, e)

    def apply(self, plan: Plan) -> PlanResult:
        """Synchronous verify + commit against the latest snapshot (the
        non-overlapped path kept for direct callers/tests)."""
        snap = self.state.snapshot()
        result = evaluate_plan(snap, plan)
        if result.is_no_op() and result.refresh_index:
            return result
        pending = PendingPlan(plan)
        self._async_commit(pending, result, {})
        res, err = pending.wait(timeout=30.0)
        if err is not None:
            raise err
        return res


# ---------------------------------------------------------------------------
# the device part of the dense verify
# ---------------------------------------------------------------------------

def dense_verify(arrays, rows, row_deltas) -> np.ndarray:
    """Fit verdict per touched row, bool[k], for the rows' aggregated
    deltas (one lane per row, i64/i32[k,C]) on top of ``arrays``, the
    (capacity, usable, used) tensors of ``DeviceState.arrays()``; the
    verify runs on the planes' device. The lanes pad to the dirty-row
    bucket with row 0 and a delta of 0, as the JAX applier pads them."""
    capacity, _, used = arrays
    if not isinstance(capacity, torch.Tensor) or not isinstance(used, torch.Tensor):
        raise TypeError("dense_verify takes the planes of DeviceState.arrays() as tensors")
    k = len(rows)
    if k == 0:
        return np.zeros(0, dtype=bool)
    if min(rows) < 0 or max(rows) >= capacity.shape[0]:
        raise ValueError(f"row outside [0, {capacity.shape[0]})")
    padded, deltas = verify_lanes(rows, row_deltas)
    fits = kernel.verify_rows(capacity, used, *kernel.from_numpy((padded, deltas), capacity.device))
    return fits[:k].cpu().numpy()


def verify_lanes(rows, row_deltas) -> tuple:
    """The verify's (rows, deltas) lanes as numpy, padded to the dirty-row
    bucket with row 0 and a delta of 0 (adding 0 to row 0 changes no
    verdict)."""
    k = len(rows)
    b = DeviceState._row_bucket(k)
    padded = np.zeros(b, dtype=np.int32)
    padded[:k] = rows
    deltas = np.zeros((b, R_COLS), dtype=np.int32)
    deltas[:k] = np.stack(row_deltas)
    return padded, deltas
