"""BlockedEvals: tracks failed-placement evaluations and unblocks them when
capacity becomes available (ref nomad/blocked_evals.go:33-761).

Evals are indexed by the computed node classes they found ineligible; when a
node of a new/updated class appears, matching evals re-enter the broker.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..structs.model import EVAL_STATUS_PENDING, EVAL_TRIGGER_MAX_PLANS, Evaluation


class BlockedEvals:
    #: prune cadence / age floor for the capacity-change index maps (ref
    #: blocked_evals.go pruneInterval=5m / pruneThreshold=15m). An entry
    #: older than PRUNE_THRESHOLD can only change the answer for a
    #: scheduler snapshot at least that stale — which the nack/lease
    #: machinery retires long before. Without pruning these maps grow one
    #: entry per node id / computed class *forever* (the `_bad_http_addrs`
    #: unbounded-growth class; surfaced by the churn soak's node flaps).
    PRUNE_INTERVAL = 60.0
    PRUNE_THRESHOLD = 900.0

    def __init__(self, broker):
        self.broker = broker
        self.enabled = False
        self._lock = threading.Lock()
        # job key -> blocked eval (one per job; ref blocked_evals.go dedup)
        self._jobs: dict[tuple[str, str], Evaluation] = {}
        # eval id -> eval
        self._captured: dict[str, Evaluation] = {}
        # SYSTEM evals block per (job, node) instead of per job (ref
        # blocked_evals_system.go:5-27): a system job that failed on one
        # node must unblock when THAT node frees capacity, independently
        # of its evals blocked on other nodes
        self._system: dict[tuple[str, str, str], Evaluation] = {}
        self._system_by_node: dict[str, set[tuple[str, str, str]]] = {}
        # per-node capacity-change indexes: closes the same
        # capacity-arrived-while-blocking race for system evals that
        # _unblock_indexes closes per class
        self._node_unblock_indexes: dict[str, int] = {}
        # last state index at which capacity changed, globally and per class
        # (closes the race where capacity arrives while a scheduler is still
        # deciding to block; ref blocked_evals.go unblockIndexes)
        self._unblock_index = 0
        self._unblock_indexes: dict[str, int] = {}
        # last-touch timestamps driving the prune (one per index-map key)
        self._unblock_at: dict[str, float] = {}
        self._node_unblock_at: dict[str, float] = {}
        self._last_prune = time.monotonic()
        # evals that escaped computed classes unblock on any change
        self._escaped: set[str] = set()
        # superseded duplicates awaiting the leader's cancellation reap
        # (ref blocked_evals.go duplicates + GetDuplicates): dedup keeps
        # the NEWER eval per job; the loser lands here so its raft record
        # doesn't sit 'blocked' forever
        self._duplicates: list = []
        self._dup_cond = threading.Condition(self._lock)

    def set_enabled(self, enabled: bool):
        with self._lock:
            prev = self.enabled
            self.enabled = enabled
        if prev and not enabled:
            self.flush()

    # ------------------------------------------------------------------
    def block(self, ev: Evaluation):
        """Track a blocked eval (ref blocked_evals.go Block)."""
        requeue = False
        with self._lock:
            if not self.enabled:
                return
            # Capacity changed after the scheduler's snapshot: the eval may
            # already fit, so re-enqueue instead of blocking
            # (ref blocked_evals.go missedUnblock)
            if ev.snapshot_index and self._missed_unblock(ev):
                requeue = True
            if ev.node_id:
                # per-node system blocked eval (one per job+node,
                # ref blocked_evals_system.go); never touches the
                # job-level dedup maps
                if not requeue:
                    skey = (ev.namespace, ev.job_id, ev.node_id)
                    self._system[skey] = ev
                    self._system_by_node.setdefault(
                        ev.node_id, set()
                    ).add(skey)
            else:
                key = (ev.namespace, ev.job_id)
                # Dedup: one blocked eval per job; the NEWER create_index
                # wins and the loser joins the duplicates reap list
                # (ref blocked_evals.go Block dedup semantics)
                existing = self._jobs.get(key)
                if existing is not None and existing.id == ev.id:
                    # re-block of the already-tracked eval (leader restore
                    # replay, FSM + caller double-routing): refresh only
                    existing = None
                if existing is not None and not requeue:
                    if existing.create_index <= ev.create_index:
                        loser, winner = existing, ev
                    else:
                        loser, winner = ev, existing
                    self._captured.pop(existing.id, None)
                    self._escaped.discard(existing.id)
                    self._duplicates.append(loser)
                    self._dup_cond.notify_all()
                    ev = winner
                if not requeue:
                    self._jobs[key] = ev
                    self._captured[ev.id] = ev
                    if ev.escaped_computed_class:
                        self._escaped.add(ev.id)
        if requeue:
            requeued = ev.copy()
            requeued.status = EVAL_STATUS_PENDING
            self.broker.enqueue(requeued)

    def _missed_unblock(self, ev: Evaluation) -> bool:
        """Did a relevant capacity change land after the eval's snapshot?"""
        if ev.node_id:
            # system eval: only ITS node's capacity changes matter
            return (
                self._node_unblock_indexes.get(ev.node_id, 0)
                > ev.snapshot_index
            )
        if ev.escaped_computed_class:
            return self._unblock_index > ev.snapshot_index
        elig = ev.class_eligibility or {}
        for cls, index in self._unblock_indexes.items():
            if index <= ev.snapshot_index:
                continue
            if elig.get(cls, True):  # eligible or never-evaluated class
                return True
        return False

    def get_duplicates(self, timeout: float = 0.0) -> list:
        """Drain superseded duplicate evals, optionally blocking up to
        ``timeout`` for one to appear (ref blocked_evals.go GetDuplicates;
        the leader's reap loop cancels what this returns)."""
        with self._dup_cond:
            if not self._duplicates and timeout > 0:
                self._dup_cond.wait(timeout)
            out = self._duplicates
            self._duplicates = []
            return out

    def untrack(self, namespace: str, job_id: str):
        """Stop tracking a job's blocked eval (e.g. job deregistered)."""
        with self._lock:
            ev = self._jobs.pop((namespace, job_id), None)
            if ev is not None:
                self._captured.pop(ev.id, None)
                self._escaped.discard(ev.id)
            for skey in [
                k for k in self._system if k[0] == namespace and k[1] == job_id
            ]:
                self._system.pop(skey, None)
                nodes = self._system_by_node.get(skey[2])
                if nodes is not None:
                    nodes.discard(skey)

    # ------------------------------------------------------------------
    def _prune_locked(self):
        """Drop index-map entries idle past PRUNE_THRESHOLD (ref
        blocked_evals.go pruneUnblockIndexes). A dropped entry reads as 0
        in ``_missed_unblock`` — the same answer a node/class that never
        changed capacity gives — so the only behavior change is for
        snapshots older than the threshold."""
        now = time.monotonic()
        if now - self._last_prune < self.PRUNE_INTERVAL:
            return
        self._last_prune = now
        cutoff = now - self.PRUNE_THRESHOLD
        for key in [k for k, t in self._unblock_at.items() if t < cutoff]:
            del self._unblock_at[key]
            self._unblock_indexes.pop(key, None)
        for key in [k for k, t in self._node_unblock_at.items() if t < cutoff]:
            del self._node_unblock_at[key]
            self._node_unblock_indexes.pop(key, None)

    def unblock_node(self, node_id: str, index: int):
        """Capacity on one node changed (alloc became terminal, node
        re-registered or turned ready): re-enqueue the SYSTEM evals
        blocked on exactly that node (ref blocked_evals_system.go
        UnblockNode)."""
        to_unblock = []
        with self._lock:
            if not self.enabled:
                return
            self._unblock_index = max(self._unblock_index, index)
            self._node_unblock_indexes[node_id] = max(
                self._node_unblock_indexes.get(node_id, 0), index
            )
            self._node_unblock_at[node_id] = time.monotonic()
            self._prune_locked()
            for skey in self._system_by_node.pop(node_id, set()):
                ev = self._system.pop(skey, None)
                if ev is not None:
                    to_unblock.append(ev)
        for ev in to_unblock:
            requeued = ev.copy()
            requeued.status = EVAL_STATUS_PENDING
            self.broker.enqueue(requeued)

    # ------------------------------------------------------------------
    def unblock(self, computed_class: str, index: int):
        """Capacity for a node class changed: re-enqueue matching evals
        (ref blocked_evals.go Unblock)."""
        to_unblock = []
        with self._lock:
            if not self.enabled:
                return
            self._unblock_index = max(self._unblock_index, index)
            self._unblock_indexes[computed_class] = max(
                self._unblock_indexes.get(computed_class, 0), index
            )
            self._unblock_at[computed_class] = time.monotonic()
            self._prune_locked()
            for eval_id, ev in list(self._captured.items()):
                if self._should_unblock(ev, computed_class):
                    to_unblock.append(ev)
                    self._captured.pop(eval_id, None)
                    self._escaped.discard(eval_id)
                    self._jobs.pop((ev.namespace, ev.job_id), None)
        for ev in to_unblock:
            requeued = ev.copy()
            requeued.status = EVAL_STATUS_PENDING
            self.broker.enqueue(requeued)

    def unblock_all(self, index: int = 0):
        """Unblock everything (e.g. new node registered with unknown class)."""
        with self._lock:
            evals = list(self._captured.values())
            evals.extend(self._system.values())
            self._captured.clear()
            self._escaped.clear()
            self._jobs.clear()
            self._system.clear()
            self._system_by_node.clear()
        for ev in evals:
            requeued = ev.copy()
            requeued.status = EVAL_STATUS_PENDING
            self.broker.enqueue(requeued)

    @staticmethod
    def _should_unblock(ev: Evaluation, computed_class: str) -> bool:
        """ref blocked_evals.go:missedUnblock semantics (inverted): an eval
        unblocks unless it explicitly marked this class ineligible."""
        if ev.escaped_computed_class:
            return True
        elig = ev.class_eligibility or {}
        if computed_class in elig:
            return elig[computed_class]
        # Unknown class: the eval never evaluated it, so it may now fit
        return True

    def unblock_failed(self):
        """Re-enqueue evals blocked due to max plan attempts after a cooldown
        (ref blocked_evals.go UnblockFailed)."""
        with self._lock:
            failed = [
                ev
                for ev in self._captured.values()
                if ev.triggered_by == EVAL_TRIGGER_MAX_PLANS
            ]
            for ev in failed:
                self._captured.pop(ev.id, None)
                self._escaped.discard(ev.id)
                self._jobs.pop((ev.namespace, ev.job_id), None)
        for ev in failed:
            requeued = ev.copy()
            requeued.status = EVAL_STATUS_PENDING
            self.broker.enqueue(requeued)

    def flush(self):
        with self._lock:
            self._jobs.clear()
            self._captured.clear()
            self._escaped.clear()
            self._system.clear()
            self._system_by_node.clear()
            # the index maps are leadership-scoped state like everything
            # else here: a revoked leader must not carry them into its
            # next term (and an unflushed map is an unbounded one)
            self._unblock_indexes.clear()
            self._node_unblock_indexes.clear()
            self._unblock_at.clear()
            self._node_unblock_at.clear()
            self._duplicates = []

    def stats(self) -> dict:
        with self._lock:
            return {
                "total_blocked": len(self._captured) + len(self._system),
                "total_escaped": len(self._escaped),
                "total_system_blocked": len(self._system),
            }
