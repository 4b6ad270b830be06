"""Scheduler worker: dequeues evals, snapshots state, runs the scheduler, and
submits plans (ref nomad/worker.go:74-523).

The port's copy of ``nomad_tpu/core/worker.py``: the schedulers and the
drain collector run on the server's device (``server.device``).

The worker implements the scheduler's Planner protocol: SubmitPlan routes
through the leader's plan queue (optimistic concurrency), and a RefreshIndex
response hands the scheduler a newer snapshot to retry against.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Optional

import itertools

from ..scheduler.scheduler import new_scheduler
from ..testing import faults as _faults
from ..trace import tracer
from ..structs.model import (
    EVAL_STATUS_FAILED,
    Evaluation,
    Plan,
    PlanResult,
)
from .broker import FAILED_QUEUE, BrokerError
from .overload import DeadlineExceeded

logger = logging.getLogger("nomad_tpu.worker")

DEQUEUE_TIMEOUT = 0.5
RAFT_SYNC_LIMIT = 5.0

#: process-wide worker thread numbering — the name is the debug
#: profiler's classification key ("worker" class)
_WORKER_SEQ = itertools.count()




class Worker:
    """One scheduling worker (the reference runs NumCPU of these)."""

    def __init__(self, server, schedulers: Optional[list[str]] = None, seed=None):
        self.server = server
        # _failed is drained by the leader's reaper (Server._reap_failed_evals),
        # not by scheduling workers (ref leader.go:505 reapFailedEvaluations)
        self.schedulers = schedulers or ["service", "batch", "system", "_core"]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.seed = seed
        # set per-invocation; lets SubmitPlan attach the eval token and
        # blocked evals record the snapshot they were evaluated against
        self._eval_token = ""
        self._eval: Optional[Evaluation] = None
        self._snapshot_index = 0

    # ------------------------------------------------------------------
    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run, daemon=True,
            name=f"sched-worker-{next(_WORKER_SEQ)}",
        )
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def run(self):
        """ref worker.go:105-140"""
        while not self._stop.is_set():
            ev, token = self.server.eval_broker.dequeue(
                self.schedulers, timeout=DEQUEUE_TIMEOUT
            )
            if ev is None:
                continue
            try:
                self.process_eval(ev, token)
            except _faults.SimulatedCrash:
                # the chaos harness killed this worker "process": no ack,
                # no nack — the broker's nack timer requeues the eval when
                # the lease expires, as with a real worker death
                logger.warning("worker crash injected; thread exiting")
                return

    # ------------------------------------------------------------------
    def _snapshot_with_lease(self, ev: Evaluation, token: str):
        """Wait for the eval's raft index in sub-lease slices, extending
        the broker lease between slices so a sync that outlasts
        nack_timeout can't nack the eval out from under a live worker
        (ref worker.go waitForIndex, which resets the lease periodically
        INSIDE the wait — a single post-wait reset fires only after the
        nack already landed)."""
        broker = self.server.eval_broker
        slice_ = max(min(broker.nack_timeout / 2.0, RAFT_SYNC_LIMIT), 0.05)
        deadline = time.monotonic() + RAFT_SYNC_LIMIT
        while True:
            remaining = deadline - time.monotonic()
            try:
                return self.server.state.snapshot_min_index(
                    ev.modify_index,
                    timeout=min(slice_, max(remaining, 0.01)),
                )
            except TimeoutError:
                if time.monotonic() >= deadline:
                    raise
                # still waiting, still making progress: extend the lease
                try:
                    broker.outstanding_reset(ev.id, token)
                except BrokerError:
                    pass

    def _fail_deadline_exceeded(self, ev: Evaluation, token: str, where: str):
        """Terminal resolution of expired work (core/overload.py): mark
        the eval failed ``deadline_exceeded`` and ACK it — nacking would
        requeue work nobody is waiting on anymore, and the broker would
        only refuse it again at the next dequeue."""
        logger.warning(
            "eval %s deadline exceeded at %s; failing terminal",
            ev.id[:8], where,
        )
        if where == "worker":
            # the applier/drain stages count their own refusal metric at
            # the refusal point; the worker-stage refusal is counted here
            from .. import metrics

            metrics.incr("overload.deadline_exceeded.worker")
        try:
            self.server.eval_deadline_exceeded(ev, where)
        except Exception:
            logger.exception(
                "deadline-exceeded update failed for %s", ev.id[:8]
            )
        try:
            self.server.eval_broker.ack(ev.id, token)
        except BrokerError:
            pass

    def process_eval(self, ev: Evaluation, token: str, snapshot=None, collector=None):
        """Dequeue → snapshot ≥ wait index → invoke scheduler → ack/nack
        (ref worker.go:142-276). ``snapshot``/``collector`` are supplied by
        the batch-drain path (one shared snapshot, fused kernel)."""
        if ev.deadline and time.time_ns() >= ev.deadline:
            # refuse BEFORE the snapshot wait and the scheduler invoke:
            # the deadline passed between broker delivery and here
            if collector is not None:
                collector.leave(ev.id)
            self._fail_deadline_exceeded(ev, token, "worker")
            return
        try:
            # the worker's slice of the eval's span tree: dequeue → ack
            # on THIS worker (a nack + re-dequeue elsewhere adds another
            # worker.process span to the same trace)
            with tracer.span(
                "worker.process",
                parent=tracer.ctx_for_eval(ev.id),
                tags={"eval_type": ev.type},
            ):
                # inside the try so an "error"-action rule nacks like any
                # processing failure; a "crash" rule raises SimulatedCrash
                # (BaseException) straight past the handler, like a real
                # death
                _faults.fault_point("worker.post_dequeue")
                if snapshot is None:
                    with tracer.span("eval.snapshot_wait"):
                        snapshot = self._snapshot_with_lease(ev, token)
                    # fresh lease for the scheduling pass itself
                    try:
                        self.server.eval_broker.outstanding_reset(
                            ev.id, token
                        )
                    except BrokerError:
                        pass
                self._eval_token = token
                self._eval = ev
                self._snapshot_index = snapshot.latest_index()
                self.invoke_scheduler(snapshot, ev, collector=collector)
        except DeadlineExceeded as e:
            # a downstream stage (applier verify/commit, drain dispatch)
            # refused the work past its deadline: terminal, not a nack —
            # retrying expired work only deepens the overload
            self._fail_deadline_exceeded(
                ev, token, getattr(e, "where", "") or "worker"
            )
            return
        except Exception:
            logger.exception("eval processing failed; nacking %s", ev.id)
            try:
                self.server.eval_broker.nack(ev.id, token)
            except BrokerError:
                pass
            return
        finally:
            self._eval_token = ""
            self._eval = None
            if collector is not None:
                # no-op if the eval submitted or already left (fallback)
                collector.leave(ev.id)
        try:
            self.server.eval_broker.ack(ev.id, token)
        except BrokerError:
            pass

    def invoke_scheduler(self, snapshot, ev: Evaluation, collector=None):
        """ref worker.go:244-276"""
        if ev.type == "_core":
            # GC runs in-worker against the snapshot (core_sched.go:26)
            from .core_sched import CoreScheduler

            CoreScheduler(self.server, snapshot).process(ev)
            return
        rng = random.Random(self.seed) if self.seed is not None else None
        sched_name = ev.type
        override = self.server.config.get("default_scheduler")
        if override:
            # route evals through the TPU backends: service/batch take the
            # generic-semantics tpu-batch, system takes the plane-batched
            # tpu-system. A non-generic override must never reach
            # service/batch evals (system semantics ignore group counts).
            if ev.type in ("service", "batch") and override in (
                "tpu-batch", "service", "batch"
            ):
                sched_name = override
            elif ev.type == "system" and override in ("tpu-batch", "tpu-system"):
                sched_name = "tpu-system"
        sched = new_scheduler(
            sched_name, snapshot, self, rng=rng, device=self.server.device
        )
        if collector is not None and hasattr(sched, "drain_collector"):
            # non-tpu schedulers simply never consume the collector; the
            # caller's finally-leave covers them
            sched.drain_collector = collector
        from .. import metrics

        with tracer.span(
            "eval.evaluate",
            tags={"scheduler": sched_name},
            metric=f"worker.invoke_scheduler.{sched_name}",
        ):
            sched.process(ev)
        metrics.incr(f"worker.evals_processed.{ev.type}")

    # ------------------------------------------------------------------
    # Planner protocol (ref worker.go:347-523)
    # ------------------------------------------------------------------
    def submit_plan(self, plan: Plan):
        """Attach the eval token, route through the plan queue, and hand back
        a fresh snapshot when the applier asks for a refresh. SnapshotIndex
        is the index this worker actually EVALUATED against (ref worker.go
        SubmitPlan), not the store head: the pipelined applier floors its
        verify snapshot at the batch's max SnapshotIndex, and chasing
        unrelated writes that landed after the scheduler ran only adds
        commit latency without adding safety (the applier re-verifies
        against its own, always-newer, base anyway)."""
        _faults.fault_point("worker.pre_submit")
        plan.eval_token = self._eval_token
        plan.snapshot_index = self._snapshot_index
        with tracer.span("plan.submit", metric="plan.submit"):
            result, error = self.server.plan_submit(plan)
        if error is not None:
            raise error
        if result is None:
            raise RuntimeError("plan submission timed out")

        new_state = None
        if result.refresh_index:
            with tracer.span("plan.refresh_wait"):
                new_state = self.server.state.snapshot_min_index(
                    result.refresh_index, timeout=RAFT_SYNC_LIMIT
                )
            # the scheduler retries against the refreshed snapshot: later
            # submits must carry ITS index (worker.go updates its snapshot
            # watermark on refresh)
            self._snapshot_index = new_state.latest_index()
        return result, new_state

    def update_eval(self, ev: Evaluation):
        """ref worker.go:426-445 (raft Eval.Update; broker routing happens
        in the FSM apply)"""
        self.server.update_evals([ev])
        if ev.status == EVAL_STATUS_FAILED:
            logger.warning("eval failed: %s (%s)", ev.id, ev.status_description)

    def create_eval(self, ev: Evaluation):
        """ref worker.go:447-466"""
        if ev.should_block() and not ev.snapshot_index:
            ev.snapshot_index = self._snapshot_index
        self.server.update_evals([ev])

    def reblock_eval(self, ev: Evaluation):
        """ref worker.go:468-523"""
        if not ev.snapshot_index:
            ev.snapshot_index = self._snapshot_index
        self.server.update_evals([ev])

    def note_kernel_fault(self, reason: str):
        """Surface a device-tier fault the scheduler degraded around
        (tpu/batch_sched.py exact-np fallback): metric + node event on the
        TPU plane. Best-effort — the eval itself already succeeded, and a
        leadership change mid-emission must not fail it retroactively."""
        try:
            self.server.note_kernel_fault(self._eval, reason)
        except Exception:
            logger.exception("kernel-fault event emission failed")


class BatchDrainWorker(Worker):
    """Worker that drains up to ``batch_size`` ready evals per cycle and
    fuses their placement scans into one kernel invocation (the north-star
    bridge: EvalBroker.dequeue_batch → one multi-eval program → individual
    plan submission and ack/nack; SURVEY §2.3, worker.go:105-276).

    Each drained eval runs its full scheduler bookkeeping on its own thread
    against one shared snapshot; their kernels rendezvous at a
    KernelBatchCollector. At-least-once semantics are untouched: every eval
    is acked/nacked individually by its own thread.

    Within a batch the collector double-buffers: the fused kernel is
    dispatched asynchronously and every parked eval wakes AT DISPATCH with
    device handles, so host-side materialization (and the broker refilling
    for the next batch) overlaps device compute. Deeper pipelining —
    spawning batch N+1's eval threads while N's plans are still
    committing — measured strictly worse here: it doubles the optimistic
    plan-apply race surface (≈2× refresh retries) and the extra threads
    contend for the interpreter lock exactly when batch N is
    materializing, so batches are joined before the next dequeue.
    """

    def __init__(self, server, schedulers=None, seed=None, batch_size: int = 16):
        super().__init__(server, schedulers, seed)
        self.batch_size = batch_size

    def run(self):
        while not self._stop.is_set():
            batch = self.server.eval_broker.dequeue_batch(
                self.schedulers, self.batch_size, timeout=DEQUEUE_TIMEOUT
            )
            if not batch:
                continue
            try:
                threads = self.process_batch(batch)
            except _faults.SimulatedCrash:
                # single-eval batches run on this thread: an injected
                # crash kills the whole worker, leases clean up
                logger.warning("drain worker crash injected; thread exiting")
                return
            for t in threads:
                t.join(timeout=120.0)

    def process_batch(self, batch: list) -> list:
        """Spawn one thread per drained eval; returns the threads for the
        run loop to join."""
        live = []
        for ev, token in batch:
            if ev.deadline and time.time_ns() >= ev.deadline:
                # expired between broker delivery and the batch forming:
                # refuse before the shared snapshot wait and the fused
                # kernel ever see it
                self._fail_deadline_exceeded(ev, token, "worker")
            else:
                live.append((ev, token))
        batch = live
        if not batch:
            return []
        if len(batch) == 1:
            self.process_eval(*batch[0])
            return []

        from ..tpu.drain import KernelBatchCollector, SharedCluster

        try:
            snapshot = self.server.state.snapshot_min_index(
                max(ev.modify_index for ev, _ in batch), timeout=RAFT_SYNC_LIMIT
            )
        except Exception:
            logger.exception("drain snapshot failed; nacking batch")
            for ev, token in batch:
                try:
                    self.server.eval_broker.nack(ev.id, token)
                except BrokerError:
                    pass
            return []

        shared = SharedCluster.from_snapshot(
            snapshot, mirror=getattr(self.server, "columnar_mirror", None)
        )
        collector = KernelBatchCollector(
            shared, expected=len(batch), pad_evals=self.batch_size,
            device=self.server.device,
        )
        threads = []
        for ev, token in batch:
            # one planner per eval: SubmitPlan attaches per-eval tokens and
            # refresh snapshots, so workers can't be shared across threads
            w = Worker(self.server, self.schedulers, seed=self.seed)

            def run_one(w=w, ev=ev, token=token):
                try:
                    w.process_eval(
                        ev, token, snapshot=snapshot, collector=collector
                    )
                except _faults.SimulatedCrash:
                    # injected death of one drain lane: no ack/nack — the
                    # broker lease expiry requeues the eval
                    logger.warning(
                        "drain worker crash injected; eval %s left to "
                        "lease expiry",
                        ev.id,
                    )

            # "drain-eval" classifies as worker-class for the profiler:
            # these lanes do the actual plan.submit waiting
            t = threading.Thread(
                target=run_one, daemon=True, name=f"drain-eval-{ev.id[:8]}"
            )
            threads.append(t)
            t.start()
        return threads
