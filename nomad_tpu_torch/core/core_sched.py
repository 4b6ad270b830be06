"""CoreScheduler: garbage collection of terminal state
(ref nomad/core_sched.go:26-705).

GC runs as ``_core`` evaluations processed by ordinary scheduler workers:
the leader's periodic loop enqueues one eval per GC family on its interval
(leader.go:440-486 schedulePeriodic), and ``/v1/system/gc`` enqueues a
``force-gc`` eval that reaps everything eligible regardless of age. Age is
measured in raft indexes via a TimeTable (a coarse time→index witness map,
ref fsm.go TimeTable): an object is old enough when its modify index is at
or below the index the cluster had reached ``threshold`` ago.

Families (thresholds are config keys, defaults as the reference's):

- ``eval-gc`` (eval_gc_threshold, 1h): terminal evals whose allocs are all
  terminal/GC-eligible; batch-job evals are skipped while their job lives
  (a re-run would re-place reaped allocs, core_sched.go:301-327) but their
  older-version terminal allocs are still collected.
- ``job-gc`` (job_gc_threshold, 4h): dead/stopped jobs all of whose evals
  (allowBatch=true) and allocs are reapable; deregisters the jobs and reaps
  their evals/allocs in one pass.
- ``node-gc`` (node_gc_threshold, 24h): down nodes with no non-terminal
  allocs.
- ``deployment-gc`` (deployment_gc_threshold, 1h): terminal deployments.
- ``force-gc``: all of the above with an infinite threshold; node GC runs
  last so alloc reaping has already emptied the nodes.
"""

from __future__ import annotations

import bisect
import logging
import time
from typing import Optional

from ..structs.model import (
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_RUNNING,
    ALLOC_DESIRED_STATUS_STOP,
    JOB_STATUS_DEAD,
    Evaluation,
    generate_uuid,
)

logger = logging.getLogger("nomad_tpu.core_sched")

CORE_JOB_EVAL_GC = "eval-gc"
CORE_JOB_NODE_GC = "node-gc"
CORE_JOB_JOB_GC = "job-gc"
CORE_JOB_DEPLOYMENT_GC = "deployment-gc"
CORE_JOB_FORCE_GC = "force-gc"

#: default thresholds (seconds), ref nomad/config.go DefaultConfig
DEFAULT_EVAL_GC_THRESHOLD = 3600.0
DEFAULT_JOB_GC_THRESHOLD = 4 * 3600.0
DEFAULT_NODE_GC_THRESHOLD = 24 * 3600.0
DEFAULT_DEPLOYMENT_GC_THRESHOLD = 3600.0

#: cap ids per raft reap message (core_sched.go maxIdsPerReap)
MAX_IDS_PER_REAP = 8192


class TimeTable:
    """Coarse monotone map from wall time to raft index (ref
    nomad/timetable.go: 5-minute granularity, 72h horizon): the FSM and the
    leader's GC loop witness (index, now) at a bounded granularity, and
    nearest_index(cutoff) returns the highest index known to be at or
    before the cutoff time.

    The retained horizon must exceed the largest GC threshold it serves
    (node GC's 24h): with the defaults the table spans ~68h, and a trim
    keeps the newest half (~34h), so a continuously-active cluster never
    loses the cutoff entry a threshold needs. Witnessed from the raft-apply
    path, the GC cron, and read by worker threads — all under the lock."""

    def __init__(self, granularity: float = 60.0, limit: int = 4096):
        import threading

        self.granularity = granularity
        self.limit = limit
        self._lock = threading.Lock()
        self._times: list[float] = []
        self._indexes: list[int] = []

    def witness(self, index: int, when: Optional[float] = None):
        when = time.time() if when is None else when
        with self._lock:
            if self._times and when - self._times[-1] < self.granularity:
                return
            if self._indexes and index <= self._indexes[-1]:
                return
            self._times.append(when)
            self._indexes.append(index)
            if len(self._times) > self.limit:
                self._times = self._times[self.limit // 2 :]
                self._indexes = self._indexes[self.limit // 2 :]

    def nearest_index(self, cutoff: float) -> int:
        """Highest witnessed index with time <= cutoff (0 if none)."""
        with self._lock:
            i = bisect.bisect_right(self._times, cutoff)
            if i == 0:
                return 0
            return self._indexes[i - 1]

    def to_dict(self) -> dict:
        with self._lock:
            return {"times": list(self._times), "indexes": list(self._indexes)}

    def restore(self, data: dict):
        with self._lock:
            self._times = list(data.get("times", []))
            self._indexes = list(data.get("indexes", []))


def core_job_eval(job_id: str, modify_index: int, priority: int = 200) -> Evaluation:
    """An evaluation for a core job (ref leader.go:488 coreJobEval)."""
    return Evaluation(
        id=generate_uuid(),
        namespace="-",
        priority=priority,
        type="_core",
        triggered_by="scheduled",
        job_id=job_id,
        status="pending",
        modify_index=modify_index,
    )


class CoreScheduler:
    """Processes ``_core`` evaluations against a snapshot, reaping through
    the server's raft apply (ref core_sched.go:26 NewCoreScheduler)."""

    def __init__(self, server, snapshot):
        self.server = server
        self.snap = snapshot

    # ------------------------------------------------------------------
    def process(self, eval: Evaluation):
        handlers = {
            CORE_JOB_EVAL_GC: self.eval_gc,
            CORE_JOB_NODE_GC: self.node_gc,
            CORE_JOB_JOB_GC: self.job_gc,
            CORE_JOB_DEPLOYMENT_GC: self.deployment_gc,
            CORE_JOB_FORCE_GC: self.force_gc,
        }
        handler = handlers.get(eval.job_id)
        if handler is None:
            raise ValueError(f"core scheduler cannot handle job {eval.job_id!r}")
        return handler(eval)

    # ------------------------------------------------------------------
    def force_gc(self, eval: Evaluation):
        self.job_gc(eval)
        self.eval_gc(eval)
        self.deployment_gc(eval)
        # node GC last so the alloc reaping above has emptied the nodes
        self.node_gc(eval)

    # ------------------------------------------------------------------
    def _threshold(self, eval: Evaluation, config_key: str, default: float) -> int:
        if eval.job_id == CORE_JOB_FORCE_GC:
            return 2**63 - 1
        threshold = float(self.server.config.get(config_key, default))
        cutoff = time.time() - threshold
        return self.server.time_table.nearest_index(cutoff)

    # ------------------------------------------------------------------
    def eval_gc(self, eval: Evaluation):
        """ref core_sched.go:215-266"""
        threshold = self._threshold(
            eval, "eval_gc_threshold", DEFAULT_EVAL_GC_THRESHOLD
        )
        gc_eval: list[str] = []
        gc_alloc: list[str] = []
        for ev in list(self.snap.evals()):
            if ev.type == "_core":
                # core evals normally live only in the leader's broker, but
                # one that exhausts its delivery limit is persisted as
                # failed by the failed-eval reaper (server._reap_failed_evals
                # applies EVAL_UPDATE) — reap those here
                if ev.terminal_status() and ev.modify_index <= threshold:
                    gc_eval.append(ev.id)
                continue
            gc, allocs = self._gc_eval(ev, threshold, allow_batch=False)
            if gc:
                gc_eval.append(ev.id)
            gc_alloc.extend(allocs)
        if gc_eval or gc_alloc:
            logger.info("eval GC: %d evals, %d allocs", len(gc_eval), len(gc_alloc))
            self._eval_reap(gc_eval, gc_alloc)

    def _gc_eval(
        self, ev: Evaluation, threshold: int, allow_batch: bool
    ) -> tuple[bool, list[str]]:
        """Whether ``ev`` (and which of its allocs) can be reaped
        (ref core_sched.go:269-344)."""
        if not ev.terminal_status() or ev.modify_index > threshold:
            return False, []
        job = self.snap.job_by_id(ev.namespace, ev.job_id)
        allocs = self.snap.allocs_by_eval(ev.id)

        if ev.type == "batch":
            # never reap a live batch job's allocs — the scheduler would
            # re-run them (core_sched.go:301-327)
            collect = False
            if job is None:
                collect = True
            elif job.status != JOB_STATUS_DEAD:
                collect = False
            elif job.stop:
                collect = True
            elif allow_batch:
                collect = True
            if not collect:
                # terminal allocs from an older job incarnation (purge +
                # re-register under the same id gives a fresh create_index;
                # in-place updates preserve it, so this matches exactly the
                # reference's alloc.Job.CreateIndex < job.CreateIndex test,
                # core_sched.go:345-355 — no age threshold there either)
                old = [
                    a.id
                    for a in allocs
                    if a.job is not None
                    and job is not None
                    and a.job.create_index < job.create_index
                    and a.terminal_status()
                ]
                return False, old

        gc = True
        gc_allocs = []
        for alloc in allocs:
            if self._alloc_gc_eligible(alloc, job, threshold):
                gc_allocs.append(alloc.id)
            else:
                gc = False
        return gc, gc_allocs

    def _alloc_gc_eligible(self, alloc, job, threshold: int) -> bool:
        """ref core_sched.go:643-684 allocGCEligible"""
        if not alloc.terminal_status() or alloc.modify_index > threshold:
            return False
        if alloc.client_status == ALLOC_CLIENT_STATUS_RUNNING:
            return False
        if job is None or job.stop or job.status == JOB_STATUS_DEAD:
            return True
        if alloc.desired_status == ALLOC_DESIRED_STATUS_STOP:
            return True
        if alloc.client_status != ALLOC_CLIENT_STATUS_FAILED:
            return True
        # failed allocs may still owe a reschedule; keep them until the
        # policy can't use them anymore
        tg = job.lookup_task_group(alloc.task_group)
        policy = tg.reschedule_policy if tg is not None else None
        if policy is None or (not policy.unlimited and policy.attempts == 0):
            return True
        if policy.unlimited:
            # next-eval decisions need the tracker regardless of age
            return False
        tracker = alloc.reschedule_tracker
        attempted = len(tracker.events) if tracker is not None else 0
        return attempted >= policy.attempts

    # ------------------------------------------------------------------
    def job_gc(self, eval: Evaluation):
        """ref core_sched.go:78-160"""
        threshold = self._threshold(
            eval, "job_gc_threshold", DEFAULT_JOB_GC_THRESHOLD
        )
        gc_jobs = []
        gc_eval: list[str] = []
        gc_alloc: list[str] = []
        for job in list(self.snap.jobs()):
            if not (job.status == JOB_STATUS_DEAD and (job.stop or job.type == "batch")):
                continue
            if job.create_index > threshold:
                continue
            if getattr(job, "periodic", None) is not None or getattr(
                job, "parameterized_job", None
            ) is not None:
                # parents GC only when explicitly stopped (children GC as
                # ordinary dead jobs)
                if not job.stop:
                    continue
            evals = self.snap.evals_by_job(job.namespace, job.id)
            all_gc = True
            job_evals: list[str] = []
            job_allocs: list[str] = []
            for ev in evals:
                gc, allocs = self._gc_eval(ev, threshold, allow_batch=True)
                if gc:
                    job_evals.append(ev.id)
                    job_allocs.extend(allocs)
                else:
                    all_gc = False
                    break
            if all_gc:
                gc_jobs.append(job)
                gc_eval.extend(job_evals)
                gc_alloc.extend(job_allocs)

        if not (gc_jobs or gc_eval or gc_alloc):
            return
        logger.info(
            "job GC: %d jobs, %d evals, %d allocs",
            len(gc_jobs), len(gc_eval), len(gc_alloc),
        )
        self._eval_reap(gc_eval, gc_alloc)
        self._job_reap(gc_jobs)

    # ------------------------------------------------------------------
    def node_gc(self, eval: Evaluation):
        """ref core_sched.go:414-487"""
        threshold = self._threshold(
            eval, "node_gc_threshold", DEFAULT_NODE_GC_THRESHOLD
        )
        gc_nodes = []
        for node in list(self.snap.nodes()):
            if not node.terminal_status() or node.modify_index > threshold:
                continue
            allocs = self.snap.allocs_by_node_terminal(node.id, False)
            if allocs:
                # non-terminal allocs: the scheduler hasn't transitioned
                # them yet; delay GC
                continue
            gc_nodes.append(node.id)
        if not gc_nodes:
            return
        logger.info("node GC: %d nodes", len(gc_nodes))
        from . import fsm as fsm_mod

        for chunk in _partition(gc_nodes, MAX_IDS_PER_REAP):
            for node_id in chunk:
                self.server._apply(fsm_mod.NODE_DEREGISTER, {"node_id": node_id})

    # ------------------------------------------------------------------
    def deployment_gc(self, eval: Evaluation):
        """ref core_sched.go:527-600"""
        threshold = self._threshold(
            eval, "deployment_gc_threshold", DEFAULT_DEPLOYMENT_GC_THRESHOLD
        )
        gc_deployments = []
        for d in list(self.snap.deployments()):
            if d.active() or d.modify_index > threshold:
                continue
            # skip deployments still referenced by non-terminal allocs
            allocs = self.snap.allocs_by_deployment(d.id)
            if any(not a.terminal_status() for a in allocs):
                continue
            gc_deployments.append(d.id)
        if not gc_deployments:
            return
        logger.info("deployment GC: %d deployments", len(gc_deployments))
        from . import fsm as fsm_mod

        for chunk in _partition(gc_deployments, MAX_IDS_PER_REAP):
            self.server._apply(
                fsm_mod.DEPLOYMENT_DELETE, {"deployment_ids": chunk}
            )

    # ------------------------------------------------------------------
    def _eval_reap(self, evals: list[str], allocs: list[str]):
        """ref core_sched.go:346-412 evalReap (partitioned raft deletes)"""
        from . import fsm as fsm_mod

        if allocs and self.server.vault.enabled():
            self.server.vault.revoke_for_allocs(list(allocs))

        evals = list(evals)
        allocs = list(allocs)
        while evals or allocs:
            chunk_e = evals[:MAX_IDS_PER_REAP]
            evals = evals[MAX_IDS_PER_REAP:]
            budget = MAX_IDS_PER_REAP - len(chunk_e)
            chunk_a = allocs[:budget]
            allocs = allocs[budget:]
            self.server._apply(
                fsm_mod.EVAL_DELETE, {"eval_ids": chunk_e, "alloc_ids": chunk_a}
            )

    def _job_reap(self, jobs: list):
        from . import fsm as fsm_mod

        for chunk in _partition(jobs, MAX_IDS_PER_REAP):
            self.server._apply(
                fsm_mod.JOB_BATCH_DEREGISTER,
                {
                    "jobs": [
                        {"namespace": j.namespace, "job_id": j.id, "purge": True}
                        for j in chunk
                    ]
                },
            )


def _partition(items: list, size: int) -> list[list]:
    return [items[i : i + size] for i in range(0, len(items), size)]
