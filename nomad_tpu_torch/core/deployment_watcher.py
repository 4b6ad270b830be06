"""Deployment watcher: leader-side subsystem driving deployment state
machines (ref nomad/deploymentwatcher/deployments_watcher.go:89 Watcher,
deployment_watcher.go:66 deploymentWatcher).

One lightweight watcher thread per active deployment, fed by blocking
queries on the deployment + alloc tables. Responsibilities, matching the
reference:

- auto-promote canaries once every group's canaries are healthy
  (deployment_watcher.go:269 autoPromoteDeployment);
- fail the deployment when an alloc reports unhealthy, rolling the job
  back to its latest stable version when ``auto_revert`` is set
  (deployment_watcher.go handleAllocUpdate → FailDeployment);
- enforce the per-group progress deadline (watchers arm a deadline timer,
  extended on every healthy alloc; deployment_watcher.go:523 watch);
- mark the job version stable when the deployment succeeds
  (state UpdateJobStability via the status-update raft entry);
- surface the manual RPCs: SetAllocHealth / Promote / Pause / Fail
  (deployments_watcher.go:319-352).

Every state change rides a single raft entry carrying the status update,
an optional reverted job, and a follow-up evaluation, mirroring the
reference's DeploymentStatusUpdateRequest {Eval, Job} composite writes.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from ..structs.model import (
    DEPLOYMENT_STATUS_FAILED,
    DEPLOYMENT_STATUS_PAUSED,
    DEPLOYMENT_STATUS_RUNNING,
    DEPLOYMENT_STATUS_DESC_RUNNING,
    EVAL_STATUS_PENDING,
    EVAL_TRIGGER_DEPLOYMENT_WATCHER,
    Deployment,
    DeploymentStatusUpdate,
    Evaluation,
    Job,
    generate_uuid,
    now_ns,
)

logger = logging.getLogger("nomad_tpu.deployment_watcher")

# Status descriptions (ref structs.go DeploymentStatusDescription*)
DESC_PAUSED = "Deployment is paused"
DESC_FAILED_ALLOCATIONS = "Failed due to unhealthy allocation"
DESC_PROGRESS_DEADLINE = "Failed due to progress deadline"
DESC_FAILED_BY_USER = "Deployment marked as failed"
DESC_FAILED_REVERT = (
    "Failed due to unhealthy allocation - rolling back to job version %d"
)
DESC_PROGRESS_REVERT = (
    "Failed due to progress deadline - rolling back to job version %d"
)
DESC_FAILED_BY_USER_REVERT = (
    "Deployment marked as failed - rolling back to job version %d"
)

DEFAULT_PROGRESS_DEADLINE = 10 * 60 * 1_000_000_000  # 10m (ref structs.go)


class DeploymentWatcher:
    """Per-deployment state machine (ref deployment_watcher.go:66)."""

    def __init__(self, parent: "DeploymentsWatcher", deployment_id: str):
        self.parent = parent
        self.server = parent.server
        self.deployment_id = deployment_id
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # group → monotonic deadline; armed from the deployment's
        # progress_deadline, extended whenever a healthy alloc lands
        # (ref deployment_watcher.go getDeploymentProgressCutoff)
        # nta: ignore[unbounded-cache] WHY: keyed by ONE deployment's
        # task-group names; the watcher dies with its deployment
        self._progress_deadline: dict[str, float] = {}
        self._last_counts: Optional[tuple] = None

    def start(self):
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"deploy-watch-{self.deployment_id[:8]}"
        )
        self._thread.start()

    def stop(self):
        self._stop.set()

    # ------------------------------------------------------------------
    def _run(self):
        state = self.server.state
        min_index = 0
        sub = self._subscribe(state.latest_index())
        self._arm_deadlines()
        try:
            while not self._stop.is_set():
                d = state.deployment_by_id(self.deployment_id)
                if d is None or not d.active():
                    break
                try:
                    if self._tick(d):
                        break
                except Exception:
                    logger.exception(
                        "deployment watcher %s tick failed",
                        self.deployment_id[:8],
                    )
                # Wake on a deployment/alloc event (push) or at the next
                # deadline edge; polls the MVCC store only when no event
                # broker is configured
                timeout = self._next_deadline_wait()
                if sub is not None:
                    sub = self._wait_event(sub, timeout)
                else:
                    min_index = self._wait_blocking(state, min_index, timeout)
        finally:
            if sub is not None:
                sub.close()
        self.parent._watcher_done(self.deployment_id, self)

    def _subscribe(self, from_index: int):
        """Push path: this deployment's Deployment events plus Alloc
        events carrying its id as a filter key (placements, client
        health updates) — no store polling while the rollout is idle."""
        broker = getattr(self.server, "event_broker", None)
        if broker is None:
            return None
        from ..events import TOPIC_ALLOC, TOPIC_DEPLOYMENT

        return broker.subscribe(
            {
                TOPIC_DEPLOYMENT: {self.deployment_id},
                TOPIC_ALLOC: {self.deployment_id},
            },
            from_index=from_index,
        )

    def _wait_event(self, sub, timeout: float):
        from ..events import SubscriptionClosedError

        try:
            if sub.next(timeout=timeout) is not None:
                # coalesce the burst: one tick per batch of queued
                # frames, not one full state re-read per frame
                while sub.next(timeout=0) is not None:
                    pass
            return sub
        except SubscriptionClosedError:
            # broker reset (restore) or backpressure close: the next tick
            # re-reads state anyway, so just re-subscribe from now
            return self._subscribe(self.server.state.latest_index())

    def _wait_blocking(self, state, min_index: int, timeout: float) -> int:
        def query(snap):
            return (
                snap.table_index("deployment"),
                snap.table_index("allocs"),
            )

        _, min_index = state.blocking_query(
            query, min_index=min_index, timeout=timeout
        )
        return min_index

    def _arm_deadlines(self):
        d = self.server.state.deployment_by_id(self.deployment_id)
        if d is None:
            return
        now = time.monotonic()
        for group, tg_state in d.task_groups.items():
            deadline = tg_state.progress_deadline or DEFAULT_PROGRESS_DEADLINE
            if deadline > 0:
                self._progress_deadline[group] = now + deadline / 1e9

    def _next_deadline_wait(self) -> float:
        if not self._progress_deadline:
            return 5.0
        now = time.monotonic()
        soonest = min(self._progress_deadline.values())
        return max(0.05, min(5.0, soonest - now))

    # ------------------------------------------------------------------
    def _tick(self, d: Deployment) -> bool:
        """One evaluation of the deployment state machine. Returns True
        when the watcher should exit (terminal transition issued)."""
        if d.status == DEPLOYMENT_STATUS_PAUSED:
            return False

        allocs = self.server.state.allocs_by_deployment(d.id)

        # Unhealthy alloc ⇒ fail (+ auto-revert when the group asks for it)
        for alloc in allocs:
            ds = alloc.deployment_status
            if ds is not None and ds.is_unhealthy():
                # Revert decision is scoped to the failing alloc's group
                # (ref deployment_watcher.go handleAllocUpdate)
                tg_state = d.task_groups.get(alloc.task_group)
                self._fail(
                    d,
                    DESC_FAILED_ALLOCATIONS,
                    DESC_FAILED_REVERT,
                    auto_revert=tg_state is not None and tg_state.auto_revert,
                )
                return True

        # Progress deadline: each group must reach full health before its
        # deadline; healthy allocs push the group's deadline out.
        now = time.monotonic()
        for group, tg_state in d.task_groups.items():
            latest_healthy = 0
            for alloc in allocs:
                ds = alloc.deployment_status
                if (
                    alloc.task_group == group
                    and ds is not None
                    and ds.is_healthy()
                    and ds.timestamp > latest_healthy
                ):
                    latest_healthy = ds.timestamp
            deadline_ns = tg_state.progress_deadline or DEFAULT_PROGRESS_DEADLINE
            if latest_healthy and group in self._progress_deadline:
                elapsed = (now_ns() - latest_healthy) / 1e9
                self._progress_deadline[group] = max(
                    self._progress_deadline[group],
                    now + deadline_ns / 1e9 - elapsed,
                )
            complete = (
                tg_state.healthy_allocs >= tg_state.desired_total
                and (tg_state.desired_canaries == 0 or tg_state.promoted)
            )
            if not complete and now > self._progress_deadline.get(group, now + 1):
                self._fail(
                    d,
                    DESC_PROGRESS_DEADLINE,
                    DESC_PROGRESS_REVERT,
                    auto_revert=tg_state.auto_revert,
                )
                return True

        # Auto-promotion (ref deployment_watcher.go:269): every canary
        # group has all its canaries healthy → promote all groups.
        if d.requires_promotion() and d.has_auto_promote():
            ready = all(
                self._healthy_canaries(allocs, group) >= s.desired_canaries
                for group, s in d.task_groups.items()
                if s.desired_canaries > 0 and not s.promoted
            )
            if ready:
                try:
                    self.server.deployment_promote(d.id, all_groups=True)
                except Exception:
                    logger.exception("auto-promote failed for %s", d.id[:8])
                return False

        # Health transitions re-evaluate the job so rolling updates release
        # their next max_parallel batch (ref deployment_watcher.go
        # createBatchedUpdate / EvalBatcher)
        counts = tuple(
            (g, s.healthy_allocs, s.unhealthy_allocs, s.promoted)
            for g, s in sorted(d.task_groups.items())
        )
        if self._last_counts is not None and counts != self._last_counts:
            from . import fsm as fsm_mod

            job = self.server.state.job_by_id(d.namespace, d.job_id)
            try:
                self.server._apply(
                    fsm_mod.EVAL_UPDATE,
                    {"evals": [_watcher_eval(d, job).to_dict()]},
                )
            except Exception:
                logger.exception("watcher eval for %s failed", d.id[:8])
        self._last_counts = counts
        return False

    @staticmethod
    def _healthy_canaries(allocs, group: str) -> int:
        n = 0
        for alloc in allocs:
            ds = alloc.deployment_status
            if (
                alloc.task_group == group
                and ds is not None
                and ds.canary
                and ds.is_healthy()
            ):
                n += 1
        return n

    def _fail(
        self, d: Deployment, desc: str, revert_desc: str, auto_revert: bool
    ):
        rollback_job = None
        if auto_revert:
            rollback_job = self.parent.latest_stable_job(
                d.namespace, d.job_id, before_version=d.job_version
            )
        if rollback_job is not None:
            desc = revert_desc % rollback_job.version
        logger.info("deployment %s failed: %s", d.id[:8], desc)
        self.server._deployment_status_update(
            d, DEPLOYMENT_STATUS_FAILED, desc, rollback_job=rollback_job
        )


class DeploymentsWatcher:
    """Watcher manager (ref deployments_watcher.go:89): tracks active
    deployments via a blocking query and runs one DeploymentWatcher per
    active deployment while this server is the leader."""

    def __init__(self, server):
        self.server = server
        server.deployment_watcher = self
        self._watchers: dict[str, DeploymentWatcher] = {}
        self._enabled = False
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def set_enabled(self, enabled: bool):
        with self._lock:
            if enabled == self._enabled:
                return
            self._enabled = enabled
            if enabled:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="deployments-watcher"
                )
                self._thread.start()
            else:
                # the manager loop notices at its next wake (≤10s push
                # path, ≤2s blocking-query fallback)
                for w in self._watchers.values():
                    w.stop()
                self._watchers.clear()

    def _run(self):
        state = self.server.state
        min_index = 0
        me = threading.current_thread()
        # push path: new/terminal deployments announce themselves on the
        # event stream, so the manager wakes on Deployment events instead
        # of re-running a blocking query that fires on EVERY state write;
        # the 10s timeout is only a fallback rescan + disable-notice bound
        # (ref deployments_watcher.go watchDeployments — the reference
        # made the same poll→push switch in 1.0)
        broker = getattr(self.server, "event_broker", None)
        sub = None
        if broker is not None:
            from ..events import TOPIC_DEPLOYMENT

            # from latest: the first loop iteration scans state anyway,
            # so replaying the ring's history would only re-wake the scan
            sub = broker.subscribe(
                {TOPIC_DEPLOYMENT: {"*"}}, from_index=state.latest_index()
            )
        try:
            while True:
                with self._lock:
                    # exit if disabled OR superseded by a newer manager
                    # thread (leadership flap inside the wait window)
                    if not self._enabled or self._thread is not me:
                        return
                    active = {
                        d.id
                        for d in state.deployments()
                        if d.status in (DEPLOYMENT_STATUS_RUNNING, DEPLOYMENT_STATUS_PAUSED)
                    }
                    for did in active - set(self._watchers):
                        w = DeploymentWatcher(self, did)
                        self._watchers[did] = w
                        w.start()
                    for did in set(self._watchers) - active:
                        self._watchers.pop(did).stop()

                if sub is not None:
                    from ..events import SubscriptionClosedError

                    try:
                        if sub.next(timeout=10.0) is not None:
                            # one rescan per burst of deployment events
                            while sub.next(timeout=0) is not None:
                                pass
                    except SubscriptionClosedError:
                        sub = broker.subscribe(
                            {TOPIC_DEPLOYMENT: {"*"}},
                            from_index=state.latest_index(),
                        )
                    continue

                def query(snap):
                    return snap.table_index("deployment")

                _, min_index = state.blocking_query(
                    query, min_index=min_index, timeout=2.0
                )
        finally:
            if sub is not None:
                sub.close()

    def _watcher_done(self, deployment_id: str, watcher: "DeploymentWatcher"):
        with self._lock:
            # only remove the exact instance: an old watcher exiting must not
            # pop a freshly created watcher for the same deployment
            if self._watchers.get(deployment_id) is watcher:
                self._watchers.pop(deployment_id)

    # ------------------------------------------------------------------
    def latest_stable_job(
        self, namespace: str, job_id: str, before_version: int
    ) -> Optional[Job]:
        """Latest stable job version older than ``before_version``
        (ref deployments_watcher.go latestStableJob)."""
        best = None
        for j in self.server.state.job_versions(namespace, job_id):
            if j.stable and j.version < before_version:
                if best is None or j.version > best.version:
                    best = j
        return best


# ----------------------------------------------------------------------
# Server endpoint mixin (ref nomad/deployment_endpoint.go). Installed on
# the Server class by core/__init__ wiring; methods live here to keep the
# deployment surface in one module.
# ----------------------------------------------------------------------

def _watcher_eval(d: Deployment, job: Optional[Job]) -> Evaluation:
    return Evaluation(
        id=generate_uuid(),
        namespace=d.namespace,
        priority=job.priority if job is not None else 50,
        type=job.type if job is not None else "service",
        triggered_by=EVAL_TRIGGER_DEPLOYMENT_WATCHER,
        job_id=d.job_id,
        deployment_id=d.id,
        status=EVAL_STATUS_PENDING,
        create_time=now_ns(),
        modify_time=now_ns(),
    )


def install_deployment_endpoints(server_cls):
    """Attach deployment RPC endpoints to Server (ref
    nomad/deployment_endpoint.go SetAllocHealth/Promote/Pause/Fail)."""
    from . import fsm as fsm_mod

    def _deployment_by_prefix(self, deployment_id: str):
        """Exact lookup, falling back to a unique short-ID prefix — the
        CLI surfaces 8-char IDs, matching the reference's prefix lookups."""
        d = self.state.deployment_by_id(deployment_id)
        if d is not None:
            return d
        matches = [
            x for x in self.state.deployments()
            if x.id.startswith(deployment_id)
        ]
        if len(matches) > 1:
            raise ValueError(
                f"ambiguous deployment prefix {deployment_id!r} "
                f"({len(matches)} matches)"
            )
        if not matches:
            raise KeyError(f"deployment not found: {deployment_id}")
        return matches[0]

    def _deployment_status_update(
        self, d, status, desc, rollback_job=None, create_eval=True
    ):
        job = self.state.job_by_id(d.namespace, d.job_id)
        payload = {
            "update": DeploymentStatusUpdate(
                deployment_id=d.id, status=status, status_description=desc
            ).to_dict(),
        }
        if rollback_job is not None:
            reverted = rollback_job.copy()
            # Registering the old spec mints a new version, exactly like
            # the reference's JobRevert path (job_endpoint.go Revert)
            payload["job"] = reverted.to_dict()
        if create_eval:
            payload["eval"] = _watcher_eval(d, job).to_dict()
        self._apply(fsm_mod.DEPLOYMENT_STATUS_UPDATE, payload)

    def deployment_promote(self, deployment_id, groups=None, all_groups=False):
        self._check_leader()
        d = self._deployment_by_prefix(deployment_id)
        job = self.state.job_by_id(d.namespace, d.job_id)
        self._apply(
            fsm_mod.DEPLOYMENT_PROMOTE,
            {
                "deployment_id": d.id,
                "groups": groups or [],
                "all": all_groups or not groups,
                "eval": _watcher_eval(d, job).to_dict(),
            },
        )

    def deployment_pause(self, deployment_id, pause: bool):
        self._check_leader()
        d = self._deployment_by_prefix(deployment_id)
        if not d.active():
            raise ValueError(f"deployment {deployment_id} is terminal")
        status = DEPLOYMENT_STATUS_PAUSED if pause else DEPLOYMENT_STATUS_RUNNING
        desc = DESC_PAUSED if pause else DEPLOYMENT_STATUS_DESC_RUNNING
        self._deployment_status_update(d, status, desc, create_eval=not pause)

    def deployment_fail(self, deployment_id):
        """Manual failure; auto-reverts when any group asks for it
        (ref deployment_watcher.go FailDeployment)."""
        self._check_leader()
        d = self._deployment_by_prefix(deployment_id)
        if not d.active():
            raise ValueError(f"deployment {deployment_id} is terminal")
        rollback = None
        if any(s.auto_revert for s in d.task_groups.values()) and self.deployment_watcher:
            rollback = self.deployment_watcher.latest_stable_job(
                d.namespace, d.job_id, before_version=d.job_version
            )
        desc = (
            DESC_FAILED_BY_USER_REVERT % rollback.version
            if rollback is not None
            else DESC_FAILED_BY_USER
        )
        self._deployment_status_update(
            d, DEPLOYMENT_STATUS_FAILED, desc, rollback_job=rollback
        )

    def deployment_set_alloc_health(
        self, deployment_id, healthy_ids=None, unhealthy_ids=None
    ):
        self._check_leader()
        d = self._deployment_by_prefix(deployment_id)
        job = self.state.job_by_id(d.namespace, d.job_id)
        self._apply(
            fsm_mod.DEPLOYMENT_ALLOC_HEALTH,
            {
                "deployment_id": d.id,
                "healthy_ids": healthy_ids or [],
                "unhealthy_ids": unhealthy_ids or [],
                "timestamp": now_ns(),
                "eval": _watcher_eval(d, job).to_dict(),
            },
        )

    def job_revert(
        self, namespace: str, job_id: str, version: int,
        enforce_prior_version: Optional[int] = None,
    ) -> str:
        """Revert a job to a prior version by re-registering that version's
        spec as a new version (ref job_endpoint.go Revert)."""
        self._check_leader()
        cur = self.state.job_by_id(namespace, job_id)
        if cur is None:
            raise KeyError(f"job not found: {job_id}")
        if enforce_prior_version is not None and cur.version != enforce_prior_version:
            raise ValueError(
                f"current version {cur.version} != enforced {enforce_prior_version}"
            )
        if version == cur.version:
            raise ValueError(f"job already at version {version}")
        old = self.state.job_by_id_and_version(namespace, job_id, version)
        if old is None:
            raise KeyError(f"job {job_id} version {version} not found")
        return self.job_register(old.copy())

    server_cls._deployment_by_prefix = _deployment_by_prefix
    server_cls._deployment_status_update = _deployment_status_update
    server_cls.deployment_promote = deployment_promote
    server_cls.deployment_pause = deployment_pause
    server_cls.deployment_fail = deployment_fail
    server_cls.deployment_set_alloc_health = deployment_set_alloc_health
    server_cls.job_revert = job_revert
    return server_cls
