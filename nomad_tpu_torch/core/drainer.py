"""Node drainer: leader-side subsystem migrating allocations off draining
nodes (ref nomad/drainer/drainer.go:130 NodeDrainer, watch_nodes.go,
watch_jobs.go, drain_heap.go).

Responsibilities, matching the reference:

- watch nodes entering/leaving drain (``node.drain`` + ``DrainStrategy``);
- pace migrations per job task group, honoring ``migrate.max_parallel``:
  an alloc marked for migration counts as in-flight until its replacement
  is running (ref drainer/watch_jobs.go handleTaskGroup);
- force-migrate everything left when the drain's force deadline passes
  (ref drain_heap.go + drainer.go handleDeadlinedNodes);
- system-job allocs drain last — only once every service/batch alloc has
  left the node — unless ``ignore_system_jobs`` leaves them in place;
- mark the drain complete (clear ``drain``, node stays ineligible) when no
  migratable allocs remain, and emit node evals (drainer.go:284).

All transitions ride batched ``AllocUpdateDesiredTransition`` raft entries
with the evals for affected jobs attached, mirroring the reference's
batched desired-transition updates (drainer.go:357).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ..structs.model import (
    ALLOC_CLIENT_STATUS_RUNNING,
    EVAL_STATUS_PENDING,
    EVAL_TRIGGER_NODE_DRAIN,
    JOB_TYPE_SYSTEM,
    Evaluation,
    generate_uuid,
    now_ns,
)

logger = logging.getLogger("nomad_tpu.drainer")


class NodeDrainer:
    """ref drainer/drainer.go:130"""

    def __init__(self, server):
        self.server = server
        server.drainer = self
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
                    target=self._run, daemon=True, name="node-drainer"
                )
                self._thread.start()
            # on disable the loop exits within its poll window

    def notify(self):
        """The drain request's own raft write bumps the state index, which
        wakes the loop's blocking query — nothing extra to do."""

    # ------------------------------------------------------------------
    def _run(self):
        state = self.server.state
        min_index = 0
        me = threading.current_thread()
        # the thread-identity check prevents two loops after a leadership
        # flap inside the poll window (old thread exits when superseded)
        while self._enabled and self._thread is me:
            try:
                deadline_wait = self._tick()
            except Exception:
                logger.exception("drainer tick failed")
                deadline_wait = 1.0

            # Wake on any state change or at the next force-deadline edge
            # (ref drain_heap.go); the blocking query watches the global
            # commit index, and drain/alloc writes always bump it.
            _, min_index = state.blocking_query(
                lambda snap: None,
                min_index=min_index,
                timeout=min(deadline_wait, 2.0),
            )

    # ------------------------------------------------------------------
    def _tick(self) -> float:
        """One drain pass. Returns seconds until the nearest force
        deadline (capped by the caller's poll interval)."""
        state = self.server.state
        draining = [n for n in state.nodes() if n.drain]
        if not draining:
            return 60.0

        next_deadline = 60.0
        transitions: dict[str, dict] = {}
        jobs_to_eval: dict[tuple[str, str], object] = {}

        # In-flight migration counts per (ns, job, task group): allocs
        # already marked migrate whose replacement isn't running yet
        # (ref watch_jobs.go handleTaskGroup pending computation)
        all_allocs = list(state.allocs())
        replacements_running: set[str] = set()
        for a in all_allocs:
            if (
                a.previous_allocation
                and a.client_status == ALLOC_CLIENT_STATUS_RUNNING
            ):
                replacements_running.add(a.previous_allocation)
        inflight: dict[tuple[str, str, str], int] = {}
        for a in all_allocs:
            if (
                a.desired_transition.should_migrate()
                and not a.terminal_status()
                and a.id not in replacements_running
            ):
                key = (a.namespace, a.job_id, a.task_group)
                inflight[key] = inflight.get(key, 0) + 1

        for node in draining:
            strategy = node.drain_strategy
            force = strategy is not None and strategy.deadline_passed()
            ignore_system = strategy is not None and strategy.ignore_system_jobs
            if strategy is not None and strategy.force_deadline:
                remaining_s = (strategy.force_deadline - now_ns()) / 1e9
                if remaining_s > 0:
                    next_deadline = min(next_deadline, remaining_s)

            allocs = [
                a
                for a in state.allocs_by_node(node.id)
                if not a.terminal_status() and not a.client_terminal_status()
            ]
            system = [
                a for a in allocs if a.job is not None and a.job.type == JOB_TYPE_SYSTEM
            ]
            movable = [
                a for a in allocs if a.job is None or a.job.type != JOB_TYPE_SYSTEM
            ]

            if not movable and (ignore_system or not system):
                self._finish_drain(node)
                continue
            if system and not ignore_system and (not movable or force):
                # system allocs drain once all other work has left the
                # node — or immediately when the force deadline passes
                # (ref drainer.go handleDeadlinedNodes drains everything)
                for a in system:
                    if not a.desired_transition.should_migrate():
                        transitions[a.id] = {"migrate": True}
                        jobs_to_eval[(a.namespace, a.job_id)] = a.job
                if not movable:
                    continue

            for a in movable:
                if a.desired_transition.should_migrate():
                    continue
                key = (a.namespace, a.job_id, a.task_group)
                if force:
                    transitions[a.id] = {"migrate": True}
                    jobs_to_eval[(a.namespace, a.job_id)] = a.job
                    continue
                max_parallel = 1
                if a.job is not None:
                    tg = a.job.lookup_task_group(a.task_group)
                    if tg is not None and tg.migrate is not None:
                        max_parallel = max(1, tg.migrate.max_parallel)
                if inflight.get(key, 0) >= max_parallel:
                    continue
                inflight[key] = inflight.get(key, 0) + 1
                transitions[a.id] = {"migrate": True}
                jobs_to_eval[(a.namespace, a.job_id)] = a.job

        if transitions:
            from . import fsm as fsm_mod

            evals = [
                Evaluation(
                    id=generate_uuid(),
                    namespace=ns,
                    priority=job.priority if job is not None else 50,
                    type=job.type if job is not None else "service",
                    triggered_by=EVAL_TRIGGER_NODE_DRAIN,
                    job_id=job_id,
                    status=EVAL_STATUS_PENDING,
                    create_time=now_ns(),
                    modify_time=now_ns(),
                ).to_dict()
                for (ns, job_id), job in jobs_to_eval.items()
            ]
            self.server._apply(
                fsm_mod.ALLOC_DESIRED_TRANSITION,
                {"allocs": transitions, "evals": evals},
            )
        return max(next_deadline, 0.05)

    def _finish_drain(self, node):
        """Drain complete: clear the flag, leave the node ineligible
        (ref drainer.go:284 handleDoneNodes)."""
        from . import fsm as fsm_mod

        logger.info("node %s drain complete", node.id[:8])
        self.server._apply(
            fsm_mod.NODE_DRAIN_UPDATE,
            {"node_id": node.id, "drain": False, "mark_eligible": False},
        )
