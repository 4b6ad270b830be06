"""GenericScheduler: service + batch scheduling (ref scheduler/generic_sched.go)."""

from __future__ import annotations

import random
import time
from typing import Optional

from ..structs.model import (
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_STATUS_RUN,
    EVAL_STATUS_BLOCKED,
    EVAL_STATUS_COMPLETE,
    EVAL_TRIGGER_DEPLOYMENT_WATCHER,
    EVAL_TRIGGER_FAILED_FOLLOW_UP,
    EVAL_TRIGGER_JOB_DEREGISTER,
    EVAL_TRIGGER_JOB_REGISTER,
    EVAL_TRIGGER_MAX_PLANS,
    EVAL_TRIGGER_NODE_DRAIN,
    EVAL_TRIGGER_NODE_UPDATE,
    EVAL_TRIGGER_PERIODIC_JOB,
    EVAL_TRIGGER_PREEMPTION,
    EVAL_TRIGGER_QUEUED_ALLOCS,
    EVAL_TRIGGER_RETRY_FAILED_ALLOC,
    EVAL_TRIGGER_ROLLING_UPDATE,
    AllocatedResources,
    AllocatedSharedResources,
    Allocation,
    AllocMetric,
    DeploymentStatus,
    Evaluation,
    Node,
    PlanAnnotations,
    RescheduleEvent,
    RescheduleTracker,
    TaskGroup,
    generate_uuid,
)
from .context import EvalContext
from .rank import RankedNode
from .reconcile import (
    AllocPlaceResult,
    AllocReconciler,
)
from .stack import GenericStack, SelectOptions
from .util import (
    ALLOC_UPDATING,
    BLOCKED_EVAL_FAILED_PLACEMENTS,
    BLOCKED_EVAL_MAX_PLAN_DESC,
    MAX_PAST_RESCHEDULE_EVENTS,
    SetStatusError,
    adjust_queued_allocations,
    generic_alloc_update_fn,
    progress_made,
    retry_max,
    set_status,
    tainted_nodes,
    update_non_terminal_allocs_to_lost,
)

MAX_SERVICE_SCHEDULE_ATTEMPTS = 5
MAX_BATCH_SCHEDULE_ATTEMPTS = 2

_VALID_TRIGGERS = {
    EVAL_TRIGGER_JOB_REGISTER,
    EVAL_TRIGGER_JOB_DEREGISTER,
    EVAL_TRIGGER_NODE_DRAIN,
    EVAL_TRIGGER_NODE_UPDATE,
    "alloc-stop",
    EVAL_TRIGGER_ROLLING_UPDATE,
    EVAL_TRIGGER_QUEUED_ALLOCS,
    EVAL_TRIGGER_PERIODIC_JOB,
    EVAL_TRIGGER_MAX_PLANS,
    EVAL_TRIGGER_DEPLOYMENT_WATCHER,
    EVAL_TRIGGER_RETRY_FAILED_ALLOC,
    EVAL_TRIGGER_FAILED_FOLLOW_UP,
    EVAL_TRIGGER_PREEMPTION,
}


class GenericScheduler:
    """ref generic_sched.go:77-639"""

    def __init__(self, state, planner, batch: bool, rng: Optional[random.Random] = None):
        self.state = state
        self.planner = planner
        self.batch = batch
        self.rng = rng

        self.eval: Optional[Evaluation] = None
        self.job = None
        self.plan = None
        self.plan_result = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[GenericStack] = None
        self.follow_up_evals: list[Evaluation] = []
        self.deployment = None
        self.blocked: Optional[Evaluation] = None
        self.failed_tg_allocs: dict[str, AllocMetric] = {}
        self.queued_allocs: dict[str, int] = {}

    # ------------------------------------------------------------------
    def process(self, eval: Evaluation):
        """ref generic_sched.go:122-185"""
        self.eval = eval

        if eval.triggered_by not in _VALID_TRIGGERS:
            desc = f"scheduler cannot handle '{eval.triggered_by}' evaluation reason"
            set_status(
                self.planner,
                self.eval,
                None,
                self.blocked,
                self.failed_tg_allocs,
                "failed",
                desc,
                self.queued_allocs,
                self._deployment_id(),
            )
            return

        limit = MAX_BATCH_SCHEDULE_ATTEMPTS if self.batch else MAX_SERVICE_SCHEDULE_ATTEMPTS
        try:
            retry_max(limit, self._process, lambda: progress_made(self.plan_result))
        except SetStatusError as e:
            # No forward progress — create a blocked eval to retry later
            self._create_blocked_eval(plan_failure=True)
            set_status(
                self.planner,
                self.eval,
                None,
                self.blocked,
                self.failed_tg_allocs,
                e.eval_status,
                str(e),
                self.queued_allocs,
                self._deployment_id(),
            )
            return

        if self.eval.status == EVAL_STATUS_BLOCKED and self.failed_tg_allocs:
            e = self.ctx.get_eligibility()
            new_eval = self.eval.copy()
            new_eval.escaped_computed_class = e.has_escaped()
            new_eval.class_eligibility = e.get_classes()
            new_eval.quota_limit_reached = e.quota_limit_reached()
            self.planner.reblock_eval(new_eval)
            return

        set_status(
            self.planner,
            self.eval,
            None,
            self.blocked,
            self.failed_tg_allocs,
            EVAL_STATUS_COMPLETE,
            "",
            self.queued_allocs,
            self._deployment_id(),
        )

    def _deployment_id(self) -> str:
        return self.deployment.id if self.deployment is not None else ""

    def _create_blocked_eval(self, plan_failure: bool):
        """ref generic_sched.go:189-208"""
        e = self.ctx.get_eligibility()
        escaped = e.has_escaped()
        class_eligibility = None if escaped else e.get_classes()
        self.blocked = self.eval.create_blocked_eval(
            class_eligibility or {}, escaped, e.quota_limit_reached()
        )
        if plan_failure:
            self.blocked.triggered_by = EVAL_TRIGGER_MAX_PLANS
            self.blocked.status_description = BLOCKED_EVAL_MAX_PLAN_DESC
        else:
            self.blocked.status_description = BLOCKED_EVAL_FAILED_PLACEMENTS
        self.planner.create_eval(self.blocked)

    # ------------------------------------------------------------------
    def _process(self) -> bool:
        """One scheduling attempt (ref generic_sched.go:212-319)."""
        self.job = self.state.job_by_id(self.eval.namespace, self.eval.job_id)
        self.queued_allocs = {}
        self.follow_up_evals = []

        self.plan = self.eval.make_plan(self.job)

        if not self.batch:
            self.deployment = self.state.latest_deployment_by_job_id(
                self.eval.namespace, self.eval.job_id
            )

        self.failed_tg_allocs = {}
        self.ctx = EvalContext(self.state, self.plan, rng=self.rng)
        self.stack = GenericStack(self.batch, self.ctx)
        if self.job is not None and not self.job.stopped():
            self.stack.set_job(self.job)

        self._compute_job_allocs()

        if (
            self.eval.status != EVAL_STATUS_BLOCKED
            and self.failed_tg_allocs
            and self.blocked is None
        ):
            self._create_blocked_eval(plan_failure=False)

        if self.plan.is_no_op() and not self.eval.annotate_plan:
            return True

        for ev in self.follow_up_evals:
            ev.previous_eval = self.eval.id
            self.planner.create_eval(ev)

        result, new_state = self.planner.submit_plan(self.plan)
        self.plan_result = result

        adjust_queued_allocations(result, self.queued_allocs)

        if new_state is not None:
            self.state = new_state
            return False

        full_commit, expected, actual = result.full_commit(self.plan)
        if not full_commit:
            raise RuntimeError("missing state refresh after partial commit")
        return True

    # ------------------------------------------------------------------
    def _compute_job_allocs(self):
        """ref generic_sched.go:323-422"""
        allocs = self.state.allocs_by_job(
            self.eval.namespace, self.eval.job_id, any_create_index=True
        )
        tainted = tainted_nodes(self.state, allocs)
        update_non_terminal_allocs_to_lost(self.plan, tainted, allocs)

        reconciler = AllocReconciler(
            generic_alloc_update_fn(self.ctx, self.stack, self.eval.id),
            self.batch,
            self.eval.job_id,
            self.job,
            self.deployment,
            allocs,
            tainted,
            self.eval.id,
        )
        results = reconciler.compute()

        if self.eval.annotate_plan:
            self.plan.annotations = PlanAnnotations(
                desired_tg_updates=results.desired_tg_updates
            )

        self.plan.deployment = results.deployment
        self.plan.deployment_updates = results.deployment_updates

        for evals in results.desired_followup_evals.values():
            self.follow_up_evals.extend(evals)

        if results.deployment is not None:
            self.deployment = results.deployment

        for stop in results.stop:
            self.plan.append_stopped_alloc(
                stop.alloc, stop.status_description, stop.client_status
            )

        for update in results.inplace_update:
            if update.deployment_id != self._deployment_id():
                update.deployment_id = self._deployment_id()
                update.deployment_status = None
            self.plan.append_alloc(update)

        for update in results.attribute_updates.values():
            self.plan.append_alloc(update)

        if not results.place and not results.destructive_update:
            if self.job is not None:
                for tg in self.job.task_groups:
                    self.queued_allocs[tg.name] = 0
            return

        from collections import Counter

        counts = Counter(p.task_group.name for p in results.place)
        counts.update(d.place_task_group.name for d in results.destructive_update)
        for name, c in counts.items():
            self.queued_allocs[name] = self.queued_allocs.get(name, 0) + c

        self._compute_placements(results.destructive_update, results.place)

    # ------------------------------------------------------------------
    def _compute_placements(self, destructive: list, place: list):
        """ref generic_sched.go:426-566"""
        nodes, by_dc = self.state.ready_nodes_in_dcs(self.job.datacenters)

        deployment_id = ""
        if self.deployment is not None and self.deployment.active():
            deployment_id = self.deployment.id

        self.stack.set_nodes(nodes)

        now = time.time_ns()

        for results in (destructive, place):
            for missing in results:
                tg = missing.task_group

                if tg.name in self.failed_tg_allocs:
                    self.failed_tg_allocs[tg.name].coalesced_failures += 1
                    continue

                preferred_node = self._find_preferred_node(missing)

                stop_prev_alloc, stop_prev_desc = missing.stop_previous_alloc()
                prev_allocation = missing.previous_alloc
                if stop_prev_alloc:
                    self.plan.append_stopped_alloc(
                        prev_allocation, stop_prev_desc, ""
                    )

                select_options = _get_select_options(prev_allocation, preferred_node)
                option = self.stack.select(tg, select_options)

                self.ctx.metrics.nodes_available = by_dc
                self.ctx.metrics.pop_score_meta()

                if option is not None:
                    resources = AllocatedResources(
                        tasks=option.task_resources,
                        shared=AllocatedSharedResources(
                            disk_mb=tg.ephemeral_disk.size_mb
                        ),
                    )
                    if option.alloc_resources is not None:
                        resources.shared.networks = option.alloc_resources.networks

                    alloc = Allocation(
                        id=generate_uuid(),
                        namespace=self.job.namespace,
                        eval_id=self.eval.id,
                        name=missing.name,
                        job_id=self.job.id,
                        task_group=tg.name,
                        metrics=self.ctx.metrics,
                        node_id=option.node.id,
                        node_name=option.node.name,
                        deployment_id=deployment_id,
                        allocated_resources=resources,
                        desired_status=ALLOC_DESIRED_STATUS_RUN,
                        client_status=ALLOC_CLIENT_STATUS_PENDING,
                    )

                    if prev_allocation is not None:
                        alloc.previous_allocation = prev_allocation.id
                        if missing.reschedule:
                            _update_reschedule_tracker(alloc, prev_allocation, now)

                    if missing.canary and self.deployment is not None:
                        state = self.deployment.task_groups.get(tg.name)
                        if state is not None:
                            state.placed_canaries = list(state.placed_canaries) + [
                                alloc.id
                            ]
                        alloc.deployment_status = DeploymentStatus(canary=True)

                    self._handle_preemptions(option, alloc, missing)
                    self.plan.append_alloc(alloc)
                else:
                    self.failed_tg_allocs[tg.name] = self.ctx.metrics
                    if stop_prev_alloc:
                        self.plan.pop_update(prev_allocation)

    def _handle_preemptions(
        self, option: RankedNode, alloc: Allocation, missing
    ):
        """Record preempted allocs in the plan (preemption is generally only
        enabled for system jobs, but wired for parity with the ENT handler)."""
        if option.preempted_allocs:
            preempted_ids = []
            for stop in option.preempted_allocs:
                self.plan.append_preempted_alloc(stop, alloc.id)
                preempted_ids.append(stop.id)
            alloc.preempted_allocations = preempted_ids

    def _find_preferred_node(self, place) -> Optional[Node]:
        """Sticky-disk preferred node (ref generic_sched.go:625-639)."""
        prev = place.previous_alloc
        if prev is not None and place.task_group.ephemeral_disk.sticky:
            preferred = self.state.node_by_id(prev.node_id)
            if preferred is not None and preferred.ready():
                return preferred
        return None


def _get_select_options(
    prev_allocation: Optional[Allocation], preferred_node: Optional[Node]
) -> SelectOptions:
    """ref generic_sched.go:569-585"""
    options = SelectOptions()
    if prev_allocation is not None:
        penalty = {prev_allocation.node_id}
        if prev_allocation.reschedule_tracker is not None:
            for ev in prev_allocation.reschedule_tracker.events:
                penalty.add(ev.prev_node_id)
        options.penalty_node_ids = penalty
    if preferred_node is not None:
        options.preferred_nodes = [preferred_node]
    return options


def _update_reschedule_tracker(alloc: Allocation, prev: Allocation, now_ns_: int):
    """ref generic_sched.go:588-622"""
    resched_policy = prev.reschedule_policy()
    reschedule_events: list[RescheduleEvent] = []
    if prev.reschedule_tracker is not None:
        interval = resched_policy.interval if resched_policy is not None else 0
        if resched_policy is not None and resched_policy.attempts > 0:
            for ev in prev.reschedule_tracker.events:
                time_diff = now_ns_ - ev.reschedule_time
                if interval > 0 and time_diff <= interval:
                    reschedule_events.append(ev.copy())
        else:
            events = prev.reschedule_tracker.events
            start = max(len(events) - MAX_PAST_RESCHEDULE_EVENTS, 0)
            reschedule_events.extend(ev.copy() for ev in events[start:])
    next_delay = prev.next_delay(resched_policy) if resched_policy is not None else 0
    reschedule_events.append(
        RescheduleEvent(
            reschedule_time=now_ns_,
            prev_alloc_id=prev.id,
            prev_node_id=prev.node_id,
            delay=next_delay,
        )
    )
    alloc.reschedule_tracker = RescheduleTracker(events=reschedule_events)
