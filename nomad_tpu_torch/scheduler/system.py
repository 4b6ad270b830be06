"""SystemScheduler: one allocation per feasible node (ref scheduler/system_sched.go)."""

from __future__ import annotations

import random
from typing import Optional

from ..structs.model import (
    ALLOC_CLIENT_STATUS_LOST,
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_STATUS_RUN,
    EVAL_STATUS_COMPLETE,
    AllocatedResources,
    AllocatedSharedResources,
    Allocation,
    AllocMetric,
    Evaluation,
    Node,
    PlanAnnotations,
    filter_terminal_allocs,
    generate_uuid,
)
from .context import EvalContext
from .stack import SystemStack
from .util import (
    ALLOC_IN_PLACE,
    ALLOC_LOST,
    ALLOC_NODE_TAINTED,
    ALLOC_NOT_NEEDED,
    ALLOC_UPDATING,
    BLOCKED_EVAL_FAILED_PLACEMENTS,
    AllocTuple,
    SetStatusError,
    adjust_queued_allocations,
    desired_updates,
    diff_system_allocs,
    evict_and_place,
    progress_made,
    retry_max,
    set_status,
    tainted_nodes,
    update_non_terminal_allocs_to_lost,
)

MAX_SYSTEM_SCHEDULE_ATTEMPTS = 5

_VALID_TRIGGERS = {
    "job-register",
    "node-update",
    "failed-follow-up",
    "job-deregister",
    "rolling-update",
    "preemption",
    "deployment-watcher",
    "node-drain",
    "alloc-stop",
    "queued-allocs",
}


class SystemScheduler:
    """ref system_sched.go:22-421"""

    def __init__(self, state, planner, rng: Optional[random.Random] = None):
        self.state = state
        self.planner = planner
        self.rng = rng

        self.eval: Optional[Evaluation] = None
        self.job = None
        self.plan = None
        self.plan_result = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[SystemStack] = None
        self.nodes: list[Node] = []
        self.nodes_by_dc: dict[str, int] = {}
        self.limit_reached = False
        self.next_eval: Optional[Evaluation] = None
        self.failed_tg_allocs: dict[str, AllocMetric] = {}
        self.queued_allocs: dict[str, int] = {}

    def process(self, eval: Evaluation):
        """ref system_sched.go:54-87"""
        self.eval = eval
        if eval.triggered_by not in _VALID_TRIGGERS:
            desc = f"scheduler cannot handle '{eval.triggered_by}' evaluation reason"
            set_status(
                self.planner, self.eval, self.next_eval, None,
                self.failed_tg_allocs, "failed", desc, self.queued_allocs, "",
            )
            return
        try:
            retry_max(
                MAX_SYSTEM_SCHEDULE_ATTEMPTS,
                self._process,
                lambda: progress_made(self.plan_result),
            )
        except SetStatusError as e:
            set_status(
                self.planner, self.eval, self.next_eval, None,
                self.failed_tg_allocs, e.eval_status, str(e), self.queued_allocs, "",
            )
            return
        set_status(
            self.planner, self.eval, self.next_eval, None,
            self.failed_tg_allocs, EVAL_STATUS_COMPLETE, "", self.queued_allocs, "",
        )

    def _process(self) -> bool:
        """ref system_sched.go:91-179"""
        self.job = self.state.job_by_id(self.eval.namespace, self.eval.job_id)
        self.queued_allocs = {}

        if self.job is not None and not self.job.stopped():
            self.nodes, self.nodes_by_dc = self.state.ready_nodes_in_dcs(
                self.job.datacenters
            )

        self.plan = self.eval.make_plan(self.job)
        self.failed_tg_allocs = {}
        self.ctx = EvalContext(self.state, self.plan, rng=self.rng)
        self.stack = SystemStack(self.ctx)
        if self.job is not None and not self.job.stopped():
            self.stack.set_job(self.job)

        self._compute_job_allocs()

        if self.plan.is_no_op() and not self.eval.annotate_plan:
            return True

        if self.limit_reached and self.next_eval is None:
            self.next_eval = self.eval.next_rolling_eval(self.job.update.stagger)
            self.planner.create_eval(self.next_eval)

        result, new_state = self.planner.submit_plan(self.plan)
        self.plan_result = result

        adjust_queued_allocations(result, self.queued_allocs)

        if new_state is not None:
            self.state = new_state
            return False

        full_commit, _, _ = result.full_commit(self.plan)
        if not full_commit:
            return False
        return True

    def _compute_job_allocs(self):
        """ref system_sched.go:183-265"""
        allocs = self.state.allocs_by_job(
            self.eval.namespace, self.eval.job_id, any_create_index=True
        )
        tainted = tainted_nodes(self.state, allocs)
        update_non_terminal_allocs_to_lost(self.plan, tainted, allocs)

        live, terminal = filter_terminal_allocs(allocs)
        diff = diff_system_allocs(self.job, self.nodes, tainted, live, terminal)

        for e in diff.stop:
            self.plan.append_stopped_alloc(e.alloc, ALLOC_NOT_NEEDED, "")
        for e in diff.migrate:
            self.plan.append_stopped_alloc(e.alloc, ALLOC_NODE_TAINTED, "")
        for e in diff.lost:
            self.plan.append_stopped_alloc(e.alloc, ALLOC_LOST, ALLOC_CLIENT_STATUS_LOST)

        destructive, inplace = self._inplace_update(diff.update)
        diff.update = destructive

        if self.eval.annotate_plan:
            self.plan.annotations = PlanAnnotations(
                desired_tg_updates=desired_updates(diff, inplace, destructive)
            )

        limit = [len(diff.update)]
        if (
            self.job is not None
            and not self.job.stopped()
            and self.job.update is not None
            and self.job.update.rolling()
        ):
            limit = [self.job.update.max_parallel]

        self.limit_reached = evict_and_place(
            self.ctx, diff, diff.update, ALLOC_UPDATING, limit
        )

        if not diff.place:
            if self.job is not None and not self.job.stopped():
                for tg in self.job.task_groups:
                    self.queued_allocs[tg.name] = 0
            return

        for tup in diff.place:
            self.queued_allocs[tup.task_group.name] = (
                self.queued_allocs.get(tup.task_group.name, 0) + 1
            )

        self._compute_placements(diff.place)

    def _inplace_update(self, updates: list[AllocTuple]):
        """ref util.go:470-578 inplaceUpdate; returns (destructive, inplace)."""
        from .util import tasks_updated

        destructive: list[AllocTuple] = []
        inplace: list[AllocTuple] = []
        for update in updates:
            existing = update.alloc.job
            if tasks_updated(self.job, existing, update.task_group.name):
                destructive.append(update)
                continue
            if update.alloc.terminal_status():
                inplace.append(update)
                continue
            node = self.state.node_by_id(update.alloc.node_id)
            if node is None:
                destructive.append(update)
                continue
            self.stack.set_nodes([node])
            self.plan.append_stopped_alloc(update.alloc, ALLOC_IN_PLACE, "")
            option = self.stack.select(update.task_group, None)
            self.plan.pop_update(update.alloc)
            if option is None:
                destructive.append(update)
                continue
            for task_name, resources in option.task_resources.items():
                networks = []
                tr = update.alloc.allocated_resources.tasks.get(task_name)
                if tr is not None:
                    networks = tr.networks
                resources.networks = networks
            new_alloc = update.alloc.copy()
            new_alloc.eval_id = self.eval.id
            new_alloc.job = None
            new_alloc.allocated_resources = AllocatedResources(
                tasks=option.task_resources,
                shared=AllocatedSharedResources(
                    disk_mb=update.task_group.ephemeral_disk.size_mb
                ),
            )
            new_alloc.metrics = self.ctx.metrics
            self.plan.append_alloc(new_alloc)
            inplace.append(update)
        return destructive, inplace

    def _compute_placements(self, place: list[AllocTuple]):
        """ref system_sched.go:268-402"""
        node_by_id = {node.id: node for node in self.nodes}

        for missing in place:
            node = node_by_id.get(missing.alloc.node_id)
            if node is None:
                raise KeyError(f"could not find node {missing.alloc.node_id}")
            self._place_one(missing, node)

    def _place_one(self, missing: AllocTuple, node: Node):
        """Run the full single-node stack for one system placement (the
        loop body of system_sched.go:268-402; also the exact-semantics
        fallback the batched tpu-system path uses for fit failures)."""
        self.stack.set_nodes([node])
        option = self.stack.select(missing.task_group, None)

        if option is None:
            if self.ctx.metrics.nodes_filtered > 0:
                self._count_filtered(missing)
                return
            if missing.task_group.name in self.failed_tg_allocs:
                self.failed_tg_allocs[
                    missing.task_group.name
                ].coalesced_failures += 1
                return
            self.ctx.metrics.nodes_available = self.nodes_by_dc
            self.ctx.metrics.pop_score_meta()
            self.failed_tg_allocs[missing.task_group.name] = self.ctx.metrics
            self._add_blocked(node)
            return

        self.ctx.metrics.nodes_available = self.nodes_by_dc
        self.ctx.metrics.pop_score_meta()

        resources = AllocatedResources(
            tasks=option.task_resources,
            shared=AllocatedSharedResources(
                disk_mb=missing.task_group.ephemeral_disk.size_mb
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
            task_group=missing.task_group.name,
            metrics=self.ctx.metrics,
            node_id=option.node.id,
            node_name=option.node.name,
            allocated_resources=resources,
            desired_status=ALLOC_DESIRED_STATUS_RUN,
            client_status=ALLOC_CLIENT_STATUS_PENDING,
        )

        if missing.alloc is not None and missing.alloc.id:
            alloc.previous_allocation = missing.alloc.id

        if option.preempted_allocs:
            preempted_ids = []
            for stop in option.preempted_allocs:
                self.plan.append_preempted_alloc(stop, alloc.id)
                preempted_ids.append(stop.id)
            alloc.preempted_allocations = preempted_ids

        self.plan.append_alloc(alloc)

    def _count_filtered(self, missing: AllocTuple):
        """Node filtered by feasibility: not queued, annotation adjusted
        (system_sched.go:283-300)."""
        self.queued_allocs[missing.task_group.name] -= 1
        if (
            self.eval.annotate_plan
            and self.plan.annotations is not None
            and self.plan.annotations.desired_tg_updates
        ):
            desired = self.plan.annotations.desired_tg_updates.get(
                missing.task_group.name
            )
            if desired is not None:
                desired.place -= 1

    def _add_blocked(self, node: Node):
        """ref system_sched.go:406-421"""
        e = self.ctx.get_eligibility()
        escaped = e.has_escaped()
        class_eligibility = {} if escaped else e.get_classes()
        blocked = self.eval.create_blocked_eval(
            class_eligibility, escaped, e.quota_limit_reached()
        )
        blocked.status_description = BLOCKED_EVAL_FAILED_PLACEMENTS
        blocked.node_id = node.id
        self.planner.create_eval(blocked)
