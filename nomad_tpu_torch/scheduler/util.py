"""Scheduler utilities: alloc diffing, tainted nodes, in-place updates
(ref scheduler/util.go)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..structs.model import (
    ALLOC_CLIENT_STATUS_LOST,
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_CLIENT_STATUS_RUNNING,
    ALLOC_DESIRED_STATUS_STOP,
    JOB_TYPE_BATCH,
    NODE_STATUS_DOWN,
    AllocatedResources,
    AllocatedSharedResources,
    Allocation,
    DesiredUpdates,
    Evaluation,
    Job,
    Node,
    Plan,
    PlanResult,
    TaskGroup,
)
from .context import EvalContext

# Stop/update descriptions (ref generic_sched.go:38-66)
ALLOC_NOT_NEEDED = "alloc not needed due to job update"
ALLOC_MIGRATING = "alloc is being migrated"
ALLOC_UPDATING = "alloc is being updated due to job update"
ALLOC_LOST = "alloc is lost since its node is down"
ALLOC_IN_PLACE = "alloc updating in-place"
ALLOC_NODE_TAINTED = "alloc not needed as node is tainted"
ALLOC_RESCHEDULED = "alloc was rescheduled because it failed"
BLOCKED_EVAL_MAX_PLAN_DESC = "created due to placement conflicts"
BLOCKED_EVAL_FAILED_PLACEMENTS = "created to place remaining allocations"
RESCHEDULING_FOLLOWUP_EVAL_DESC = "created for delayed rescheduling"
MAX_PAST_RESCHEDULE_EVENTS = 5


@dataclass
class AllocTuple:
    name: str = ""
    task_group: Optional[TaskGroup] = None
    alloc: Optional[Allocation] = None


@dataclass
class DiffResult:
    place: list[AllocTuple] = field(default_factory=list)
    update: list[AllocTuple] = field(default_factory=list)
    migrate: list[AllocTuple] = field(default_factory=list)
    stop: list[AllocTuple] = field(default_factory=list)
    ignore: list[AllocTuple] = field(default_factory=list)
    lost: list[AllocTuple] = field(default_factory=list)

    def append(self, other: "DiffResult"):
        self.place.extend(other.place)
        self.update.extend(other.update)
        self.migrate.extend(other.migrate)
        self.stop.extend(other.stop)
        self.ignore.extend(other.ignore)
        self.lost.extend(other.lost)


class SetStatusError(Exception):
    def __init__(self, err: str, eval_status: str):
        super().__init__(err)
        self.eval_status = eval_status


def materialize_task_groups(job: Optional[Job]) -> dict[str, TaskGroup]:
    """Expand task group counts into named slots (ref util.go:22-35; a
    purged job arrives as None and materializes nothing, so every live
    alloc diffs to stop)."""
    out: dict[str, TaskGroup] = {}
    if job is None or job.stopped():
        return out
    for tg in job.task_groups:
        for i in range(tg.count):
            out[f"{job.name}.{tg.name}[{i}]"] = tg
    return out


def diff_allocs(
    job: Job,
    tainted_nodes: dict[str, Optional[Node]],
    required: dict[str, TaskGroup],
    allocs: list[Allocation],
    terminal_allocs: dict[str, Allocation],
) -> DiffResult:
    """Set-difference the required vs existing allocations
    (ref util.go:70-165)."""
    result = DiffResult()
    existing: set[str] = set()

    for exist in allocs:
        name = exist.name
        existing.add(name)
        tg = required.get(name)

        if tg is None:
            result.stop.append(AllocTuple(name=name, task_group=tg, alloc=exist))
            continue

        if not exist.terminal_status() and exist.desired_transition.should_migrate():
            result.migrate.append(AllocTuple(name=name, task_group=tg, alloc=exist))
            continue

        if exist.node_id in tainted_nodes:
            node = tainted_nodes[exist.node_id]
            if exist.job.type == JOB_TYPE_BATCH and exist.ran_successfully():
                result.ignore.append(AllocTuple(name=name, task_group=tg, alloc=exist))
                continue
            if not exist.terminal_status() and (
                node is None or node.terminal_status()
            ):
                result.lost.append(AllocTuple(name=name, task_group=tg, alloc=exist))
            else:
                result.ignore.append(AllocTuple(name=name, task_group=tg, alloc=exist))
            continue

        if job.job_modify_index != exist.job.job_modify_index:
            result.update.append(AllocTuple(name=name, task_group=tg, alloc=exist))
            continue

        result.ignore.append(AllocTuple(name=name, task_group=tg, alloc=exist))

    for name, tg in required.items():
        if name not in existing:
            result.place.append(
                AllocTuple(name=name, task_group=tg, alloc=terminal_allocs.get(name))
            )
    return result


def diff_system_allocs(
    job: Job,
    nodes: list[Node],
    tainted_nodes: dict[str, Optional[Node]],
    allocs: list[Allocation],
    terminal_allocs: dict[str, Allocation],
) -> DiffResult:
    """Per-node diff for system jobs (ref util.go:176-220)."""
    node_allocs: dict[str, list[Allocation]] = {}
    for alloc in allocs:
        node_allocs.setdefault(alloc.node_id, []).append(alloc)
    for node in nodes:
        node_allocs.setdefault(node.id, [])

    required = materialize_task_groups(job)
    result = DiffResult()
    for node_id, nallocs in node_allocs.items():
        diff = diff_allocs(job, tainted_nodes, required, nallocs, terminal_allocs)
        if node_id in tainted_nodes:
            diff.place = []
        else:
            for tup in diff.place:
                if tup.alloc is None or tup.alloc.node_id != node_id:
                    tup.alloc = Allocation(node_id=node_id)
        result.append(diff)
    return result


def retry_max(
    max_attempts: int, cb: Callable[[], bool], reset: Optional[Callable[[], bool]] = None
):
    """Retry cb until it reports done or attempts are exhausted
    (ref util.go:268-290)."""
    attempts = 0
    while attempts < max_attempts:
        done = cb()
        if done:
            return
        if reset is not None and reset():
            attempts = 0
        else:
            attempts += 1
    raise SetStatusError(
        f"maximum attempts reached ({max_attempts})", eval_status="failed"
    )


def progress_made(result: Optional[PlanResult]) -> bool:
    """ref util.go:294-298"""
    return result is not None and (
        bool(result.node_update)
        or bool(result.node_allocation)
        or result.deployment is not None
        or bool(result.deployment_updates)
    )


def tainted_nodes(state, allocs: list[Allocation]) -> dict[str, Optional[Node]]:
    """Nodes that are down/draining/gone among the allocs' nodes
    (ref util.go:303-326)."""
    out: dict[str, Optional[Node]] = {}
    for alloc in allocs:
        if alloc.node_id in out:
            continue
        node = state.node_by_id(alloc.node_id)
        if node is None:
            out[alloc.node_id] = None
            continue
        if node.status == NODE_STATUS_DOWN or node.drain:
            out[alloc.node_id] = node
    return out


def tasks_updated(job_a: Job, job_b: Job, task_group: str) -> bool:
    """Whether the group requires a destructive update (ref util.go:340-407)."""
    a = job_a.lookup_task_group(task_group)
    b = job_b.lookup_task_group(task_group)
    if len(a.tasks) != len(b.tasks):
        return True
    if a.ephemeral_disk.to_dict() != b.ephemeral_disk.to_dict():
        return True
    if _network_updated(a.networks, b.networks):
        return True
    for at in a.tasks:
        bt = b.lookup_task(at.name)
        if bt is None:
            return True
        if at.driver != bt.driver or at.user != bt.user:
            return True
        if at.config != bt.config or at.env != bt.env:
            return True
        if [x.to_dict() for x in at.artifacts] != [x.to_dict() for x in bt.artifacts]:
            return True
        av = at.vault.to_dict() if at.vault else None
        bv = bt.vault.to_dict() if bt.vault else None
        if av != bv:
            return True
        if [x.to_dict() for x in at.templates] != [x.to_dict() for x in bt.templates]:
            return True
        if _combined_meta(job_a, a, at) != _combined_meta(job_b, b, bt):
            return True
        if _network_updated(at.resources.networks, bt.resources.networks):
            return True
        if (
            at.resources.cpu != bt.resources.cpu
            or at.resources.memory_mb != bt.resources.memory_mb
        ):
            return True
    return False


def _combined_meta(job: Job, tg: TaskGroup, task) -> dict[str, str]:
    """Job < group < task meta precedence (ref structs.go CombinedTaskMeta)."""
    meta = dict(job.meta)
    meta.update(tg.meta)
    meta.update(task.meta)
    return meta


def _network_updated(net_a, net_b) -> bool:
    """ref util.go:409-427"""
    if len(net_a) != len(net_b):
        return True
    for an, bn in zip(net_a, net_b):
        if an.mbits != bn.mbits:
            return True
        if _network_port_map(an) != _network_port_map(bn):
            return True
    return False


def _network_port_map(n) -> dict[str, int]:
    m = {p.label: p.value for p in n.reserved_ports}
    for p in n.dynamic_ports:
        m[p.label] = -1
    return m


def set_status(
    planner,
    eval: Evaluation,
    next_eval: Optional[Evaluation],
    spawned_blocked: Optional[Evaluation],
    tg_metrics: dict,
    status: str,
    desc: str,
    queued_allocs: Optional[dict[str, int]],
    deployment_id: str,
):
    """Update the eval's status via the planner (ref util.go:444-466)."""
    new_eval = eval.copy()
    new_eval.status = status
    new_eval.status_description = desc
    new_eval.deployment_id = deployment_id
    new_eval.failed_tg_allocs = tg_metrics
    if next_eval is not None:
        new_eval.next_eval = next_eval.id
    if spawned_blocked is not None:
        new_eval.blocked_eval = spawned_blocked.id
    if queued_allocs is not None:
        new_eval.queued_allocations = queued_allocs
    planner.update_eval(new_eval)


def evict_and_place(
    ctx: EvalContext,
    diff: DiffResult,
    allocs: list[AllocTuple],
    desc: str,
    limit: list[int],
) -> bool:
    """Stop allocs up to limit[0], queueing their replacements; True if the
    limit was reached (ref util.go:583-596)."""
    n = len(allocs)
    for i in range(min(n, limit[0])):
        a = allocs[i]
        ctx.plan.append_stopped_alloc(a.alloc, desc, "")
        diff.place.append(a)
    if n <= limit[0]:
        limit[0] -= n
        return False
    limit[0] = 0
    return True


def desired_updates(
    diff: DiffResult,
    inplace_updates: list[AllocTuple],
    destructive_updates: list[AllocTuple],
) -> dict[str, DesiredUpdates]:
    """ref util.go:627-698"""
    out: dict[str, DesiredUpdates] = {}

    def get(name: str) -> DesiredUpdates:
        if name not in out:
            out[name] = DesiredUpdates()
        return out[name]

    for tup in diff.place:
        get(tup.task_group.name).place += 1
    for tup in diff.stop:
        get(tup.alloc.task_group).stop += 1
    for tup in diff.ignore:
        get(tup.task_group.name).ignore += 1
    for tup in diff.migrate:
        get(tup.task_group.name).migrate += 1
    for tup in inplace_updates:
        get(tup.task_group.name).in_place_update += 1
    for tup in destructive_updates:
        get(tup.task_group.name).destructive_update += 1
    return out


def adjust_queued_allocations(
    result: Optional[PlanResult], queued_allocs: dict[str, int]
):
    """ref util.go:702-727"""
    if result is None:
        return
    for allocations in result.node_allocation.values():
        for allocation in allocations:
            if allocation.create_index != allocation.modify_index:
                continue
            if allocation.task_group in queued_allocs:
                queued_allocs[allocation.task_group] -= 1


def update_non_terminal_allocs_to_lost(
    plan: Plan, tainted: dict[str, Optional[Node]], allocs: list[Allocation]
):
    """ref util.go:731-751"""
    for alloc in allocs:
        if alloc.node_id not in tainted:
            continue
        node = tainted[alloc.node_id]
        if node is not None and node.status != NODE_STATUS_DOWN:
            continue
        if alloc.desired_status == ALLOC_DESIRED_STATUS_STOP and alloc.client_status in (
            ALLOC_CLIENT_STATUS_RUNNING,
            ALLOC_CLIENT_STATUS_PENDING,
        ):
            plan.append_stopped_alloc(alloc, ALLOC_LOST, ALLOC_CLIENT_STATUS_LOST)


def generic_alloc_update_fn(ctx: EvalContext, stack, eval_id: str):
    """Factory for the reconciler's in-place-update decision function
    (ref util.go:759-856)."""

    def update_fn(existing: Allocation, new_job: Job, new_tg: TaskGroup):
        if existing.job.job_modify_index == new_job.job_modify_index:
            return True, False, None
        if tasks_updated(new_job, existing.job, new_tg.name):
            return False, True, None
        if existing.terminal_status():
            return True, False, None

        node = ctx.state.node_by_id(existing.node_id)
        if node is None:
            return False, True, None

        stack.set_nodes([node])
        ctx.plan.append_stopped_alloc(existing, ALLOC_IN_PLACE, "")
        option = stack.select(new_tg, None)
        ctx.plan.pop_update(existing)

        if option is None:
            return False, True, None

        # Restore network offers from the existing allocation (ports can't
        # change in-place; guarded by tasks_updated)
        for task_name, resources in option.task_resources.items():
            networks = []
            tr = existing.allocated_resources.tasks.get(task_name)
            if tr is not None:
                networks = tr.networks
            resources.networks = networks

        new_alloc = existing.copy()
        new_alloc.eval_id = eval_id
        new_alloc.job = None  # use the job in the plan
        new_alloc.allocated_resources = AllocatedResources(
            tasks=option.task_resources,
            shared=AllocatedSharedResources(
                disk_mb=new_tg.ephemeral_disk.size_mb,
                networks=existing.allocated_resources.shared.networks,
            ),
        )
        new_alloc.metrics = (
            existing.metrics.copy() if existing.metrics is not None else None
        )
        return False, False, new_alloc

    return update_fn
