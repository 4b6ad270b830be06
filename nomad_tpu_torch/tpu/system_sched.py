"""The ``tpu-system`` scheduler: SystemScheduler with the per-node stack
walk replaced by dense columnar planes.

A system eval places one allocation per feasible node
(system_sched.go:268-402) — there is no cross-placement coupling except
same-node capacity, which makes it embarrassingly batchable: feasibility is
one class-memoized plane over the target nodes (columnar.build_group_planes,
the exact planes the tpu-batch kernel uses) and the fit check is one
dense usage+demand ≤ capacity comparison. Nodes failing the dense fit fall
back to the single-node oracle walk, which carries the exact failure
metrics, preemption, and blocked-eval semantics; groups the kernel doesn't
model (ports, devices, distinct_*) fall back wholesale."""

from __future__ import annotations

import numpy as np

from ..scheduler.system import SystemScheduler
from ..structs.model import (
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_STATUS_RUN,
    DesiredTransition,
    AllocatedCpuResources,
    AllocatedMemoryResources,
    AllocatedResources,
    AllocatedSharedResources,
    AllocatedTaskResources,
    Allocation,
    generate_uuids,
)
from .batch_sched import SCHED_COUNTERS, _count_fallback, _count_kernel
from .columnar import ColumnarCluster, build_group_planes, kernel_supported

#: below this many placements the per-node walk is cheaper than plane builds
BATCH_THRESHOLD = 32


class TPUSystemScheduler(SystemScheduler):
    """SystemScheduler with dense feasibility/fit planes."""

    def _compute_placements(self, place):
        groups = {t.task_group.name: t.task_group for t in place}
        if len(place) < BATCH_THRESHOLD or not all(
            kernel_supported(self.job, tg) for tg in groups.values()
        ):
            if place:
                _count_fallback(
                    "system_small" if len(place) < BATCH_THRESHOLD
                    else "unsupported_group"
                )
            return super()._compute_placements(place)
        _count_kernel()
        SCHED_COUNTERS["modes"]["system-planes"] = (
            SCHED_COUNTERS["modes"].get("system-planes", 0) + 1
        )

        node_by_id = {node.id: node for node in self.nodes}
        target_nodes = []
        seen = set()
        for t in place:
            if t.alloc.node_id not in seen:
                node = node_by_id.get(t.alloc.node_id)
                if node is None:
                    raise KeyError(f"could not find node {t.alloc.node_id}")
                seen.add(t.alloc.node_id)
                target_nodes.append(node)

        cluster = ColumnarCluster.shared(self.state, target_nodes)
        planes = {
            name: build_group_planes(self.ctx, cluster, self.state, self.job, tg)
            for name, tg in groups.items()
        }
        demands = {
            name: np.array(
                (
                    sum(t.resources.cpu for t in tg.tasks),
                    sum(t.resources.memory_mb for t in tg.tasks),
                    tg.ephemeral_disk.size_mb,
                    0,  # tpu-system stays gated to no-network groups
                ),
                dtype=np.int64,
            )
            for name, tg in groups.items()
        }
        used = cluster.initial_used(self.state, self.plan)
        capacity = cluster.capacity

        # per-group alloc templates (same trick as tpu-batch _materialize)
        templates = {}
        for name, tg in groups.items():
            tasks = {
                t.name: AllocatedTaskResources(
                    cpu=AllocatedCpuResources(cpu_shares=t.resources.cpu),
                    memory=AllocatedMemoryResources(memory_mb=t.resources.memory_mb),
                )
                for t in tg.tasks
            }
            templates[name] = Allocation(
                namespace=self.job.namespace,
                eval_id=self.eval.id,
                job_id=self.job.id,
                task_group=name,
                metrics=self.ctx.metrics,
                allocated_resources=AllocatedResources(
                    tasks=tasks,
                    shared=AllocatedSharedResources(
                        disk_mb=tg.ephemeral_disk.size_mb
                    ),
                ),
                desired_status=ALLOC_DESIRED_STATUS_RUN,
                client_status=ALLOC_CLIENT_STATUS_PENDING,
            ).__dict__

        ids = generate_uuids(len(place))
        alloc_new = Allocation.__new__
        for i, missing in enumerate(place):
            name = missing.task_group.name
            idx = cluster.index[missing.alloc.node_id]
            if not planes[name].feasible[idx]:
                self._count_filtered(missing)
                continue
            demand = demands[name]
            if (used[idx] + demand > capacity[idx]).any():
                # exact fallback: preemption, failure metrics, blocked eval —
                # and preemption changes the node's real usage, so the dense
                # plane is recomputed from the plan before later groups reuse
                # this node
                self._place_one(missing, target_nodes[idx])
                used[idx] = self._recompute_used(cluster, idx, target_nodes[idx])
                continue
            used[idx] += demand
            node = target_nodes[idx]
            alloc = alloc_new(Allocation)
            alloc.__dict__ = dict(
                templates[name],
                id=ids[i],
                name=missing.name,
                node_id=node.id,
                node_name=node.name,
                task_states={},
                preempted_allocations=[],
                # per-alloc resources object: the task-resource values stay
                # shared (immutable by the store contract) but no two allocs
                # alias the same top-level container
                allocated_resources=AllocatedResources(
                    tasks=templates[name]["allocated_resources"].tasks,
                    shared=AllocatedSharedResources(
                        disk_mb=groups[name].ephemeral_disk.size_mb
                    ),
                ),
            )
            alloc.desired_transition = DesiredTransition()
            if missing.alloc is not None and missing.alloc.id:
                alloc.previous_allocation = missing.alloc.id
            self.plan.append_alloc(alloc)

    def _recompute_used(self, cluster, idx, node):
        """The node's usage from state + the plan's overlays (the
        evaluate_node_plan composition: existing − stops/preemptions/updates
        + placements), as an int triple."""
        from ..structs.model import remove_allocs

        allocs = self.state.allocs_by_node_terminal(node.id, False)
        removed = (
            self.plan.node_update.get(node.id, [])
            + self.plan.node_preemptions.get(node.id, [])
            + self.plan.node_allocation.get(node.id, [])
        )
        allocs = remove_allocs(allocs, removed)
        allocs = allocs + self.plan.node_allocation.get(node.id, [])
        used = np.array(cluster.reserved[idx], dtype=np.int64)
        return ColumnarCluster.sum_alloc_usage(allocs, into=used)
