"""Rank iterators: bin packing, anti-affinity, penalties, node affinity, and
score normalization (ref scheduler/rank.go).

Final-score semantics reproduced exactly: each iterator appends component
scores, and ScoreNormalizationIterator averages over only the appended scores
(rank.go:678-692) — a node with no affinity component averages fewer terms.
"""

from __future__ import annotations

import math
from typing import Optional

from ..structs.funcs import allocs_fit, score_fit
from ..structs.model import (
    AllocatedCpuResources,
    AllocatedMemoryResources,
    AllocatedResources,
    AllocatedSharedResources,
    AllocatedTaskResources,
    Affinity,
    Allocation,
    Job,
    Node,
    Task,
    TaskGroup,
    remove_allocs,
)
from ..structs.network import NetworkIndex
from .context import EvalContext

BIN_PACKING_MAX_FIT_SCORE = 18.0


class RankedNode:
    """A candidate node + accumulated scoring state (ref rank.go:19-58)."""

    __slots__ = (
        "node",
        "final_score",
        "scores",
        "task_resources",
        "alloc_resources",
        "proposed",
        "preempted_allocs",
    )

    def __init__(self, node: Node):
        self.node = node
        self.final_score = 0.0
        self.scores: list[float] = []
        self.task_resources: dict[str, AllocatedTaskResources] = {}
        self.alloc_resources: Optional[AllocatedSharedResources] = None
        self.proposed: Optional[list[Allocation]] = None
        self.preempted_allocs: list[Allocation] = []

    def proposed_allocs(self, ctx: EvalContext) -> list[Allocation]:
        if self.proposed is None:
            self.proposed = ctx.proposed_allocs(self.node.id)
        return self.proposed

    def set_task_resources(self, task: Task, resource: AllocatedTaskResources):
        self.task_resources[task.name] = resource


class FeasibleRankIterator:
    """Upgrades a feasible iterator into the rank chain (ref rank.go:74-102)."""

    def __init__(self, ctx: EvalContext, source):
        self.ctx = ctx
        self.source = source

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        return RankedNode(option)

    def reset(self):
        self.source.reset()


class StaticRankIterator:
    """Fixed list of ranked nodes; for tests (ref rank.go:106-142)."""

    def __init__(self, ctx: EvalContext, nodes: list[RankedNode]):
        self.ctx = ctx
        self.nodes = nodes
        self.offset = 0
        self.seen = 0

    def next(self) -> Optional[RankedNode]:
        n = len(self.nodes)
        if self.offset == n or self.seen == n:
            if self.seen != n:
                self.offset = 0
            else:
                return None
        offset = self.offset
        self.offset += 1
        self.seen += 1
        return self.nodes[offset]

    def reset(self):
        self.seen = 0


#: shared empty index for the no-networks fast path: never mutated, every
#: check (overcommitted, collisions) is vacuously false on it
_EMPTY_NET_INDEX = NetworkIndex()


class _ProposedAlloc:
    """Stand-in for the would-be allocation inside the per-option fit
    check: allocs_fit only reads terminal_status/allocated_resources/
    comparable_cached, and a full Allocation dataclass __init__ per node
    option was measurable at 10K options per placement. No caching — the
    resources are still being accumulated when this is built."""

    __slots__ = ("allocated_resources",)

    def __init__(self, resources):
        self.allocated_resources = resources

    def terminal_status(self) -> bool:
        return False

    def comparable_cached(self):
        return self.allocated_resources.comparable()


class BinPackIterator:
    """Scores nodes by bin-packing fit, assigning networks and devices along
    the way; optionally preempts lower-priority allocs (ref rank.go:146-451)."""

    def __init__(self, ctx: EvalContext, source, evict: bool, priority: int):
        self.ctx = ctx
        self.source = source
        self.evict = evict
        self.priority = priority
        self.job_id: Optional[tuple[str, str]] = None
        self.task_group: Optional[TaskGroup] = None

    def set_job(self, job: Job):
        self.priority = job.priority
        self.job_id = job.namespaced_id()

    def set_task_group(self, task_group: TaskGroup):
        self.task_group = task_group
        # hoisted per-option guards: at 10K options per placement, even
        # constructing an unused helper object per node is real money
        self._tg_nets = bool(task_group.networks) or any(
            t.resources.networks for t in task_group.tasks
        )
        self._tg_devs = any(t.resources.devices for t in task_group.tasks)

    def next(self) -> Optional[RankedNode]:
        from .preemption import Preemptor

        while True:
            option = self.source.next()
            if option is None:
                return None

            proposed = option.proposed_allocs(self.ctx)
            node_res = option.node.node_resources

            # network/device accounting only where it can matter: a node
            # with no NICs serving a group with no asks can neither offer
            # nor collide (the shared empty index answers every check)
            if self._tg_nets or (node_res is not None and node_res.networks):
                net_idx = NetworkIndex(rng=self.ctx.rng)
                net_idx.set_node(option.node)
                net_idx.add_allocs(proposed)
            else:
                net_idx = _EMPTY_NET_INDEX

            # only group device ASKS read the allocator (allocs_fit runs
            # with check_devices=False here) — node-side devices alone
            # don't warrant building one per option
            dev_allocator = None
            if self._tg_devs:
                from .device import DeviceAllocator

                dev_allocator = DeviceAllocator(self.ctx, option.node)
                dev_allocator.add_allocs(proposed)

            total_device_affinity_weight = 0.0
            sum_matching_affinities = 0.0

            total = AllocatedResources(
                tasks={},
                shared=AllocatedSharedResources(
                    disk_mb=self.task_group.ephemeral_disk.size_mb
                ),
            )

            allocs_to_preempt: list[Allocation] = []
            preemptor = None
            if self.evict:
                preemptor = Preemptor(self.priority, self.ctx, self.job_id)
                preemptor.set_node(option.node)
                current_preemptions = [
                    a
                    for allocs in self.ctx.plan.node_preemptions.values()
                    for a in allocs
                ]
                preemptor.set_preemptions(current_preemptions)

            exhausted = False

            # Task-group-level network ask (ref rank.go:229-279)
            if self.task_group.networks:
                ask = self.task_group.networks[0].copy()
                offer, err = net_idx.assign_network(ask)
                if offer is None:
                    if not self.evict:
                        self.ctx.metrics.exhausted_node(
                            option.node, f"network: {err}"
                        )
                        continue
                    preemptor.set_candidates(proposed)
                    net_preemptions = preemptor.preempt_for_network(ask, net_idx)
                    if net_preemptions is None:
                        continue
                    allocs_to_preempt.extend(net_preemptions)
                    proposed = remove_allocs(proposed, net_preemptions)
                    net_idx = NetworkIndex(rng=self.ctx.rng)
                    net_idx.set_node(option.node)
                    net_idx.add_allocs(proposed)
                    offer, err = net_idx.assign_network(ask)
                    if offer is None:
                        continue
                net_idx.add_reserved(offer)
                total.shared.networks = [offer]
                option.alloc_resources = AllocatedSharedResources(
                    networks=[offer],
                    disk_mb=self.task_group.ephemeral_disk.size_mb,
                )

            for task in self.task_group.tasks:
                task_resources = AllocatedTaskResources(
                    cpu=AllocatedCpuResources(cpu_shares=task.resources.cpu),
                    memory=AllocatedMemoryResources(
                        memory_mb=task.resources.memory_mb
                    ),
                )

                # Task-level network ask (ref rank.go:292-338)
                if task.resources.networks:
                    ask = task.resources.networks[0].copy()
                    offer, err = net_idx.assign_network(ask)
                    if offer is None:
                        if not self.evict:
                            self.ctx.metrics.exhausted_node(
                                option.node, f"network: {err}"
                            )
                            exhausted = True
                            break
                        preemptor.set_candidates(proposed)
                        net_preemptions = preemptor.preempt_for_network(ask, net_idx)
                        if net_preemptions is None:
                            exhausted = True
                            break
                        allocs_to_preempt.extend(net_preemptions)
                        proposed = remove_allocs(proposed, net_preemptions)
                        net_idx = NetworkIndex(rng=self.ctx.rng)
                        net_idx.set_node(option.node)
                        net_idx.add_allocs(proposed)
                        offer, err = net_idx.assign_network(ask)
                        if offer is None:
                            exhausted = True
                            break
                    net_idx.add_reserved(offer)
                    task_resources.networks = [offer]

                # Device asks (ref rank.go:341-387)
                device_failed = False
                for req in task.resources.devices:
                    offer, sum_affinities, err = dev_allocator.assign_device(req)
                    if offer is None:
                        if not self.evict:
                            self.ctx.metrics.exhausted_node(
                                option.node, f"devices: {err}"
                            )
                            device_failed = True
                            break
                        preemptor.set_candidates(proposed)
                        device_preemptions = preemptor.preempt_for_device(
                            req, dev_allocator
                        )
                        if device_preemptions is None:
                            device_failed = True
                            break
                        allocs_to_preempt.extend(device_preemptions)
                        proposed = remove_allocs(proposed, allocs_to_preempt)
                        # The retry offer is computed against a fresh allocator
                        # but the reservation below is recorded in the outer one,
                        # preserving instances reserved by earlier asks of this
                        # same placement (the reference's ':=' shadowing,
                        # rank.go:365-373, has exactly this effect).
                        retry_allocator = DeviceAllocator(self.ctx, option.node)
                        retry_allocator.add_allocs(proposed)
                        offer, sum_affinities, err = retry_allocator.assign_device(req)
                        if offer is None:
                            device_failed = True
                            break
                    dev_allocator.add_reserved(offer)
                    task_resources.devices.append(offer)
                    if req.affinities:
                        for a in req.affinities:
                            total_device_affinity_weight += abs(float(a.weight))
                        sum_matching_affinities += sum_affinities
                if device_failed:
                    exhausted = True
                    break

                option.set_task_resources(task, task_resources)
                total.tasks[task.name] = task_resources

            if exhausted:
                continue

            # Store current set before adding the new alloc's resources
            current = proposed
            proposed = proposed + [_ProposedAlloc(total)]

            fit, dim, util = allocs_fit(option.node, proposed, net_idx, False)
            if not fit:
                if not self.evict:
                    self.ctx.metrics.exhausted_node(option.node, dim)
                    continue
                preemptor.set_candidates(current)
                preempted_allocs = preemptor.preempt_for_task_group(total)
                allocs_to_preempt.extend(preempted_allocs)
                if not preempted_allocs:
                    self.ctx.metrics.exhausted_node(option.node, dim)
                    continue
            if allocs_to_preempt:
                option.preempted_allocs = allocs_to_preempt

            fitness = score_fit(option.node, util)
            normalized_fit = fitness / BIN_PACKING_MAX_FIT_SCORE
            option.scores.append(normalized_fit)
            self.ctx.metrics.score_node(option.node, "binpack", normalized_fit)

            if total_device_affinity_weight != 0:
                sum_matching_affinities /= total_device_affinity_weight
                option.scores.append(sum_matching_affinities)
                self.ctx.metrics.score_node(
                    option.node, "devices", sum_matching_affinities
                )

            return option

    def reset(self):
        self.source.reset()


class JobAntiAffinityIterator:
    """Penalty −(collisions+1)/desired_count for co-placement with allocs of
    the same job+group (ref rank.go:456-521)."""

    def __init__(self, ctx: EvalContext, source, job_id: str):
        self.ctx = ctx
        self.source = source
        self.job_id = job_id
        self.task_group = ""
        self.desired_count = 0

    def set_job(self, job: Job):
        self.job_id = job.id

    def set_task_group(self, tg: TaskGroup):
        self.task_group = tg.name
        self.desired_count = tg.count

    def next(self) -> Optional[RankedNode]:
        while True:
            option = self.source.next()
            if option is None:
                return None
            proposed = option.proposed_allocs(self.ctx)
            collisions = sum(
                1
                for alloc in proposed
                if alloc.job_id == self.job_id and alloc.task_group == self.task_group
            )
            if collisions > 0:
                score_penalty = -1 * float(collisions + 1) / float(self.desired_count)
                option.scores.append(score_penalty)
                self.ctx.metrics.score_node(
                    option.node, "job-anti-affinity", score_penalty
                )
            else:
                self.ctx.metrics.score_node(option.node, "job-anti-affinity", 0)
            return option

    def reset(self):
        self.source.reset()


class NodeReschedulingPenaltyIterator:
    """−1 on nodes where the previous attempt of a rescheduled alloc ran
    (ref rank.go:526-567)."""

    def __init__(self, ctx: EvalContext, source):
        self.ctx = ctx
        self.source = source
        self.penalty_nodes: set[str] = set()

    def set_penalty_nodes(self, penalty_nodes: set[str]):
        self.penalty_nodes = penalty_nodes or set()

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        if option.node.id in self.penalty_nodes:
            option.scores.append(-1)
            self.ctx.metrics.score_node(option.node, "node-reschedule-penalty", -1)
        else:
            self.ctx.metrics.score_node(option.node, "node-reschedule-penalty", 0)
        return option

    def reset(self):
        self.penalty_nodes = set()
        self.source.reset()


class NodeAffinityIterator:
    """Σ(weight·match)/Σ|weight| for affinity stanzas (ref rank.go:571-646)."""

    def __init__(self, ctx: EvalContext, source):
        self.ctx = ctx
        self.source = source
        self.job_affinities: list[Affinity] = []
        self.affinities: list[Affinity] = []

    def set_job(self, job: Job):
        self.job_affinities = job.affinities

    def set_task_group(self, tg: TaskGroup):
        if self.job_affinities:
            self.affinities.extend(self.job_affinities)
        if tg.affinities:
            self.affinities.extend(tg.affinities)
        for task in tg.tasks:
            if task.affinities:
                self.affinities.extend(task.affinities)

    def reset(self):
        self.source.reset()
        self.affinities = []

    def has_affinities(self) -> bool:
        return bool(self.affinities)

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        if not self.has_affinities():
            self.ctx.metrics.score_node(option.node, "node-affinity", 0)
            return option
        sum_weight = sum(abs(float(a.weight)) for a in self.affinities)
        total = 0.0
        for affinity in self.affinities:
            if matches_affinity(self.ctx, affinity, option.node):
                total += float(affinity.weight)
        # Go float semantics: /0 yields NaN and scheduling continues
        norm_score = total / sum_weight if sum_weight else float("nan")
        if total != 0.0:
            option.scores.append(norm_score)
            self.ctx.metrics.score_node(option.node, "node-affinity", norm_score)
        return option


def matches_affinity(ctx: EvalContext, affinity: Affinity, node: Node) -> bool:
    from .feasible import check_affinity, resolve_target

    l_val, l_ok = resolve_target(affinity.l_target, node)
    r_val, r_ok = resolve_target(affinity.r_target, node)
    return check_affinity(ctx, affinity.operand, l_val, r_val, l_ok, r_ok)


class ScoreNormalizationIterator:
    """Averages appended component scores into the final score
    (ref rank.go:661-692)."""

    def __init__(self, ctx: EvalContext, source):
        self.ctx = ctx
        self.source = source

    def reset(self):
        self.source.reset()

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None or not option.scores:
            return option
        option.final_score = sum(option.scores) / len(option.scores)
        self.ctx.metrics.score_node(
            option.node, "normalized-score", option.final_score
        )
        return option
