"""Placement stacks: the chained iterator pipelines for generic and system
scheduling (ref scheduler/stack.go, stack_oss.go).

GenericStack chain order (stack_oss.go:6-83): Random source → Quota(noop) →
FeasibilityWrapper[job: constraints; tg: drivers, constraints, host volumes,
devices] → DistinctHosts → DistinctProperty → FeasibleRank → BinPack →
JobAntiAffinity → ReschedulePenalty → NodeAffinity → Spread → ScoreNorm →
Limit(max(2,⌈log2 N⌉), skip≤3 at score ≤0; ∞ with affinities/spreads) →
MaxScore.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Optional

from ..structs.model import Job, Node, TaskGroup
from .context import EvalContext
from .feasible import (
    ConstraintChecker,
    DeviceChecker,
    DistinctHostsIterator,
    DistinctPropertyIterator,
    DriverChecker,
    FeasibilityWrapper,
    HostVolumeChecker,
    QuotaIterator,
    StaticIterator,
    shuffle_nodes,
)
from .rank import (
    BinPackIterator,
    FeasibleRankIterator,
    JobAntiAffinityIterator,
    NodeAffinityIterator,
    NodeReschedulingPenaltyIterator,
    RankedNode,
    ScoreNormalizationIterator,
)
from .select import LimitIterator, MaxScoreIterator
from .spread import SpreadIterator

# ref stack.go:10-18
SKIP_SCORE_THRESHOLD = 0.0
MAX_SKIP = 3


@dataclass
class SelectOptions:
    penalty_node_ids: set[str] = field(default_factory=set)
    preferred_nodes: list[Node] = field(default_factory=list)
    preempt: bool = False


def task_group_constraints(tg: TaskGroup):
    """Combined constraints + drivers for a task group
    (ref scheduler/util.go:609)."""
    constraints = list(tg.constraints)
    drivers: set[str] = set()
    for task in tg.tasks:
        drivers.add(task.driver)
        constraints.extend(task.constraints)
    return constraints, drivers


class GenericStack:
    """ref stack.go:42-162 + stack_oss.go"""

    def __init__(self, batch: bool, ctx: EvalContext):
        self.batch = batch
        self.ctx = ctx

        self.source = StaticIterator(ctx, [])
        self.quota = QuotaIterator(ctx, self.source)
        self.job_constraint = ConstraintChecker(ctx)
        self.task_group_drivers = DriverChecker(ctx)
        self.task_group_constraint = ConstraintChecker(ctx)
        self.task_group_devices = DeviceChecker(ctx)
        self.task_group_host_volumes = HostVolumeChecker(ctx)

        self.wrapped_checks = FeasibilityWrapper(
            ctx,
            self.quota,
            [self.job_constraint],
            [
                self.task_group_drivers,
                self.task_group_constraint,
                self.task_group_host_volumes,
                self.task_group_devices,
            ],
        )
        self.distinct_hosts_constraint = DistinctHostsIterator(ctx, self.wrapped_checks)
        self.distinct_property_constraint = DistinctPropertyIterator(
            ctx, self.distinct_hosts_constraint
        )
        rank_source = FeasibleRankIterator(ctx, self.distinct_property_constraint)
        self.bin_pack = BinPackIterator(ctx, rank_source, False, 0)
        self.job_anti_aff = JobAntiAffinityIterator(ctx, self.bin_pack, "")
        self.node_rescheduling_penalty = NodeReschedulingPenaltyIterator(
            ctx, self.job_anti_aff
        )
        self.node_affinity = NodeAffinityIterator(ctx, self.node_rescheduling_penalty)
        self.spread = SpreadIterator(ctx, self.node_affinity)
        self.score_norm = ScoreNormalizationIterator(ctx, self.spread)
        self.limit = LimitIterator(
            ctx, self.score_norm, 2, SKIP_SCORE_THRESHOLD, MAX_SKIP
        )
        self.max_score = MaxScoreIterator(ctx, self.limit)

    def set_nodes(self, base_nodes: list[Node]):
        """Shuffle + set the log₂-bounded candidate limit (ref stack.go:67-87)."""
        shuffle_nodes(self.ctx, base_nodes)
        self.source.set_nodes(base_nodes)

        limit = 2
        n = len(base_nodes)
        if not self.batch and n > 0:
            log_limit = int(math.ceil(math.log2(n)))
            if log_limit > limit:
                limit = log_limit
        self.limit.set_limit(limit)

    def set_job(self, job: Job):
        self.job_constraint.set_constraints(job.constraints)
        self.distinct_hosts_constraint.set_job(job)
        self.distinct_property_constraint.set_job(job)
        self.bin_pack.set_job(job)
        self.job_anti_aff.set_job(job)
        self.node_affinity.set_job(job)
        self.spread.set_job(job)
        self.ctx.get_eligibility().set_job(job)

    def select(
        self, tg: TaskGroup, options: Optional[SelectOptions] = None
    ) -> Optional[RankedNode]:
        """ref stack.go:104-162"""
        # Preferred-node (sticky-disk) handling
        if options is not None and options.preferred_nodes:
            original_nodes = self.source.nodes
            self.source.set_nodes(list(options.preferred_nodes))
            options_new = SelectOptions(
                penalty_node_ids=options.penalty_node_ids,
                preferred_nodes=[],
                preempt=options.preempt,
            )
            option = self.select(tg, options_new)
            self.source.set_nodes(original_nodes)
            if option is not None:
                return option
            return self.select(tg, options_new)

        self.max_score.reset()
        self.ctx.reset()
        start = time.monotonic()

        constraints, drivers = task_group_constraints(tg)
        self.task_group_drivers.set_drivers(drivers)
        self.task_group_constraint.set_constraints(constraints)
        self.task_group_devices.set_task_group(tg)
        self.task_group_host_volumes.set_volumes(tg.volumes)
        self.distinct_hosts_constraint.set_task_group(tg)
        self.distinct_property_constraint.set_task_group(tg)
        self.wrapped_checks.set_task_group(tg.name)
        self.bin_pack.set_task_group(tg)
        if options is not None:
            self.bin_pack.evict = options.preempt
        self.job_anti_aff.set_task_group(tg)
        if options is not None:
            self.node_rescheduling_penalty.set_penalty_nodes(options.penalty_node_ids)
        self.node_affinity.set_task_group(tg)
        self.spread.set_task_group(tg)

        if self.node_affinity.has_affinities() or self.spread.has_spreads():
            self.limit.set_limit(2**31 - 1)

        option = self.max_score.next()
        self.ctx.metrics.allocation_time = time.monotonic() - start
        return option


class SystemStack:
    """Stack for the system scheduler: every node considered, preemption
    enabled by scheduler config (ref stack.go:166-284)."""

    def __init__(self, ctx: EvalContext):
        self.ctx = ctx
        self.source = StaticIterator(ctx, [])
        self.quota = QuotaIterator(ctx, self.source)
        self.job_constraint = ConstraintChecker(ctx)
        self.task_group_drivers = DriverChecker(ctx)
        self.task_group_constraint = ConstraintChecker(ctx)
        self.task_group_host_volumes = HostVolumeChecker(ctx)
        self.task_group_devices = DeviceChecker(ctx)

        self.wrapped_checks = FeasibilityWrapper(
            ctx,
            self.quota,
            [self.job_constraint],
            [
                self.task_group_drivers,
                self.task_group_constraint,
                self.task_group_host_volumes,
                self.task_group_devices,
            ],
        )
        self.distinct_property_constraint = DistinctPropertyIterator(
            ctx, self.wrapped_checks
        )
        rank_source = FeasibleRankIterator(ctx, self.distinct_property_constraint)

        enable_preemption = True
        config = ctx.state.scheduler_config()
        if config is not None:
            enable_preemption = config.get("preemption_config", {}).get(
                "system_scheduler_enabled", True
            )
        self.bin_pack = BinPackIterator(ctx, rank_source, enable_preemption, 0)
        self.score_norm = ScoreNormalizationIterator(ctx, self.bin_pack)

    def set_nodes(self, base_nodes: list[Node]):
        self.source.set_nodes(base_nodes)

    def set_job(self, job: Job):
        self.job_constraint.set_constraints(job.constraints)
        self.distinct_property_constraint.set_job(job)
        self.bin_pack.set_job(job)
        self.ctx.get_eligibility().set_job(job)

    def select(
        self, tg: TaskGroup, options: Optional[SelectOptions] = None
    ) -> Optional[RankedNode]:
        self.score_norm.reset()
        self.ctx.reset()
        start = time.monotonic()

        constraints, drivers = task_group_constraints(tg)
        self.task_group_drivers.set_drivers(drivers)
        self.task_group_constraint.set_constraints(constraints)
        self.task_group_devices.set_task_group(tg)
        self.task_group_host_volumes.set_volumes(tg.volumes)
        self.wrapped_checks.set_task_group(tg.name)
        self.distinct_property_constraint.set_task_group(tg)
        self.bin_pack.set_task_group(tg)

        option = self.score_norm.next()
        self.ctx.metrics.allocation_time = time.monotonic() - start
        return option
