"""Evaluation context: per-eval caches, proposed-alloc overlay, class
eligibility (ref scheduler/context.go)."""

from __future__ import annotations

import logging
import random
import re
from typing import Optional

from ..structs.model import Allocation, AllocMetric, Job, Plan, remove_allocs
from ..structs.node_class import escaped_constraints

logger = logging.getLogger("nomad_tpu.scheduler")

# ComputedClassFeasibility states (ref context.go:158-177)
EVAL_COMPUTED_CLASS_UNKNOWN = 0
EVAL_COMPUTED_CLASS_INELIGIBLE = 1
EVAL_COMPUTED_CLASS_ELIGIBLE = 2
EVAL_COMPUTED_CLASS_ESCAPED = 3


class EvalEligibility:
    """Tracks node eligibility by computed node class over an evaluation
    (ref context.go:181-347)."""

    def __init__(self):
        self.job: dict[str, int] = {}
        self.job_escaped = False
        self.task_groups: dict[str, dict[str, int]] = {}
        self.tg_escaped: dict[str, bool] = {}
        self.quota_reached = ""

    def set_job(self, job: Job):
        self.job_escaped = len(escaped_constraints(job.constraints)) != 0
        for tg in job.task_groups:
            constraints = list(tg.constraints)
            for task in tg.tasks:
                constraints.extend(task.constraints)
            self.tg_escaped[tg.name] = len(escaped_constraints(constraints)) != 0

    def has_escaped(self) -> bool:
        return self.job_escaped or any(self.tg_escaped.values())

    def get_classes(self) -> dict[str, bool]:
        """ref context.go:245-281"""
        elig: dict[str, bool] = {}
        for classes in self.task_groups.values():
            for cls, feas in classes.items():
                if feas == EVAL_COMPUTED_CLASS_ELIGIBLE:
                    elig[cls] = True
                elif feas == EVAL_COMPUTED_CLASS_INELIGIBLE:
                    if cls not in elig:
                        elig[cls] = False
        for cls, feas in self.job.items():
            if feas == EVAL_COMPUTED_CLASS_ELIGIBLE:
                if cls not in elig:
                    elig[cls] = True
            elif feas == EVAL_COMPUTED_CLASS_INELIGIBLE:
                elig[cls] = False
        return elig

    def job_status(self, cls: str) -> int:
        if self.job_escaped:
            return EVAL_COMPUTED_CLASS_ESCAPED
        return self.job.get(cls, EVAL_COMPUTED_CLASS_UNKNOWN)

    def set_job_eligibility(self, eligible: bool, cls: str):
        self.job[cls] = (
            EVAL_COMPUTED_CLASS_ELIGIBLE if eligible else EVAL_COMPUTED_CLASS_INELIGIBLE
        )

    def task_group_status(self, tg: str, cls: str) -> int:
        if self.tg_escaped.get(tg, False):
            return EVAL_COMPUTED_CLASS_ESCAPED
        return self.task_groups.get(tg, {}).get(cls, EVAL_COMPUTED_CLASS_UNKNOWN)

    def set_task_group_eligibility(self, eligible: bool, tg: str, cls: str):
        val = (
            EVAL_COMPUTED_CLASS_ELIGIBLE if eligible else EVAL_COMPUTED_CLASS_INELIGIBLE
        )
        self.task_groups.setdefault(tg, {})[cls] = val

    def set_quota_limit_reached(self, quota: str):
        self.quota_reached = quota

    def quota_limit_reached(self) -> str:
        return self.quota_reached


class EvalContext:
    """Context threaded through the placement stack (ref context.go:66-156).

    ``rng`` makes every randomized decision (node shuffle, stochastic port
    picks) reproducible so the TPU batch path can be diffed against this
    oracle deterministically.
    """

    def __init__(self, state, plan: Plan, rng: Optional[random.Random] = None):
        self.state = state
        self.plan = plan
        self.metrics = AllocMetric()
        self.eligibility: Optional[EvalEligibility] = None
        self.regexp_cache: dict[str, Optional[re.Pattern]] = {}
        self.version_constraint_cache: dict[str, object] = {}
        self.logger = logger
        self.rng = rng or random.Random()

    def reset(self):
        self.metrics = AllocMetric()

    def get_eligibility(self) -> EvalEligibility:
        if self.eligibility is None:
            self.eligibility = EvalEligibility()
        return self.eligibility

    def proposed_allocs(self, node_id: str) -> list[Allocation]:
        """Existing non-terminal allocs − planned evictions − preemptions +
        planned placements (ref context.go:110-148)."""
        existing = self.state.allocs_by_node_terminal(node_id, False)
        proposed = existing
        update = self.plan.node_update.get(node_id, [])
        if update:
            proposed = remove_allocs(existing, update)
        preempted = self.plan.node_preemptions.get(node_id, [])
        if preempted:
            proposed = remove_allocs(existing, preempted)

        proposed_ids: dict[str, Allocation] = {a.id: a for a in proposed}
        for alloc in self.plan.node_allocation.get(node_id, []):
            proposed_ids[alloc.id] = alloc
        return list(proposed_ids.values())
