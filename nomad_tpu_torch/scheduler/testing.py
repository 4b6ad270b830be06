"""Test harness: in-process fake Planner + real StateStore
(ref scheduler/testing.go:42-283). This is the oracle-parity fixture —
identical inputs through the scalar oracle and the TPU batch path are
compared on the plans captured here."""

from __future__ import annotations

import random
import threading
from typing import Optional

from ..state import StateStore
from ..structs.model import Evaluation, Plan, PlanResult


class RejectPlan:
    """Planner that rejects all plans (ref testing.go:17-39)."""

    def __init__(self, harness: "Harness"):
        self.harness = harness

    def submit_plan(self, plan: Plan):
        result = PlanResult(refresh_index=self.harness.next_index())
        return result, self.harness.state

    def update_eval(self, eval: Evaluation):
        pass

    def create_eval(self, eval: Evaluation):
        pass

    def reblock_eval(self, eval: Evaluation):
        pass


class Harness:
    """ref testing.go:42-283"""

    def __init__(
        self,
        state: Optional[StateStore] = None,
        seed: Optional[int] = None,
        device=None,
    ):
        self.state = state or StateStore()
        self.planner = None  # optional override
        self.plans: list[Plan] = []
        self.evals: list[Evaluation] = []
        self.create_evals: list[Evaluation] = []
        self.reblock_evals: list[Evaluation] = []
        self._next_index = 1
        self._lock = threading.Lock()
        self.seed = seed
        #: the planners' device, handed to every scheduler it makes
        self.device = device

    def next_index(self) -> int:
        with self._lock:
            idx = self._next_index
            self._next_index += 1
            return idx

    # -- Planner interface -------------------------------------------------
    def submit_plan(self, plan: Plan):
        """Apply the plan directly against the state store
        (ref testing.go:70-128)."""
        self.plans.append(plan)
        if self.planner is not None:
            return self.planner.submit_plan(plan)

        index = self.next_index()
        result = PlanResult(
            node_update=plan.node_update,
            node_allocation=plan.node_allocation,
            node_preemptions=plan.node_preemptions,
            deployment=plan.deployment,
            deployment_updates=plan.deployment_updates,
            alloc_index=index,
        )
        self.state.upsert_plan_results(index, plan, result)
        return result, None

    def update_eval(self, eval: Evaluation):
        self.evals.append(eval)
        if self.planner is not None:
            self.planner.update_eval(eval)

    def create_eval(self, eval: Evaluation):
        self.create_evals.append(eval)
        if self.planner is not None:
            self.planner.create_eval(eval)

    def reblock_eval(self, eval: Evaluation):
        self.reblock_evals.append(eval)
        if self.planner is not None:
            self.planner.reblock_eval(eval)

    # -- Driving -----------------------------------------------------------
    def snapshot(self):
        return self.state.snapshot()

    def process(self, factory_name: str, eval: Evaluation):
        """Create a scheduler against a snapshot and process the eval
        (ref testing.go:260-270)."""
        from .scheduler import new_scheduler

        rng = random.Random(self.seed) if self.seed is not None else None
        sched = new_scheduler(
            factory_name, self.snapshot(), self, rng=rng, device=self.device
        )
        sched.process(eval)
        return sched
