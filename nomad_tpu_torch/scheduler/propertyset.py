"""Property sets: value→count maps backing distinct_property constraints and
spread scoring (ref scheduler/propertyset.go)."""

from __future__ import annotations

from typing import Optional

from ..structs.model import Allocation, Job, Node
from .context import EvalContext


def get_property(n: Optional[Node], prop: str) -> tuple[str, bool]:
    """ref propertyset.go:340-355"""
    from .feasible import resolve_target

    if n is None or not prop:
        return "", False
    val, ok = resolve_target(prop, n)
    if not ok or not isinstance(val, str):
        return "", False
    return val, True


class PropertySet:
    """Tracks values used for a node property across existing + proposed
    allocations (ref propertyset.go:14-337)."""

    def __init__(self, ctx: EvalContext, job: Job):
        self.ctx = ctx
        self.job_id = job.id
        self.namespace = job.namespace
        self.task_group = ""
        self.target_attribute = ""
        self.allowed_count = 0
        self.error_building: Optional[str] = None
        self.existing_values: dict[str, int] = {}
        self.proposed_values: dict[str, int] = {}
        self.cleared_values: dict[str, int] = {}

    # -- parameterization --------------------------------------------------
    def set_job_constraint(self, constraint):
        self._set_constraint(constraint, "")

    def set_tg_constraint(self, constraint, task_group: str):
        self._set_constraint(constraint, task_group)

    def _set_constraint(self, constraint, task_group: str):
        if constraint.r_target:
            try:
                allowed_count = int(constraint.r_target)
            except ValueError:
                self.error_building = (
                    f"failed to convert RTarget {constraint.r_target!r} to uint64"
                )
                return
        else:
            allowed_count = 1
        self._set_target(constraint.l_target, allowed_count, task_group)

    def set_target_attribute(self, target_attribute: str, task_group: str):
        """Used for spread evaluation (allowed_count unused)."""
        self._set_target(target_attribute, 0, task_group)

    def _set_target(self, target_attribute: str, allowed_count: int, task_group: str):
        if task_group:
            self.task_group = task_group
        self.target_attribute = target_attribute
        self.allowed_count = allowed_count
        self._populate_existing()
        self.populate_proposed()

    # -- population --------------------------------------------------------
    def _populate_existing(self):
        self._combined_cache = None
        allocs = self.ctx.state.allocs_by_job(self.namespace, self.job_id)
        allocs = self._filter_allocs(allocs, filter_terminal=True)
        nodes = self._build_node_map(allocs)
        self._populate_properties(allocs, nodes, self.existing_values)

    def populate_proposed(self):
        """ref propertyset.go:160-208"""
        self._combined_cache = None
        self.proposed_values = {}
        self.cleared_values = {}

        stopping: list[Allocation] = []
        for updates in self.ctx.plan.node_update.values():
            stopping.extend(updates)
        stopping = self._filter_allocs(stopping, filter_terminal=False)

        proposed: list[Allocation] = []
        for pallocs in self.ctx.plan.node_allocation.values():
            proposed.extend(pallocs)
        proposed = self._filter_allocs(proposed, filter_terminal=True)

        nodes = self._build_node_map(stopping + proposed)
        self._populate_properties(stopping, nodes, self.cleared_values)
        self._populate_properties(proposed, nodes, self.proposed_values)

        for value in self.proposed_values:
            current = self.cleared_values.get(value)
            if current is None:
                continue
            if current == 0:
                del self.cleared_values[value]
            elif current > 1:
                self.cleared_values[value] -= 1

    # -- queries -----------------------------------------------------------
    def satisfies_distinct_properties(self, option: Node, tg: str) -> tuple[bool, str]:
        n_value, error_msg, used_count = self.used_count(option, tg)
        if error_msg:
            return False, error_msg
        if used_count < self.allowed_count:
            return True, ""
        return False, (
            f"distinct_property: {self.target_attribute}={n_value} "
            f"used by {used_count} allocs"
        )

    def used_count(self, option: Node, tg: str) -> tuple[str, str, int]:
        if self.error_building is not None:
            return "", self.error_building, 0
        n_value, ok = get_property(option, self.target_attribute)
        if not ok:
            return n_value, f'missing property "{self.target_attribute}"', 0
        combined = self.get_combined_use_map()
        return n_value, "", combined.get(n_value, 0)

    def get_combined_use_map(self) -> dict[str, int]:
        """ref propertyset.go:250-274. Cached between populate calls: the
        spread iterator asks once PER NODE OPTION while the inputs only
        change per Select (populate_proposed on reset) — rebuilding the
        map 10K times per placement was pure overhead."""
        cached = getattr(self, "_combined_cache", None)
        if cached is not None:
            return cached
        combined: dict[str, int] = {}
        for used in (self.existing_values, self.proposed_values):
            for value, count in used.items():
                combined[value] = combined.get(value, 0) + count
        for value, cleared in self.cleared_values.items():
            if value not in combined:
                continue
            combined[value] = max(combined[value] - cleared, 0)
        self._combined_cache = combined
        return combined

    # -- helpers -----------------------------------------------------------
    def _filter_allocs(
        self, allocs: list[Allocation], filter_terminal: bool
    ) -> list[Allocation]:
        out = []
        for a in allocs:
            if filter_terminal and a.terminal_status():
                continue
            if self.task_group and a.task_group != self.task_group:
                continue
            out.append(a)
        return out

    def _build_node_map(self, allocs: list[Allocation]) -> dict[str, Node]:
        nodes: dict[str, Node] = {}
        for alloc in allocs:
            if alloc.node_id in nodes:
                continue
            nodes[alloc.node_id] = self.ctx.state.node_by_id(alloc.node_id)
        return nodes

    def _populate_properties(
        self,
        allocs: list[Allocation],
        nodes: dict[str, Node],
        properties: dict[str, int],
    ):
        for alloc in allocs:
            value, ok = get_property(nodes.get(alloc.node_id), self.target_attribute)
            if not ok:
                continue
            properties[value] = properties.get(value, 0) + 1
