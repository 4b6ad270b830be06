"""Spread iterator: weighted spread boosts over target attributes
(ref scheduler/spread.go)."""

from __future__ import annotations

from typing import Optional

from ..structs.model import Job, Node, Spread, TaskGroup
from .context import EvalContext
from .propertyset import PropertySet, get_property
from .rank import RankedNode

IMPLICIT_TARGET = "*"


class SpreadInfo:
    __slots__ = ("weight", "desired_counts")

    def __init__(self, weight: int):
        self.weight = weight
        self.desired_counts: dict[str, float] = {}


class SpreadIterator:
    """ref spread.go:15-257"""

    def __init__(self, ctx: EvalContext, source):
        self.ctx = ctx
        self.source = source
        self.job: Optional[Job] = None
        self.tg: Optional[TaskGroup] = None
        self.job_spreads: list[Spread] = []
        self.tg_spread_info: dict[str, dict[str, SpreadInfo]] = {}
        self.sum_spread_weights = 0
        self.has_spread = False
        self.group_property_sets: dict[str, list[PropertySet]] = {}

    def reset(self):
        self.source.reset()
        for sets in self.group_property_sets.values():
            for ps in sets:
                ps.populate_proposed()

    def set_job(self, job: Job):
        self.job = job
        if job.spreads:
            self.job_spreads = job.spreads

    def set_task_group(self, tg: TaskGroup):
        self.tg = tg
        if tg.name not in self.group_property_sets:
            sets = []
            for spread in self.job_spreads:
                pset = PropertySet(self.ctx, self.job)
                pset.set_target_attribute(spread.attribute, tg.name)
                sets.append(pset)
            for spread in tg.spreads:
                pset = PropertySet(self.ctx, self.job)
                pset.set_target_attribute(spread.attribute, tg.name)
                sets.append(pset)
            self.group_property_sets[tg.name] = sets
        self.has_spread = bool(self.group_property_sets[tg.name])
        if tg.name not in self.tg_spread_info:
            self._compute_spread_info(tg)

    def has_spreads(self) -> bool:
        return self.has_spread

    def next(self) -> Optional[RankedNode]:
        while True:
            option = self.source.next()
            if option is None or not self.has_spreads():
                return option

            tg_name = self.tg.name
            property_sets = self.group_property_sets[tg_name]
            total_spread_score = 0.0
            for pset in property_sets:
                n_value, error_msg, used_count = pset.used_count(option.node, tg_name)
                # Include this placement in the count
                used_count += 1
                if error_msg:
                    total_spread_score -= 1.0
                    continue
                spread_details = self.tg_spread_info[tg_name].get(
                    pset.target_attribute
                )
                if spread_details is None:
                    continue
                if not spread_details.desired_counts:
                    # No targets: even-spread scoring
                    total_spread_score += even_spread_score_boost(pset, option.node)
                else:
                    desired_count = spread_details.desired_counts.get(n_value)
                    if desired_count is None:
                        desired_count = spread_details.desired_counts.get(
                            IMPLICIT_TARGET
                        )
                        if desired_count is None:
                            total_spread_score -= 1.0
                            continue
                    # Go float semantics: /0 yields NaN, scheduling continues
                    spread_weight = (
                        float(spread_details.weight) / self.sum_spread_weights
                        if self.sum_spread_weights
                        else float("nan")
                    )
                    if desired_count == 0:
                        # Go float division: (0-used)/0 = -Inf (used ≥ 1
                        # here) — a 0% target class is effectively never
                        # chosen while any other option exists
                        boost = float("-inf") * spread_weight
                    else:
                        boost = (
                            (desired_count - float(used_count)) / desired_count
                        ) * spread_weight
                    total_spread_score += boost

            if total_spread_score != 0.0:
                option.scores.append(total_spread_score)
                self.ctx.metrics.score_node(
                    option.node, "allocation-spread", total_spread_score
                )
            return option

    def _compute_spread_info(self, tg: TaskGroup):
        """ref spread.go:232-257"""
        spread_infos: dict[str, SpreadInfo] = {}
        total_count = tg.count
        combined = list(tg.spreads) + list(self.job_spreads)
        for spread in combined:
            si = SpreadInfo(spread.weight)
            sum_desired = 0.0
            for st in spread.spread_target:
                desired_count = (float(st.percent) / 100.0) * float(total_count)
                si.desired_counts[st.value] = desired_count
                sum_desired += desired_count
            if 0 < sum_desired < float(total_count):
                si.desired_counts[IMPLICIT_TARGET] = float(total_count) - sum_desired
            spread_infos[spread.attribute] = si
            self.sum_spread_weights += spread.weight
        self.tg_spread_info[tg.name] = spread_infos


def even_spread_score_boost(pset: PropertySet, option: Node) -> float:
    """Even-spread scoring when no targets are configured (ref spread.go:178-228)."""
    combined_use = pset.get_combined_use_map()
    if not combined_use:
        return 0.0
    n_value, ok = get_property(option, pset.target_attribute)
    if not ok:
        return -1.0
    current = combined_use.get(n_value, 0)
    min_count = 0
    max_count = 0
    for value in combined_use.values():
        if min_count == 0 or value < min_count:
            min_count = value
        if max_count == 0 or value > max_count:
            max_count = value

    if min_count == 0:
        delta_boost = -1.0
    else:
        delta = min_count - current
        delta_boost = float(delta) / float(min_count)
    if current != min_count:
        return delta_boost
    elif min_count == max_count:
        return -1.0
    elif min_count == 0:
        return 1.0
    delta = max_count - min_count
    return float(delta) / float(min_count)
