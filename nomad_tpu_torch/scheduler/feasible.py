"""Feasibility iterators and checkers (ref scheduler/feasible.go).

Constraint operand semantics are reproduced exactly (feasible.go:533-564):
``= == is != not < <= > >= version regexp set_contains{,_all,_any} is_set
is_not_set`` with lexical string comparison, cached regex/version-constraint
compilation, and the computed-node-class memoization wrapper.
"""

from __future__ import annotations

import re
from typing import Optional

from ..structs.attribute import Attribute, parse_attribute
from ..structs.model import (
    CONSTRAINT_ATTRIBUTE_IS_NOT_SET,
    CONSTRAINT_ATTRIBUTE_IS_SET,
    CONSTRAINT_DISTINCT_HOSTS,
    CONSTRAINT_DISTINCT_PROPERTY,
    CONSTRAINT_REGEX,
    CONSTRAINT_SET_CONTAINS,
    CONSTRAINT_SET_CONTAINS_ALL,
    CONSTRAINT_SET_CONTAINS_ANY,
    CONSTRAINT_VERSION,
    VOLUME_TYPE_HOST,
    Constraint,
    Job,
    Node,
    NodeDeviceResource,
    RequestedDevice,
    TaskGroup,
    VolumeRequest,
)
from .context import (
    EVAL_COMPUTED_CLASS_ELIGIBLE,
    EVAL_COMPUTED_CLASS_ESCAPED,
    EVAL_COMPUTED_CLASS_INELIGIBLE,
    EVAL_COMPUTED_CLASS_UNKNOWN,
    EvalContext,
)
from .version import Constraints, Version


# ---------------------------------------------------------------------------
# Target resolution + operand checks
# ---------------------------------------------------------------------------

def resolve_target(target: str, node: Node) -> tuple[Optional[str], bool]:
    """Resolve a constraint target against a node (ref feasible.go:496-529)."""
    if not target.startswith("${"):
        return target, True
    if target == "${node.unique.id}":
        return node.id, True
    if target == "${node.datacenter}":
        return node.datacenter, True
    if target == "${node.unique.name}":
        return node.name, True
    if target == "${node.class}":
        return node.node_class, True
    if target.startswith("${attr."):
        attr = target[len("${attr.") : -1]
        if attr in node.attributes:
            return node.attributes[attr], True
        return None, False
    if target.startswith("${meta."):
        meta = target[len("${meta.") : -1]
        if meta in node.meta:
            return node.meta[meta], True
        return None, False
    return None, False


def check_lexical_order(op: str, l_val, r_val) -> bool:
    if not isinstance(l_val, str) or not isinstance(r_val, str):
        return False
    if op == "<":
        return l_val < r_val
    if op == "<=":
        return l_val <= r_val
    if op == ">":
        return l_val > r_val
    if op == ">=":
        return l_val >= r_val
    return False


def check_version_match(ctx: EvalContext, l_val, r_val) -> bool:
    """ref feasible.go:604-643"""
    if isinstance(l_val, int):
        version_str = str(l_val)
    elif isinstance(l_val, str):
        version_str = l_val
    else:
        return False
    vers = Version.parse(version_str)
    if vers is None:
        return False
    if not isinstance(r_val, str):
        return False
    constraints = ctx.version_constraint_cache.get(r_val)
    if constraints is None:
        constraints = Constraints.parse(r_val)
        if constraints is None:
            return False
        ctx.version_constraint_cache[r_val] = constraints
    return constraints.check(vers)


def check_regexp_match(ctx: EvalContext, l_val, r_val) -> bool:
    """ref feasible.go:689-718"""
    if not isinstance(l_val, str) or not isinstance(r_val, str):
        return False
    pattern = ctx.regexp_cache.get(r_val)
    if pattern is None:
        try:
            pattern = re.compile(r_val)
        except re.error:
            return False
        ctx.regexp_cache[r_val] = pattern
    return pattern.search(l_val) is not None


def _split_set(s: str) -> set[str]:
    return {part.strip() for part in s.split(",")}


def check_set_contains_all(l_val, r_val) -> bool:
    if not isinstance(l_val, str) or not isinstance(r_val, str):
        return False
    return _split_set(r_val) <= _split_set(l_val)


def check_set_contains_any(l_val, r_val) -> bool:
    if not isinstance(l_val, str) or not isinstance(r_val, str):
        return False
    return bool(_split_set(r_val) & _split_set(l_val))


def check_constraint(
    ctx: EvalContext, operand: str, l_val, r_val, l_found: bool, r_found: bool
) -> bool:
    """ref feasible.go:533-564"""
    if operand in (CONSTRAINT_DISTINCT_HOSTS, CONSTRAINT_DISTINCT_PROPERTY):
        return True
    if operand in ("=", "==", "is"):
        return l_found and r_found and l_val == r_val
    if operand in ("!=", "not"):
        return l_val != r_val
    if operand in ("<", "<=", ">", ">="):
        return l_found and r_found and check_lexical_order(operand, l_val, r_val)
    if operand == CONSTRAINT_ATTRIBUTE_IS_SET:
        return l_found
    if operand == CONSTRAINT_ATTRIBUTE_IS_NOT_SET:
        return not l_found
    if operand == CONSTRAINT_VERSION:
        return l_found and r_found and check_version_match(ctx, l_val, r_val)
    if operand == CONSTRAINT_REGEX:
        return l_found and r_found and check_regexp_match(ctx, l_val, r_val)
    if operand in (CONSTRAINT_SET_CONTAINS, CONSTRAINT_SET_CONTAINS_ALL):
        return l_found and r_found and check_set_contains_all(l_val, r_val)
    if operand == CONSTRAINT_SET_CONTAINS_ANY:
        return l_found and r_found and check_set_contains_any(l_val, r_val)
    return False


def check_affinity(ctx, operand, l_val, r_val, l_found, r_found) -> bool:
    return check_constraint(ctx, operand, l_val, r_val, l_found, r_found)


# ---------------------------------------------------------------------------
# Device attribute constraints (ref feasible.go:1007-1166)
# ---------------------------------------------------------------------------

def resolve_device_target(
    target: str, d: NodeDeviceResource
) -> tuple[Optional[Attribute], bool]:
    """ref feasible.go:1033-1059"""
    if not target.startswith("${"):
        return parse_attribute(target), True
    if target == "${device.model}":
        return Attribute.of_string(d.name), True
    if target == "${device.vendor}":
        return Attribute.of_string(d.vendor), True
    if target == "${device.type}":
        return Attribute.of_string(d.type), True
    if target.startswith("${device.attr."):
        attr = target[len("${device.attr.") : -1]
        if attr in d.attributes:
            return d.attributes[attr], True
        return None, False
    return None, False


def check_attribute_constraint(
    ctx: EvalContext,
    operand: str,
    l_val: Optional[Attribute],
    r_val: Optional[Attribute],
    l_found: bool,
    r_found: bool,
) -> bool:
    """ref feasible.go:1063-1166"""
    if operand in (CONSTRAINT_DISTINCT_HOSTS, CONSTRAINT_DISTINCT_PROPERTY):
        return True

    if operand in ("!=", "not"):
        if not (l_found or r_found):
            return False
        if l_found != r_found:
            return True
        v, ok = l_val.compare(r_val)
        return ok and v != 0

    if operand in ("<", "<=", ">", ">=", "=", "==", "is"):
        if not (l_found and r_found):
            return False
        v, ok = l_val.compare(r_val)
        if not ok:
            return False
        return {
            "is": v == 0,
            "==": v == 0,
            "=": v == 0,
            "<": v == -1,
            "<=": v != 1,
            ">": v == 1,
            ">=": v != -1,
        }[operand]

    if operand == CONSTRAINT_VERSION:
        if not (l_found and r_found):
            return False
        ls, ok = l_val.get_string()
        if not ok:
            lv, ok2 = l_val.get_int()
            if not ok2:
                return False
            ls = str(lv)
        rs, ok = r_val.get_string()
        if not ok:
            return False
        return check_version_match(ctx, ls, rs)

    if operand == CONSTRAINT_REGEX:
        if not (l_found and r_found):
            return False
        ls, ok1 = l_val.get_string()
        rs, ok2 = r_val.get_string()
        return ok1 and ok2 and check_regexp_match(ctx, ls, rs)

    if operand in (CONSTRAINT_SET_CONTAINS, CONSTRAINT_SET_CONTAINS_ALL):
        if not (l_found and r_found):
            return False
        ls, ok1 = l_val.get_string()
        rs, ok2 = r_val.get_string()
        return ok1 and ok2 and check_set_contains_all(ls, rs)

    if operand == CONSTRAINT_SET_CONTAINS_ANY:
        if not (l_found and r_found):
            return False
        ls, ok1 = l_val.get_string()
        rs, ok2 = r_val.get_string()
        return ok1 and ok2 and check_set_contains_any(ls, rs)

    if operand == CONSTRAINT_ATTRIBUTE_IS_SET:
        return l_found
    if operand == CONSTRAINT_ATTRIBUTE_IS_NOT_SET:
        return not l_found
    return False


def check_attribute_affinity(ctx, operand, l_val, r_val, l_found, r_found) -> bool:
    return check_attribute_constraint(ctx, operand, l_val, r_val, l_found, r_found)


def node_device_matches(
    ctx: EvalContext, d: NodeDeviceResource, req: RequestedDevice
) -> bool:
    """ref feasible.go:1007-1029"""
    if not d.device_id().matches(req.device_id()):
        return False
    for c in req.constraints:
        l_val, l_ok = resolve_device_target(c.l_target, d)
        r_val, r_ok = resolve_device_target(c.r_target, d)
        if not check_attribute_constraint(ctx, c.operand, l_val, r_val, l_ok, r_ok):
            return False
    return True


# ---------------------------------------------------------------------------
# Source iterators
# ---------------------------------------------------------------------------

class StaticIterator:
    """Yields nodes in fixed order (ref feasible.go:43-97)."""

    def __init__(self, ctx: EvalContext, nodes: Optional[list[Node]]):
        self.ctx = ctx
        self.nodes = nodes or []
        self.offset = 0
        self.seen = 0

    def next(self) -> Optional[Node]:
        n = len(self.nodes)
        if self.offset == n or self.seen == n:
            if self.seen != n:
                self.offset = 0
            else:
                return None
        offset = self.offset
        self.offset += 1
        self.seen += 1
        self.ctx.metrics.evaluate_node()
        return self.nodes[offset]

    def reset(self):
        self.seen = 0

    def set_nodes(self, nodes: list[Node]):
        self.nodes = nodes
        self.offset = 0
        self.seen = 0


def new_random_iterator(ctx: EvalContext, nodes: list[Node]) -> StaticIterator:
    shuffle_nodes(ctx, nodes)
    return StaticIterator(ctx, nodes)


def shuffle_nodes(ctx: EvalContext, nodes: list[Node]):
    """In-place Fisher-Yates with the context's seeded rng
    (ref scheduler/util.go:329)."""
    for i in range(len(nodes) - 1, 0, -1):
        j = ctx.rng.randrange(i + 1)
        nodes[i], nodes[j] = nodes[j], nodes[i]


# ---------------------------------------------------------------------------
# Checkers
# ---------------------------------------------------------------------------

class HostVolumeChecker:
    """ref feasible.go:99-177"""

    def __init__(self, ctx: EvalContext):
        self.ctx = ctx
        self.volumes: dict[str, list[VolumeRequest]] = {}

    def set_volumes(self, volumes: dict[str, VolumeRequest]):
        lookup: dict[str, list[VolumeRequest]] = {}
        for req in volumes.values():
            if req.type != VOLUME_TYPE_HOST:
                continue
            lookup.setdefault(req.source, []).append(req)
        self.volumes = lookup

    def feasible(self, candidate: Node) -> bool:
        if self._has_volumes(candidate):
            return True
        self.ctx.metrics.filter_node(candidate, "missing compatible host volumes")
        return False

    def _has_volumes(self, n: Node) -> bool:
        if not self.volumes:
            return True
        if len(self.volumes) > len(n.host_volumes):
            return False
        for source, requests in self.volumes.items():
            node_volume = n.host_volumes.get(source)
            if node_volume is None:
                return False
            if not node_volume.read_only:
                continue
            for req in requests:
                if not req.read_only:
                    return False
        return True


class DriverChecker:
    """ref feasible.go:179-248"""

    def __init__(self, ctx: EvalContext, drivers: Optional[set[str]] = None):
        self.ctx = ctx
        self.drivers = drivers or set()

    def set_drivers(self, drivers: set[str]):
        self.drivers = drivers

    def feasible(self, option: Node) -> bool:
        if self._has_drivers(option):
            return True
        self.ctx.metrics.filter_node(option, "missing drivers")
        return False

    def _has_drivers(self, option: Node) -> bool:
        for driver in self.drivers:
            info = option.drivers.get(driver)
            if info is not None:
                if info.detected and info.healthy:
                    continue
                return False
            value = option.attributes.get(f"driver.{driver}")
            if value is None:
                return False
            if value.strip().lower() not in ("1", "true", "t"):
                return False
        return True


class ConstraintChecker:
    """ref feasible.go:454-493"""

    def __init__(self, ctx: EvalContext, constraints: Optional[list[Constraint]] = None):
        self.ctx = ctx
        self.constraints = constraints or []

    def set_constraints(self, constraints: list[Constraint]):
        self.constraints = constraints

    def feasible(self, option: Node) -> bool:
        for constraint in self.constraints:
            if not self._meets_constraint(constraint, option):
                self.ctx.metrics.filter_node(option, str(constraint))
                return False
        return True

    def _meets_constraint(self, constraint: Constraint, option: Node) -> bool:
        l_val, l_ok = resolve_target(constraint.l_target, option)
        r_val, r_ok = resolve_target(constraint.r_target, option)
        return check_constraint(
            self.ctx, constraint.operand, l_val, r_val, l_ok, r_ok
        )


class DeviceChecker:
    """ref feasible.go:900-1003"""

    def __init__(self, ctx: EvalContext):
        self.ctx = ctx
        self.required: list[RequestedDevice] = []
        self.requires_devices = False

    def set_task_group(self, tg: TaskGroup):
        self.required = []
        for task in tg.tasks:
            self.required.extend(task.resources.devices)
        self.requires_devices = bool(self.required)

    def feasible(self, option: Node) -> bool:
        if self._has_devices(option):
            return True
        self.ctx.metrics.filter_node(option, "missing devices")
        return False

    def _has_devices(self, option: Node) -> bool:
        if not self.requires_devices:
            return True
        if option.node_resources is None:
            return False
        node_devs = option.node_resources.devices
        if not node_devs:
            return False

        available: dict[int, tuple[NodeDeviceResource, int]] = {}
        for i, d in enumerate(node_devs):
            healthy = sum(1 for inst in d.instances if inst.healthy)
            if healthy:
                available[i] = (d, healthy)

        for req in self.required:
            desired = req.count
            matched = False
            for i, (d, unused) in available.items():
                if unused == 0 or unused < desired:
                    continue
                if node_device_matches(self.ctx, d, req):
                    available[i] = (d, unused - desired)
                    matched = True
                    break
            if not matched:
                return False
        return True


# ---------------------------------------------------------------------------
# Distinct-hosts / distinct-property iterators
# ---------------------------------------------------------------------------

class DistinctHostsIterator:
    """ref feasible.go:250-347"""

    def __init__(self, ctx: EvalContext, source):
        self.ctx = ctx
        self.source = source
        self.tg: Optional[TaskGroup] = None
        self.job: Optional[Job] = None
        self.tg_distinct_hosts = False
        self.job_distinct_hosts = False

    @staticmethod
    def _has_distinct_hosts(constraints: list[Constraint]) -> bool:
        return any(c.operand == CONSTRAINT_DISTINCT_HOSTS for c in constraints)

    def set_task_group(self, tg: TaskGroup):
        self.tg = tg
        self.tg_distinct_hosts = self._has_distinct_hosts(tg.constraints)

    def set_job(self, job: Job):
        self.job = job
        self.job_distinct_hosts = self._has_distinct_hosts(job.constraints)

    def next(self) -> Optional[Node]:
        while True:
            option = self.source.next()
            if option is None or not (
                self.job_distinct_hosts or self.tg_distinct_hosts
            ):
                return option
            if not self._satisfies(option):
                self.ctx.metrics.filter_node(option, CONSTRAINT_DISTINCT_HOSTS)
                continue
            return option

    def _satisfies(self, option: Node) -> bool:
        proposed = self.ctx.proposed_allocs(option.id)
        for alloc in proposed:
            job_collision = alloc.job_id == self.job.id
            task_collision = alloc.task_group == self.tg.name
            if (self.job_distinct_hosts and job_collision) or (
                job_collision and task_collision
            ):
                return False
        return True

    def reset(self):
        self.source.reset()


class DistinctPropertyIterator:
    """ref feasible.go:349-452"""

    def __init__(self, ctx: EvalContext, source):
        from .propertyset import PropertySet

        self.ctx = ctx
        self.source = source
        self.tg: Optional[TaskGroup] = None
        self.job: Optional[Job] = None
        self.has_distinct_property = False
        self.job_property_sets: list = []
        self.group_property_sets: dict[str, list] = {}
        self._pset_cls = PropertySet

    def set_task_group(self, tg: TaskGroup):
        self.tg = tg
        if tg.name not in self.group_property_sets:
            sets = []
            for c in tg.constraints:
                if c.operand != CONSTRAINT_DISTINCT_PROPERTY:
                    continue
                pset = self._pset_cls(self.ctx, self.job)
                pset.set_tg_constraint(c, tg.name)
                sets.append(pset)
            self.group_property_sets[tg.name] = sets
        self.has_distinct_property = bool(self.job_property_sets) or bool(
            self.group_property_sets[tg.name]
        )

    def set_job(self, job: Job):
        self.job = job
        for c in job.constraints:
            if c.operand != CONSTRAINT_DISTINCT_PROPERTY:
                continue
            pset = self._pset_cls(self.ctx, job)
            pset.set_job_constraint(c)
            self.job_property_sets.append(pset)

    def next(self) -> Optional[Node]:
        while True:
            option = self.source.next()
            if option is None or not self.has_distinct_property:
                return option
            if not self._satisfies_properties(option, self.job_property_sets):
                continue
            if not self._satisfies_properties(
                option, self.group_property_sets.get(self.tg.name, [])
            ):
                continue
            return option

    def _satisfies_properties(self, option: Node, sets: list) -> bool:
        for ps in sets:
            satisfies, reason = ps.satisfies_distinct_properties(option, self.tg.name)
            if not satisfies:
                self.ctx.metrics.filter_node(option, reason)
                return False
        return True

    def reset(self):
        self.source.reset()
        for ps in self.job_property_sets:
            ps.populate_proposed()
        for sets in self.group_property_sets.values():
            for ps in sets:
                ps.populate_proposed()


# ---------------------------------------------------------------------------
# Class-memoized feasibility wrapper
# ---------------------------------------------------------------------------

class FeasibilityWrapper:
    """Runs job/task-group checkers only when the computed node class hasn't
    already been decided (ref feasible.go:784-898)."""

    def __init__(self, ctx: EvalContext, source, job_checkers, tg_checkers):
        self.ctx = ctx
        self.source = source
        self.job_checkers = job_checkers
        self.tg_checkers = tg_checkers
        self.tg = ""

    def set_task_group(self, tg: str):
        self.tg = tg

    def reset(self):
        self.source.reset()

    def next(self) -> Optional[Node]:
        elig = self.ctx.get_eligibility()
        metrics = self.ctx.metrics

        while True:
            option = self.source.next()
            if option is None:
                return None

            job_escaped = job_unknown = False
            status = elig.job_status(option.computed_class)
            if status == EVAL_COMPUTED_CLASS_INELIGIBLE:
                metrics.filter_node(option, "computed class ineligible")
                continue
            elif status == EVAL_COMPUTED_CLASS_ESCAPED:
                job_escaped = True
            elif status == EVAL_COMPUTED_CLASS_UNKNOWN:
                job_unknown = True

            failed_job = False
            for check in self.job_checkers:
                if not check.feasible(option):
                    if not job_escaped:
                        elig.set_job_eligibility(False, option.computed_class)
                    failed_job = True
                    break
            if failed_job:
                continue

            if not job_escaped and job_unknown:
                elig.set_job_eligibility(True, option.computed_class)

            tg_escaped = tg_unknown = False
            status = elig.task_group_status(self.tg, option.computed_class)
            if status == EVAL_COMPUTED_CLASS_INELIGIBLE:
                metrics.filter_node(option, "computed class ineligible")
                continue
            elif status == EVAL_COMPUTED_CLASS_ELIGIBLE:
                return option
            elif status == EVAL_COMPUTED_CLASS_ESCAPED:
                tg_escaped = True
            elif status == EVAL_COMPUTED_CLASS_UNKNOWN:
                tg_unknown = True

            failed_tg = False
            for check in self.tg_checkers:
                if not check.feasible(option):
                    if not tg_escaped:
                        elig.set_task_group_eligibility(
                            False, self.tg, option.computed_class
                        )
                    failed_tg = True
                    break
            if failed_tg:
                continue

            if not tg_escaped and tg_unknown:
                elig.set_task_group_eligibility(True, self.tg, option.computed_class)

            return option


class QuotaIterator:
    """OSS no-op quota iterator (ref scheduler/quota.go OSS stub)."""

    def __init__(self, ctx: EvalContext, source):
        self.source = source

    def next(self):
        return self.source.next()

    def reset(self):
        self.source.reset()
