"""Preemption: choose lower-priority allocations to evict when a placement
doesn't fit (ref scheduler/preemption.go).

Semantics reproduced: candidates must be ≥10 priority below the placing job,
grouped by priority (lowest first), greedily picked by resource-distance with
a max_parallel penalty (cap 50/excess), then trimmed by filter_superset.
"""

from __future__ import annotations

import math
from typing import Optional

from ..structs.model import (
    AllocatedResources,
    AllocatedTaskResources,
    Allocation,
    ComparableResources,
    NetworkResource,
    Node,
    RequestedDevice,
)
from ..structs.network import NetworkIndex
from .context import EvalContext

MAX_PARALLEL_PENALTY = 50.0


def basic_resource_distance(
    ask: ComparableResources, used: ComparableResources
) -> float:
    """Euclidean distance in normalized (mem, cpu, disk) space
    (ref preemption.go:608-624)."""
    memory_coord = cpu_coord = disk_coord = 0.0
    if ask.flattened.memory.memory_mb > 0:
        memory_coord = (
            float(ask.flattened.memory.memory_mb)
            - float(used.flattened.memory.memory_mb)
        ) / float(ask.flattened.memory.memory_mb)
    if ask.flattened.cpu.cpu_shares > 0:
        cpu_coord = (
            float(ask.flattened.cpu.cpu_shares) - float(used.flattened.cpu.cpu_shares)
        ) / float(ask.flattened.cpu.cpu_shares)
    if ask.shared.disk_mb > 0:
        disk_coord = (
            float(ask.shared.disk_mb) - float(used.shared.disk_mb)
        ) / float(ask.shared.disk_mb)
    return math.sqrt(memory_coord**2 + cpu_coord**2 + disk_coord**2)


def network_resource_distance(
    used: Optional[NetworkResource], needed: Optional[NetworkResource]
) -> float:
    """ref preemption.go:627-635"""
    if used is None or needed is None:
        return math.inf
    return abs(float(needed.mbits - used.mbits) / float(needed.mbits))


def score_for_task_group(
    ask: ComparableResources,
    used: ComparableResources,
    max_parallel: int,
    num_preempted: int,
) -> float:
    """ref preemption.go:640-646"""
    penalty = 0.0
    if max_parallel > 0 and num_preempted >= max_parallel:
        penalty = float((num_preempted + 1) - max_parallel) * MAX_PARALLEL_PENALTY
    return basic_resource_distance(ask, used) + penalty


def score_for_network(
    used: Optional[NetworkResource],
    needed: Optional[NetworkResource],
    max_parallel: int,
    num_preempted: int,
) -> float:
    """ref preemption.go:650-659"""
    if used is None or needed is None:
        return math.inf
    penalty = 0.0
    if max_parallel > 0 and num_preempted >= max_parallel:
        penalty = float((num_preempted + 1) - max_parallel) * MAX_PARALLEL_PENALTY
    return network_resource_distance(used, needed) + penalty


def filter_and_group_preemptible_allocs(
    job_priority: int, current: list[Allocation]
) -> list[tuple[int, list[Allocation]]]:
    """Group by priority (ascending) after filtering allocs within a priority
    delta of 10 (ref preemption.go:663-697)."""
    by_priority: dict[int, list[Allocation]] = {}
    for alloc in current:
        if alloc.job is None:
            continue
        if job_priority - alloc.job.priority < 10:
            continue
        by_priority.setdefault(alloc.job.priority, []).append(alloc)
    return sorted(by_priority.items())


class Preemptor:
    """ref preemption.go:96-454"""

    def __init__(
        self, job_priority: int, ctx: EvalContext, job_id: Optional[tuple[str, str]]
    ):
        self.current_preemptions: dict[tuple[str, str], dict[str, int]] = {}
        self.alloc_details: dict[str, dict] = {}
        self.job_priority = job_priority
        self.job_id = job_id
        self.node_remaining_resources: Optional[ComparableResources] = None
        self.current_allocs: list[Allocation] = []
        self.ctx = ctx

    def set_node(self, node: Node):
        remaining = node.comparable_resources()
        reserved = node.comparable_reserved_resources()
        if reserved is not None:
            remaining.subtract(reserved)
        self.node_remaining_resources = remaining

    def set_candidates(self, allocs: list[Allocation]):
        self.current_allocs = []
        for alloc in allocs:
            if (
                self.job_id is not None
                and alloc.job_id == self.job_id[1]
                and alloc.namespace == self.job_id[0]
            ):
                continue
            max_parallel = 0
            if alloc.job is not None:
                tg = alloc.job.lookup_task_group(alloc.task_group)
                if tg is not None and tg.migrate is not None:
                    max_parallel = tg.migrate.max_parallel
            self.alloc_details[alloc.id] = {
                "max_parallel": max_parallel,
                "resources": alloc.comparable_resources(),
            }
            self.current_allocs.append(alloc)

    def set_preemptions(self, allocs: list[Allocation]):
        self.current_preemptions = {}
        for alloc in allocs:
            key = (alloc.namespace, alloc.job_id)
            self.current_preemptions.setdefault(key, {})
            self.current_preemptions[key][alloc.task_group] = (
                self.current_preemptions[key].get(alloc.task_group, 0) + 1
            )

    def _num_preemptions(self, alloc: Allocation) -> int:
        return self.current_preemptions.get((alloc.namespace, alloc.job_id), {}).get(
            alloc.task_group, 0
        )

    # ------------------------------------------------------------------
    def preempt_for_task_group(
        self, resource_ask: AllocatedResources
    ) -> list[Allocation]:
        """ref preemption.go:198-265"""
        resources_needed = resource_ask.comparable()

        for alloc in self.current_allocs:
            self.node_remaining_resources.subtract(
                self.alloc_details[alloc.id]["resources"]
            )

        allocs_by_priority = filter_and_group_preemptible_allocs(
            self.job_priority, self.current_allocs
        )

        best_allocs: list[Allocation] = []
        all_requirements_met = False
        available = self.node_remaining_resources.copy()
        resources_asked = resource_ask.comparable()

        for _, grp_allocs in allocs_by_priority:
            grp = list(grp_allocs)
            while grp and not all_requirements_met:
                closest_index = -1
                best_distance = math.inf
                for index, alloc in enumerate(grp):
                    count = self._num_preemptions(alloc)
                    details = self.alloc_details[alloc.id]
                    distance = score_for_task_group(
                        resources_needed,
                        details["resources"],
                        details["max_parallel"],
                        count,
                    )
                    if distance < best_distance:
                        best_distance = distance
                        closest_index = index
                closest = grp[closest_index]
                closest_resources = self.alloc_details[closest.id]["resources"]
                available.add(closest_resources)
                all_requirements_met, _ = available.superset(resources_asked)
                best_allocs.append(closest)
                grp[closest_index] = grp[-1]
                grp.pop()
                resources_needed.subtract(closest_resources)
            if all_requirements_met:
                break

        if not all_requirements_met:
            return []

        resources_needed = resource_ask.comparable()
        return self._filter_superset_base(
            best_allocs, self.node_remaining_resources, resources_needed
        )

    # ------------------------------------------------------------------
    def preempt_for_network(
        self, ask: NetworkResource, net_idx: NetworkIndex
    ) -> Optional[list[Allocation]]:
        """ref preemption.go:270-454. Returns None when preemption can't
        satisfy the ask (so the caller can skip this node)."""
        if not self.current_allocs:
            return None

        mbits_needed = ask.mbits
        reserved_ports_needed = ask.reserved_ports

        filtered_reserved_ports: dict[str, set[int]] = {}
        device_to_allocs: dict[str, list[Allocation]] = {}

        for alloc in self.current_allocs:
            if alloc.job is None:
                continue
            networks = self.alloc_details[alloc.id]["resources"].flattened.networks
            if not networks:
                continue
            net = networks[0]
            if self.job_priority - alloc.job.priority < 10:
                for port in net.reserved_ports:
                    filtered_reserved_ports.setdefault(net.device, set()).add(
                        port.value
                    )
                continue
            device_to_allocs.setdefault(net.device, []).append(alloc)

        if not device_to_allocs:
            return None

        allocs_to_preempt: list[Allocation] = []
        met = False
        free_bandwidth = 0
        preempted_device = ""

        for device, current_allocs in device_to_allocs.items():
            preempted_device = device
            total_bandwidth = net_idx.avail_bandwidth.get(device, 0)
            if total_bandwidth < mbits_needed:
                continue
            free_bandwidth = total_bandwidth - net_idx.used_bandwidth.get(device, 0)
            preempted_bandwidth = 0
            allocs_to_preempt = []
            skip_device = False

            if reserved_ports_needed:
                used_port_to_alloc: dict[int, Allocation] = {}
                for alloc in current_allocs:
                    for n in self.alloc_details[alloc.id][
                        "resources"
                    ].flattened.networks:
                        for p in n.reserved_ports:
                            used_port_to_alloc[p.value] = alloc
                for port in reserved_ports_needed:
                    alloc = used_port_to_alloc.get(port.value)
                    if alloc is not None:
                        preempted_bandwidth += self.alloc_details[alloc.id][
                            "resources"
                        ].flattened.networks[0].mbits
                        allocs_to_preempt.append(alloc)
                    elif port.value in filtered_reserved_ports.get(device, set()):
                        skip_device = True
                        break
                if skip_device:
                    continue
                preempt_ids = {a.id for a in allocs_to_preempt}
                current_allocs = [
                    a for a in current_allocs if a.id not in preempt_ids
                ]

            if preempted_bandwidth + free_bandwidth >= mbits_needed:
                met = True
                break

            allocs_by_priority = filter_and_group_preemptible_allocs(
                self.job_priority, current_allocs
            )
            for _, grp_allocs in allocs_by_priority:
                allocs = sorted(
                    grp_allocs, key=lambda a: self._network_distance_key(a, ask)
                )
                for alloc in allocs:
                    preempted_bandwidth += self.alloc_details[alloc.id][
                        "resources"
                    ].flattened.networks[0].mbits
                    allocs_to_preempt.append(alloc)
                    if preempted_bandwidth + free_bandwidth >= mbits_needed:
                        met = True
                        break
                if met:
                    break
            if met:
                break

        if not met:
            return None

        node_remaining = ComparableResources(
            flattened=AllocatedTaskResources(
                networks=[
                    NetworkResource(device=preempted_device, mbits=free_bandwidth)
                ]
            )
        )
        resources_needed = ComparableResources(
            flattened=AllocatedTaskResources(networks=[ask])
        )
        return self._filter_superset_network(
            allocs_to_preempt, node_remaining, resources_needed
        )

    def _network_distance_key(self, alloc: Allocation, ask: NetworkResource) -> float:
        """ref preemption.go:738-776"""
        count = self._num_preemptions(alloc)
        max_parallel = 0
        if alloc.job is not None:
            tg = alloc.job.lookup_task_group(alloc.task_group)
            if tg is not None and tg.migrate is not None:
                max_parallel = tg.migrate.max_parallel
        networks = self.alloc_details[alloc.id]["resources"].flattened.networks
        used = networks[0] if networks else None
        return score_for_network(used, ask, max_parallel, count)

    # ------------------------------------------------------------------
    def preempt_for_device(
        self, ask: RequestedDevice, dev_alloc
    ) -> Optional[list[Allocation]]:
        """ref preemption.go:472-555"""
        from .feasible import node_device_matches

        device_to_allocs: dict = {}
        for alloc in self.current_allocs:
            if alloc.allocated_resources is None:
                continue
            for tr in alloc.allocated_resources.tasks.values():
                for device in tr.devices:
                    device_id = device.device_id()
                    dev_inst = dev_alloc.devices.get(device_id)
                    if dev_inst is None:
                        continue
                    if not node_device_matches(self.ctx, dev_inst.device, ask):
                        continue
                    grp = device_to_allocs.setdefault(
                        device_id, {"allocs": [], "device_instances": {}}
                    )
                    grp["allocs"].append(alloc)
                    grp["device_instances"][alloc.id] = grp["device_instances"].get(
                        alloc.id, 0
                    ) + len(device.device_ids)

        needed_count = ask.count
        preemption_options = []

        for device_id, grp in device_to_allocs.items():
            allocs_by_priority = filter_and_group_preemptible_allocs(
                self.job_priority, grp["allocs"]
            )
            preempted_count = 0
            preempted_allocs: list[Allocation] = []
            satisfied = False
            for _, grp_allocs in allocs_by_priority:
                for alloc in grp_allocs:
                    dev_inst = dev_alloc.devices[device_id]
                    preempted_count += grp["device_instances"][alloc.id]
                    preempted_allocs.append(alloc)
                    if preempted_count + dev_inst.free_count() >= needed_count:
                        preemption_options.append(
                            {
                                "allocs": preempted_allocs,
                                "device_instances": grp["device_instances"],
                            }
                        )
                        satisfied = True
                        break
                if satisfied:
                    break

        if preemption_options:
            return _select_best_allocs(preemption_options, needed_count)
        return None

    # ------------------------------------------------------------------
    def _filter_superset_base(
        self,
        best_allocs: list[Allocation],
        node_remaining: ComparableResources,
        resource_ask: ComparableResources,
    ) -> list[Allocation]:
        """ref preemption.go:702-733 with base-resource distance."""
        best_allocs = sorted(
            best_allocs,
            key=lambda a: basic_resource_distance(
                resource_ask, self.alloc_details[a.id]["resources"]
            ),
            reverse=True,
        )
        available = node_remaining.copy()
        filtered: list[Allocation] = []
        for alloc in best_allocs:
            filtered.append(alloc)
            available.add(self.alloc_details[alloc.id]["resources"])
            met, _ = available.superset(resource_ask)
            if met:
                break
        return filtered

    def _filter_superset_network(
        self,
        best_allocs: list[Allocation],
        node_remaining: ComparableResources,
        resource_ask: ComparableResources,
    ) -> list[Allocation]:
        """ref preemption.go:702-733 with network distance."""
        needed = resource_ask.flattened.networks[0]

        def distance(a: Allocation) -> float:
            networks = self.alloc_details[a.id]["resources"].flattened.networks
            used = networks[0] if networks else None
            return network_resource_distance(used, needed)

        best_allocs = sorted(best_allocs, key=distance, reverse=True)
        available_mbits = node_remaining.flattened.networks[0].mbits
        filtered: list[Allocation] = []
        for alloc in best_allocs:
            filtered.append(alloc)
            networks = self.alloc_details[alloc.id]["resources"].flattened.networks
            if networks:
                available_mbits += networks[0].mbits
            if available_mbits != 0 and needed.mbits != 0 and available_mbits >= needed.mbits:
                break
        return filtered


def _select_best_allocs(preemption_options: list[dict], needed_count: int):
    """Choose the option with the lowest net (unique-priority-sum) priority
    (ref preemption.go:559-604)."""
    best_priority = math.inf
    best_allocs: list[Allocation] = []
    for grp in preemption_options:
        dev_inst = grp["device_instances"]
        allocs = sorted(grp["allocs"], key=lambda a: dev_inst[a.id], reverse=True)
        priorities: set[int] = set()
        net_priority = 0
        filtered: list[Allocation] = []
        preempted_instance_count = 0
        for alloc in allocs:
            if preempted_instance_count >= needed_count:
                break
            preempted_instance_count += dev_inst[alloc.id]
            filtered.append(alloc)
            if alloc.job.priority not in priorities:
                priorities.add(alloc.job.priority)
                net_priority += alloc.job.priority
        if net_priority < best_priority:
            best_priority = net_priority
            best_allocs = filtered
    return best_allocs
