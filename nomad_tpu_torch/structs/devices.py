"""Device instance accounting (ref nomad/structs/devices.go)."""

from __future__ import annotations

from .model import (
    AllocatedDeviceResource,
    Allocation,
    DeviceIdTuple,
    Node,
    NodeDeviceResource,
)


class DeviceAccounterInstance:
    """One device group plus per-instance usage counts (0 == free)."""

    def __init__(self, device: NodeDeviceResource):
        self.device = device
        self.instances: dict[str, int] = {
            inst.id: 0 for inst in device.instances if inst.healthy
        }

    def free_count(self) -> int:
        return sum(1 for c in self.instances.values() if c == 0)


class DeviceAccounter:
    """Tracks device usage on a node; detects oversubscription
    (ref devices.go:6-143)."""

    def __init__(self, node: Node):
        self.devices: dict[DeviceIdTuple, DeviceAccounterInstance] = {}
        if node.node_resources is not None:
            for dev in node.node_resources.devices:
                self.devices[dev.device_id()] = DeviceAccounterInstance(dev)

    def add_allocs(self, allocs: list[Allocation]) -> bool:
        """Mark devices used by non-terminal allocs; True on collision."""
        collision = False
        for a in allocs:
            if a.terminal_status() or a.allocated_resources is None:
                continue
            for tr in a.allocated_resources.tasks.values():
                for device in tr.devices:
                    dev_id = device.device_id()
                    inst = self.devices.get(dev_id)
                    if inst is None:
                        continue
                    for instance_id in device.device_ids:
                        if instance_id in inst.instances:
                            if inst.instances[instance_id] != 0:
                                collision = True
                            inst.instances[instance_id] += 1
        return collision

    def add_reserved(self, res: AllocatedDeviceResource) -> bool:
        """Mark reserved instances used; True on collision."""
        inst = self.devices.get(res.device_id())
        if inst is None:
            return False
        collision = False
        for instance_id in res.device_ids:
            if instance_id not in inst.instances:
                continue
            if inst.instances[instance_id] != 0:
                collision = True
            inst.instances[instance_id] += 1
        return collision
