"""Device allocator: affinity-weighted device instance assignment
(ref scheduler/device.go)."""

from __future__ import annotations

from typing import Optional

from ..structs.devices import DeviceAccounter
from ..structs.model import AllocatedDeviceResource, Node, RequestedDevice
from .context import EvalContext


class DeviceAllocator(DeviceAccounter):
    """DeviceAccounter + scoring assignment (ref device.go:13-131)."""

    def __init__(self, ctx: EvalContext, node: Node):
        super().__init__(node)
        self.ctx = ctx

    def assign_device(
        self, ask: RequestedDevice
    ) -> tuple[Optional[AllocatedDeviceResource], float, str]:
        """Pick the best-scoring feasible device group; returns
        (offer, sum-of-matched-affinity-weights, error)."""
        from .feasible import check_attribute_affinity, node_device_matches, resolve_device_target

        if not self.devices:
            return None, 0.0, "no devices available"
        if ask.count == 0:
            return None, 0.0, "invalid request of zero devices"

        offer: Optional[AllocatedDeviceResource] = None
        offer_score = 0.0
        matched_weights = 0.0

        for dev_id, dev_inst in self.devices.items():
            assignable = sum(1 for v in dev_inst.instances.values() if v == 0)
            if assignable < ask.count:
                continue
            if not node_device_matches(self.ctx, dev_inst.device, ask):
                continue

            choice_score = 0.0
            sum_matched = 0.0
            if ask.affinities:
                total_weight = 0.0
                for a in ask.affinities:
                    l_val, l_ok = resolve_device_target(a.l_target, dev_inst.device)
                    r_val, r_ok = resolve_device_target(a.r_target, dev_inst.device)
                    total_weight += abs(float(a.weight))
                    if not check_attribute_affinity(
                        self.ctx, a.operand, l_val, r_val, l_ok, r_ok
                    ):
                        continue
                    choice_score += float(a.weight)
                    sum_matched += float(a.weight)
                # Go float semantics: /0 yields NaN and scheduling continues
                choice_score = (
                    choice_score / total_weight if total_weight else float("nan")
                )

            if offer is not None and choice_score < offer_score:
                continue

            offer_score = choice_score
            matched_weights = sum_matched
            device_ids = []
            for instance_id, v in dev_inst.instances.items():
                if v == 0:
                    device_ids.append(instance_id)
                    if len(device_ids) == ask.count:
                        break
            offer = AllocatedDeviceResource(
                vendor=dev_id.vendor,
                type=dev_id.type,
                name=dev_id.name,
                device_ids=device_ids,
            )

        if offer is None:
            return None, 0.0, "no devices match request"
        return offer, matched_weights, ""
