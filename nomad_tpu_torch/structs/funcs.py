"""Resource fit check + bin-pack scoring — the scalar kernel the TPU batch
scheduler vectorizes (ref nomad/structs/funcs.go:102-191)."""

from __future__ import annotations

import math
from typing import Optional

from .devices import DeviceAccounter
from .model import Allocation, ComparableResources, Node
from .network import NetworkIndex


def allocs_fit(
    node: Node,
    allocs: list[Allocation],
    net_idx: Optional[NetworkIndex] = None,
    check_devices: bool = False,
) -> tuple[bool, str, ComparableResources]:
    """Check whether a set of allocations fits on a node.

    Returns (fit, failing-dimension, total-utilization). Mirrors
    funcs.go:102-149: sums node-reserved + non-terminal alloc resources,
    checks cpu/memory/disk superset, then port collisions / bandwidth via the
    NetworkIndex, then optional device oversubscription.
    """
    resources, reserved = node.comparable_cached()
    used = ComparableResources()
    used.add(reserved)
    for alloc in allocs:
        if alloc.terminal_status() or alloc.allocated_resources is None:
            continue
        used.add(alloc.comparable_cached())

    superset, dimension = resources.superset(used)
    if not superset:
        return False, dimension, used

    if net_idx is None:
        net_idx = NetworkIndex()
        if net_idx.set_node(node) or net_idx.add_allocs(allocs):
            return False, "reserved port collision", used

    if net_idx.overcommitted():
        return False, "bandwidth exceeded", used

    if check_devices:
        accounter = DeviceAccounter(node)
        if accounter.add_allocs(allocs):
            return False, "device oversubscribed", used

    return True, "", used


def score_fit(node: Node, util: ComparableResources) -> float:
    """Bin-packing score: 20 - (10^freeCpuPct + 10^freeMemPct), clamped to
    [0, 18] — BestFit v3 from the Google datacenter-scheduling slides
    (ref funcs.go:154-188)."""
    res, reserved = node.comparable_cached()

    node_cpu = float(res.flattened.cpu.cpu_shares)
    node_mem = float(res.flattened.memory.memory_mb)
    if reserved is not None:
        node_cpu -= float(reserved.flattened.cpu.cpu_shares)
        node_mem -= float(reserved.flattened.memory.memory_mb)

    # A node whose usable cpu/mem is zero scores 0 (the reference's float
    # division yields Inf and the clamp below floors it; avoid the Python
    # ZeroDivisionError).
    if node_cpu <= 0 or node_mem <= 0:
        return 0.0

    free_pct_cpu = 1 - (float(util.flattened.cpu.cpu_shares) / node_cpu)
    free_pct_ram = 1 - (float(util.flattened.memory.memory_mb) / node_mem)

    total = math.pow(10, free_pct_cpu) + math.pow(10, free_pct_ram)
    score = 20.0 - total

    if score > 18.0:
        score = 18.0
    elif score < 0:
        score = 0.0
    return score
