"""Per-node network/port accounting: the NetworkIndex.

Semantics mirror the reference (nomad/structs/network.go:35-417): available
networks/bandwidth per device, used ports tracked per-IP in a 65536-bit
bitmap, reserved-port collision detection, and AssignNetwork picking an IP +
dynamic ports — stochastic probing first (20 tries), falling back to a precise
bitmap scan. Randomness is injected via an explicit ``random.Random`` so the
scheduler can run deterministically (seeded) for oracle-parity testing.
"""

from __future__ import annotations

import ipaddress
import random
from typing import Callable, Optional

from .bitmap import Bitmap
from .model import (
    MAX_DYNAMIC_PORT,
    MAX_VALID_PORT,
    MIN_DYNAMIC_PORT,
    Allocation,
    NetworkResource,
    Node,
)

MAX_RAND_PORT_ATTEMPTS = 20


def parse_port_ranges(spec: str) -> list[int]:
    """Parse '80,100-200,205' into a sorted port list (ref structs.go
    ParsePortRanges)."""
    ports: set[int] = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo_s, hi_s = part.split("-", 1)
            lo, hi = int(lo_s), int(hi_s)
            if lo > hi:
                raise ValueError(f"invalid port range {part}")
            ports.update(range(lo, hi + 1))
        else:
            ports.add(int(part))
    return sorted(ports)


class NetworkIndex:
    """Index of available and used network resources on one node."""

    def __init__(self, rng: Optional[random.Random] = None):
        self.avail_networks: list[NetworkResource] = []
        self.avail_bandwidth: dict[str, int] = {}
        self.used_ports: dict[str, Bitmap] = {}
        self.used_bandwidth: dict[str, int] = {}
        # lazy: seeding a fresh Mersenne state costs ~ms-scale urandom
        # reads, and the plan-verify hot path builds a NetworkIndex per
        # touched node without ever assigning a port
        self._rng = rng

    @property
    def rng(self) -> random.Random:
        if self._rng is None:
            self._rng = random.Random()
        return self._rng

    def release(self):
        """No-op (the Go version pools bitmaps; numpy makes this unnecessary)."""

    def overcommitted(self) -> bool:
        return any(
            used > self.avail_bandwidth.get(device, 0)
            for device, used in self.used_bandwidth.items()
        )

    def set_node(self, node: Node) -> bool:
        """Record the node's available networks + reserved host ports.
        Returns True on a reserved-port collision (ref network.go:72-104)."""
        collide = False
        if node.node_resources is not None:
            for n in node.node_resources.networks:
                if n.device:
                    self.avail_networks.append(n)
                    self.avail_bandwidth[n.device] = n.mbits
        if (
            node.reserved_resources is not None
            and node.reserved_resources.networks.reserved_host_ports
        ):
            collide = self.add_reserved_port_range(
                node.reserved_resources.networks.reserved_host_ports
            )
        return collide

    def add_allocs(self, allocs: list[Allocation]) -> bool:
        """Record ports used by non-terminal allocs; True on collision
        (ref network.go:108-148)."""
        collide = False
        for alloc in allocs:
            if alloc.terminal_status():
                continue
            if alloc.allocated_resources is None:
                continue
            for network in alloc.allocated_resources.shared.networks:
                if self.add_reserved(network):
                    collide = True
            for task in alloc.allocated_resources.tasks.values():
                if not task.networks:
                    continue
                if self.add_reserved(task.networks[0]):
                    collide = True
        return collide

    def add_reserved(self, n: NetworkResource) -> bool:
        """Mark a network resource's ports/bandwidth used; True on collision
        (ref network.go:152-184)."""
        collide = False
        used = self.used_ports.get(n.ip)
        if used is None:
            used = Bitmap(MAX_VALID_PORT)
            self.used_ports[n.ip] = used
        for ports in (n.reserved_ports, n.dynamic_ports):
            for port in ports:
                if port.value < 0 or port.value >= MAX_VALID_PORT:
                    return True
                if used.check(port.value):
                    collide = True
                else:
                    used.set(port.value)
        self.used_bandwidth[n.device] = self.used_bandwidth.get(n.device, 0) + n.mbits
        return collide

    def add_reserved_port_range(self, ports: str) -> bool:
        """Reserve a comma/range port spec on every known IP
        (ref network.go:189-227)."""
        try:
            res_ports = parse_port_ranges(ports)
        except ValueError:
            return False
        collide = False
        for n in self.avail_networks:
            if n.ip not in self.used_ports:
                self.used_ports[n.ip] = Bitmap(MAX_VALID_PORT)
        for used in self.used_ports.values():
            for port in res_ports:
                if port < 0 or port >= MAX_VALID_PORT:
                    return True
                if used.check(port):
                    collide = True
                else:
                    used.set(port)
        return collide

    def _yield_ips(self, cb: Callable[[NetworkResource, str], bool]):
        """Invoke cb for each IP in each available CIDR until it returns True
        (ref network.go:231-252)."""
        for n in self.avail_networks:
            try:
                net = ipaddress.ip_network(n.cidr, strict=False)
            except ValueError:
                continue
            for ip in net:
                if cb(n, str(ip)):
                    return

    def assign_network(
        self, ask: NetworkResource
    ) -> tuple[Optional[NetworkResource], str]:
        """Assign an IP + ports for the ask; (offer, "") on success or
        (None, reason) (ref network.go:256-330)."""
        err = "no networks available"
        out: Optional[NetworkResource] = None

        def attempt(n: NetworkResource, ip_str: str) -> bool:
            nonlocal err, out
            avail_bw = self.avail_bandwidth.get(n.device, 0)
            used_bw = self.used_bandwidth.get(n.device, 0)
            if used_bw + ask.mbits > avail_bw:
                err = "bandwidth exceeded"
                return False
            used = self.used_ports.get(ip_str)
            for port in ask.reserved_ports:
                if port.value < 0 or port.value >= MAX_VALID_PORT:
                    err = f"invalid port {port.value} (out of range)"
                    return False
                if used is not None and used.check(port.value):
                    err = "reserved port collision"
                    return False

            offer = NetworkResource(
                mode=ask.mode,
                device=n.device,
                ip=ip_str,
                mbits=ask.mbits,
                reserved_ports=[p.copy() for p in ask.reserved_ports],
                dynamic_ports=[p.copy() for p in ask.dynamic_ports],
            )

            dyn_ports = self._dynamic_ports_stochastic(used, ask)
            if dyn_ports is None:
                dyn_ports, perr = self._dynamic_ports_precise(used, ask)
                if dyn_ports is None:
                    err = perr
                    return False

            for i, port in enumerate(dyn_ports):
                offer.dynamic_ports[i].value = port
                if offer.dynamic_ports[i].to == -1:
                    offer.dynamic_ports[i].to = port

            out = offer
            err = ""
            return True

        self._yield_ips(attempt)
        return out, err

    def _dynamic_ports_precise(
        self, node_used: Optional[Bitmap], ask: NetworkResource
    ) -> tuple[Optional[list[int]], str]:
        """Precise dynamic-port pick via bitmap scan (ref network.go:336-372)."""
        used_set = node_used.copy() if node_used is not None else Bitmap(MAX_VALID_PORT)
        for port in ask.reserved_ports:
            used_set.set(port.value)
        available = used_set.indexes_in_range(False, MIN_DYNAMIC_PORT, MAX_DYNAMIC_PORT)
        num_dyn = len(ask.dynamic_ports)
        if len(available) < num_dyn:
            return None, "dynamic port selection failed"
        num_available = len(available)
        for i in range(num_dyn):
            j = self.rng.randrange(num_available)
            available[i], available[j] = available[j], available[i]
        return available[:num_dyn], ""

    def _dynamic_ports_stochastic(
        self, node_used: Optional[Bitmap], ask: NetworkResource
    ) -> Optional[list[int]]:
        """Stochastic dynamic-port pick, bounded probes (ref network.go:379-407)."""
        reserved = [p.value for p in ask.reserved_ports]
        dynamic: list[int] = []
        for _ in range(len(ask.dynamic_ports)):
            attempts = 0
            while True:
                attempts += 1
                if attempts > MAX_RAND_PORT_ATTEMPTS:
                    return None
                rand_port = MIN_DYNAMIC_PORT + self.rng.randrange(
                    MAX_DYNAMIC_PORT - MIN_DYNAMIC_PORT
                )
                if node_used is not None and node_used.check(rand_port):
                    continue
                if rand_port in reserved or rand_port in dynamic:
                    continue
                dynamic.append(rand_port)
                break
        return dynamic
