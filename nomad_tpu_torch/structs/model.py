"""Core data model: Job / TaskGroup / Task / Node / Allocation / Evaluation / Plan.

Semantics follow the reference data model (nomad/structs/structs.go: Job :3257,
TaskGroup :4658, Task :5231, Node :1480, Allocation :7417, Evaluation :8303,
Plan :8596, PlanResult :8770, Deployment :7080) but the representation is new:
plain Python dataclasses carrying only the modern (0.9+) resource schema —
the reference's COMPAT upgrade paths for pre-0.9 resources are deliberately
dropped. Every object serializes to/from plain dicts (``to_dict``/``from_dict``)
so the HTTP API, the durable log, and the TPU columnar mirror all share one
canonical encoding.
"""

from __future__ import annotations

import functools
import os
import time
import typing
import uuid
from dataclasses import dataclass, field, fields, is_dataclass, replace
from typing import Any, Optional

from .attribute import Attribute

# ---------------------------------------------------------------------------
# Enumerations (ref structs.go:3217-3251, :8247-8268, :7403-7413)
# ---------------------------------------------------------------------------

JOB_TYPE_CORE = "_core"
JOB_TYPE_SERVICE = "service"
JOB_TYPE_BATCH = "batch"
JOB_TYPE_SYSTEM = "system"

JOB_STATUS_PENDING = "pending"
JOB_STATUS_RUNNING = "running"
JOB_STATUS_DEAD = "dead"

JOB_MIN_PRIORITY = 1
JOB_DEFAULT_PRIORITY = 50
JOB_MAX_PRIORITY = 100
CORE_JOB_PRIORITY = JOB_MAX_PRIORITY * 2

DEFAULT_NAMESPACE = "default"

EVAL_STATUS_BLOCKED = "blocked"
EVAL_STATUS_PENDING = "pending"
EVAL_STATUS_COMPLETE = "complete"
EVAL_STATUS_FAILED = "failed"
EVAL_STATUS_CANCELLED = "canceled"

EVAL_TRIGGER_JOB_REGISTER = "job-register"
EVAL_TRIGGER_JOB_DEREGISTER = "job-deregister"
EVAL_TRIGGER_PERIODIC_JOB = "periodic-job"
EVAL_TRIGGER_NODE_DRAIN = "node-drain"
EVAL_TRIGGER_NODE_UPDATE = "node-update"
EVAL_TRIGGER_SCHEDULED = "scheduled"
EVAL_TRIGGER_ROLLING_UPDATE = "rolling-update"
EVAL_TRIGGER_DEPLOYMENT_WATCHER = "deployment-watcher"
EVAL_TRIGGER_FAILED_FOLLOW_UP = "failed-follow-up"
EVAL_TRIGGER_MAX_PLANS = "max-plan-attempts"
EVAL_TRIGGER_RETRY_FAILED_ALLOC = "alloc-failure"
EVAL_TRIGGER_QUEUED_ALLOCS = "queued-allocs"
EVAL_TRIGGER_PREEMPTION = "preemption"
EVAL_TRIGGER_JOB_SCALING = "job-scaling"
EVAL_TRIGGER_ALLOC_STOP = "alloc-stop"

ALLOC_DESIRED_STATUS_RUN = "run"
ALLOC_DESIRED_STATUS_STOP = "stop"
ALLOC_DESIRED_STATUS_EVICT = "evict"

ALLOC_CLIENT_STATUS_PENDING = "pending"
ALLOC_CLIENT_STATUS_RUNNING = "running"
ALLOC_CLIENT_STATUS_COMPLETE = "complete"
ALLOC_CLIENT_STATUS_FAILED = "failed"
ALLOC_CLIENT_STATUS_LOST = "lost"

NODE_STATUS_INIT = "initializing"
NODE_STATUS_READY = "ready"
NODE_STATUS_DOWN = "down"

NODE_SCHED_ELIGIBLE = "eligible"
NODE_SCHED_INELIGIBLE = "ineligible"

DEPLOYMENT_STATUS_RUNNING = "running"
DEPLOYMENT_STATUS_PAUSED = "paused"
DEPLOYMENT_STATUS_FAILED = "failed"
DEPLOYMENT_STATUS_SUCCESSFUL = "successful"
DEPLOYMENT_STATUS_CANCELLED = "cancelled"

DEPLOYMENT_STATUS_DESC_RUNNING = "Deployment is running"
DEPLOYMENT_STATUS_DESC_RUNNING_NEEDS_PROMOTION = (
    "Deployment is running but requires promotion"
)
DEPLOYMENT_STATUS_DESC_PROMOTED = "Deployment completed successfully"
DEPLOYMENT_STATUS_DESC_NEW_ER_JOB = "Cancelled due to newer version of job"

# Constraint operands (ref structs.go:6591-, feasible.go:533-564)
CONSTRAINT_DISTINCT_PROPERTY = "distinct_property"
CONSTRAINT_DISTINCT_HOSTS = "distinct_hosts"
CONSTRAINT_REGEX = "regexp"
CONSTRAINT_VERSION = "version"
CONSTRAINT_SET_CONTAINS = "set_contains"
CONSTRAINT_SET_CONTAINS_ALL = "set_contains_all"
CONSTRAINT_SET_CONTAINS_ANY = "set_contains_any"
CONSTRAINT_ATTRIBUTE_IS_SET = "is_set"
CONSTRAINT_ATTRIBUTE_IS_NOT_SET = "is_not_set"

VOLUME_TYPE_HOST = "host"

MIN_DYNAMIC_PORT = 20000
MAX_DYNAMIC_PORT = 32000
MAX_VALID_PORT = 65536


def generate_uuid() -> str:
    return str(uuid.uuid4())


def generate_uuids(n: int) -> list[str]:
    """Batched uuid4 generation: one urandom call + hex slicing instead of
    n ``uuid.UUID`` object round-trips (~10x faster at 50K-alloc plan scale,
    where per-alloc id minting is pure overhead on the hot path). The C
    tier (native/_fastobj.c) formats from the raw bytes directly when
    available."""
    from ..native import fastobj

    fo = fastobj()
    if fo is not None:
        return fo.uuid4_batch(n)
    raw = os.urandom(16 * n).hex()
    out = []
    for off in range(0, 32 * n, 32):
        s = raw[off : off + 32]
        # force the uuid4 version/variant nibbles like uuid.uuid4 does
        out.append(
            f"{s[:8]}-{s[8:12]}-4{s[13:16]}-{'89ab'[int(s[16], 16) & 3]}{s[17:20]}-{s[20:]}"
        )
    return out


def now_ns() -> int:
    return time.time_ns()


# ---------------------------------------------------------------------------
# dict (de)serialization shared by every model object
# ---------------------------------------------------------------------------

def _to_plain(v: Any) -> Any:
    if is_dataclass(v) and not isinstance(v, type):
        return {f.name: _to_plain(getattr(v, f.name)) for f in fields(v)}
    if isinstance(v, dict):
        return {k: _to_plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_plain(x) for x in v]
    return v


@functools.lru_cache(maxsize=None)
def _type_hints(cls: type) -> dict[str, Any]:
    return typing.get_type_hints(cls)


class Base:
    """Shared dict round-tripping for all model dataclasses."""

    def to_dict(self) -> dict:
        return _to_plain(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Base":
        kwargs = {}
        hints = _type_hints(cls)
        for f in fields(cls):
            if f.name not in d:
                continue
            kwargs[f.name] = _from_plain(hints.get(f.name), d[f.name])
        return cls(**kwargs)

    def copy(self):
        """Deep copy via dict round-trip (mirrors the reference's Copy methods)."""
        return type(self).from_dict(self.to_dict())


def _from_plain(hint: Any, v: Any) -> Any:
    if v is None:
        return None
    origin = typing.get_origin(hint)
    if origin is typing.Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if len(args) == 1:
            return _from_plain(args[0], v)
        return v
    if origin in (list, tuple):
        (sub,) = typing.get_args(hint) or (Any,)
        return [_from_plain(sub, x) for x in v]
    if origin is dict:
        args = typing.get_args(hint)
        sub = args[1] if len(args) == 2 else Any
        return {k: _from_plain(sub, x) for k, x in v.items()}
    if isinstance(hint, type) and is_dataclass(hint) and isinstance(v, dict):
        return hint.from_dict(v)
    return v


# ---------------------------------------------------------------------------
# Networks and ports (ref structs.go NetworkResource, Port)
# ---------------------------------------------------------------------------

@dataclass
class Port(Base):
    label: str = ""
    value: int = 0
    to: int = 0


@dataclass
class NetworkResource(Base):
    """A network ask or offer (ref structs.go NetworkResource)."""

    mode: str = ""
    device: str = ""
    cidr: str = ""
    ip: str = ""
    mbits: int = 0
    reserved_ports: list[Port] = field(default_factory=list)
    dynamic_ports: list[Port] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Devices (ref structs.go NodeDeviceResource / RequestedDevice, devices.go)
# ---------------------------------------------------------------------------

@dataclass
class NodeDevice(Base):
    id: str = ""
    healthy: bool = True
    health_description: str = ""


@dataclass
class NodeDeviceResource(Base):
    vendor: str = ""
    type: str = ""
    name: str = ""
    instances: list[NodeDevice] = field(default_factory=list)
    attributes: dict[str, Attribute] = field(default_factory=dict)

    def device_id(self) -> "DeviceIdTuple":
        return DeviceIdTuple(self.vendor, self.type, self.name)


@dataclass(frozen=True)
class DeviceIdTuple:
    vendor: str
    type: str
    name: str

    def matches(self, req: "DeviceIdTuple") -> bool:
        """Match a requested id against this device id (ref structs.go
        DeviceIdTuple.Matches): empty request fields are wildcards, matched
        from most-specific (name) outward."""
        if req.name != "" and self.name != req.name:
            return False
        if req.type != "" and self.type != req.type:
            return False
        if req.vendor != "" and self.vendor != req.vendor:
            return False
        return True


def parse_device_id(name: str) -> DeviceIdTuple:
    """Parse 'vendor/type/name', 'vendor/type', or 'type' request strings
    (ref structs.go RequestedDevice.ID)."""
    parts = name.split("/", 2)
    if len(parts) == 1:
        return DeviceIdTuple("", parts[0], "")
    if len(parts) == 2:
        return DeviceIdTuple(parts[0], parts[1], "")
    return DeviceIdTuple(parts[0], parts[1], parts[2])


@dataclass
class Constraint(Base):
    l_target: str = ""
    r_target: str = ""
    operand: str = ""

    def __str__(self) -> str:  # used in filter metrics
        return f"{self.l_target} {self.operand} {self.r_target}"


@dataclass
class Affinity(Base):
    l_target: str = ""
    r_target: str = ""
    operand: str = ""
    weight: int = 0


@dataclass
class SpreadTarget(Base):
    value: str = ""
    percent: int = 0


@dataclass
class Spread(Base):
    attribute: str = ""
    weight: int = 0
    spread_target: list[SpreadTarget] = field(default_factory=list)


@dataclass
class RequestedDevice(Base):
    """A device ask inside task resources (ref structs.go RequestedDevice :2214)."""

    name: str = ""
    count: int = 1
    constraints: list[Constraint] = field(default_factory=list)
    affinities: list[Affinity] = field(default_factory=list)

    def device_id(self) -> DeviceIdTuple:
        return parse_device_id(self.name)


# ---------------------------------------------------------------------------
# Resources (modern schema only; ref structs.go NodeResources :2322,
# AllocatedResources :2854, ComparableResources :3165)
# ---------------------------------------------------------------------------

@dataclass
class Resources(Base):
    """A task's resource ask (cpu MHz shares, memory MB, networks, devices)."""

    cpu: int = 100
    memory_mb: int = 300
    disk_mb: int = 0
    networks: list[NetworkResource] = field(default_factory=list)
    devices: list[RequestedDevice] = field(default_factory=list)


@dataclass
class NodeCpuResources(Base):
    cpu_shares: int = 0


@dataclass
class NodeMemoryResources(Base):
    memory_mb: int = 0


@dataclass
class NodeDiskResources(Base):
    disk_mb: int = 0


@dataclass
class NodeResources(Base):
    cpu: NodeCpuResources = field(default_factory=NodeCpuResources)
    memory: NodeMemoryResources = field(default_factory=NodeMemoryResources)
    disk: NodeDiskResources = field(default_factory=NodeDiskResources)
    networks: list[NetworkResource] = field(default_factory=list)
    devices: list[NodeDeviceResource] = field(default_factory=list)

    def comparable(self) -> "ComparableResources":
        return ComparableResources(
            flattened=AllocatedTaskResources(
                cpu=AllocatedCpuResources(cpu_shares=self.cpu.cpu_shares),
                memory=AllocatedMemoryResources(memory_mb=self.memory.memory_mb),
                networks=list(self.networks),
            ),
            shared=AllocatedSharedResources(disk_mb=self.disk.disk_mb),
        )


@dataclass
class NodeReservedNetworkResources(Base):
    reserved_host_ports: str = ""


@dataclass
class NodeReservedResources(Base):
    cpu: NodeCpuResources = field(default_factory=NodeCpuResources)
    memory: NodeMemoryResources = field(default_factory=NodeMemoryResources)
    disk: NodeDiskResources = field(default_factory=NodeDiskResources)
    networks: NodeReservedNetworkResources = field(
        default_factory=NodeReservedNetworkResources
    )

    def comparable(self) -> "ComparableResources":
        return ComparableResources(
            flattened=AllocatedTaskResources(
                cpu=AllocatedCpuResources(cpu_shares=self.cpu.cpu_shares),
                memory=AllocatedMemoryResources(memory_mb=self.memory.memory_mb),
            ),
            shared=AllocatedSharedResources(disk_mb=self.disk.disk_mb),
        )


@dataclass
class AllocatedCpuResources(Base):
    cpu_shares: int = 0

    def add(self, other: "AllocatedCpuResources"):
        self.cpu_shares += other.cpu_shares

    def subtract(self, other: "AllocatedCpuResources"):
        self.cpu_shares -= other.cpu_shares


@dataclass
class AllocatedMemoryResources(Base):
    memory_mb: int = 0

    def add(self, other: "AllocatedMemoryResources"):
        self.memory_mb += other.memory_mb

    def subtract(self, other: "AllocatedMemoryResources"):
        self.memory_mb -= other.memory_mb


@dataclass
class AllocatedDeviceResource(Base):
    vendor: str = ""
    type: str = ""
    name: str = ""
    device_ids: list[str] = field(default_factory=list)

    def device_id(self) -> DeviceIdTuple:
        return DeviceIdTuple(self.vendor, self.type, self.name)


@dataclass
class AllocatedTaskResources(Base):
    cpu: AllocatedCpuResources = field(default_factory=AllocatedCpuResources)
    memory: AllocatedMemoryResources = field(default_factory=AllocatedMemoryResources)
    networks: list[NetworkResource] = field(default_factory=list)
    devices: list[AllocatedDeviceResource] = field(default_factory=list)

    def add(self, other: "AllocatedTaskResources"):
        self.cpu.add(other.cpu)
        self.memory.add(other.memory)
        # merge networks by device (ref structs.go AllocatedTaskResources.Add
        # → NetIndex match + NetworkResource.Add): flattening a task net and
        # a group net on the same NIC yields ONE entry with summed mbits —
        # preemption reads networks[0] and undercounts if they stay split
        for n in other.networks:
            mine = next(
                (m for m in self.networks if m.device == n.device), None
            )
            if mine is None:
                self.networks.append(n.copy())
            else:
                mine.mbits += n.mbits
                mine.reserved_ports = mine.reserved_ports + n.reserved_ports
                mine.dynamic_ports = mine.dynamic_ports + n.dynamic_ports

    def subtract(self, other: "AllocatedTaskResources"):
        self.cpu.subtract(other.cpu)
        self.memory.subtract(other.memory)


@dataclass
class AllocatedSharedResources(Base):
    disk_mb: int = 0
    networks: list[NetworkResource] = field(default_factory=list)

    def add(self, other: "AllocatedSharedResources"):
        self.disk_mb += other.disk_mb
        self.networks.extend(other.networks)

    def subtract(self, other: "AllocatedSharedResources"):
        self.disk_mb -= other.disk_mb


@dataclass
class AllocatedResources(Base):
    """Resources actually granted to an allocation, per task + shared."""

    tasks: dict[str, AllocatedTaskResources] = field(default_factory=dict)
    shared: AllocatedSharedResources = field(default_factory=AllocatedSharedResources)

    def comparable(self) -> "ComparableResources":
        c = ComparableResources(shared=AllocatedSharedResources(disk_mb=self.shared.disk_mb))
        for t in self.tasks.values():
            c.flattened.add(t)
        # Add network resources that are at the task group level, merging
        # by device like the per-task nets (ref structs.go Comparable →
        # Flattened.Add)
        c.flattened.add(
            AllocatedTaskResources(networks=self.shared.networks)
        )
        return c


@dataclass
class ComparableResources(Base):
    """Flattened cpu/mem/disk view used for fit checks and scoring
    (ref structs.go :3165-3215)."""

    flattened: AllocatedTaskResources = field(default_factory=AllocatedTaskResources)
    shared: AllocatedSharedResources = field(default_factory=AllocatedSharedResources)

    def add(self, other: Optional["ComparableResources"]):
        if other is None:
            return
        self.flattened.add(other.flattened)
        self.shared.add(other.shared)

    def subtract(self, other: Optional["ComparableResources"]):
        if other is None:
            return
        self.flattened.subtract(other.flattened)
        self.shared.subtract(other.shared)

    def superset(self, other: "ComparableResources") -> tuple[bool, str]:
        """Superset check, ignoring networks (ref structs.go :3199-3210)."""
        if self.flattened.cpu.cpu_shares < other.flattened.cpu.cpu_shares:
            return False, "cpu"
        if self.flattened.memory.memory_mb < other.flattened.memory.memory_mb:
            return False, "memory"
        if self.shared.disk_mb < other.shared.disk_mb:
            return False, "disk"
        return True, ""


# ---------------------------------------------------------------------------
# Node (ref structs.go :1480)
# ---------------------------------------------------------------------------

@dataclass
class DriverInfo(Base):
    detected: bool = False
    healthy: bool = False
    health_description: str = ""


@dataclass
class ClientHostVolumeConfig(Base):
    name: str = ""
    path: str = ""
    read_only: bool = False


@dataclass
class DrainStrategy(Base):
    """ref structs.go DrainStrategy/DrainSpec: how long a drain may take
    before remaining allocs are force-migrated."""

    deadline: int = 0  # ns duration requested by the operator
    force_deadline: int = 0  # absolute ns wall-clock when the drain forces
    ignore_system_jobs: bool = False

    def deadline_passed(self) -> bool:
        return 0 < self.force_deadline < now_ns()


@dataclass
class Node(Base):
    id: str = ""
    name: str = ""
    datacenter: str = "dc1"
    node_class: str = ""
    attributes: dict[str, str] = field(default_factory=dict)
    meta: dict[str, str] = field(default_factory=dict)
    node_resources: Optional[NodeResources] = None
    reserved_resources: Optional[NodeReservedResources] = None
    links: dict[str, str] = field(default_factory=dict)
    drivers: dict[str, DriverInfo] = field(default_factory=dict)
    host_volumes: dict[str, ClientHostVolumeConfig] = field(default_factory=dict)
    status: str = NODE_STATUS_INIT
    status_description: str = ""
    scheduling_eligibility: str = NODE_SCHED_ELIGIBLE
    drain: bool = False
    drain_strategy: Optional[DrainStrategy] = None
    computed_class: str = ""
    http_addr: str = ""
    secret_id: str = ""
    events: list[dict] = field(default_factory=list)
    create_index: int = 0
    modify_index: int = 0
    status_updated_at: int = 0

    def ready(self) -> bool:
        return (
            self.status == NODE_STATUS_READY
            and not self.drain
            and self.scheduling_eligibility == NODE_SCHED_ELIGIBLE
        )

    def comparable_resources(self) -> ComparableResources:
        return self.node_resources.comparable()

    def comparable_reserved_resources(self) -> Optional[ComparableResources]:
        if self.reserved_resources is None:
            return None
        return self.reserved_resources.comparable()

    def comparable_cached(self) -> tuple:
        """(resources, reserved) as SHARED read-only ComparableResources —
        built once per node object. Callers must never mutate the result
        (use the uncached accessors for that, e.g. Preemptor.set_node which
        subtracts in place). Safe because published nodes are immutable and
        the dict-roundtrip copy() drops this cache; rebuilding
        ComparableResources per score was ~35% of the oracle's per-option
        cost at 10K nodes."""
        cr = self.__dict__.get("_cr")
        if cr is None:
            cr = self.__dict__["_cr"] = (
                self.comparable_resources(),
                self.comparable_reserved_resources(),
            )
        return cr

    def terminal_status(self) -> bool:
        return self.status == NODE_STATUS_DOWN


# ---------------------------------------------------------------------------
# Policies (ref structs.go UpdateStrategy :3908, ReschedulePolicy :4392, ...)
# ---------------------------------------------------------------------------

@dataclass
class UpdateStrategy(Base):
    stagger: int = 0  # nanoseconds
    max_parallel: int = 0
    health_check: str = "checks"
    min_healthy_time: int = 0
    healthy_deadline: int = 0
    progress_deadline: int = 0
    auto_revert: bool = False
    auto_promote: bool = False
    canary: int = 0

    def rolling(self) -> bool:
        return self.stagger > 0 and self.max_parallel > 0


@dataclass
class ReschedulePolicy(Base):
    attempts: int = 0
    interval: int = 0  # nanoseconds
    delay: int = 0  # nanoseconds
    delay_function: str = ""  # constant | exponential | fibonacci
    max_delay: int = 0
    unlimited: bool = False


@dataclass
class RestartPolicy(Base):
    attempts: int = 2
    interval: int = 0
    delay: int = 0
    mode: str = "fail"


@dataclass
class MigrateStrategy(Base):
    max_parallel: int = 1
    health_check: str = "checks"
    min_healthy_time: int = 0
    healthy_deadline: int = 0


@dataclass
class PeriodicConfig(Base):
    enabled: bool = False
    spec: str = ""
    spec_type: str = "cron"
    prohibit_overlap: bool = False
    time_zone: str = "UTC"


@dataclass
class ParameterizedJobConfig(Base):
    payload: str = ""
    meta_required: list[str] = field(default_factory=list)
    meta_optional: list[str] = field(default_factory=list)


@dataclass
class DispatchPayloadConfig(Base):
    file: str = ""


@dataclass
class EphemeralDisk(Base):
    sticky: bool = False
    size_mb: int = 150
    migrate: bool = False


@dataclass
class VolumeRequest(Base):
    name: str = ""
    type: str = VOLUME_TYPE_HOST
    source: str = ""
    read_only: bool = False


@dataclass
class VolumeMount(Base):
    volume: str = ""
    destination: str = ""
    read_only: bool = False


@dataclass
class LogConfig(Base):
    max_files: int = 10
    max_file_size_mb: int = 10


@dataclass
class CheckRestart(Base):
    """ref structs.go CheckRestart: restart the task after ``limit``
    consecutive failing results, once ``grace`` has passed since start."""

    limit: int = 0
    grace: int = 0  # ns


@dataclass
class ServiceCheck(Base):
    name: str = ""
    type: str = ""
    command: str = ""
    args: list[str] = field(default_factory=list)
    path: str = ""
    protocol: str = ""
    port_label: str = ""
    interval: int = 0
    timeout: int = 0
    check_restart: Optional[CheckRestart] = None


@dataclass
class ConsulUpstream(Base):
    """ref structs.go ConsulUpstream: a dependency reached through the
    local sidecar at local_bind_port."""

    destination_name: str = ""
    local_bind_port: int = 0


@dataclass
class ConsulProxy(Base):
    upstreams: list[ConsulUpstream] = field(default_factory=list)


@dataclass
class ConsulSidecarService(Base):
    port: str = ""
    proxy: Optional[ConsulProxy] = None


@dataclass
class ConsulConnect(Base):
    """ref structs.go ConsulConnect (Nomad 0.10's Connect integration):
    a service with a sidecar_service gets a mesh proxy in front of it, and
    its upstreams become local ports proxied to other services' sidecars."""

    sidecar_service: Optional[ConsulSidecarService] = None


@dataclass
class Service(Base):
    name: str = ""
    port_label: str = ""
    address_mode: str = "auto"
    tags: list[str] = field(default_factory=list)
    canary_tags: list[str] = field(default_factory=list)
    checks: list[ServiceCheck] = field(default_factory=list)
    connect: Optional[ConsulConnect] = None


@dataclass
class Template(Base):
    source_path: str = ""
    dest_path: str = ""
    embedded_tmpl: str = ""
    change_mode: str = "restart"
    change_signal: str = ""
    splay: int = 0
    perms: str = "0644"


@dataclass
class TaskArtifact(Base):
    getter_source: str = ""
    getter_options: dict[str, str] = field(default_factory=dict)
    getter_mode: str = "any"
    relative_dest: str = ""


@dataclass
class Vault(Base):
    policies: list[str] = field(default_factory=list)
    env: bool = True
    change_mode: str = "restart"
    change_signal: str = ""


# ---------------------------------------------------------------------------
# Task / TaskGroup / Job
# ---------------------------------------------------------------------------

@dataclass
class Task(Base):
    name: str = ""
    driver: str = ""
    user: str = ""
    config: dict[str, Any] = field(default_factory=dict)
    env: dict[str, str] = field(default_factory=dict)
    services: list[Service] = field(default_factory=list)
    vault: Optional[Vault] = None
    templates: list[Template] = field(default_factory=list)
    constraints: list[Constraint] = field(default_factory=list)
    affinities: list[Affinity] = field(default_factory=list)
    resources: Resources = field(default_factory=Resources)
    dispatch_payload: Optional[DispatchPayloadConfig] = None
    meta: dict[str, str] = field(default_factory=dict)
    kill_timeout: int = 5_000_000_000
    log_config: LogConfig = field(default_factory=LogConfig)
    artifacts: list[TaskArtifact] = field(default_factory=list)
    leader: bool = False
    shutdown_delay: int = 0
    volume_mounts: list[VolumeMount] = field(default_factory=list)
    kill_signal: str = ""


@dataclass
class TaskGroup(Base):
    name: str = ""
    count: int = 1
    update: Optional[UpdateStrategy] = None
    migrate: Optional[MigrateStrategy] = None
    constraints: list[Constraint] = field(default_factory=list)
    restart_policy: Optional[RestartPolicy] = None
    reschedule_policy: Optional[ReschedulePolicy] = None
    affinities: list[Affinity] = field(default_factory=list)
    spreads: list[Spread] = field(default_factory=list)
    networks: list[NetworkResource] = field(default_factory=list)
    tasks: list[Task] = field(default_factory=list)
    ephemeral_disk: EphemeralDisk = field(default_factory=EphemeralDisk)
    meta: dict[str, str] = field(default_factory=dict)
    volumes: dict[str, VolumeRequest] = field(default_factory=dict)

    def lookup_task(self, name: str) -> Optional[Task]:
        for t in self.tasks:
            if t.name == name:
                return t
        return None


@dataclass
class Job(Base):
    id: str = ""
    namespace: str = DEFAULT_NAMESPACE
    name: str = ""
    type: str = JOB_TYPE_SERVICE
    priority: int = JOB_DEFAULT_PRIORITY
    region: str = "global"
    datacenters: list[str] = field(default_factory=lambda: ["dc1"])
    all_at_once: bool = False
    constraints: list[Constraint] = field(default_factory=list)
    affinities: list[Affinity] = field(default_factory=list)
    spreads: list[Spread] = field(default_factory=list)
    task_groups: list[TaskGroup] = field(default_factory=list)
    update: Optional[UpdateStrategy] = None
    periodic: Optional[PeriodicConfig] = None
    parameterized_job: Optional[ParameterizedJobConfig] = None
    dispatched: bool = False
    payload: str = ""
    meta: dict[str, str] = field(default_factory=dict)
    vault_token: str = ""
    status: str = JOB_STATUS_PENDING
    status_description: str = ""
    stable: bool = False
    version: int = 0
    stop: bool = False
    parent_id: str = ""
    submit_time: int = 0
    create_index: int = 0
    modify_index: int = 0
    job_modify_index: int = 0

    def namespaced_id(self) -> tuple[str, str]:
        return (self.namespace, self.id)

    def lookup_task_group(self, name: str) -> Optional[TaskGroup]:
        for tg in self.task_groups:
            if tg.name == name:
                return tg
        return None

    def stopped(self) -> bool:
        return self.stop

    def is_periodic(self) -> bool:
        return self.periodic is not None and self.periodic.enabled

    def is_parameterized(self) -> bool:
        return self.parameterized_job is not None and not self.dispatched

    def has_update_strategy(self) -> bool:
        return self.update is not None and self.update.max_parallel > 0

    def specchanged(self, other: "Job") -> bool:
        """Determine if job specification (ignoring server-set bookkeeping
        fields) changed (ref structs.go Job.SpecChanged)."""
        a, b = self.to_dict(), other.to_dict()
        for k in (
            "status", "status_description", "stable", "version", "create_index",
            "modify_index", "job_modify_index", "submit_time",
        ):
            a.pop(k, None)
            b.pop(k, None)
        return a != b


# ---------------------------------------------------------------------------
# Allocation (ref structs.go :7417)
# ---------------------------------------------------------------------------

@dataclass
class RescheduleEvent(Base):
    reschedule_time: int = 0
    prev_alloc_id: str = ""
    prev_node_id: str = ""
    delay: int = 0


@dataclass
class RescheduleTracker(Base):
    events: list[RescheduleEvent] = field(default_factory=list)


@dataclass
class DesiredTransition(Base):
    migrate: Optional[bool] = None
    reschedule: Optional[bool] = None
    force_reschedule: Optional[bool] = None

    def should_migrate(self) -> bool:
        return bool(self.migrate)

    def should_force_reschedule(self) -> bool:
        return bool(self.force_reschedule)


@dataclass
class DeploymentStatus(Base):
    healthy: Optional[bool] = None
    timestamp: int = 0
    canary: bool = False
    modify_index: int = 0

    def is_healthy(self) -> bool:
        return self.healthy is True

    def is_unhealthy(self) -> bool:
        return self.healthy is False


@dataclass
class TaskState(Base):
    state: str = "pending"
    failed: bool = False
    restarts: int = 0
    last_restart: int = 0
    started_at: int = 0
    finished_at: int = 0
    events: list[dict] = field(default_factory=list)
    # service-check name → "passing"/"critical" (the client's check runner
    # publishes health through alloc updates the way the reference pushes
    # check state into Consul; the nomad-native catalog reads it from here)
    check_status: dict[str, str] = field(default_factory=dict)

    def successful(self) -> bool:
        return self.state == "dead" and not self.failed


@dataclass
class NodeScoreMeta(Base):
    node_id: str = ""
    scores: dict[str, float] = field(default_factory=dict)
    norm_score: float = 0.0


@dataclass
class AllocMetric(Base):
    """Scheduling metadata recorded per placement attempt
    (ref structs.go :7986-8040)."""

    nodes_evaluated: int = 0
    nodes_filtered: int = 0
    nodes_available: dict[str, int] = field(default_factory=dict)
    class_filtered: dict[str, int] = field(default_factory=dict)
    constraint_filtered: dict[str, int] = field(default_factory=dict)
    nodes_exhausted: int = 0
    class_exhausted: dict[str, int] = field(default_factory=dict)
    dimension_exhausted: dict[str, int] = field(default_factory=dict)
    quota_exhausted: list[str] = field(default_factory=list)
    scores: dict[str, float] = field(default_factory=dict)
    score_meta_data: list[NodeScoreMeta] = field(default_factory=list)
    allocation_time: float = 0.0
    coalesced_failures: int = 0
    # internal top-K accumulator (not serialized meaningfully)
    _topk: dict[str, dict[str, float]] = field(default_factory=dict)

    MAX_SCORE_META = 5

    def evaluate_node(self):
        self.nodes_evaluated += 1

    def filter_node(self, node: Optional[Node], constraint: str):
        self.nodes_filtered += 1
        if node is not None and node.node_class:
            self.class_filtered[node.node_class] = (
                self.class_filtered.get(node.node_class, 0) + 1
            )
        if constraint:
            self.constraint_filtered[constraint] = (
                self.constraint_filtered.get(constraint, 0) + 1
            )

    def exhausted_node(self, node: Optional[Node], dimension: str):
        self.nodes_exhausted += 1
        if node is not None and node.node_class:
            self.class_exhausted[node.node_class] = (
                self.class_exhausted.get(node.node_class, 0) + 1
            )
        if dimension:
            self.dimension_exhausted[dimension] = (
                self.dimension_exhausted.get(dimension, 0) + 1
            )

    def score_node(self, node: Node, name: str, score: float):
        self._topk.setdefault(node.id, {})[name] = score

    def pop_score_meta(self):
        """Materialize top-K score metadata from accumulated per-node scores,
        keyed by normalized score (ref lib/kheap + structs.go PopulateScoreMetaData)."""
        metas = [
            NodeScoreMeta(
                node_id=nid,
                scores={k: v for k, v in scores.items() if k != "normalized-score"},
                norm_score=scores.get("normalized-score", 0.0),
            )
            for nid, scores in self._topk.items()
        ]
        metas.sort(key=lambda m: m.norm_score, reverse=True)
        self.score_meta_data = metas[: self.MAX_SCORE_META]
        self._topk = {}


@dataclass
class Allocation(Base):
    id: str = ""
    namespace: str = DEFAULT_NAMESPACE
    eval_id: str = ""
    name: str = ""
    node_id: str = ""
    node_name: str = ""
    job_id: str = ""
    job: Optional[Job] = None
    task_group: str = ""
    allocated_resources: Optional[AllocatedResources] = None
    metrics: Optional[AllocMetric] = None
    desired_status: str = ALLOC_DESIRED_STATUS_RUN
    desired_description: str = ""
    desired_transition: DesiredTransition = field(default_factory=DesiredTransition)
    client_status: str = ALLOC_CLIENT_STATUS_PENDING
    client_description: str = ""
    task_states: dict[str, TaskState] = field(default_factory=dict)
    # service name → {"ip","port"}: the client's Connect sidecar listeners,
    # published through alloc updates so other allocs' upstream proxies can
    # discover them from the catalog (the role Consul's sidecar service
    # registrations play for the reference)
    connect_proxies: dict[str, dict] = field(default_factory=dict)
    deployment_id: str = ""
    deployment_status: Optional[DeploymentStatus] = None
    reschedule_tracker: Optional[RescheduleTracker] = None
    follow_up_eval_id: str = ""
    previous_allocation: str = ""
    next_allocation: str = ""
    preempted_allocations: list[str] = field(default_factory=list)
    preempted_by_allocation: str = ""
    create_index: int = 0
    modify_index: int = 0
    alloc_modify_index: int = 0
    create_time: int = 0
    modify_time: int = 0

    def server_terminal_status(self) -> bool:
        return self.desired_status in (
            ALLOC_DESIRED_STATUS_STOP,
            ALLOC_DESIRED_STATUS_EVICT,
        )

    def client_terminal_status(self) -> bool:
        return self.client_status in (
            ALLOC_CLIENT_STATUS_COMPLETE,
            ALLOC_CLIENT_STATUS_FAILED,
            ALLOC_CLIENT_STATUS_LOST,
        )

    def terminal_status(self) -> bool:
        """ref structs.go :7600-7624"""
        return self.server_terminal_status() or self.client_terminal_status()

    def comparable_resources(self) -> ComparableResources:
        return self.allocated_resources.comparable()

    def comparable_cached(self) -> ComparableResources:
        """SHARED read-only comparable view, built once per alloc object.
        Valid because allocated_resources is immutable after placement
        (mutation paths clone the alloc; fast_alloc_clone shares it, which
        keeps the cache correct). Callers must not mutate the result."""
        cr = self.__dict__.get("_cr")
        if cr is None:
            cr = self.__dict__["_cr"] = self.comparable_resources()
        return cr

    def ran_successfully(self) -> bool:
        return any(ts.successful() for ts in self.task_states.values()) and not any(
            ts.failed for ts in self.task_states.values()
        )

    def next_reschedule_time(self) -> tuple[int, bool]:
        """Next eligible reschedule time (ns) for a failed alloc under a
        delayed reschedule policy (ref structs.go:7703-7726)."""
        fail_time = self.last_event_time()
        policy = self.reschedule_policy()
        if (
            self.desired_status == ALLOC_DESIRED_STATUS_STOP
            or self.client_status != ALLOC_CLIENT_STATUS_FAILED
            or fail_time == 0
            or policy is None
        ):
            return 0, False
        next_delay = self.next_delay(policy)
        next_time = fail_time + next_delay
        eligible = policy.unlimited or (
            policy.attempts > 0 and self.reschedule_tracker is None
        )
        if (
            policy.attempts > 0
            and self.reschedule_tracker is not None
            and self.reschedule_tracker.events
        ):
            attempted = 0
            for ev in reversed(self.reschedule_tracker.events):
                if fail_time - ev.reschedule_time < policy.interval:
                    attempted += 1
            eligible = attempted < policy.attempts and next_delay < policy.interval
        return next_time, eligible

    def last_event_time(self) -> int:
        """Last task finished_at timestamp (ns)."""
        last = 0
        for ts in self.task_states.values():
            if ts.finished_at and ts.finished_at > last:
                last = ts.finished_at
        return last or self.modify_time

    def reschedule_policy(self) -> Optional[ReschedulePolicy]:
        if self.job is None:
            return None
        tg = self.job.lookup_task_group(self.task_group)
        return tg.reschedule_policy if tg else None

    def next_delay(self, policy: ReschedulePolicy) -> int:
        """Compute the next reschedule delay (constant/exponential/fibonacci,
        capped by max_delay; ref structs.go Allocation.NextDelay)."""
        delay_dur = policy.delay
        if policy.delay_function == "exponential":
            delay_dur = self._delay_exponential(policy)
        elif policy.delay_function == "fibonacci":
            delay_dur = self._delay_fibonacci(policy)
        if policy.max_delay and delay_dur > policy.max_delay:
            delay_dur = policy.max_delay
        return delay_dur

    def _num_prior_delays(self) -> int:
        if self.reschedule_tracker is None:
            return 0
        return len(self.reschedule_tracker.events)

    def _delay_exponential(self, policy: ReschedulePolicy) -> int:
        return policy.delay * (2 ** self._num_prior_delays())

    def _delay_fibonacci(self, policy: ReschedulePolicy) -> int:
        n = self._num_prior_delays()
        a, b = policy.delay, policy.delay
        for _ in range(n):
            a, b = b, a + b
        return a

    def should_reschedule(self, policy: Optional[ReschedulePolicy], fail_time_ns: int) -> bool:
        """ref structs.go :7628-7641"""
        if self.server_terminal_status():
            return False
        if self.client_status != ALLOC_CLIENT_STATUS_FAILED:
            return False
        return self.reschedule_eligible(policy, fail_time_ns)

    def reschedule_eligible(self, policy: Optional[ReschedulePolicy], fail_time_ns: int) -> bool:
        """ref structs.go :7645-"""
        if policy is None:
            return False
        if policy.unlimited:
            return True
        attempts, interval = policy.attempts, policy.interval
        if attempts == 0 and interval == 0:
            return False
        attempted = 0
        if self.reschedule_tracker is not None:
            for ev in reversed(self.reschedule_tracker.events):
                if fail_time_ns - ev.reschedule_time < interval:
                    attempted += 1
        return attempted < attempts


# ---------------------------------------------------------------------------
# Evaluation / Plan (ref structs.go :8303, :8596)
# ---------------------------------------------------------------------------

@dataclass
class Evaluation(Base):
    id: str = ""
    namespace: str = DEFAULT_NAMESPACE
    priority: int = JOB_DEFAULT_PRIORITY
    type: str = JOB_TYPE_SERVICE
    triggered_by: str = ""
    job_id: str = ""
    job_modify_index: int = 0
    node_id: str = ""
    node_modify_index: int = 0
    deployment_id: str = ""
    status: str = EVAL_STATUS_PENDING
    status_description: str = ""
    wait_until: int = 0  # unix ns
    next_eval: str = ""
    previous_eval: str = ""
    blocked_eval: str = ""
    failed_tg_allocs: dict[str, AllocMetric] = field(default_factory=dict)
    class_eligibility: dict[str, bool] = field(default_factory=dict)
    escaped_computed_class: bool = False
    quota_limit_reached: str = ""
    annotate_plan: bool = False
    queued_allocations: dict[str, int] = field(default_factory=dict)
    leader_ack_token: str = ""
    snapshot_index: int = 0
    #: wall-clock unix-ns deadline minted at the submitting edge
    #: (core/overload.py); 0 = none. The broker refuses to dequeue, the
    #: worker refuses to evaluate, and the applier refuses to commit an
    #: eval whose deadline passed — terminal ``deadline_exceeded``, never
    #: a silent drop. Server-initiated follow-up evals (rolling, blocked,
    #: failed-follow-up) deliberately do NOT inherit it: the client's
    #: deadline bounds the client's request, not the reconciliation work
    #: it eventually triggers.
    deadline: int = 0
    create_index: int = 0
    modify_index: int = 0
    create_time: int = 0
    modify_time: int = 0

    def terminal_status(self) -> bool:
        return self.status in (
            EVAL_STATUS_COMPLETE,
            EVAL_STATUS_FAILED,
            EVAL_STATUS_CANCELLED,
        )

    def should_enqueue(self) -> bool:
        return self.status == EVAL_STATUS_PENDING

    def should_block(self) -> bool:
        return self.status == EVAL_STATUS_BLOCKED

    def make_plan(self, job: Optional[Job]) -> "Plan":
        p = Plan(
            eval_id=self.id,
            priority=self.priority,
            job=job,
            deadline=self.deadline,
        )
        if job is not None:
            p.all_at_once = job.all_at_once
        return p

    def next_rolling_eval(self, wait_ns: int) -> "Evaluation":
        now = now_ns()
        return Evaluation(
            id=generate_uuid(),
            namespace=self.namespace,
            priority=self.priority,
            type=self.type,
            triggered_by=EVAL_TRIGGER_ROLLING_UPDATE,
            job_id=self.job_id,
            job_modify_index=self.job_modify_index,
            status=EVAL_STATUS_PENDING,
            wait_until=now + wait_ns,
            previous_eval=self.id,
            create_time=now,
            modify_time=now,
        )

    def create_blocked_eval(
        self,
        class_eligibility: dict[str, bool],
        escaped: bool,
        quota_reached: str,
    ) -> "Evaluation":
        now = now_ns()
        return Evaluation(
            id=generate_uuid(),
            namespace=self.namespace,
            priority=self.priority,
            type=self.type,
            triggered_by=EVAL_TRIGGER_QUEUED_ALLOCS,
            job_id=self.job_id,
            job_modify_index=self.job_modify_index,
            status=EVAL_STATUS_BLOCKED,
            previous_eval=self.id,
            class_eligibility=class_eligibility,
            escaped_computed_class=escaped,
            quota_limit_reached=quota_reached,
            create_time=now,
            modify_time=now,
        )

    def create_failed_follow_up_eval(self, wait_ns: int) -> "Evaluation":
        now = now_ns()
        return Evaluation(
            id=generate_uuid(),
            namespace=self.namespace,
            priority=self.priority,
            type=self.type,
            triggered_by=EVAL_TRIGGER_FAILED_FOLLOW_UP,
            job_id=self.job_id,
            job_modify_index=self.job_modify_index,
            status=EVAL_STATUS_PENDING,
            wait_until=now_ns() + wait_ns,
            previous_eval=self.id,
            create_time=now,
            modify_time=now,
        )


@dataclass
class TaskGroupSummary(Base):
    queued: int = 0
    complete: int = 0
    failed: int = 0
    running: int = 0
    starting: int = 0
    lost: int = 0


# ---------------------------------------------------------------------------
# ACL (ref structs.go ACLPolicy :8850 / ACLToken :8950, acl/)
# ---------------------------------------------------------------------------

ACL_TOKEN_TYPE_CLIENT = "client"
ACL_TOKEN_TYPE_MANAGEMENT = "management"


@dataclass
class AclPolicy(Base):
    name: str = ""
    description: str = ""
    rules: str = ""  # HCL rules document (acl/policy.go format)
    create_index: int = 0
    modify_index: int = 0


@dataclass
class AclToken(Base):
    accessor_id: str = ""  # public identifier
    secret_id: str = ""  # the bearer credential
    name: str = ""
    type: str = ACL_TOKEN_TYPE_CLIENT  # client | management
    policies: list[str] = field(default_factory=list)
    global_token: bool = False
    create_time: int = 0
    create_index: int = 0
    modify_index: int = 0


@dataclass
class JobSummary(Base):
    """Per-job rollup of alloc states by task group (ref structs.go JobSummary)."""

    job_id: str = ""
    namespace: str = DEFAULT_NAMESPACE
    summary: dict[str, TaskGroupSummary] = field(default_factory=dict)
    children_pending: int = 0
    children_running: int = 0
    children_dead: int = 0
    create_index: int = 0
    modify_index: int = 0


@dataclass
class DesiredUpdates(Base):
    ignore: int = 0
    place: int = 0
    migrate: int = 0
    stop: int = 0
    in_place_update: int = 0
    destructive_update: int = 0
    canary: int = 0
    preemptions: int = 0


@dataclass
class PlanAnnotations(Base):
    desired_tg_updates: dict[str, DesiredUpdates] = field(default_factory=dict)


@dataclass
class DeploymentTaskGroupState(Base):
    auto_revert: bool = False
    auto_promote: bool = False
    promoted: bool = False
    placed_canaries: list[str] = field(default_factory=list)
    desired_canaries: int = 0
    desired_total: int = 0
    placed_allocs: int = 0
    healthy_allocs: int = 0
    unhealthy_allocs: int = 0
    progress_deadline: int = 0
    require_progress_by: int = 0


@dataclass
class Deployment(Base):
    id: str = ""
    namespace: str = DEFAULT_NAMESPACE
    job_id: str = ""
    job_version: int = 0
    job_modify_index: int = 0
    job_spec_modify_index: int = 0
    job_create_index: int = 0
    task_groups: dict[str, DeploymentTaskGroupState] = field(default_factory=dict)
    status: str = DEPLOYMENT_STATUS_RUNNING
    status_description: str = DEPLOYMENT_STATUS_DESC_RUNNING
    create_index: int = 0
    modify_index: int = 0

    def active(self) -> bool:
        return self.status in (DEPLOYMENT_STATUS_RUNNING, DEPLOYMENT_STATUS_PAUSED)

    def requires_promotion(self) -> bool:
        return any(
            s.desired_canaries > 0 and not s.promoted for s in self.task_groups.values()
        )

    def has_auto_promote(self) -> bool:
        return bool(self.task_groups) and all(
            s.auto_promote for s in self.task_groups.values()
        )

    @classmethod
    def new_for_job(cls, job: Job) -> "Deployment":
        return cls(
            id=generate_uuid(),
            namespace=job.namespace,
            job_id=job.id,
            job_version=job.version,
            job_modify_index=job.modify_index,
            job_spec_modify_index=job.job_modify_index,
            job_create_index=job.create_index,
        )


@dataclass
class DeploymentStatusUpdate(Base):
    deployment_id: str = ""
    status: str = ""
    status_description: str = ""


@dataclass
class Plan(Base):
    """The scheduler's proposed state mutation (ref structs.go :8596)."""

    eval_id: str = ""
    eval_token: str = ""
    priority: int = JOB_DEFAULT_PRIORITY
    all_at_once: bool = False
    job: Optional[Job] = None
    node_update: dict[str, list[Allocation]] = field(default_factory=dict)
    node_allocation: dict[str, list[Allocation]] = field(default_factory=dict)
    annotations: Optional[PlanAnnotations] = None
    deployment: Optional[Deployment] = None
    deployment_updates: list[DeploymentStatusUpdate] = field(default_factory=list)
    node_preemptions: dict[str, list[Allocation]] = field(default_factory=dict)
    snapshot_index: int = 0
    #: the submitting eval's deadline (unix ns, 0 = none) — the plan
    #: applier refuses to verify/commit past it (core/overload.py)
    deadline: int = 0

    def append_stopped_alloc(self, alloc: Allocation, desc: str, client_status: str):
        """Mark an alloc for stopping in this plan (ref Plan.AppendStoppedAlloc)."""
        new_alloc = alloc.copy()
        new_alloc.job = None
        new_alloc.desired_status = ALLOC_DESIRED_STATUS_STOP
        new_alloc.desired_description = desc
        if client_status:
            new_alloc.client_status = client_status
        self.node_update.setdefault(alloc.node_id, []).append(new_alloc)

    def append_alloc(self, alloc: Allocation):
        self.node_allocation.setdefault(alloc.node_id, []).append(alloc)

    def append_preempted_alloc(self, alloc: Allocation, preempting_alloc_id: str):
        new_alloc = alloc.copy()
        new_alloc.job = None
        new_alloc.desired_status = ALLOC_DESIRED_STATUS_EVICT
        new_alloc.preempted_by_allocation = preempting_alloc_id
        new_alloc.desired_description = (
            f"Preempted by alloc ID {preempting_alloc_id}"
        )
        self.node_preemptions.setdefault(alloc.node_id, []).append(new_alloc)

    def pop_update(self, alloc: Allocation):
        """Remove the most recent stop for an alloc (used when an in-place
        update succeeds; ref Plan.PopUpdate)."""
        updates = self.node_update.get(alloc.node_id, [])
        if updates and updates[-1].id == alloc.id:
            updates.pop()
            if not updates:
                del self.node_update[alloc.node_id]

    def is_no_op(self) -> bool:
        return (
            not self.node_update
            and not self.node_allocation
            and self.deployment is None
            and not self.deployment_updates
        )


@dataclass
class PlanResult(Base):
    """The committed subset of a plan (ref structs.go :8770)."""

    node_update: dict[str, list[Allocation]] = field(default_factory=dict)
    node_allocation: dict[str, list[Allocation]] = field(default_factory=dict)
    deployment: Optional[Deployment] = None
    deployment_updates: list[DeploymentStatusUpdate] = field(default_factory=list)
    node_preemptions: dict[str, list[Allocation]] = field(default_factory=dict)
    refresh_index: int = 0
    alloc_index: int = 0

    def full_commit(self, plan: Plan) -> tuple[bool, int, int]:
        expected = sum(len(v) for v in plan.node_allocation.values())
        actual = sum(len(v) for v in self.node_allocation.values())
        return expected == actual, expected, actual

    def is_no_op(self) -> bool:
        return (
            not self.node_update
            and not self.node_allocation
            and not self.deployment_updates
            and self.deployment is None
        )


def fast_alloc_clone(a: Allocation) -> Allocation:
    """Shallow Allocation clone for hot paths (bulk plan commit/apply):
    the deep dict-roundtrip copy() costs ~250µs per alloc, which at
    10-50K allocs per plan dominates everything else. Top-level fields on
    the clone may be rebound freely; deployment_status is itself copied
    because upsert mutates its modify_index. All other nested objects
    stay SHARED — safe only under the store's published-objects-are-
    immutable contract (every later mutation path copies before writing).
    """
    c = Allocation.__new__(Allocation)
    c.__dict__ = dict(a.__dict__)
    if c.deployment_status is not None:
        c.deployment_status = replace(c.deployment_status)
    return c


def remove_allocs(allocs: list[Allocation], remove: list[Allocation]) -> list[Allocation]:
    """Filter out allocs whose IDs appear in remove (ref funcs.go:52-70)."""
    remove_ids = {a.id for a in remove}
    return [a for a in allocs if a.id not in remove_ids]


def filter_terminal_allocs(
    allocs: list[Allocation],
) -> tuple[list[Allocation], dict[str, Allocation]]:
    """Split out terminal allocs, keeping the latest terminal alloc per name
    (ref funcs.go:74-95)."""
    terminal: dict[str, Allocation] = {}
    live = []
    for a in allocs:
        if a.terminal_status():
            prev = terminal.get(a.name)
            if prev is None or prev.create_index < a.create_index:
                terminal[a.name] = a
        else:
            live.append(a)
    return live, terminal


def alloc_name(job_id: str, task_group: str, idx: int) -> str:
    return f"{job_id}.{task_group}[{idx}]"


def alloc_name_index(name: str) -> int:
    """Extract the bracketed index from an alloc name."""
    lo = name.rfind("[")
    hi = name.rfind("]")
    if lo == -1 or hi == -1 or hi < lo:
        return 0
    return int(name[lo + 1 : hi])
