"""Mock object factory for tests and benchmarks (ref nomad/mock/mock.go).

Fixture values (4000 CPU / 8192 MB nodes, 500/256 web tasks, etc.) match the
reference's mocks so oracle-parity tests exercise identical numbers.
"""

from __future__ import annotations

from .structs import compute_class
from .structs.attribute import Attribute
from .structs.model import (
    JOB_TYPE_BATCH,
    JOB_TYPE_SERVICE,
    JOB_TYPE_SYSTEM,
    NODE_STATUS_READY,
    AllocatedCpuResources,
    AllocatedMemoryResources,
    AllocatedResources,
    AllocatedSharedResources,
    AllocatedTaskResources,
    Allocation,
    Constraint,
    Deployment,
    DriverInfo,
    EphemeralDisk,
    Evaluation,
    Job,
    MigrateStrategy,
    NetworkResource,
    Node,
    NodeCpuResources,
    NodeDevice,
    NodeDeviceResource,
    NodeDiskResources,
    NodeMemoryResources,
    NodeReservedNetworkResources,
    NodeReservedResources,
    NodeResources,
    PeriodicConfig,
    Port,
    ReschedulePolicy,
    Resources,
    RestartPolicy,
    Task,
    TaskGroup,
    UpdateStrategy,
    generate_uuid,
    now_ns,
)

MINUTE_NS = 60 * 1_000_000_000
SECOND_NS = 1_000_000_000


def node() -> Node:
    n = Node(
        id=generate_uuid(),
        secret_id=generate_uuid(),
        datacenter="dc1",
        name="foobar",
        drivers={
            "exec": DriverInfo(detected=True, healthy=True),
            "mock_driver": DriverInfo(detected=True, healthy=True),
        },
        attributes={
            "kernel.name": "linux",
            "arch": "x86",
            "nomad.version": "0.5.0",
            "driver.exec": "1",
            "driver.mock_driver": "1",
        },
        node_resources=NodeResources(
            cpu=NodeCpuResources(cpu_shares=4000),
            memory=NodeMemoryResources(memory_mb=8192),
            disk=NodeDiskResources(disk_mb=100 * 1024),
            networks=[
                NetworkResource(
                    device="eth0",
                    cidr="192.168.0.100/32",
                    ip="192.168.0.100",
                    mbits=1000,
                )
            ],
        ),
        reserved_resources=NodeReservedResources(
            cpu=NodeCpuResources(cpu_shares=100),
            memory=NodeMemoryResources(memory_mb=256),
            disk=NodeDiskResources(disk_mb=4 * 1024),
            networks=NodeReservedNetworkResources(reserved_host_ports="22"),
        ),
        links={"consul": "foobar.dc1"},
        meta={"pci-dss": "true", "database": "mysql", "version": "5.6"},
        node_class="linux-medium-pci",
        status=NODE_STATUS_READY,
    )
    compute_class(n)
    return n


def tpu_node() -> Node:
    """A node carrying a TPU device group (the reference's NvidiaNode analog,
    fingerprinting TPU chips instead of GPUs; ref mock.go NvidiaNode)."""
    n = node()
    n.node_resources.devices = [
        NodeDeviceResource(
            vendor="google",
            type="tpu",
            name="v5e",
            attributes={
                "memory": Attribute.of_int(16, "GiB"),
                "clock": Attribute.of_int(940, "MHz"),
                "hbm_bandwidth": Attribute.of_int(819, "GB/s"),
            },
            instances=[
                NodeDevice(id=generate_uuid(), healthy=True),
                NodeDevice(id=generate_uuid(), healthy=True),
            ],
        )
    ]
    compute_class(n)
    return n


# Backwards-looking alias for parity test naming against the reference.
def nvidia_node() -> Node:
    n = node()
    n.node_resources.devices = [
        NodeDeviceResource(
            vendor="nvidia",
            type="gpu",
            name="1080ti",
            attributes={
                "memory": Attribute.of_int(11, "GiB"),
                "cuda_cores": Attribute.of_int(3584, ""),
                "graphics_clock": Attribute.of_int(1480, "MHz"),
                "memory_bandwidth": Attribute.of_int(11, "GB/s"),
            },
            instances=[
                NodeDevice(id=generate_uuid(), healthy=True),
                NodeDevice(id=generate_uuid(), healthy=True),
            ],
        )
    ]
    compute_class(n)
    return n


def _web_task() -> Task:
    return Task(
        name="web",
        driver="exec",
        config={"command": "/bin/date"},
        env={"FOO": "bar"},
        resources=Resources(
            cpu=500,
            memory_mb=256,
            networks=[
                NetworkResource(
                    mbits=50,
                    dynamic_ports=[Port(label="http"), Port(label="admin")],
                )
            ],
        ),
        meta={"foo": "bar"},
    )


def job() -> Job:
    j = Job(
        region="global",
        id=f"mock-service-{generate_uuid()}",
        name="my-job",
        type=JOB_TYPE_SERVICE,
        priority=50,
        datacenters=["dc1"],
        constraints=[
            Constraint(l_target="${attr.kernel.name}", r_target="linux", operand="=")
        ],
        task_groups=[
            TaskGroup(
                name="web",
                count=10,
                ephemeral_disk=EphemeralDisk(size_mb=150),
                restart_policy=RestartPolicy(
                    attempts=3, interval=10 * MINUTE_NS, delay=1 * MINUTE_NS, mode="delay"
                ),
                reschedule_policy=ReschedulePolicy(
                    attempts=2,
                    interval=10 * MINUTE_NS,
                    delay=5 * SECOND_NS,
                    delay_function="constant",
                ),
                migrate=MigrateStrategy(
                    max_parallel=1,
                    health_check="checks",
                    min_healthy_time=10 * SECOND_NS,
                    healthy_deadline=5 * MINUTE_NS,
                ),
                tasks=[_web_task()],
                meta={"elb_check_type": "http"},
            )
        ],
        meta={"owner": "armon"},
        create_index=42,
        modify_index=99,
        job_modify_index=99,
        submit_time=now_ns(),
    )
    return j


def batch_job() -> Job:
    j = job()
    j.id = f"mock-batch-{generate_uuid()}"
    j.name = "batch-job"
    j.type = JOB_TYPE_BATCH
    j.constraints = []
    tg = j.task_groups[0]
    tg.reschedule_policy = ReschedulePolicy(
        attempts=2,
        interval=10 * MINUTE_NS,
        delay=5 * SECOND_NS,
        delay_function="constant",
    )
    tg.tasks[0].resources.networks = []
    return j


def system_job() -> Job:
    j = Job(
        region="global",
        id=f"mock-system-{generate_uuid()}",
        name="my-job",
        type=JOB_TYPE_SYSTEM,
        priority=100,
        datacenters=["dc1"],
        constraints=[
            Constraint(l_target="${attr.kernel.name}", r_target="linux", operand="=")
        ],
        task_groups=[
            TaskGroup(
                name="web",
                count=1,
                restart_policy=RestartPolicy(
                    attempts=3, interval=10 * MINUTE_NS, delay=1 * MINUTE_NS, mode="delay"
                ),
                ephemeral_disk=EphemeralDisk(),
                tasks=[
                    Task(
                        name="web",
                        driver="exec",
                        config={"command": "/bin/date"},
                        resources=Resources(
                            cpu=500,
                            memory_mb=256,
                            networks=[
                                NetworkResource(
                                    mbits=50, dynamic_ports=[Port(label="http")]
                                )
                            ],
                        ),
                    )
                ],
            )
        ],
        meta={"owner": "armon"},
        create_index=42,
        modify_index=99,
    )
    return j


def periodic_job() -> Job:
    j = job()
    j.type = JOB_TYPE_BATCH
    j.periodic = PeriodicConfig(enabled=True, spec_type="cron", spec="*/30 * * * *")
    j.status = "running"
    return j


def evaluation() -> Evaluation:
    now = now_ns()
    return Evaluation(
        id=generate_uuid(),
        priority=50,
        type=JOB_TYPE_SERVICE,
        job_id=generate_uuid(),
        status="pending",
        create_time=now,
        modify_time=now,
    )


def alloc() -> Allocation:
    a = Allocation(
        id=generate_uuid(),
        eval_id=generate_uuid(),
        node_id="12345678-abcd-efab-cdef-123456789abc",
        task_group="web",
        allocated_resources=AllocatedResources(
            tasks={
                "web": AllocatedTaskResources(
                    cpu=AllocatedCpuResources(cpu_shares=500),
                    memory=AllocatedMemoryResources(memory_mb=256),
                    networks=[
                        NetworkResource(
                            device="eth0",
                            ip="192.168.0.100",
                            reserved_ports=[Port(label="admin", value=5000)],
                            mbits=50,
                            dynamic_ports=[Port(label="http", value=9876)],
                        )
                    ],
                )
            },
            shared=AllocatedSharedResources(disk_mb=150),
        ),
        desired_status="run",
        client_status="pending",
    )
    a.job = job()
    a.job_id = a.job.id
    a.namespace = a.job.namespace
    a.name = f"{a.job_id}.web[0]"
    return a


def batch_alloc() -> Allocation:
    a = alloc()
    a.job = batch_job()
    a.job_id = a.job.id
    a.name = f"{a.job_id}.web[0]"
    return a


def deployment() -> Deployment:
    j = job()
    d = Deployment.new_for_job(j)
    return d
