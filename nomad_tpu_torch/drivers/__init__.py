"""Extended task-driver families (ref /root/reference/drivers/: docker,
java, qemu alongside the exec/rawexec/mock family that lives in
client/driver.py).

Each driver fingerprints its external runtime (java, qemu-system-*,
docker) and reports ``detected=False`` when absent, exactly like the
reference's fingerprint-gated drivers — jobs constrained to the driver
then never match the node (scheduler DriverChecker)."""

from .docker import DockerDriver
from .java import JavaDriver
from .qemu import QemuDriver

EXTENDED_DRIVERS = {
    JavaDriver.name: JavaDriver,
    QemuDriver.name: QemuDriver,
    DockerDriver.name: DockerDriver,
}

__all__ = [
    "DockerDriver",
    "JavaDriver",
    "QemuDriver",
    "EXTENDED_DRIVERS",
]
