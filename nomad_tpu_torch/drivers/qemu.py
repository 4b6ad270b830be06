"""QEMU task driver (ref drivers/qemu/driver.go): boot a VM image as the
task process.

Task config:
  image_path       VM image (required)
  accelerator      kvm|tcg (default kvm when /dev/kvm exists, else tcg)
  graceful_shutdown  send ACPI powerdown via monitor before SIGKILL
  port_map         {vm_port: host_port_label} user-net hostfwd rules
  args             raw extra qemu arguments
"""

from __future__ import annotations

import os
import shutil

from ..client.driver import RawExecDriver, TaskHandle
from ..structs.model import Task

QEMU_BINARIES = (
    "qemu-system-x86_64",
    "qemu-system-aarch64",
    "qemu-kvm",
)


class QemuDriver(RawExecDriver):
    name = "qemu"

    def __init__(self, binary: str = ""):
        super().__init__()
        self._qemu = binary or next(
            (p for b in QEMU_BINARIES if (p := shutil.which(b))), None
        )
        self._version = ""
        if self._qemu:
            self._version = self._probe_version()

    def _probe_version(self) -> str:
        import subprocess

        try:
            out = subprocess.run(
                [self._qemu, "--version"],
                capture_output=True,
                text=True,
                timeout=10,
            )
            # "QEMU emulator version 6.2.0 ..."
            for tok in out.stdout.split():
                if tok[:1].isdigit():
                    return tok
        except (OSError, subprocess.TimeoutExpired):
            pass
        return ""

    def fingerprint(self) -> dict:
        detected = bool(self._qemu)
        attrs = {}
        if detected:
            attrs["driver.qemu.version"] = self._version
        return {"detected": detected, "healthy": detected, "attributes": attrs}

    def start_task(self, task: Task, task_dir: str) -> TaskHandle:
        if not self._qemu:
            raise RuntimeError("qemu not found on this node")
        cfg = task.config or {}
        image = cfg.get("image_path")
        if not image:
            raise RuntimeError("qemu requires image_path")
        mem = task.resources.memory_mb or 512
        argv = [
            self._qemu,
            "-machine",
            "type=pc,accel="
            + cfg.get(
                "accelerator",
                "kvm" if os.path.exists("/dev/kvm") else "tcg",
            ),
            "-m",
            f"{mem}M",
            "-drive",
            f"file={image}",
            "-nographic",
            "-nodefaults",
        ]
        port_map = cfg.get("port_map") or {}
        if port_map:
            # user-mode net with hostfwd per mapping (ref qemu driver's
            # port_map → hostfwd_tcp rules); host ports come from the
            # task's reserved/dynamic port labels
            ports = {}
            for net in task.resources.networks:
                for p in list(net.reserved_ports) + list(net.dynamic_ports):
                    ports[p.label] = p.value
            fwds = []
            for vm_port, label in port_map.items():
                host_port = ports.get(label)
                if host_port:
                    fwds.append(f"hostfwd=tcp::{host_port}-:{vm_port}")
            argv += ["-netdev", "user,id=user.0," + ",".join(fwds), "-device", "virtio-net,netdev=user.0"]
        argv += [str(a) for a in cfg.get("args", [])]
        return self._spawn(task, argv, task_dir or None)
