"""Host fingerprinting (ref client/fingerprint/: arch, cpu, host, memory,
network, storage fingerprinters + the periodic re-fingerprint manager,
fingerprint.go:31-50, fingerprint_manager.go).

Real detection — /proc/meminfo for memory, statvfs for storage,
/proc/cpuinfo + sysfs for cpu frequency, /sys/class/net for links — so the
scheduler bin-packs against actual host capacity instead of invented
numbers. Every fingerprinter degrades gracefully on exotic hosts (missing
/proc entries fall back to conservative defaults)."""

from __future__ import annotations

import logging
import os
import platform
import re
import socket

from ..structs.model import NetworkResource

logger = logging.getLogger("nomad_tpu.client.fingerprint")


def cpu_fingerprint() -> dict:
    """Core count + clock → total compute MHz (ref fingerprint/cpu.go:
    Nomad advertises cores × MHz as cpu shares)."""
    cores = os.cpu_count() or 1
    mhz = 0.0
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                m = re.match(r"cpu MHz\s*:\s*([\d.]+)", line)
                if m:
                    mhz = max(mhz, float(m.group(1)))
    except OSError:
        pass
    if not mhz:
        try:
            with open(
                "/sys/devices/system/cpu/cpu0/cpufreq/cpuinfo_max_freq"
            ) as f:
                mhz = int(f.read().strip()) / 1000.0
        except OSError:
            pass
    if not mhz:
        mhz = 1000.0  # conservative default when the host hides its clock
    return {
        "cores": cores,
        "mhz": mhz,
        "total_compute": int(cores * mhz),
    }


def memory_fingerprint() -> int:
    """Total memory in MB (ref fingerprint/memory.go ← /proc/meminfo)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                m = re.match(r"MemTotal:\s*(\d+)\s*kB", line)
                if m:
                    return int(m.group(1)) // 1024
    except OSError:
        pass
    return 1024


def storage_fingerprint(path: str) -> tuple[int, int]:
    """(total_mb, free_mb) of the volume holding ``path``
    (ref fingerprint/storage.go ← statfs of the alloc dir)."""
    try:
        os.makedirs(path, exist_ok=True)
        st = os.statvfs(path)
        total = st.f_blocks * st.f_frsize // (1024 * 1024)
        free = st.f_bavail * st.f_frsize // (1024 * 1024)
        return total, free
    except OSError:
        return 1024, 1024


def host_fingerprint() -> dict:
    """ref fingerprint/host.go + arch.go"""
    return {
        "hostname": platform.node() or "client",
        "kernel.name": platform.system().lower(),
        "kernel.version": platform.release(),
        "os.name": platform.system().lower(),
        "arch": platform.machine(),
    }


# nta: ignore[unbounded-cache] WHY: process-wide memo keyed by the two
# probe names (aws/gce) — fixed cardinality by construction
_ENV_PROBE_CACHE: dict[str, dict] = {}


def env_aws_fingerprint(base: str = "", timeout: float = 0.25) -> dict:
    """EC2 metadata-service probe (ref fingerprint/env_aws.go). Returns
    platform.aws.* attributes, or {} when the node isn't on EC2 — the
    probe's short timeout keeps non-cloud boots fast, and the default
    endpoint is probed once per process (cloudiness doesn't change)."""
    import urllib.request

    if not base and "aws" in _ENV_PROBE_CACHE:
        return dict(_ENV_PROBE_CACHE["aws"])
    cache_key = "aws" if not base else None
    base = base or "http://169.254.169.254/latest/meta-data/"
    attrs = {}
    keys = {
        "instance-id": "unique.platform.aws.instance-id",
        "instance-type": "platform.aws.instance-type",
        "placement/availability-zone": "platform.aws.placement.availability-zone",
        "local-ipv4": "unique.platform.aws.local-ipv4",
        "local-hostname": "unique.platform.aws.local-hostname",
        "ami-id": "platform.aws.ami-id",
    }
    for path, attr in keys.items():
        try:
            with urllib.request.urlopen(base + path, timeout=timeout) as resp:
                attrs[attr] = resp.read().decode().strip()
        except Exception:
            if not attrs:
                attrs = {}
                break  # first probe failed: not on EC2, stop probing
            continue  # partial metadata: keep what answered
    if cache_key:
        _ENV_PROBE_CACHE[cache_key] = dict(attrs)
    return attrs


def env_gce_fingerprint(base: str = "", timeout: float = 0.25) -> dict:
    """GCE metadata-service probe (ref fingerprint/env_gce.go): requires
    the Metadata-Flavor header, so a generic http server won't false-
    positive."""
    import urllib.request

    if not base and "gce" in _ENV_PROBE_CACHE:
        return dict(_ENV_PROBE_CACHE["gce"])
    cache_key = "gce" if not base else None
    base = base or "http://metadata.google.internal/computeMetadata/v1/instance/"
    attrs = {}
    keys = {
        "id": "unique.platform.gce.id",
        "hostname": "unique.platform.gce.hostname",
        "machine-type": "platform.gce.machine-type",
        "zone": "platform.gce.zone",
    }
    for path, attr in keys.items():
        req = urllib.request.Request(
            base + path, headers={"Metadata-Flavor": "Google"}
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                if resp.headers.get("Metadata-Flavor") != "Google":
                    attrs = {}
                    break  # something answered, but not GCE metadata
                value = resp.read().decode().strip()
        except Exception:
            if not attrs:
                attrs = {}
                break
            continue
        # machine-type/zone arrive as long resource paths; keep the leaf
        attrs[attr] = value.rsplit("/", 1)[-1] if "/" in value else value
    if cache_key:
        _ENV_PROBE_CACHE[cache_key] = dict(attrs)
    return attrs


def network_fingerprint() -> list[NetworkResource]:
    """Usable links with an address (ref fingerprint/network.go: interface
    speed from sysfs, default-route IP detection; loopback as last
    resort)."""
    networks: list[NetworkResource] = []
    ip = _default_ip()
    try:
        devices = sorted(os.listdir("/sys/class/net"))
    except OSError:
        devices = []
    for dev in devices:
        if dev == "lo":
            continue
        state_path = f"/sys/class/net/{dev}/operstate"
        try:
            with open(state_path) as f:
                state = f.read().strip()
        except OSError:
            continue
        if state not in ("up", "unknown"):
            continue
        mbits = 1000
        try:
            with open(f"/sys/class/net/{dev}/speed") as f:
                speed = int(f.read().strip())
                if speed > 0:
                    mbits = speed
        except (OSError, ValueError):
            pass
        networks.append(
            NetworkResource(device=dev, ip=ip, cidr=f"{ip}/32", mbits=mbits)
        )
        break  # first usable link, like the reference's default behavior
    if not networks:
        networks.append(
            NetworkResource(
                device="lo", ip="127.0.0.1", cidr="127.0.0.1/32", mbits=1000
            )
        )
    return networks


def _default_ip() -> str:
    """Routable source address without sending traffic (UDP connect trick;
    falls back to loopback on isolated hosts)."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("255.255.255.254", 1))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"
