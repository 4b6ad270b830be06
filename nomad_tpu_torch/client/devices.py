"""Device plugin tier + TPU fingerprinting
(ref plugins/device/proto/device.proto: Fingerprint/Reserve/Stats;
devices/gpu/nvidia/device.go: the NVML-backed GPU plugin this framework's
TPU plugin mirrors — fingerprint chips into node device groups, reserve →
environment variables, stats).

The client's DeviceManager runs the configured plugins, merges their
fingerprints into the node's device groups before registration, and at
task start asks the owning plugin to reserve the allocated instance ids —
producing the env the driver injects (TPU_VISIBLE_DEVICES here, the
CUDA_VISIBLE_DEVICES analog).

The port's copy of ``nomad_tpu/client/devices.py``. ``TPUDevicePlugin``
and ``DeviceManager`` are as in the JAX package; the default plugin list
holds ``NvidiaDevicePlugin`` in the TPU plugin's place: the port's card is
an NVIDIA GPU, fingerprinted as Nomad's ``devices/gpu/nvidia`` does and
reserved through CUDA_VISIBLE_DEVICES."""

from __future__ import annotations

import glob
import logging
import os
import re
import shutil
import subprocess
from typing import Optional

from ..structs.model import Attribute, NodeDevice, NodeDeviceResource

logger = logging.getLogger("nomad_tpu.client.devices")


class DevicePlugin:
    """Device plugin interface (ref plugins/device/device.go)."""

    name = "device"

    def fingerprint(self) -> list[NodeDeviceResource]:
        """Detected device groups (empty when absent)."""
        return []

    def reserve(self, device_ids: list[str]) -> dict:
        """Reservation for the given instance ids → {"env": {...}}."""
        return {"env": {}}

    def stats(self) -> dict:
        return {}


class TPUDevicePlugin(DevicePlugin):
    """Fingerprints the host's TPU chips (ref devices/gpu/nvidia, with
    libtpu/accel chardevs standing in for NVML).

    Detection: accelerator character devices (``/dev/accel*`` — the PCIe
    TPU driver surface — or ``/dev/vfio/*`` for VFIO-bound chips), plus
    libtpu presence for the version attribute. NOMAD_TPU_DEV_GLOB overrides
    the device glob (tests point it at a fake dev tree). Reserve maps
    instance ids to TPU_VISIBLE_DEVICES, libtpu's device-selection env."""

    name = "tpu"

    def __init__(self, dev_glob: Optional[str] = None):
        self.dev_glob = dev_glob or os.environ.get(
            "NOMAD_TPU_DEV_GLOB", "/dev/accel*"
        )

    def config_schema(self) -> dict:
        """base.proto ConfigSchema: the subprocess-plugin handshake pushes
        the agent's plugin{config{}} stanza through this schema."""
        return {"dev_glob": {"type": "string"}}

    def set_config(self, config: dict) -> None:
        if config.get("dev_glob"):
            self.dev_glob = config["dev_glob"]

    def _chips(self) -> list[str]:
        chips = sorted(glob.glob(self.dev_glob))
        # vfio fallback: chips bound to vfio show up as numbered group files
        if not chips and self.dev_glob == "/dev/accel*":
            chips = sorted(
                p for p in glob.glob("/dev/vfio/*") if re.search(r"\d+$", p)
            )
        return chips

    @staticmethod
    def _libtpu_version() -> str:
        try:
            import importlib.metadata as md

            for dist in ("libtpu", "libtpu-nightly"):
                try:
                    return md.version(dist)
                except md.PackageNotFoundError:
                    continue
        except Exception:
            pass
        return ""

    def fingerprint(self) -> list[NodeDeviceResource]:
        chips = self._chips()
        if not chips:
            return []
        attributes = {
            "driver_version": Attribute.of_string(self._libtpu_version() or "unknown"),
        }
        instances = []
        for path in chips:
            m = re.search(r"(\d+)$", os.path.basename(path))
            chip_id = m.group(1) if m else os.path.basename(path)
            instances.append(NodeDevice(id=chip_id, healthy=True))
        return [
            NodeDeviceResource(
                vendor="google",
                type="tpu",
                name="tpu",
                instances=instances,
                attributes=attributes,
            )
        ]

    def reserve(self, device_ids: list[str]) -> dict:
        return {"env": {"TPU_VISIBLE_DEVICES": ",".join(device_ids)}}

    def stats(self) -> dict:
        """Chip presence/health (ref device.proto Stats: the nvidia plugin
        streams NVML gauges; the chardev tier exposes presence + driver)."""
        chips = self._chips()
        if not chips:
            return {}
        return {
            "chip_count": len(chips),
            "chips": {
                os.path.basename(p): {"present": True, "healthy": True}
                for p in chips
            },
            "driver_version": self._libtpu_version() or "unknown",
        }


class NvidiaDevicePlugin(DevicePlugin):
    """Fingerprints the host's NVIDIA cards (ref devices/gpu/nvidia, with
    ``nvidia-smi``, which ships with the driver, standing in for NVML).

    One NodeDeviceResource per card model (vendor ``nvidia``, type ``gpu``,
    the model as its name, as the reference groups them) with a NodeDevice
    per card. An instance id is the card's UUID (``GPU-...``): it names the
    same card whatever the agent's own CUDA_VISIBLE_DEVICES renumbers and
    whatever /dev/nvidiaN minor a container exposes, and CUDA_VISIBLE_DEVICES
    takes it as it is. Reserve maps instance ids to CUDA_VISIBLE_DEVICES.

    Without ``nvidia-smi`` on PATH (no driver) it finds nothing, as the TPU
    plugin finds nothing without /dev/accel*. A query that fails where
    ``nvidia-smi`` exists raises, so the DeviceManager logs the failure.
    ``nvidia_smi`` (or the plugin stanza's ``nvidia_smi`` config) names the
    binary; tests point it at a fake."""

    name = "nvidia"

    FIELDS = ("uuid", "name", "driver_version", "memory.total")

    def __init__(self, nvidia_smi: Optional[str] = None):
        self.nvidia_smi = nvidia_smi

    def config_schema(self) -> dict:
        return {"nvidia_smi": {"type": "string"}}

    def set_config(self, config: dict) -> None:
        if config.get("nvidia_smi"):
            self.nvidia_smi = config["nvidia_smi"]

    def _cards(self) -> list[tuple[str, str, str, int]]:
        """(uuid, model, driver version, memory MiB) of each card."""
        smi = self.nvidia_smi or shutil.which("nvidia-smi")
        if smi is None:
            return []
        proc = subprocess.run(
            [smi, f"--query-gpu={','.join(self.FIELDS)}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvidia-smi failed ({proc.returncode}): {proc.stderr.strip()}"
            )
        cards = []
        for line in proc.stdout.splitlines():
            if not line.strip():
                continue
            # a model name may hold a comma; the other fields do not
            uuid, rest = line.split(",", 1)
            name, driver, memory = rest.rsplit(",", 2)
            cards.append((uuid.strip(), name.strip(), driver.strip(), int(float(memory))))
        return cards

    def fingerprint(self) -> list[NodeDeviceResource]:
        groups: dict[str, NodeDeviceResource] = {}
        for uuid, name, driver, memory in self._cards():
            group = groups.get(name)
            if group is None:
                group = groups[name] = NodeDeviceResource(
                    vendor="nvidia",
                    type="gpu",
                    name=name,
                    attributes={
                        "driver_version": Attribute.of_string(driver or "unknown"),
                        "memory": Attribute.of_int(memory, "MiB"),
                    },
                )
            group.instances.append(NodeDevice(id=uuid, healthy=True))
        return list(groups.values())

    def reserve(self, device_ids: list[str]) -> dict:
        return {"env": {"CUDA_VISIBLE_DEVICES": ",".join(device_ids)}}

    def stats(self) -> dict:
        """Card presence/health, in the TPU plugin's shape."""
        cards = self._cards()
        if not cards:
            return {}
        return {
            "chip_count": len(cards),
            "chips": {
                uuid: {"present": True, "healthy": True, "name": name}
                for uuid, name, _, _ in cards
            },
            "driver_version": cards[0][2] or "unknown",
        }


class DeviceManager:
    """Client-side plugin lifecycle + reservation routing
    (ref client/devicemanager/manager.go)."""

    def __init__(self, plugins: Optional[list[DevicePlugin]] = None):
        self.plugins = plugins if plugins is not None else [NvidiaDevicePlugin()]
        # (vendor, type, name) → owning plugin, filled by fingerprint_node
        # nta: ignore[unbounded-cache] WHY: keyed by device instance
        # ids on this node — hardware-bounded
        self._owners: dict[tuple, DevicePlugin] = {}
        # node attribute keys this manager set, so a shrinking device set
        # clears its stale count attributes
        self._attr_keys: set[str] = set()

    def fingerprint_node(self, node) -> int:
        """Merge all plugins' device groups into the node; returns the
        number of device groups found. Assigns unconditionally — a set that
        shrinks to empty (last chip pulled/unhealthy) must CLEAR the node's
        advertised devices, or the scheduler keeps placing device jobs on a
        chipless node (the change watch makes shrink a live path)."""
        groups = []
        attr_keys = set()
        for plugin in self.plugins:
            try:
                found = plugin.fingerprint()
            except Exception:
                logger.exception("device plugin %s fingerprint failed", plugin.name)
                continue
            for group in found:
                key = (group.vendor, group.type, group.name)
                self._owners[key] = plugin
                groups.append(group)
                attr_key = f"device.{group.vendor}.{group.type}.count"
                node.attributes[attr_key] = str(len(group.instances))
                attr_keys.add(attr_key)
        for stale in self._attr_keys - attr_keys:
            node.attributes.pop(stale, None)
        self._attr_keys = attr_keys
        node.node_resources.devices = groups
        return len(groups)

    def stats(self) -> dict:
        """Per-plugin device stats (ref device.proto Stats stream; served
        inside /v1/client/stats)."""
        out = {}
        for plugin in self.plugins:
            try:
                stats = plugin.stats()
            except Exception:
                logger.exception("device plugin %s stats failed", plugin.name)
                continue
            if stats:
                out[plugin.name] = stats
        return out

    def start_watches(self, on_change) -> None:
        """Start change watches on plugins that stream fingerprints
        (external subprocess plugins; ref device.proto's Fingerprint
        stream). ``on_change()`` should re-fingerprint and re-register the
        node."""
        for plugin in self.plugins:
            watch = getattr(plugin, "watch", None)
            if watch is not None:
                try:
                    watch(on_change)
                except Exception:
                    logger.exception(
                        "device plugin %s watch failed to start", plugin.name
                    )

    def shutdown(self) -> None:
        """Tear down external plugin processes (no-op for in-process)."""
        for plugin in self.plugins:
            stop = getattr(plugin, "shutdown", None)
            if stop is not None:
                try:
                    stop()
                except Exception:
                    logger.exception(
                        "device plugin %s shutdown failed", plugin.name
                    )

    def reserve_env(self, allocated_devices) -> dict:
        """Env for a task's AllocatedDeviceResource list."""
        env: dict[str, str] = {}
        for ad in allocated_devices or []:
            plugin = self._owners.get((ad.vendor, ad.type, ad.name))
            if plugin is None:
                logger.warning(
                    "no device plugin owns %s/%s/%s", ad.vendor, ad.type, ad.name
                )
                continue
            try:
                res = plugin.reserve(list(ad.device_ids))
            except Exception:
                logger.exception("device reserve failed")
                continue
            env.update(res.get("env", {}))
        return env
