"""External-Consul sync adapter (ref command/agent/consul/client.go:212
ServiceClient: the reference registers workload services and checks into
a Consul agent and keeps them in sync on a commit interval).

The framework's PRIMARY service catalog is nomad-native (`/v1/services`,
served straight from cluster state — see client/connect.py and the
PARITY.md divergence note). This adapter is the optional interop bridge:
it extracts the same service entries from state snapshots, diffs them
against what it last wrote, and pushes the delta to an external Consul
agent over its HTTP API —
``PUT /v1/agent/service/register`` with a TTL check,
``PUT /v1/agent/check/update/:id`` for health transitions, and
``PUT /v1/agent/service/deregister/:id`` when a service goes away.
Enabled by a ``consul { address = "http://..." }`` stanza on agents that
host cluster state (dev/server modes)."""

from __future__ import annotations

import json
import logging
import threading
import urllib.error
import urllib.request
from typing import Callable, Optional

logger = logging.getLogger("nomad_tpu.consul")

#: service-ID prefix, mirroring the reference's "_nomad-task-..." ids so
#: an operator can tell nomad-managed registrations apart (ref
#: command/agent/consul/client.go makeAgentServiceID)
ID_PREFIX = "_nomad-task"


def service_entries(snap) -> dict[str, dict]:
    """Extract {service_id: registration} for every service of every
    non-terminal alloc in the snapshot — the same data the native catalog
    serves, keyed for idempotent external sync."""
    out: dict[str, dict] = {}
    for alloc in snap.allocs():
        if alloc.terminal_status():
            continue
        job = alloc.job
        tg = job.lookup_task_group(alloc.task_group) if job else None
        if tg is None:
            continue
        for task in tg.tasks:
            state = alloc.task_states.get(task.name)
            healthy = state is not None and state.state == "running"
            checks = dict(state.check_status) if state is not None else {}
            if healthy and any(v != "passing" for v in checks.values()):
                healthy = False
            for svc in task.services:
                address, port = "", 0
                resources = alloc.allocated_resources
                tr = (
                    resources.tasks.get(task.name)
                    if resources is not None
                    else None
                )
                if tr is not None and svc.port_label:
                    for net in tr.networks:
                        for p in list(net.reserved_ports) + list(
                            net.dynamic_ports
                        ):
                            if p.label == svc.port_label:
                                address, port = net.ip, p.value
                sid = (
                    f"{ID_PREFIX}-{alloc.id}-{task.name}-{svc.name}"
                )
                out[sid] = {
                    "ID": sid,
                    "Name": svc.name,
                    "Tags": list(svc.tags),
                    "Address": address,
                    "Port": int(port),
                    "status": "passing" if healthy else "critical",
                }
    return out


class ConsulSyncer:
    """Periodic diff-sync of the native catalog into an external Consul
    agent. Registrations and deregistrations are only issued for CHANGES
    (the reference's operation batching per commit interval); health
    rides a TTL check per service updated on transitions."""

    def __init__(
        self,
        snapshot_fn: Callable,
        address: str,
        token: str = "",
        interval: float = 5.0,
        timeout: float = 5.0,
    ):
        self.snapshot_fn = snapshot_fn
        self.address = address.rstrip("/")
        self.token = token
        self.interval = interval
        self.timeout = timeout
        #: sid -> last registration payload (incl. health) written
        self._registered: dict[str, dict] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- consul agent HTTP API ------------------------------------------
    def _req(self, method: str, path: str, body: Optional[dict] = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            f"{self.address}{path}", data=data, method=method,
            headers={"Content-Type": "application/json"},
        )
        if self.token:
            req.add_header("X-Consul-Token", self.token)
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return resp.read()

    def _register(self, entry: dict):
        payload = {
            "ID": entry["ID"],
            "Name": entry["Name"],
            "Tags": entry["Tags"],
            "Address": entry["Address"],
            "Port": entry["Port"],
            # health rides a TTL check the syncer itself keeps fresh
            # (ref client.go: nomad pushes check state, consul stores it)
            "Check": {
                "CheckID": f"{entry['ID']}-ttl",
                "Name": f"{entry['Name']} liveness (nomad-synced)",
                "TTL": f"{max(int(self.interval * 6), 30)}s",
                "Status": entry["status"],
            },
        }
        self._req("PUT", "/v1/agent/service/register", payload)

    def _update_check(self, sid: str, status: str):
        self._req(
            "PUT",
            f"/v1/agent/check/update/{sid}-ttl",
            {"Status": status},
        )

    def _deregister(self, sid: str):
        self._req("PUT", f"/v1/agent/service/deregister/{sid}")

    # -- sync loop -------------------------------------------------------
    def sync_once(self) -> dict:
        """One diff-sync pass; returns op counts (observability + tests).
        Consul being down is retried next interval — already-registered
        state is kept so recovery converges instead of re-registering
        everything blindly."""
        desired = service_entries(self.snapshot_fn())
        ops = {"register": 0, "update": 0, "deregister": 0}
        try:
            for sid, entry in desired.items():
                prev = self._registered.get(sid)
                if prev is None or any(
                    prev[k] != entry[k]
                    for k in ("Name", "Tags", "Address", "Port")
                ):
                    self._register(entry)
                    ops["register"] += 1
                    self._registered[sid] = dict(entry)
                elif prev["status"] != entry["status"]:
                    self._update_check(sid, entry["status"])
                    ops["update"] += 1
                    self._registered[sid]["status"] = entry["status"]
                else:
                    # refresh the TTL so healthy services don't lapse
                    self._update_check(sid, entry["status"])
            for sid in list(self._registered):
                if sid not in desired:
                    self._deregister(sid)
                    ops["deregister"] += 1
                    del self._registered[sid]
        except (urllib.error.URLError, OSError) as e:
            logger.warning("consul sync failed (will retry): %s", e)
        return ops

    def start(self):
        def loop():
            while not self._stop.wait(self.interval):
                self.sync_once()

        self._thread = threading.Thread(
            target=loop, daemon=True, name="consul-sync"
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        # a clean shutdown removes this agent's registrations, like the
        # reference's Shutdown dereg pass
        for sid in list(self._registered):
            try:
                self._deregister(sid)
            except Exception:
                pass
        self._registered.clear()


def syncer_from_config(config: dict, snapshot_fn) -> Optional[ConsulSyncer]:
    """consul{address, token, sync_interval_s} → a started ConsulSyncer,
    or None when the stanza is absent (the native catalog needs none)."""
    ccfg = (config or {}).get("consul") or {}
    if not ccfg.get("address"):
        return None
    return ConsulSyncer(
        snapshot_fn,
        str(ccfg["address"]),
        token=str(ccfg.get("token", "")),
        interval=float(ccfg.get("sync_interval_s", 5.0)),
    ).start()
