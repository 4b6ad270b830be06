"""Agents: the processes that run servers and node clients
(ref command/agent/agent.go — an Agent embeds a Server and/or Client).

``DevAgent`` is the -dev mode: server + in-process clients, no network.
``ServerAgent`` runs a server with a real RPC listener (raft + endpoint
protocols muxed on one port, ref nomad/rpc.go); ``ClientAgent`` runs a
node agent that talks to servers over RPC via ServerProxy.

The port's copy of ``nomad_tpu/agent.py``. ``DevAgent`` and
``ServerAgent`` take ``device`` and hand it to their ``Server``: CUDA
unless the caller passes ``"cpu"``, and without a card they raise before
any client is built. The clients hold no tensor.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Optional

from . import resolve_device
from .client import Client
from .core import Server


class DevAgent:
    """Single-process cluster for development, tests, and the CLI dev mode."""

    def __init__(
        self,
        num_clients: int = 1,
        server_config: Optional[dict] = None,
        num_workers: int = 2,
        device=None,
    ):
        config = {"heartbeat_ttl": 3.0}
        config.update(server_config or {})
        self.server = Server(config, device=device)
        self.num_workers = num_workers
        self.clients: list[Client] = []
        self._tmpdir = tempfile.mkdtemp(prefix="nomad_tpu_dev_")
        for i in range(num_clients):
            self.clients.append(
                Client(self.server, data_dir=f"{self._tmpdir}/client{i}")
            )

    def start(self):
        self.server.start(num_workers=self.num_workers)
        for c in self.clients:
            c.start()

    def stop(self):
        for c in self.clients:
            c.stop()
        self.server.stop()

    # convenience passthroughs
    @property
    def state(self):
        return self.server.state

    def run_job(self, job) -> str:
        return self.server.job_register(job)


def apply_client_config(agent: "DevAgent", config: dict) -> None:
    """Apply agent-config client settings to the (not yet started) agent's
    clients: host_volume declarations land on the node before registration
    (ref client config HostVolumes), meta merges into node metadata."""
    client_cfg = config.get("client", {}) or {}
    volumes = client_cfg.get("host_volume") or {}
    meta = client_cfg.get("meta") or {}
    # vault{address} flows to clients for template ${vault.*} reads
    vault_cfg = config.get("vault") or {}
    if vault_cfg.get("address"):
        for client in agent.clients:
            client.vault_config = dict(vault_cfg)
    # plugin "name" { type = "driver"|"device", spec = "pkg.mod:factory",
    # config {...} } — external subprocess plugins (ref command/agent
    # plugin stanza + helper/pluginutils/loader; device.proto / driver.proto)
    plugins = config.get("plugin") or {}
    if plugins:
        from .plugins.external import ExternalDevicePlugin, ExternalDriver
        from .structs.node_class import compute_class as _cc

        for pname, body in plugins.items():
            body = body or {}
            spec = str(body.get("spec", ""))
            if not spec:
                logging.getLogger("nomad_tpu.agent").warning(
                    "plugin %r has no spec; skipped", pname
                )
                continue
            kind = str(body.get("type", "driver"))
            if kind not in ("driver", "device"):
                logging.getLogger("nomad_tpu.agent").warning(
                    "plugin %r has unknown type %r (want driver|device); "
                    "skipped", pname, kind
                )
                continue
            pconfig = body.get("config") or {}
            for client in agent.clients:
                if kind == "device":
                    plugin = ExternalDevicePlugin(
                        spec, name=pname, config=pconfig
                    )
                    client.device_manager.plugins.append(plugin)
                    # the node was fingerprinted at construction; merge the
                    # new plugin's device groups before registration
                    client.device_manager.fingerprint_node(client.node)
                    _cc(client.node)
                else:
                    client.drivers[pname] = ExternalDriver(
                        spec, name=pname, config=pconfig
                    )
                    # re-fingerprint so node.drivers advertises the new
                    # driver at registration (feasible.py filters nodes
                    # missing a task's driver); the device branch merges
                    # symmetrically above
                    client._fingerprint_drivers(client.node)
                    _cc(client.node)
    if not volumes and not meta:
        return
    from .structs.model import ClientHostVolumeConfig
    from .structs.node_class import compute_class

    for client in agent.clients:
        for vol_name, body in volumes.items():
            body = body or {}
            client.node.host_volumes[vol_name] = ClientHostVolumeConfig(
                name=vol_name,
                path=str(body.get("path", "")),
                read_only=bool(body.get("read_only", False)),
            )
        for k, v in meta.items():
            client.node.meta[str(k)] = str(v)
        compute_class(client.node)


class ServerAgent:
    """A server with a network RPC listener (ref command/agent/agent.go
    server mode + nomad/rpc.go listener).

    Two-phase start so multi-server clusters can exchange addresses:
    constructing binds the listener (``.address`` is then known); ``start``
    takes the full voter map and boots raft + endpoints.
    """

    def __init__(
        self,
        name: str,
        bind: str = "127.0.0.1",
        port: int = 0,
        data_dir: Optional[str] = None,
        config: Optional[dict] = None,
        device=None,
    ):
        from .rpc import RpcServer, TcpRaftTransport
        from .rpc.endpoints import register_endpoints

        #: the server's device tier (resolved before any socket binds)
        self.device = resolve_device(device)
        self.name = name
        self.data_dir = data_dir
        self.config = dict(config or {})
        # mTLS (helper/tlsutil): config["tls"] = {ca, cert, key} wraps the
        # RPC listener and every outbound raft/endpoint connection
        from .tlsutil import contexts_from_config

        server_ctx, client_ctx = contexts_from_config(self.config.get("tls"))
        #: outbound mTLS context; consumed by the HTTP agent's client-fs
        #: forwarding pool (attached onto the core Server in start())
        self.tls_client_context = client_ctx
        self.rpc = RpcServer(bind, port, tls_context=server_ctx)
        self.address = self.rpc.address
        self._transport = TcpRaftTransport(self.rpc, tls_context=client_ctx)
        self._register_endpoints = register_endpoints
        self.server: Optional[Server] = None

    def start(
        self,
        voters: Optional[dict[str, str]] = None,
        num_workers: int = 2,
        wait_for_leader: Optional[float] = None,
    ):
        from .raft.log import FileLogStore, SnapshotStore, StableStore

        # None = single-voter default; an EXPLICIT empty dict means "join
        # via gossip discovery" (the server starts voter-less and waits
        # for the region leader's CONFIG entry — it never self-elects)
        voters = {self.name: self.address} if voters is None else voters
        # merge ON TOP of any user-supplied raft stanza so timing knobs
        # (heartbeat_interval / election_timeout_*) survive the wiring
        raft_cfg: dict = {
            **self.config.get("raft", {}),
            "node_id": self.name,
            "address": self.address,
            "voters": voters,
            "transport": self._transport,
        }
        if self.data_dir:
            os.makedirs(self.data_dir, exist_ok=True)
            raft_cfg["log_store"] = FileLogStore(
                os.path.join(self.data_dir, "raft.log")
            )
            raft_cfg["stable"] = StableStore(
                os.path.join(self.data_dir, "stable.db")
            )
            raft_cfg["snapshots"] = SnapshotStore(
                os.path.join(self.data_dir, "snapshots")
            )
        cfg = dict(self.config)
        cfg["name"] = self.name
        cfg["raft"] = raft_cfg
        if self.data_dir:
            cfg.setdefault("data_dir", self.data_dir)
        self.server = Server(cfg, device=self.device)
        # the HTTP agent's client-fs forwarding pool must dial client RPC
        # listeners with the same mTLS identity
        self.server.tls_client_context = self.tls_client_context
        # raft rides the RPC listener, so raft addr == rpc addr; the
        # live voter map keeps not_leader hints dialable after restarts
        # and membership changes outgrow the boot-time seed
        self.rpc.server_rpc_addrs = dict(voters)
        self.rpc.voters_snapshot = self.server.raft.voters_snapshot
        self._register_endpoints(self.server, self.rpc)
        if self.server.overload is not None:
            ov = self.server.overload

            def _admission_check(method, payload, _ov=ov):
                # priority-aware shedding at the RPC edge: job-carrying
                # payloads classify on the job's own priority, everything
                # else rides the service default. Heartbeats and node
                # registration are exempted by RpcServer.ADMISSION_EXEMPT.
                pri = None
                if isinstance(payload, dict):
                    job = payload.get("job")
                    if isinstance(job, dict):
                        pri = job.get("priority")
                _ov.admit_request(pri)

            self.rpc.admission_check = _admission_check
        self.rpc.start()
        self.server.start(num_workers=num_workers, wait_for_leader=wait_for_leader)

    def stop(self, hard: bool = False):
        """``hard=True`` simulates a crash: the server skips its gossip
        leave broadcast (peers must detect the death), but the listener
        and transport still close — a dead process holds no sockets."""
        if self.server is not None:
            self.server.stop(hard=hard)
        self._transport.close()
        self.rpc.stop()


class ClientAgent:
    """A node agent connected to servers over RPC (ref command/agent client
    mode; server list managed like client/servers/manager.go)."""

    def __init__(
        self,
        servers: list[str],
        data_dir: Optional[str] = None,
        node=None,
        drivers: Optional[dict] = None,
        bind: str = "127.0.0.1",
        advertise: Optional[str] = None,
        tls: Optional[dict] = None,
    ):
        from .client.fs import register_alloc_rpc, register_fs_rpc
        from .rpc import ConnPool, RpcServer, ServerProxy
        from .tlsutil import contexts_from_config

        server_ctx, client_ctx = contexts_from_config(tls or {})
        pool = ConnPool(tls_context=client_ctx) if client_ctx else None
        self.proxy = ServerProxy(servers, pool=pool)
        self.client = Client(
            self.proxy,
            data_dir=data_dir or tempfile.mkdtemp(prefix="nomad_tpu_client_"),
            node=node,
            drivers=drivers,
        )
        # Connect sidecars ride the same cluster identity: with TLS
        # configured, sidecar↔sidecar hops are mutually authenticated
        # (the Consul-CA role the reference delegates)
        self.client.tls_server_context = server_ctx
        self.client.tls_client_context = client_ctx
        # the client's own RPC listener: servers/agents forward alloc
        # fs/logs/exec here (the reverse-streaming path of
        # client_fs_endpoint.go, served as plain RPC). ``bind`` must be a
        # reachable interface (and ``advertise`` the reachable address) in
        # multi-host topologies.
        self.rpc = RpcServer(bind, 0, tls_context=server_ctx)
        register_fs_rpc(self.rpc, self.client)
        register_alloc_rpc(self.rpc, self.client)
        self.client.node.attributes["unique.advertise.client_rpc"] = (
            advertise or self.rpc.address
        )
        from .structs.node_class import compute_class

        compute_class(self.client.node)

    @property
    def node(self):
        return self.client.node

    def start(self):
        self.rpc.start()
        self.client.start()

    def stop(self):
        self.client.stop()
        self.rpc.stop()
        self.proxy.pool.close()
