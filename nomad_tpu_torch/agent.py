"""Agents: the processes that run servers and node clients
(ref command/agent/agent.go — an Agent embeds a Server and/or Client).

``DevAgent`` is the -dev mode: server + in-process clients, no network.
``ServerAgent`` runs a server with a real RPC listener (raft + endpoint
protocols muxed on one port, ref nomad/rpc.go); ``ClientAgent`` runs a
node agent that talks to servers over RPC via ServerProxy.

The port's copy of ``nomad_tpu/agent.py``. ``DevAgent`` and
``ServerAgent`` take ``device`` and hand it to their ``Server``: CUDA
unless the caller passes ``"cpu"``, and without a card they raise. The
node client is not ported (ROADMAP queue A, the client and its drivers):
``DevAgent`` runs with ``num_clients=0``, and asking for clients, a
``ClientAgent`` or a ``plugin`` stanza raises naming that item.
"""

from __future__ import annotations

import os
from typing import Optional

from . import resolve_device
from .core import Server
from .core.server import _not_ported

_CLIENT_ITEM = "the client and its drivers"


class DevAgent:
    """Single-process cluster for development, tests, and the CLI dev mode."""

    def __init__(
        self,
        num_clients: int = 1,
        server_config: Optional[dict] = None,
        num_workers: int = 2,
        device=None,
    ):
        if num_clients:
            raise _not_ported(f"DevAgent with {num_clients} in-process client(s)", _CLIENT_ITEM)
        config = {"heartbeat_ttl": 3.0}
        config.update(server_config or {})
        self.server = Server(config, device=device)
        self.num_workers = num_workers
        self.clients: list = []

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
    # plugin "name" { ... } stanzas load driver and device plugins into
    # the clients, which the port does not have
    if config.get("plugin"):
        raise _not_ported("the plugin stanza", _CLIENT_ITEM)
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
    mode): the node client is not in the port yet."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("the client agent", _CLIENT_ITEM)
