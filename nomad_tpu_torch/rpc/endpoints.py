"""Wires a core.Server's endpoint surface onto an RpcServer
(ref nomad/server.go:1019-1073 endpoint registry + nomad/*_endpoint.go).

Handlers decode plain msgpack payloads into model objects, call the
server method (which may raise NotLeaderError — answered with a leader
hint for client-side forwarding), and encode plain results.
"""

from __future__ import annotations

from ..structs.model import Allocation, Job, Node


def register_endpoints(server, rpc) -> None:
    """server: core.Server; rpc: RpcServer"""

    # ------------------------------------------------------------- Job
    def job_register(p):
        return server.job_register(Job.from_dict(p["job"]))

    def job_deregister(p):
        return server.job_deregister(
            p["namespace"], p["job_id"], purge=p.get("purge", False)
        )

    rpc.register("Job.Register", job_register)
    rpc.register("Job.Deregister", job_deregister)

    # ------------------------------------------------------------ Node
    def node_register(p):
        return server.node_register(Node.from_dict(p["node"]))

    def node_update_status(p):
        if p.get("heartbeat"):
            return server.node_heartbeat(p["node_id"])
        return server.node_update_status(p["node_id"], p["status"])

    def node_drain(p):
        server.node_drain(
            p["node_id"],
            p["drain"],
            deadline_ns=p.get("deadline_ns", 0),
            ignore_system_jobs=p.get("ignore_system_jobs", False),
            mark_eligible=p.get("mark_eligible"),
        )
        return {}

    def node_eligibility(p):
        server.node_update_eligibility(p["node_id"], p["eligibility"])
        return {}

    def node_deregister(p):
        server.node_deregister(p["node_id"])
        return {}

    def node_get_client_allocs(p):
        allocs, index = server.get_client_allocs(
            p["node_id"],
            min_index=p.get("min_index", 0),
            timeout=min(p.get("timeout", 30.0), 300.0),
        )
        return {"allocs": [a.to_dict() for a in allocs], "index": index}

    def node_update_alloc(p):
        server.update_allocs([Allocation.from_dict(d) for d in p["allocs"]])
        return {}

    rpc.register("Node.Register", node_register)

    def node_derive_vault_token(payload):
        return server.derive_vault_token(payload["alloc_id"], payload["task"])

    rpc.register("Node.DeriveVaultToken", node_derive_vault_token)
    rpc.register("Node.UpdateStatus", node_update_status)
    rpc.register("Node.Drain", node_drain)
    rpc.register("Node.Eligibility", node_eligibility)
    rpc.register("Node.Deregister", node_deregister)
    rpc.register("Node.GetClientAllocs", node_get_client_allocs)
    rpc.register("Node.UpdateAlloc", node_update_alloc)

    # ------------------------------------------------------------ Eval
    def eval_dequeue(p):
        ev, token = server.eval_dequeue(
            p["schedulers"], timeout=min(p.get("timeout", 1.0), 10.0)
        )
        return {"eval": ev.to_dict() if ev is not None else None, "token": token}

    rpc.register("Eval.Dequeue", eval_dequeue)
    rpc.register("Eval.Ack", lambda p: server.eval_ack(p["eval_id"], p["token"]) or {})
    rpc.register("Eval.Nack", lambda p: server.eval_nack(p["eval_id"], p["token"]) or {})

    # ---------------------------------------------------------- Status
    rpc.register(
        "Alloc.GetAlloc", lambda p: {"alloc": server.alloc_get(p["alloc_id"])}
    )
    rpc.register(
        "Catalog.Service",
        lambda p: {"entries": server.catalog_service(p["name"])},
    )
    rpc.register(
        "ClientFS.Forward",
        lambda p: server.forward_client_fs(
            p["alloc_id"], p["method"], p.get("params") or {}
        ),
    )

    def exec_forward(payload, stream):
        """Server hop of the interactive exec path: open the duplex stream
        to the hosting node's client and pump frames both ways until
        either side ends (the agent→server→client forwarding of the
        reference's alloc exec)."""
        import threading as _threading

        from .mux import StreamClosed, StreamError

        client_stream = server.open_client_exec(
            payload["alloc_id"],
            {
                "task": payload.get("task", ""),
                "cmd": payload.get("cmd", []),
                "tty": payload.get("tty", False),
            },
        )

        def pump(src, dst):
            try:
                for frame in src:
                    dst.send(frame)
                dst.close()
            except StreamError as e:
                # the node ended with a typed error (task not found, ...):
                # relay it verbatim instead of degrading to "internal"
                src.close()
                dst.close(e.error)
            except (StreamClosed, TimeoutError, OSError):
                # either side dropped mid-bridge (peer disconnect or pool
                # teardown) — close both directions and stop quietly
                src.close()
                dst.close()

        up = _threading.Thread(
            target=pump, args=(stream, client_stream), daemon=True,
            name="rpc-stream-bridge",
        )
        up.start()
        pump(client_stream, stream)
        up.join(timeout=5.0)

    rpc.register_duplex("ClientAllocations.ExecForward", exec_forward)

    rpc.register("Status.Ping", lambda p: {"ok": True})
    rpc.register(
        "Status.Leader",
        lambda p: {
            "leader_id": server.raft.leader_id,
            "leader_rpc_addr": rpc.server_rpc_addrs.get(server.raft.leader_id),
            "is_leader": server.is_leader(),
        },
    )
    rpc.register(
        "Status.Peers",
        lambda p: {"peers": dict(server.raft.voters)},
    )
    rpc.register("Status.RaftStats", lambda p: server.raft.stats())
    # the peer-HTTP-address lookup behind follower→leader forwarding
    # (ref nomad/rpc.go:280-340 forward(): the reference forwards over the
    # server RPC tier; our HTTP proxy layer resolves the leader's HTTP
    # address over that same tier so forwarding needs no gossip/config)
    rpc.register(
        "Status.HTTPAddr",
        lambda p: {"http_addr": server.http_advertise_addr},
    )
