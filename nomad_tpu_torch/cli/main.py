"""Command-line interface (ref command/commands.go — the ~90-command mitchellh
CLI tree; the operationally-core subset is implemented here, one subcommand
family per reference command file).

The port's copy of ``nomad_tpu/cli/main.py``. ``agent`` takes one flag the
JAX CLI lacks, ``-device`` (default ``cuda``): the server's device tier
runs there, and without a card the agent raises unless given ``-device
cpu``. An agent installs its SIGINT/SIGTERM handlers before it prints its
start line.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time

from ..api.client import APIError, ApiClient

EXAMPLE_JOB = """\
job "example" {
  datacenters = ["dc1"]
  type = "service"

  group "cache" {
    count = 1

    restart {
      attempts = 2
      interval = "30m"
      delay    = "15s"
      mode     = "fail"
    }

    task "redis" {
      driver = "mock_driver"

      config {
        run_for = "3600"
      }

      resources {
        cpu    = 500
        memory = 256
      }
    }
  }
}
"""


def _client(args) -> ApiClient:
    import os as os_mod

    return ApiClient(
        address=args.address,
        namespace=getattr(args, "namespace", "default"),
        token=getattr(args, "token", None)
        or os_mod.environ.get("NOMAD_TOKEN", ""),
    )


def _stop_on_signals() -> list:
    """A list that SIGINT and SIGTERM append to. An agent installs it
    before it prints its start line, so a signal sent right after that
    line stops the agent cleanly instead of killing it."""
    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    return stop


def _wait_for_signals(cleanup, stop):
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        cleanup()
    return 0


def _run_networked_server(args, config: dict):
    """One real cluster member per process (ref command/agent server mode;
    the forked-binary e2e harness spawns three of these)."""
    from ..agent import ServerAgent
    from ..api.http import HTTPServer
    from ..config import server_config_from_agent

    server_stanza = config.get("server", {}) or {}
    name = config.get("name", "server-1")
    server_cfg = server_config_from_agent(config)
    agent = ServerAgent(
        name,
        bind=config.get("bind_addr", "127.0.0.1"),
        port=int(server_stanza.get("rpc_port", 0)),
        data_dir=(config.get("data_dir") or None),
        config=server_cfg,
        device=args.device,
    )
    voters = {str(k): str(v) for k, v in server_stanza["voters"].items()}
    agent.start(
        voters=voters,
        num_workers=int(server_stanza.get("num_schedulers", 2)),
    )
    port = args.port if args.port is not None else int(
        config.get("ports", {}).get("http", 4646)
    )
    http = HTTPServer(agent.server, host=args.bind, port=port)
    http.start()
    from ..client.consul_sync import syncer_from_config
    from ..metrics import configure_telemetry

    telemetry = configure_telemetry(config)
    consul_sync = syncer_from_config(config, agent.server.state.snapshot)
    stop = _stop_on_signals()
    print(
        f"==> nomad-tpu server {name} started: http {http.address} "
        f"rpc {agent.address}", flush=True,
    )

    def cleanup():
        print("==> shutting down", flush=True)
        if consul_sync is not None:
            consul_sync.stop()
        if telemetry is not None:
            telemetry.stop()
        http.stop()
        agent.stop()

    return _wait_for_signals(cleanup, stop)


def _run_networked_client(args, config: dict):
    """A node agent connected to remote servers over RPC (ref command/agent
    client mode)."""
    from ..agent import ClientAgent, apply_client_config

    client_stanza = config.get("client", {}) or {}
    servers = [str(s) for s in client_stanza.get("servers", [])]
    agent = ClientAgent(
        servers,
        data_dir=(config.get("data_dir") or None),
        bind=config.get("bind_addr", "127.0.0.1"),
    )

    # reuse the stanza plumbing (host volumes, meta, plugins, vault)
    class _Shim:
        clients = [agent.client]

    apply_client_config(_Shim, config)
    agent.start()
    stop = _stop_on_signals()
    print(
        f"==> nomad-tpu client started: node {agent.node.id[:8]} "
        f"servers {servers}", flush=True,
    )

    def cleanup():
        print("==> shutting down", flush=True)
        agent.stop()

    return _wait_for_signals(cleanup, stop)


def cmd_agent(args):
    """ref command/agent/command.go: -dev mode, or HCL config files with
    merge semantics and SIGHUP log-level reload."""
    from ..agent import DevAgent
    from ..api.http import HTTPServer
    from ..config import (
        apply_log_level,
        load_agent_config,
        server_config_from_agent,
    )

    config_paths = list(args.config or [])
    if not args.dev and not config_paths:
        print("provide -dev or -config <file>", file=sys.stderr)
        return 1

    config = load_agent_config(config_paths)
    apply_log_level(config)

    # networked modes (the forked-binary topology of testutil/server.go:
    # each `nomad agent` process is one real cluster member):
    #   server { enabled, rpc_port, voters { name = "host:port" } }
    #   client { enabled, servers = ["host:port", ...] }  (no local server)
    server_stanza = config.get("server", {}) or {}
    client_stanza = config.get("client", {}) or {}
    if not args.dev and server_stanza.get("voters"):
        return _run_networked_server(args, config)
    if (
        not args.dev
        and not server_stanza.get("enabled")
        and client_stanza.get("enabled")
        and client_stanza.get("servers")
    ):
        return _run_networked_client(args, config)

    server_cfg = server_config_from_agent(config)
    server_cfg["name"] = config.get("name", "server-1")
    # agents prewarm the planner shape ladder by default (first-eval
    # latency; server.prewarm_kernels=false in the HCL config disables)
    server_cfg.setdefault(
        "prewarm_kernels",
        bool(config.get("server", {}).get("prewarm_kernels", True)),
    )

    num_clients = args.clients
    if (
        not args.dev
        and config_paths
        and not config.get("client", {}).get("enabled", False)
    ):
        num_clients = 0
    agent = DevAgent(
        num_clients=num_clients,
        server_config=server_cfg,
        num_workers=int(config.get("server", {}).get("num_schedulers", 2)),
        device=args.device,
    )
    from ..agent import apply_client_config

    apply_client_config(agent, config)
    agent.start()
    port = args.port if args.port is not None else int(
        config.get("ports", {}).get("http", 4646)
    )
    http = HTTPServer(agent.server, host=args.bind, port=port, agent=agent)
    http.start()
    from ..client.consul_sync import syncer_from_config
    from ..metrics import configure_telemetry

    telemetry = configure_telemetry(config)
    consul_sync = syncer_from_config(config, agent.server.state.snapshot)
    stop = _stop_on_signals()

    def _reload(*_a):
        # SIGHUP: re-read config files, apply the reloadable subset
        try:
            level = apply_log_level(load_agent_config(config_paths))
            print(f"==> config reloaded (log_level={level})")
        except Exception as e:
            print(f"==> config reload failed: {e}", file=sys.stderr)

    signal.signal(signal.SIGHUP, _reload)
    print(f"==> nomad-tpu agent started: {http.address} "
          f"(region {agent.server.region!r})")
    print(f"    clients: {[c.node.id[:8] for c in agent.clients]}")
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        print("==> shutting down")
        if consul_sync is not None:
            consul_sync.stop()
        if telemetry is not None:
            telemetry.stop()
        http.stop()
        agent.stop()
    return 0


def cmd_job_init(args):
    path = args.filename or "example.nomad"
    with open(path, "w") as f:
        f.write(EXAMPLE_JOB)
    print(f"Example job file written to {path}")
    return 0


def cmd_job_run(args):
    from ..jobspec import parse_job

    with open(args.jobfile) as f:
        job = parse_job(f.read())
    client = _client(args)
    resp = client.register_job(job.to_dict())
    eval_id = resp.get("EvalID", "")
    if not eval_id:
        # periodic/parameterized jobs register without a direct evaluation
        kind = "periodic" if job.is_periodic() else "parameterized"
        print(f"==> Registered {kind} job {job.id!r} (no evaluation created)")
        return 0
    print(f"==> Evaluation {eval_id[:8]} created")
    if args.detach:
        return 0
    deadline = time.time() + 30
    while time.time() < deadline:
        ev = client.evaluation(eval_id)
        if ev["status"] in ("complete", "failed", "canceled"):
            print(f"==> Evaluation status: {ev['status']}")
            if ev.get("failed_tg_allocs"):
                for tg, metrics in ev["failed_tg_allocs"].items():
                    print(f"    group {tg}: failed to place "
                          f"({metrics.get('nodes_filtered', 0)} filtered, "
                          f"{metrics.get('nodes_exhausted', 0)} exhausted)")
                return 2
            return 0
        time.sleep(0.2)
    print("==> Timed out waiting for evaluation")
    return 1


def _render_field_diff(d, indent):
    mark = {"Added": "+", "Deleted": "-", "Edited": "~"}.get(d["Type"], " ")
    if d["Type"] == "Edited":
        print(f"{indent}{mark} {d['Name']}: {d['Old']!r} => {d['New']!r}")
    elif d["Type"] == "Added":
        print(f"{indent}{mark} {d['Name']}: {d['New']!r}")
    else:
        print(f"{indent}{mark} {d['Name']}: {d['Old']!r}")


def _render_object_diff(d, indent="  "):
    mark = {"Added": "+", "Deleted": "-", "Edited": "~"}.get(d["Type"], " ")
    print(f"{indent}{mark} {d['Name']}")
    for fd in d.get("Fields", []):
        _render_field_diff(fd, indent + "  ")
    for od in d.get("Objects", []):
        _render_object_diff(od, indent + "  ")


def cmd_job_plan(args):
    """Dry-run a job: structural diff + annotated placement decisions,
    nothing committed (ref command/job_plan.go)."""
    from ..jobspec import parse_job

    with open(args.jobfile) as f:
        job = parse_job(f.read())
    client = _client(args)
    resp = client.plan_job(job.to_dict(), diff=not args.no_diff)

    diff = resp.get("Diff")
    if diff:
        print(f"==> Job: {job.id!r} ({diff['Type']})")
        for fd in diff.get("Fields", []):
            _render_field_diff(fd, "  ")
        for od in diff.get("Objects", []):
            _render_object_diff(od)
        for tg in diff.get("TaskGroups", []):
            mark = {"Added": "+", "Deleted": "-", "Edited": "~"}.get(tg["Type"], " ")
            print(f"{mark} Task Group: {tg['Name']!r}")
            for fd in tg.get("Fields", []):
                _render_field_diff(fd, "    ")
            for od in tg.get("Objects", []):
                _render_object_diff(od, "    ")
            for td in tg.get("Tasks", []):
                tmark = {"Added": "+", "Deleted": "-", "Edited": "~"}.get(td["Type"], " ")
                print(f"    {tmark} Task: {td['Name']!r}")
                for fd in td.get("Fields", []):
                    _render_field_diff(fd, "      ")
                for od in td.get("Objects", []):
                    _render_object_diff(od, "      ")

    annotations = resp.get("Annotations") or {}
    updates = annotations.get("desired_tg_updates") or {}
    if updates:
        print("==> Scheduler dry-run:")
        for tg, u in updates.items():
            parts = []
            for key, label in (
                ("place", "place"),
                ("stop", "stop"),
                ("in_place_update", "in-place update"),
                ("destructive_update", "destructive update"),
                ("migrate", "migrate"),
                ("canary", "canary"),
                ("ignore", "ignore"),
            ):
                if u.get(key):
                    parts.append(f"{u[key]} {label}")
            detail = ", ".join(parts) if parts else "no changes"
            print(f"    group {tg!r}: {detail}")
    failed = resp.get("FailedTGAllocs") or {}
    for tg, metrics in failed.items():
        print(f"    group {tg!r}: WOULD FAIL to place "
              f"({metrics.get('nodes_filtered', 0)} filtered, "
              f"{metrics.get('nodes_exhausted', 0)} exhausted)")
    print(f"==> Job Modify Index: {resp.get('JobModifyIndex', 0)}")
    return 2 if failed else 0


def cmd_job_status(args):
    client = _client(args)
    if not args.job_id:
        jobs = client.jobs()
        if not jobs:
            print("No running jobs")
            return 0
        print(f"{'ID':<30} {'Type':<10} {'Priority':<9} Status")
        for j in jobs:
            print(f"{j['ID']:<30} {j['Type']:<10} {j['Priority']:<9} {j['Status']}")
        return 0
    job = client.job(args.job_id)
    print(f"ID            = {job['id']}")
    print(f"Name          = {job['name']}")
    print(f"Type          = {job['type']}")
    print(f"Priority      = {job['priority']}")
    print(f"Datacenters   = {','.join(job['datacenters'])}")
    print(f"Status        = {job['status']}")
    try:
        summary = client.job_summary(args.job_id)
        print("\nSummary")
        print(f"{'Task Group':<15} {'Queued':<7} {'Starting':<9} {'Running':<8} "
              f"{'Failed':<7} {'Complete':<9} Lost")
        for tg, s in summary["summary"].items():
            print(f"{tg:<15} {s['queued']:<7} {s['starting']:<9} {s['running']:<8} "
                  f"{s['failed']:<7} {s['complete']:<9} {s['lost']}")
    except APIError:
        pass
    # placement failures from the newest eval (ref job_status.go's
    # "Placement Failure" section via the monitor's metric formatter)
    try:
        evals = client.job_evaluations(args.job_id)
        newest_failed = next(
            (
                e
                for e in sorted(
                    evals,
                    key=lambda e: e.get("modify_index", 0),
                    reverse=True,
                )
                if e.get("failed_tg_allocs")
            ),
            None,
        )
        if newest_failed is not None:
            print("\nPlacement Failure")
            _render_alloc_metrics(newest_failed["failed_tg_allocs"])
    except APIError:
        pass
    allocs = client.job_allocations(args.job_id)
    if allocs:
        print("\nAllocations")
        print(f"{'ID':<10} {'Node ID':<10} {'Task Group':<12} {'Desired':<8} Status")
        for a in allocs:
            print(f"{a['ID'][:8]:<10} {a['NodeID'][:8]:<10} "
                  f"{a['TaskGroup']:<12} {a['DesiredStatus']:<8} {a['ClientStatus']}")
    return 0


def cmd_job_stop(args):
    client = _client(args)
    resp = client.deregister_job(args.job_id, purge=args.purge)
    print(f"==> Evaluation {resp.get('EvalID', '')[:8]} created")
    return 0


def cmd_node_status(args):
    client = _client(args)
    if not args.node_id:
        nodes = client.nodes()
        print(f"{'ID':<10} {'DC':<6} {'Name':<16} {'Class':<18} "
              f"{'Drain':<6} {'Eligibility':<12} Status")
        for n in nodes:
            print(f"{n['ID'][:8]:<10} {n['Datacenter']:<6} {n['Name'][:15]:<16} "
                  f"{(n['NodeClass'] or '<none>'):<18} {str(n['Drain']).lower():<6} "
                  f"{n['SchedulingEligibility']:<12} {n['Status']}")
        return 0
    node = client.node(args.node_id)
    print(f"ID          = {node['id']}")
    print(f"Name        = {node['name']}")
    print(f"Datacenter  = {node['datacenter']}")
    print(f"Class       = {node['node_class'] or '<none>'}")
    print(f"Status      = {node['status']}")
    print(f"Drain       = {node['drain']}")
    res = node.get("node_resources") or {}
    if res:
        print(f"Resources   = cpu {res['cpu']['cpu_shares']} MHz, "
              f"mem {res['memory']['memory_mb']} MB, "
              f"disk {res['disk']['disk_mb']} MB")
    allocs = client.node_allocations(node["id"])
    if allocs:
        print("\nAllocations")
        for a in allocs:
            print(f"  {a['ID'][:8]} {a['JobID'][:24]:<26} "
                  f"{a['DesiredStatus']:<8} {a['ClientStatus']}")
    if getattr(args, "stats", False):
        try:
            stats = client.client_stats(node["id"])
        except Exception as e:
            print(f"\nHost Stats  = unavailable ({e})")
            return 0
        mem = stats.get("memory", {})
        disk = stats.get("disk", {})
        cpu = stats.get("cpu", {})
        print("\nHost Stats")
        print(f"  CPU    = {cpu.get('total_percent', 0):.1f}% busy")
        print(f"  Memory = {mem.get('used', 0) // (1 << 20)} MiB used / "
              f"{mem.get('total', 0) // (1 << 20)} MiB")
        print(f"  Disk   = {disk.get('used_percent', 0):.1f}% of "
              f"{disk.get('size', 0) // (1 << 30)} GiB")
        print(f"  Uptime = {stats.get('uptime_s', 0):.0f}s")
    return 0


def cmd_node_drain(args):
    client = _client(args)
    enable = not args.disable
    deadline_ns = 0
    if enable and args.deadline:
        from ..jobspec.hcl import parse_duration as hcl_duration

        deadline_ns = hcl_duration(args.deadline)
    client.drain_node(
        args.node_id,
        enable,
        deadline_ns=deadline_ns,
        ignore_system_jobs=args.ignore_system,
    )
    print(f"Node {args.node_id[:8]} drain {'enabled' if enable else 'disabled'}")
    return 0


def cmd_node_eligibility(args):
    client = _client(args)
    elig = "ineligible" if args.elig_disable else "eligible"
    client.put(f"/v1/node/{args.node_id}/eligibility", body={"Eligibility": elig})
    print(f"Node {args.node_id[:8]} marked {elig}")
    return 0


def cmd_alloc_logs(args):
    """ref command/alloc_logs.go (poll-follow on the offset cursor)"""
    client = _client(args)
    kind = "stderr" if args.stderr else "stdout"
    params = {"task": args.task, "type": kind}
    resp = client.get(f"/v1/client/fs/logs/{args.alloc_id}", **params)[0]
    print(resp.get("Data", ""), end="")
    if args.follow:
        offset = resp.get("Offset", 0)
        try:
            while True:
                time.sleep(1.0)
                resp = client.get(
                    f"/v1/client/fs/logs/{args.alloc_id}",
                    **params,
                    offset=offset,
                )[0]
                if resp.get("Data"):
                    print(resp["Data"], end="", flush=True)
                    offset = resp.get("Offset", offset)
        except KeyboardInterrupt:
            return 0
    return 0


def cmd_alloc_fs(args):
    """ref command/alloc_fs.go: ls a directory, cat a file"""
    client = _client(args)
    path = args.path or "/"
    try:
        entries = client.get(f"/v1/client/fs/ls/{args.alloc_id}", path=path)[0]
        for entry in entries:
            kind = "d" if entry["IsDir"] else "-"
            print(f"{kind} {entry['Size']:>10}  {entry['Name']}")
        return 0
    except APIError:
        resp = client.get(f"/v1/client/fs/cat/{args.alloc_id}", path=path)[0]
        print(resp.get("Data", ""), end="")
        return 0


def cmd_alloc_exec(args):
    """ref command/alloc_exec.go: interactive streaming session with
    -i/-t (websocket → server → client → driver exec-in-context), or the
    legacy one-shot captured exec without."""
    client = _client(args)
    # resolve a short alloc-id prefix to the full id (ref command/meta:
    # every alloc command accepts prefixes)
    alloc_id = client.allocation(args.alloc_id)["id"]
    if not (args.interactive or args.tty):
        resp = client.put(
            f"/v1/client/exec/{alloc_id}",
            body={"Task": args.task, "Cmd": args.cmd},
        )[0]
        if resp.get("Stdout"):
            print(resp["Stdout"], end="")
        if resp.get("Stderr"):
            import sys

            print(resp["Stderr"], end="", file=sys.stderr)
        return resp.get("ExitCode", 0)

    import os
    import sys
    import threading

    session = client.alloc_exec_session(
        alloc_id, args.task, args.cmd, tty=args.tty
    )
    exit_code = [0]
    done = threading.Event()

    raw = False
    if args.tty and sys.stdin.isatty():
        import termios
        import tty as tty_mod

        saved = termios.tcgetattr(sys.stdin.fileno())
        tty_mod.setraw(sys.stdin.fileno())
        raw = True
        try:
            cols, rows = os.get_terminal_size()
            session.resize(rows, cols)
        except OSError:
            pass

    def stdin_pump():
        try:
            while not done.is_set():
                data = os.read(sys.stdin.fileno(), 4096)
                if not data:
                    session.close_stdin()
                    return
                session.send_stdin(data)
        except (OSError, ValueError):
            pass

    t = threading.Thread(
        target=stdin_pump, daemon=True, name="cli-exec-stdin-pump"
    )
    t.start()
    try:
        while True:
            frame = session.recv_frame(timeout=3600)
            if frame is None:
                break
            if frame.get("stdout"):
                sys.stdout.buffer.write(frame["stdout"])
                sys.stdout.flush()
            if frame.get("stderr"):
                sys.stderr.buffer.write(frame["stderr"])
                sys.stderr.flush()
            if frame.get("error"):
                print(frame["error"], file=sys.stderr)
                exit_code[0] = 1
                break
            if frame.get("exited"):
                exit_code[0] = int(frame.get("exit_code", 0))
                break
    finally:
        done.set()
        session.close()
        if raw:
            termios.tcsetattr(
                sys.stdin.fileno(), termios.TCSADRAIN, saved
            )
    return exit_code[0]


def cmd_alloc_status(args):
    client = _client(args)
    alloc = client.allocation(args.alloc_id)
    print(f"ID            = {alloc['id']}")
    print(f"Name          = {alloc['name']}")
    print(f"Node ID       = {alloc['node_id'][:8]}")
    print(f"Job ID        = {alloc['job_id']}")
    print(f"Desired       = {alloc['desired_status']}")
    print(f"Client Status = {alloc['client_status']}")
    states = alloc.get("task_states") or {}
    for task, st in states.items():
        print(f"\nTask \"{task}\": {st['state']}"
              + (" (failed)" if st.get("failed") else ""))
        print(f"  Restarts = {st.get('restarts', 0)}")
    if getattr(args, "stats", False):
        try:
            stats = client.alloc_stats(alloc["id"])
        except Exception as e:
            print(f"\nResource Usage = unavailable ({e})")
            return 0
        print("\nResource Usage")
        for task, usage in sorted(stats.get("tasks", {}).items()):
            print(f"  {task}: cpu {usage.get('cpu_time_s', 0)}s, "
                  f"rss {usage.get('rss_bytes', 0) // (1 << 20)} MiB, "
                  f"pids {usage.get('pids', 0)}")
    return 0


def cmd_alloc_stop(args):
    client = _client(args)
    out = client.alloc_stop(args.alloc_id)
    print(f"Stop requested; eval {out['EvalID']}")
    return 0


def cmd_alloc_restart(args):
    client = _client(args)
    out = client.alloc_restart(args.alloc_id, task=args.task or "")
    print(f"Restarted tasks: {', '.join(out['tasks'])}")
    return 0


def cmd_alloc_signal(args):
    client = _client(args)
    out = client.alloc_signal(
        args.alloc_id, signal=args.signal, task=args.task or ""
    )
    print(f"Signaled tasks: {', '.join(out['tasks'])}")
    return 0


def cmd_eval_status(args):
    client = _client(args)
    ev = client.evaluation(args.eval_id)
    print(f"ID            = {ev['id']}")
    print(f"Type          = {ev['type']}")
    print(f"TriggeredBy   = {ev['triggered_by']}")
    print(f"Job ID        = {ev['job_id']}")
    print(f"Status        = {ev['status']}")
    if ev.get("status_description"):
        print(f"Description   = {ev['status_description']}")
    queued = {k: v for k, v in (ev.get("queued_allocations") or {}).items() if v}
    if queued:
        print(f"Queued        = {queued}")
    _render_alloc_metrics(ev.get("failed_tg_allocs") or {})
    return 0


def _render_alloc_metrics(failed_tg_allocs: dict):
    """Placement failure breakdown (ref command/monitor.go
    formatAllocMetrics: the signature debugging surface)."""
    for tg, metric in failed_tg_allocs.items():
        print(f"\nTask Group {tg!r} (failed to place"
              + (f", {metric['coalesced_failures']} coalesced" if metric.get("coalesced_failures") else "")
              + "):")
        print(f"  Nodes evaluated = {metric.get('nodes_evaluated', 0)}")
        print(f"  Nodes filtered  = {metric.get('nodes_filtered', 0)}")
        print(f"  Nodes exhausted = {metric.get('nodes_exhausted', 0)}")
        for constraint, n in (metric.get("constraint_filtered") or {}).items():
            print(f"  Constraint {constraint!r} filtered {n} nodes")
        for dim, n in (metric.get("dimension_exhausted") or {}).items():
            print(f"  Resource {dim!r} exhausted on {n} nodes")
        for cls, n in (metric.get("class_filtered") or {}).items():
            print(f"  Class {cls!r} filtered {n} nodes")


def cmd_deployment_list(args):
    client = _client(args)
    rows = client.deployments()
    print(f"{'ID':<10} {'Job ID':<24} {'Status':<12} Description")
    for d in rows:
        print(
            f"{d['id'][:8]:<10} {d['job_id'][:22]:<24} "
            f"{d['status']:<12} {d['status_description']}"
        )
    return 0


def cmd_deployment_status(args):
    client = _client(args)
    d = client.deployment(args.deployment_id)
    print(f"ID          = {d['id']}")
    print(f"Job ID      = {d['job_id']}")
    print(f"Job Version = {d['job_version']}")
    print(f"Status      = {d['status']}")
    print(f"Description = {d['status_description']}")
    print()
    print("Deployed")
    print(f"{'Task Group':<12} {'Desired':>8} {'Placed':>8} {'Healthy':>8} {'Unhealthy':>10}")
    for name, s in d.get("task_groups", {}).items():
        print(
            f"{name:<12} {s['desired_total']:>8} {s['placed_allocs']:>8} "
            f"{s['healthy_allocs']:>8} {s['unhealthy_allocs']:>10}"
        )
    return 0


def cmd_deployment_promote(args):
    _client(args).deployment_promote(args.deployment_id, groups=args.group or None)
    print(f"Deployment {args.deployment_id[:8]} promoted")
    return 0


def cmd_deployment_fail(args):
    _client(args).deployment_fail(args.deployment_id)
    print(f"Deployment {args.deployment_id[:8]} marked as failed")
    return 0


def cmd_deployment_pause(args):
    _client(args).deployment_pause(args.deployment_id, not args.resume)
    verb = "resumed" if args.resume else "paused"
    print(f"Deployment {args.deployment_id[:8]} {verb}")
    return 0


def cmd_job_revert(args):
    out = _client(args).job_revert(args.job_id, args.version)
    print(f"Job {args.job_id} reverted to version {args.version}")
    if out.get("EvalID"):
        print(f"Evaluation ID: {out['EvalID']}")
    return 0


def cmd_job_dispatch(args):
    client = _client(args)
    payload = ""
    if args.payload_file:
        with open(args.payload_file) as f:
            payload = f.read()
    meta = {}
    for kv in args.meta or []:
        if "=" not in kv:
            print(f"Error: -meta expects KEY=VALUE, got {kv!r}", file=sys.stderr)
            return 1
        k, v = kv.split("=", 1)
        meta[k] = v
    out = client.job_dispatch(args.job_id, payload=payload, meta=meta)
    print(f"Dispatched Job ID = {out['DispatchedJobID']}")
    print(f"Evaluation ID     = {out['EvalID']}")
    return 0


def cmd_job_periodic_force(args):
    out = _client(args).job_periodic_force(args.job_id)
    print(f"Forced periodic launch: {out['DispatchedJobID']}")
    return 0


def cmd_job_history(args):
    client = _client(args)
    versions = client.job_versions(args.job_id)
    by_version = {v["version"]: v for v in versions}
    for v in versions:
        print(f"Version     = {v['version']}")
        print(f"Stable      = {v['stable']}")
        print(f"Submit Date = {v.get('submit_time', 0)}")
        if getattr(args, "diffs", False) and (v["version"] - 1) in by_version:
            # ref command/job_history.go -p: structural diff vs previous
            from ..structs.diff import job_diff
            from ..structs.model import Job

            prev = Job.from_dict(by_version[v["version"] - 1])
            cur = Job.from_dict(v)
            diff = job_diff(prev, cur)
            if diff and diff.get("Type") != "None":
                print("Diff        =")
                for fd in diff.get("Fields", []):
                    _render_field_diff(fd, "  ")
                for tg in diff.get("TaskGroups", []):
                    if tg["Type"] == "None":
                        continue
                    print(f"  ~ Task Group {tg['Name']!r}")
                    for fd in tg.get("Fields", []):
                        _render_field_diff(fd, "    ")
                    for td in tg.get("Tasks", []):
                        if td["Type"] == "None":
                            continue
                        print(f"    ~ Task {td['Name']!r}")
                        for fd in td.get("Fields", []):
                            _render_field_diff(fd, "      ")
        print()
    return 0


def cmd_job_deployments(args):
    client = _client(args)
    rows = client.job_deployments(args.job_id)
    print(f"{'ID':<10} {'Job Version':>12} {'Status':<12} Description")
    for d in rows:
        print(
            f"{d['id'][:8]:<10} {d['job_version']:>12} {d['status']:<12} "
            f"{d['status_description']}"
        )
    return 0


def cmd_job_validate(args):
    from ..jobspec import parse_job

    client = _client(args)
    with open(args.path) as f:
        job = parse_job(f.read())
    out = client.validate_job(job.to_dict())
    if out.get("ValidationErrors"):
        print("Job validation errors:")
        for e in out["ValidationErrors"]:
            print(f"  * {e}")
        return 1
    print("Job validation successful")
    return 0


def cmd_job_inspect(args):
    import json as json_mod

    client = _client(args)
    print(json_mod.dumps(client.job(args.job_id), indent=2, sort_keys=True))
    return 0


def cmd_job_eval(args):
    client = _client(args)
    out = client.job_evaluate(args.job_id, force_reschedule=args.force_reschedule)
    print(f"Created eval {out['EvalID']}")
    return 0


def cmd_eval_list(args):
    client = _client(args)
    evals = client.evaluations()
    print(f"{'ID':<10} {'Priority':<9} {'Triggered By':<18} {'Job ID':<28} Status")
    for e in evals:
        print(f"{e['id'][:8]:<10} {e['priority']:<9} {e['triggered_by']:<18} "
              f"{e['job_id'][:26]:<28} {e['status']}")
    return 0


def cmd_acl(args):
    client = _client(args)
    sub = args.acl_cmd
    if sub == "bootstrap":
        t = client.acl_bootstrap()
        print(f"Accessor ID = {t['AccessorID']}")
        print(f"Secret ID   = {t['SecretID']}")
        print(f"Type        = {t['Type']}")
        return 0
    if sub == "policy-apply":
        with open(args.path) as f:
            rules = f.read()
        client.acl_put_policy(args.name, rules, description=args.description or "")
        print(f"Successfully wrote {args.name!r} ACL policy")
        return 0
    if sub == "policy-list":
        for p in client.acl_policies():
            print(f"{p['Name']:<24} {p.get('Description', '')}")
        return 0
    if sub == "policy-info":
        p = client.acl_policy(args.name)
        print(f"Name        = {p['Name']}")
        print(f"Description = {p['Description']}")
        print("Rules:")
        print(p["Rules"])
        return 0
    if sub == "policy-delete":
        client.acl_delete_policy(args.name)
        print(f"Deleted policy {args.name!r}")
        return 0
    if sub == "token-create":
        t = client.acl_create_token(
            name=args.name or "",
            type=args.type,
            policies=args.policy or [],
            global_token=args.global_token,
        )
        print(f"Accessor ID = {t['AccessorID']}")
        print(f"Secret ID   = {t['SecretID']}")
        print(f"Type        = {t['Type']}")
        print(f"Policies    = {t['Policies']}")
        return 0
    if sub == "token-list":
        for t in client.acl_tokens():
            print(f"{t['AccessorID'][:8]:<10} {t['Type']:<12} "
                  f"{t['Name'] or '<none>':<24} {','.join(t['Policies'])}")
        return 0
    if sub == "token-info":
        t = client.acl_token(args.accessor)
        print(f"Accessor ID = {t['AccessorID']}")
        print(f"Name        = {t['Name']}")
        print(f"Type        = {t['Type']}")
        print(f"Policies    = {t['Policies']}")
        return 0
    if sub == "token-self":
        t = client.acl_token_self()
        print(f"Accessor ID = {t['AccessorID']}")
        print(f"Type        = {t['Type']}")
        print(f"Policies    = {t['Policies']}")
        return 0
    if sub == "token-delete":
        client.acl_delete_token(args.accessor)
        print(f"Deleted token {args.accessor[:8]}")
        return 0
    print(f"unknown acl subcommand: {sub}")
    return 1


def cmd_operator_raft_list(args):
    client = _client(args)
    cfg = client.raft_configuration()
    print(f"{'Node':<16} {'ID':<16} {'Address':<24} {'Leader':<7} Voter")
    for s in cfg["Servers"]:
        print(f"{s['Node']:<16} {s['ID']:<16} {s['Address']:<24} "
              f"{str(s['Leader']).lower():<7} {str(s['Voter']).lower()}")
    return 0


def cmd_operator_raft_remove(args):
    client = _client(args)
    client.raft_remove_peer(args.peer_id)
    print(f"Removed peer {args.peer_id}")
    return 0


def cmd_operator_autopilot_get(args):
    client = _client(args)
    for k, v in sorted(client.autopilot_configuration().items()):
        print(f"{k} = {v}")
    return 0


def cmd_operator_autopilot_set(args):
    client = _client(args)
    overrides = {}
    if args.cleanup_dead_servers is not None:
        overrides["cleanup_dead_servers"] = args.cleanup_dead_servers == "true"
    if args.last_contact_threshold is not None:
        overrides["last_contact_threshold_s"] = float(args.last_contact_threshold)
    if args.max_trailing_logs is not None:
        overrides["max_trailing_logs"] = int(args.max_trailing_logs)
    client.autopilot_set_configuration(overrides)
    print("Configuration updated!")
    return 0


def cmd_operator_debug(args):
    """Capture a debug bundle from the running agent (ref `nomad
    operator debug`): profiles, flight-recorder dump, slowest traces,
    metrics, redacted config — one tarball for the support ticket.
    Requires enable_debug on the agent."""
    client = _client(args)
    output = args.output or time.strftime(
        "nomad-tpu-debug-%Y%m%d-%H%M%S.tar.gz"
    )
    data = client.debug_bundle(seconds=args.seconds, output=output)
    # print the findings headline from the bundle itself, so the
    # operator sees the verdict without unpacking anything
    try:
        import io
        import tarfile

        with tarfile.open(fileobj=io.BytesIO(data)) as tar:
            member = next(
                mem for mem in tar.getmembers()
                if mem.name.endswith("findings.json")
            )
            summary = json.loads(tar.extractfile(member).read())
        frac = summary.get("applier_block_frac")
        if frac is not None:
            print(f"applier_block_frac = {frac}")
        for row in (summary.get("top_blocked_sites") or [])[:3]:
            print(
                f"blocked {row['class']:<9} {row['site']:<40} "
                f"share={row['share']}"
            )
    except Exception:
        pass  # the bundle itself is the deliverable
    print(f"Debug bundle written to {output}")
    return 0


def cmd_operator_device(args):
    """Print the live server's device-plane numbers (`operator
    device`): compile ledger top-N, collective_rounds_per_placement —
    the ROADMAP item 2 knee as one number off a running cluster — and
    the h2d/d2h transfer totals. Reads /v1/metrics' tpu_devprof key via
    ApiClient.device_stats; -json dumps the raw payload."""
    from ..debug import devprof

    payload = _client(args).device_stats()
    if not payload:
        print("device plane dark (devprof disabled or no TPU dispatches)")
        return 0
    if args.as_json:
        print(json.dumps(payload, indent=1))
        return 0
    print(devprof.format_report(payload, top=args.top))
    return 0


def cmd_operator_keygen(args):
    from ..gossip.keyring import generate_key

    print(generate_key())
    return 0


def cmd_operator_keyring(args):
    client = _client(args)
    if args.install:
        out = client.put("/v1/agent/keyring/install", body={"Key": args.install})[0]
    elif args.use:
        out = client.put("/v1/agent/keyring/use", body={"Key": args.use})[0]
    elif args.remove:
        out = client.put("/v1/agent/keyring/remove", body={"Key": args.remove})[0]
    else:
        out = client.put("/v1/agent/keyring/list")[0]
    print(f"Primary: {out['PrimaryKey'][:12]}…")
    for k in out["Keys"]:
        print(f"  {k[:12]}…")
    return 0


def cmd_system_gc(args):
    _client(args).system_gc()
    print("System GC triggered")
    return 0


def cmd_system_reconcile(args):
    _client(args).reconcile_summaries()
    print("Job summaries reconciled")
    return 0


def cmd_server_join(args):
    client = _client(args)
    out = client.agent_join(args.address)
    print(f"Joined {out['num_joined']} servers successfully")
    return 0


def cmd_server_force_leave(args):
    client = _client(args)
    client.agent_force_leave(args.node)
    print(f"Force-leave issued for {args.node}")
    return 0


def cmd_monitor(args):
    import time as time_mod

    client = _client(args)
    index = 0
    try:
        while True:
            out = client.agent_monitor(index=index, log_level=args.log_level or "")
            for e in out["Entries"]:
                print(e["message"])
            index = out["Index"]
            if not args.follow:
                return 0
            time_mod.sleep(1.0)
    except KeyboardInterrupt:
        return 0


def cmd_event_stream(args):
    """Follow the cluster event stream (ref command/event/stream.go
    `nomad event stream`): one JSON object per line, or a compact
    human-readable line with -short."""
    import time as time_mod

    client = _client(args)
    index = args.index or 0
    delay = 1.0
    # WHY: one interactive stream, reconnect paced at human timescale —
    # a budget here would only mute the operator's terminal mid-incident
    while True:  # nta: ignore[retry-without-budget]
        try:
            stream = client.event_stream(
                topics=args.topic or None,
                index=index,
                namespace=args.namespace,
            )
        except KeyboardInterrupt:
            return 0
        except Exception as e:
            # connection refused / reset: exactly what -reconnect is for
            if not args.reconnect:
                raise
            print(
                f"stream dial failed: {e}; retrying in {delay:.0f}s",
                file=sys.stderr,
            )
            try:
                time_mod.sleep(delay)
            except KeyboardInterrupt:
                return 0
            delay = min(delay * 2, 15.0)
            continue
        delay = 1.0
        try:
            for frame in stream:
                if frame.get("Error"):
                    # resume from OUR last consumed index (exactly-once);
                    # the server's ResumeIndex is only a floor for a
                    # consumer that never received anything — resuming
                    # below it would just re-print delivered events
                    index = (
                        stream.last_index
                        or frame.get("ResumeIndex", 0)
                        or index
                    )
                    print(
                        f"stream closed: {frame['Error']} "
                        f"(resuming from index {index})",
                        file=sys.stderr,
                    )
                    break
                if frame.get("LostGap"):
                    print(
                        f"[gap] events through index {frame.get('Index', 0)} "
                        "were dropped before this subscriber read them",
                        file=sys.stderr,
                    )
                    continue
                if args.short:
                    for e in frame.get("Events", []):
                        key = e.get("Key", "")
                        print(
                            f"{e.get('Index', 0):>8}  "
                            f"{e.get('Topic', ''):<11} "
                            f"{e.get('Type', ''):<28} {key[:36]}"
                        )
                else:
                    print(json.dumps(frame))
                sys.stdout.flush()
                index = stream.last_index or index
        except KeyboardInterrupt:
            stream.close()
            return 0
        if not args.reconnect:
            return 0
        try:
            time_mod.sleep(1.0)  # never hot-loop re-dials on instant closes
        except KeyboardInterrupt:
            return 0


def cmd_trace_list(args):
    """List retained traces (OBSERVABILITY.md): newest first, or the
    slowest-N / error keeps with -slowest / -errors."""
    client = _client(args)
    out = client.traces(
        limit=args.limit, slowest=args.slowest, errors=args.errors
    )
    stats = out.get("stats", {})
    print(
        f"retained={stats.get('retained', 0)} "
        f"open={stats.get('open', 0)} "
        f"finished={stats.get('finished', 0)} "
        f"sample_rate={stats.get('sample_rate', 1.0)}"
    )
    rows = out.get("traces", [])
    if not rows:
        print("No retained traces")
        return 0
    print(f"{'Trace ID':<34} {'Root':<12} {'Duration':>10} {'Spans':>6}  Err")
    for r in rows:
        dur = r.get("duration_ms")
        print(
            f"{r['trace_id']:<34} {str(r.get('root')):<12} "
            f"{dur if dur is not None else '-':>10} "
            f"{r.get('spans', 0):>6}  {'x' if r.get('error') else ''}"
        )
    return 0


def cmd_trace_get(args):
    """One trace's span tree, indented by parent (or raw JSON)."""
    from ..trace.critical_path import build_tree

    client = _client(args)
    record = client.trace(args.trace_id)
    if args.json:
        print(json.dumps(record, indent=2))
        return 0
    print(
        f"trace {record['trace_id']}  duration="
        f"{record.get('duration_ms')}ms  spans={len(record['spans'])}  "
        f"orphans={record.get('orphans', 0)}"
    )
    roots, children = build_tree(record)
    t_base = min(
        (s.get("start") or 0.0 for s in record["spans"]), default=0.0
    )

    def show(span, depth):
        rel = ((span.get("start") or 0.0) - t_base) * 1e3
        flags = ",".join(span.get("flags") or [])
        err = span.get("error")
        line = (
            f"{'  ' * depth}{span['name']:<{max(28 - 2 * depth, 8)}} "
            f"+{rel:9.2f}ms {span.get('duration_ms', 0):>10.2f}ms"
        )
        if flags:
            line += f"  [{flags}]"
        if err:
            line += f"  ERROR: {err}"
        print(line)
        for child in children.get(span["span_id"], ()):
            show(child, depth + 1)

    for root in sorted(roots, key=lambda s: s.get("start") or 0.0):
        show(root, 0)
    return 0


def cmd_trace_critical_path(args):
    """Aggregate critical-path attribution over the retained traces —
    the per-stage blame table for the eval.e2e tail."""
    from ..trace.critical_path import format_report

    client = _client(args)
    report = client.trace_critical_path(tail=args.tail)
    if args.json:
        print(json.dumps(report, indent=2))
        return 0
    print(format_report(report))
    return 0


def cmd_status(args):
    """Generic prefix dispatch (ref command/status.go): search all
    contexts and show the best match."""
    client = _client(args)
    if not args.prefix:
        args.job_id = None
        return cmd_job_status(args)
    out = client.put(
        "/v1/search", body={"Prefix": args.prefix, "Context": "all"}
    )[0]
    found = False
    for context in ("jobs", "allocs", "nodes", "evals", "deployments"):
        ids = (out.get("matches") or {}).get(context) or []
        if ids:
            found = True
            print(f"{context}: {', '.join(ids[:10])}")
    if not found:
        print(f"No matches found for {args.prefix!r}")
    return 0


def cmd_ui(args):
    addr = args.address or "http://127.0.0.1:4646"
    print(f"Opening Nomad UI: {addr}/ui/")
    return 0


def cmd_server_members(args):
    client = _client(args)
    info = client.agent_self()
    member = info["member"]
    print(f"{'Name':<12} Status")
    print(f"{member['Name']:<12} {member['Status']}")
    return 0


def cmd_agent_info(args):
    client = _client(args)
    print(json.dumps(client.agent_self(), indent=2))
    return 0


def cmd_version(args):
    from .. import __version__

    print(f"nomad-tpu v{__version__}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nomad-tpu")
    p.add_argument("-address", default=None, help="agent HTTP address")
    p.add_argument(
        "-namespace", default="default",
        help="target namespace ('*' lists all authorized namespaces)",
    )
    p.add_argument(
        "-token", default=None,
        help="ACL secret (falls back to $NOMAD_TOKEN)",
    )
    sub = p.add_subparsers(dest="command")

    agent = sub.add_parser("agent", help="run the agent")
    agent.add_argument("-dev", action="store_true")
    agent.add_argument("-bind", default="127.0.0.1")
    agent.add_argument("-port", type=int, default=None)
    agent.add_argument("-clients", type=int, default=1)
    agent.add_argument(
        "-device", default="cuda",
        help="where the server's kernels run: cuda (default) or cpu",
    )
    agent.add_argument(
        "-config", action="append",
        help="HCL agent config file (repeatable; merged in order)",
    )
    agent.set_defaults(fn=cmd_agent)

    job = sub.add_parser("job", help="job commands")
    jsub = job.add_subparsers(dest="subcommand")
    jp = jsub.add_parser("plan", help="dry-run a job: diff + placements")
    jp.add_argument("jobfile")
    jp.add_argument("--no-diff", action="store_true")
    jp.set_defaults(fn=cmd_job_plan)
    jr = jsub.add_parser("run")
    jr.add_argument("jobfile")
    jr.add_argument("-detach", action="store_true")
    jr.set_defaults(fn=cmd_job_run)
    js = jsub.add_parser("status")
    js.add_argument("job_id", nargs="?")
    js.set_defaults(fn=cmd_job_status)
    jst = jsub.add_parser("stop")
    jst.add_argument("job_id")
    jst.add_argument("-purge", action="store_true")
    jst.set_defaults(fn=cmd_job_stop)
    ji = jsub.add_parser("init")
    ji.add_argument("filename", nargs="?")
    ji.set_defaults(fn=cmd_job_init)
    jdp = jsub.add_parser("dispatch")
    jdp.add_argument("job_id")
    jdp.add_argument("payload_file", nargs="?")
    jdp.add_argument("-meta", action="append", metavar="KEY=VALUE")
    jdp.set_defaults(fn=cmd_job_dispatch)
    jpf = jsub.add_parser("periodic")
    jpf_sub = jpf.add_subparsers(dest="periodic_cmd")
    jpff = jpf_sub.add_parser("force")
    jpff.add_argument("job_id")
    jpff.set_defaults(fn=cmd_job_periodic_force)
    jrv = jsub.add_parser("revert")
    jrv.add_argument("job_id")
    jrv.add_argument("version", type=int)
    jrv.set_defaults(fn=cmd_job_revert)
    jh = jsub.add_parser("history")
    jh.add_argument("-p", "--diffs", action="store_true", dest="diffs",
                    help="show structural diffs between versions")
    jh.add_argument("job_id")
    jh.set_defaults(fn=cmd_job_history)
    jd = jsub.add_parser("deployments")
    jd.add_argument("job_id")
    jd.set_defaults(fn=cmd_job_deployments)
    jv = jsub.add_parser("validate", help="validate a jobspec without running it")
    jv.add_argument("path")
    jv.set_defaults(fn=cmd_job_validate)
    jins = jsub.add_parser("inspect", help="dump the registered job as JSON")
    jins.add_argument("job_id")
    jins.set_defaults(fn=cmd_job_inspect)
    jev = jsub.add_parser("eval", help="force a fresh evaluation of a job")
    jev.add_argument("-force-reschedule", "--force-reschedule",
                     action="store_true", dest="force_reschedule")
    jev.add_argument("job_id")
    jev.set_defaults(fn=cmd_job_eval)

    node = sub.add_parser("node", help="node commands")
    nsub = node.add_subparsers(dest="subcommand")
    ns = nsub.add_parser("status")
    ns.add_argument("-stats", "--stats", action="store_true", dest="stats")
    ns.add_argument("node_id", nargs="?")
    ns.set_defaults(fn=cmd_node_status)
    nd = nsub.add_parser("drain")
    nd.add_argument("node_id")
    nd.add_argument("-disable", action="store_true")
    nd.add_argument("-deadline", default="", help='force deadline, e.g. "5m"')
    nd.add_argument("-ignore-system", dest="ignore_system", action="store_true")
    nd.set_defaults(fn=cmd_node_drain)
    ne = nsub.add_parser("eligibility")
    ne.add_argument("node_id")
    ne_group = ne.add_mutually_exclusive_group(required=True)
    ne_group.add_argument("-enable", dest="elig_enable", action="store_true")
    ne_group.add_argument("-disable", dest="elig_disable", action="store_true")
    ne.set_defaults(fn=cmd_node_eligibility)

    alloc = sub.add_parser("alloc", help="allocation commands")
    asub = alloc.add_subparsers(dest="subcommand")
    alog = asub.add_parser("logs", help="task log window (poll-follow)")
    alog.add_argument("alloc_id")
    alog.add_argument("task")
    alog.add_argument("--stderr", action="store_true")
    alog.add_argument("-f", "--follow", action="store_true")
    alog.set_defaults(fn=cmd_alloc_logs)
    afs = asub.add_parser("fs", help="browse the allocation directory")
    afs.add_argument("alloc_id")
    afs.add_argument("path", nargs="?")
    afs.set_defaults(fn=cmd_alloc_fs)
    aex = asub.add_parser(
        "exec", help="run a command in the task's execution context"
    )
    aex.add_argument("alloc_id")
    aex.add_argument("task")
    aex.add_argument("cmd", nargs="+")
    aex.add_argument(
        "-i", "--interactive", action="store_true",
        help="stream stdin to the command (websocket session)",
    )
    aex.add_argument(
        "-t", "--tty", action="store_true",
        help="allocate a pseudo-terminal (implies streaming)",
    )
    aex.set_defaults(fn=cmd_alloc_exec)
    ast = asub.add_parser("status")
    ast.add_argument("alloc_id")
    ast.add_argument("-stats", "--stats", action="store_true", dest="stats")
    ast.set_defaults(fn=cmd_alloc_status)
    astop = asub.add_parser("stop", help="stop and reschedule an allocation")
    astop.add_argument("alloc_id")
    astop.set_defaults(fn=cmd_alloc_stop)
    arst = asub.add_parser("restart", help="restart an allocation's tasks")
    arst.add_argument("alloc_id")
    arst.add_argument("task", nargs="?")
    arst.set_defaults(fn=cmd_alloc_restart)
    asig = asub.add_parser("signal", help="signal an allocation's tasks")
    asig.add_argument("-s", "--signal", default="SIGINT")
    asig.add_argument("alloc_id")
    asig.add_argument("task", nargs="?")
    asig.set_defaults(fn=cmd_alloc_signal)

    ev = sub.add_parser("eval", help="evaluation commands")
    esub = ev.add_subparsers(dest="subcommand")
    est = esub.add_parser("status")
    est.add_argument("eval_id")
    est.set_defaults(fn=cmd_eval_status)

    dep = sub.add_parser("deployment", help="deployment commands")
    dsub = dep.add_subparsers(dest="subcommand")
    dl = dsub.add_parser("list")
    dl.set_defaults(fn=cmd_deployment_list)
    dst = dsub.add_parser("status")
    dst.add_argument("deployment_id")
    dst.set_defaults(fn=cmd_deployment_status)
    dp = dsub.add_parser("promote")
    dp.add_argument("deployment_id")
    dp.add_argument("-group", action="append")
    dp.set_defaults(fn=cmd_deployment_promote)
    df = dsub.add_parser("fail")
    df.add_argument("deployment_id")
    df.set_defaults(fn=cmd_deployment_fail)
    dpa = dsub.add_parser("pause")
    dpa.add_argument("deployment_id")
    dpa.add_argument("-resume", action="store_true")
    dpa.set_defaults(fn=cmd_deployment_pause)

    server = sub.add_parser("server", help="server commands")
    ssub = server.add_subparsers(dest="subcommand")
    sm = ssub.add_parser("members")
    sm.set_defaults(fn=cmd_server_members)
    sj = ssub.add_parser("join", help="join this server to a gossip peer")
    sj.add_argument("address")
    sj.set_defaults(fn=cmd_server_join)
    sfl = ssub.add_parser("force-leave", help="force a failed server out")
    sfl.add_argument("node")
    sfl.set_defaults(fn=cmd_server_force_leave)

    ev2 = esub.add_parser("list")
    ev2.set_defaults(fn=cmd_eval_list)

    acl = sub.add_parser("acl", help="ACL policies and tokens")
    aclsub = acl.add_subparsers(dest="acl_group")
    ab = aclsub.add_parser("bootstrap")
    ab.set_defaults(fn=cmd_acl, acl_cmd="bootstrap")
    apol = aclsub.add_parser("policy")
    apolsub = apol.add_subparsers(dest="acl_policy_cmd")
    apa = apolsub.add_parser("apply")
    apa.add_argument("-description", "--description")
    apa.add_argument("name")
    apa.add_argument("path")
    apa.set_defaults(fn=cmd_acl, acl_cmd="policy-apply")
    apl = apolsub.add_parser("list")
    apl.set_defaults(fn=cmd_acl, acl_cmd="policy-list")
    api_ = apolsub.add_parser("info")
    api_.add_argument("name")
    api_.set_defaults(fn=cmd_acl, acl_cmd="policy-info")
    apd = apolsub.add_parser("delete")
    apd.add_argument("name")
    apd.set_defaults(fn=cmd_acl, acl_cmd="policy-delete")
    atok = aclsub.add_parser("token")
    atoksub = atok.add_subparsers(dest="acl_token_cmd")
    atc = atoksub.add_parser("create")
    atc.add_argument("-name", "--name")
    atc.add_argument("-type", "--type", default="client")
    atc.add_argument("-policy", "--policy", action="append")
    atc.add_argument("-global", "--global", action="store_true",
                     dest="global_token")
    atc.set_defaults(fn=cmd_acl, acl_cmd="token-create")
    atl = atoksub.add_parser("list")
    atl.set_defaults(fn=cmd_acl, acl_cmd="token-list")
    ati = atoksub.add_parser("info")
    ati.add_argument("accessor")
    ati.set_defaults(fn=cmd_acl, acl_cmd="token-info")
    ats = atoksub.add_parser("self")
    ats.set_defaults(fn=cmd_acl, acl_cmd="token-self")
    atd = atoksub.add_parser("delete")
    atd.add_argument("accessor")
    atd.set_defaults(fn=cmd_acl, acl_cmd="token-delete")

    op = sub.add_parser("operator", help="cluster operator commands")
    opsub = op.add_subparsers(dest="operator_group")
    opraft = opsub.add_parser("raft")
    opraftsub = opraft.add_subparsers(dest="raft_cmd")
    orl = opraftsub.add_parser("list-peers")
    orl.set_defaults(fn=cmd_operator_raft_list)
    orr = opraftsub.add_parser("remove-peer")
    orr.add_argument("peer_id")
    orr.set_defaults(fn=cmd_operator_raft_remove)
    odbg = opsub.add_parser(
        "debug", help="capture a debug bundle from the agent"
    )
    odbg.add_argument(
        "-seconds", type=float, default=2.0,
        help="sampling-profiler duration inside the bundle (default 2s)",
    )
    odbg.add_argument(
        "-output", default=None,
        help="tarball path (default nomad-tpu-debug-<timestamp>.tar.gz)",
    )
    odbg.set_defaults(fn=cmd_operator_debug)
    odev = opsub.add_parser(
        "device",
        help="device-plane stats: compile ledger, collective rounds, "
        "transfer totals (debug/devprof.py)",
    )
    odev.add_argument(
        "-top", type=int, default=8,
        help="compile-ledger rows to print (default 8)",
    )
    odev.add_argument(
        "-json", action="store_true", dest="as_json",
        help="dump the raw tpu_devprof payload",
    )
    odev.set_defaults(fn=cmd_operator_device)
    okg = opsub.add_parser("keygen", help="generate a gossip encryption key")
    okg.set_defaults(fn=cmd_operator_keygen)
    okr = opsub.add_parser("keyring", help="manage the gossip keyring")
    okr.add_argument("-install", "--install")
    okr.add_argument("-use", "--use")
    okr.add_argument("-remove", "--remove")
    okr.set_defaults(fn=cmd_operator_keyring)
    opap = opsub.add_parser("autopilot")
    opapsub = opap.add_subparsers(dest="autopilot_cmd")
    oag = opapsub.add_parser("get-config")
    oag.set_defaults(fn=cmd_operator_autopilot_get)
    oas = opapsub.add_parser("set-config")
    oas.add_argument("-cleanup-dead-servers", "--cleanup-dead-servers",
                     dest="cleanup_dead_servers", choices=["true", "false"])
    oas.add_argument("-last-contact-threshold", "--last-contact-threshold",
                     dest="last_contact_threshold")
    oas.add_argument("-max-trailing-logs", "--max-trailing-logs",
                     dest="max_trailing_logs")
    oas.set_defaults(fn=cmd_operator_autopilot_set)

    system = sub.add_parser("system", help="system maintenance")
    syssub = system.add_subparsers(dest="system_cmd")
    sgc = syssub.add_parser("gc")
    sgc.set_defaults(fn=cmd_system_gc)
    srec = syssub.add_parser("reconcile")
    srecsub = srec.add_subparsers(dest="reconcile_cmd")
    srs = srecsub.add_parser("summaries")
    srs.set_defaults(fn=cmd_system_reconcile)

    event = sub.add_parser("event", help="cluster event stream")
    evsub = event.add_subparsers(dest="subcommand")
    evs = evsub.add_parser(
        "stream", help="follow /v1/event/stream (NDJSON frames)"
    )
    evs.add_argument(
        "-topic", action="append",
        help='topic filter, "Topic" or "Topic:key" (repeatable; default all)',
    )
    evs.add_argument(
        "-index", type=int, default=0,
        help="resume after this raft index (exclusive)",
    )
    evs.add_argument(
        "-short", action="store_true",
        help="one compact line per event instead of raw JSON frames",
    )
    evs.add_argument(
        "-reconnect", action="store_true",
        help="auto-reconnect from the last index when the stream closes",
    )
    evs.set_defaults(fn=cmd_event_stream)

    tr = sub.add_parser("trace", help="eval span trees + critical path")
    trsub = tr.add_subparsers(dest="subcommand")
    trl = trsub.add_parser("list", help="retained traces")
    trl.add_argument("-limit", type=int, default=25)
    trl.add_argument(
        "-slowest", action="store_true", help="the slowest-N tail keep"
    )
    trl.add_argument(
        "-errors", action="store_true", help="the error/fault keep"
    )
    trl.set_defaults(fn=cmd_trace_list)
    trg = trsub.add_parser("get", help="one trace's span tree")
    trg.add_argument("trace_id")
    trg.add_argument("-json", action="store_true")
    trg.set_defaults(fn=cmd_trace_get)
    trc = trsub.add_parser(
        "critical-path",
        help="per-stage attribution of the eval.e2e tail",
    )
    trc.add_argument(
        "-tail", type=float, default=0.99,
        help="tail quantile to attribute (default 0.99)",
    )
    trc.add_argument("-json", action="store_true")
    trc.set_defaults(fn=cmd_trace_critical_path)

    mon = sub.add_parser("monitor", help="stream agent logs")
    mon.add_argument("-log-level", "--log-level", dest="log_level")
    mon.add_argument("-f", "--follow", action="store_true")
    mon.set_defaults(fn=cmd_monitor)

    st = sub.add_parser("status", help="status of any prefix (job/alloc/node/eval)")
    st.add_argument("prefix", nargs="?")
    st.set_defaults(fn=cmd_status)

    uip = sub.add_parser("ui", help="print the web UI address")
    uip.set_defaults(fn=cmd_ui)

    ai = sub.add_parser("agent-info")
    ai.set_defaults(fn=cmd_agent_info)

    ver = sub.add_parser("version")
    ver.set_defaults(fn=cmd_version)
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    fn = getattr(args, "fn", None)
    if fn is None:
        parser.print_help()
        return 1
    try:
        return fn(args)
    except BrokenPipeError:
        # `nomad ... | head` closed our stdout: normal unix behavior,
        # not an error worth reporting
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0
    except APIError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except FileNotFoundError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except Exception as e:  # jobspec parse errors, connection refused, ...
        print(f"Error: {type(e).__name__}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
