"""Jobspec: HCL → Job model (ref jobspec/parse.go:27 and the per-stanza
parse_*.go files)."""

from __future__ import annotations

from typing import Any, Optional

from ..structs.model import (
    Affinity,
    Constraint,
    DispatchPayloadConfig,
    EphemeralDisk,
    Job,
    LogConfig,
    MigrateStrategy,
    NetworkResource,
    ParameterizedJobConfig,
    PeriodicConfig,
    Port,
    ReschedulePolicy,
    Resources,
    RestartPolicy,
    RequestedDevice,
    CheckRestart,
    ConsulConnect,
    ConsulProxy,
    ConsulSidecarService,
    ConsulUpstream,
    Service,
    ServiceCheck,
    Spread,
    SpreadTarget,
    Task,
    TaskArtifact,
    TaskGroup,
    Template,
    UpdateStrategy,
    Vault,
    VolumeMount,
    VolumeRequest,
)
from .hcl import HCLError, parse as hcl_parse, parse_duration


def _listify(v) -> list:
    if v is None:
        return []
    if isinstance(v, list):
        return v
    return [v]


def _labeled_blocks(v) -> list[tuple[str, dict]]:
    """A labeled-block family parsed as {label: body} or the HCL1 list form."""
    out = []
    if v is None:
        return out
    if isinstance(v, dict):
        for label, body in v.items():
            for b in _listify(body):
                out.append((label, b))
    elif isinstance(v, list):
        for item in v:
            out.extend(_labeled_blocks(item))
    return out


def parse_constraint(d: dict) -> Constraint:
    """ref jobspec/parse.go parseConstraints: 'attribute' is LTarget,
    'value' RTarget; operator shorthands map to operands."""
    operand = d.get("operator", "=")
    l_target = d.get("attribute", "")
    r_target = str(d.get("value", "")) if d.get("value") is not None else ""
    for shorthand in (
        "version", "regexp", "distinct_hosts", "distinct_property",
        "set_contains", "set_contains_any",
    ):
        if shorthand in d:
            operand = shorthand
            val = d[shorthand]
            if shorthand in ("distinct_hosts",):
                if not val:
                    operand = "="
            else:
                r_target = str(val)
    return Constraint(l_target=l_target, r_target=r_target, operand=operand)


def parse_affinity(d: dict) -> Affinity:
    c = parse_constraint(d)
    return Affinity(
        l_target=c.l_target,
        r_target=c.r_target,
        operand=c.operand,
        weight=int(d.get("weight", 50)),
    )


def parse_spread(d: dict) -> Spread:
    targets = []
    for label, body in _labeled_blocks(d.get("target")):
        targets.append(
            SpreadTarget(value=label, percent=int(body.get("percent", 0)))
        )
    return Spread(
        attribute=d.get("attribute", ""),
        weight=int(d.get("weight", 50)),
        spread_target=targets,
    )


def parse_update(d: dict) -> UpdateStrategy:
    return UpdateStrategy(
        stagger=parse_duration(d.get("stagger", 0)),
        max_parallel=int(d.get("max_parallel", 1)),
        health_check=d.get("health_check", "checks"),
        min_healthy_time=parse_duration(d.get("min_healthy_time", "10s")),
        healthy_deadline=parse_duration(d.get("healthy_deadline", "5m")),
        progress_deadline=parse_duration(d.get("progress_deadline", "10m")),
        auto_revert=bool(d.get("auto_revert", False)),
        auto_promote=bool(d.get("auto_promote", False)),
        canary=int(d.get("canary", 0)),
    )


def parse_network(d: dict) -> NetworkResource:
    net = NetworkResource(mbits=int(d.get("mbits", 10)), mode=d.get("mode", ""))
    for label, body in _labeled_blocks(d.get("port")):
        port = Port(label=label)
        if "static" in body:
            port.value = int(body["static"])
            net.reserved_ports.append(port)
        else:
            port.to = int(body.get("to", 0))
            net.dynamic_ports.append(port)
    return net


def parse_resources(d: dict) -> Resources:
    res = Resources(
        cpu=int(d.get("cpu", 100)),
        memory_mb=int(d.get("memory", 300)),
    )
    if "network" in d:
        for body in _listify(d["network"]):
            res.networks.append(parse_network(body))
    for label, body in _labeled_blocks(d.get("device")):
        res.devices.append(
            RequestedDevice(
                name=label,
                count=int(body.get("count", 1)),
                constraints=[
                    parse_constraint(c) for c in _listify(body.get("constraint"))
                ],
                affinities=[
                    parse_affinity(a) for a in _listify(body.get("affinity"))
                ],
            )
        )
    return res


def parse_service(name_default: str, d: dict) -> Service:
    svc = Service(
        name=d.get("name", name_default),
        port_label=str(d.get("port", "")),
        tags=[str(t) for t in _listify(d.get("tags"))],
        canary_tags=[str(t) for t in _listify(d.get("canary_tags"))],
    )
    for body in _listify(d.get("check")):
        check = ServiceCheck(
            name=body.get("name", ""),
            type=body.get("type", ""),
            command=body.get("command", ""),
            args=[str(a) for a in _listify(body.get("args"))],
            path=body.get("path", ""),
            protocol=body.get("protocol", ""),
            port_label=str(body.get("port", "")),
            interval=parse_duration(body.get("interval", 0)),
            timeout=parse_duration(body.get("timeout", 0)),
        )
        for cr in _listify(body.get("check_restart")):
            cr = cr or {}
            check.check_restart = CheckRestart(
                limit=int(cr.get("limit", 0)),
                grace=parse_duration(cr.get("grace", 0)),
            )
        svc.checks.append(check)
    for body in _listify(d.get("connect")):
        connect = ConsulConnect()
        for sidecar in _listify(body.get("sidecar_service")):
            sidecar = sidecar or {}
            proxy = None
            for pbody in _listify(sidecar.get("proxy")):
                pbody = pbody or {}
                proxy = ConsulProxy(
                    upstreams=[
                        ConsulUpstream(
                            destination_name=u.get("destination_name", ""),
                            local_bind_port=int(u.get("local_bind_port", 0)),
                        )
                        for u in _listify(pbody.get("upstreams"))
                    ]
                )
            connect.sidecar_service = ConsulSidecarService(
                port=str(sidecar.get("port", "")), proxy=proxy
            )
        svc.connect = connect
    return svc


def parse_task(name: str, d: dict) -> Task:
    task = Task(
        name=name,
        driver=d.get("driver", ""),
        user=d.get("user", ""),
        config=d.get("config", {}) or {},
        env={k: str(v) for k, v in (d.get("env") or {}).items()},
        meta={k: str(v) for k, v in (d.get("meta") or {}).items()},
        kill_signal=d.get("kill_signal", ""),
        leader=bool(d.get("leader", False)),
    )
    if "kill_timeout" in d:
        task.kill_timeout = parse_duration(d["kill_timeout"])
    if "shutdown_delay" in d:
        task.shutdown_delay = parse_duration(d["shutdown_delay"])
    if "resources" in d:
        task.resources = parse_resources(d["resources"] or {})
    for body in _listify(d.get("constraint")):
        task.constraints.append(parse_constraint(body))
    for body in _listify(d.get("affinity")):
        task.affinities.append(parse_affinity(body))
    for body in _listify(d.get("service")):
        task.services.append(parse_service(name, body))
    for body in _listify(d.get("artifact")):
        task.artifacts.append(
            TaskArtifact(
                getter_source=body.get("source", ""),
                getter_options={
                    k: str(v) for k, v in (body.get("options") or {}).items()
                },
                getter_mode=body.get("mode", "any"),
                relative_dest=body.get("destination", ""),
            )
        )
    for body in _listify(d.get("template")):
        task.templates.append(
            Template(
                source_path=body.get("source", ""),
                dest_path=body.get("destination", ""),
                embedded_tmpl=body.get("data", ""),
                change_mode=body.get("change_mode", "restart"),
                change_signal=body.get("change_signal", ""),
                splay=parse_duration(body.get("splay", "5s")),
                perms=str(body.get("perms", "0644")),
            )
        )
    if "vault" in d:
        body = d["vault"] or {}
        task.vault = Vault(
            policies=[str(p) for p in _listify(body.get("policies"))],
            env=bool(body.get("env", True)),
            change_mode=body.get("change_mode", "restart"),
            change_signal=body.get("change_signal", ""),
        )
    if "logs" in d:
        body = d["logs"] or {}
        task.log_config = LogConfig(
            max_files=int(body.get("max_files", 10)),
            max_file_size_mb=int(body.get("max_file_size", 10)),
        )
    if "dispatch_payload" in d:
        task.dispatch_payload = DispatchPayloadConfig(
            file=(d["dispatch_payload"] or {}).get("file", "")
        )
    for body in _listify(d.get("volume_mount")):
        task.volume_mounts.append(
            VolumeMount(
                volume=body.get("volume", ""),
                destination=body.get("destination", ""),
                read_only=bool(body.get("read_only", False)),
            )
        )
    return task


def parse_group(name: str, d: dict) -> TaskGroup:
    tg = TaskGroup(
        name=name,
        count=int(d.get("count", 1)),
        meta={k: str(v) for k, v in (d.get("meta") or {}).items()},
    )
    for body in _listify(d.get("constraint")):
        tg.constraints.append(parse_constraint(body))
    for body in _listify(d.get("affinity")):
        tg.affinities.append(parse_affinity(body))
    for body in _listify(d.get("spread")):
        tg.spreads.append(parse_spread(body))
    if "restart" in d:
        body = d["restart"] or {}
        tg.restart_policy = RestartPolicy(
            attempts=int(body.get("attempts", 2)),
            interval=parse_duration(body.get("interval", "30m")),
            delay=parse_duration(body.get("delay", "15s")),
            mode=body.get("mode", "fail"),
        )
    if "reschedule" in d:
        body = d["reschedule"] or {}
        tg.reschedule_policy = ReschedulePolicy(
            attempts=int(body.get("attempts", 0)),
            interval=parse_duration(body.get("interval", 0)),
            delay=parse_duration(body.get("delay", "30s")),
            delay_function=body.get("delay_function", "exponential"),
            max_delay=parse_duration(body.get("max_delay", "1h")),
            unlimited=bool(body.get("unlimited", True)),
        )
    if "migrate" in d:
        body = d["migrate"] or {}
        tg.migrate = MigrateStrategy(
            max_parallel=int(body.get("max_parallel", 1)),
            health_check=body.get("health_check", "checks"),
            min_healthy_time=parse_duration(body.get("min_healthy_time", "10s")),
            healthy_deadline=parse_duration(body.get("healthy_deadline", "5m")),
        )
    if "update" in d:
        tg.update = parse_update(d["update"] or {})
    if "ephemeral_disk" in d:
        body = d["ephemeral_disk"] or {}
        tg.ephemeral_disk = EphemeralDisk(
            sticky=bool(body.get("sticky", False)),
            size_mb=int(body.get("size", 150)),
            migrate=bool(body.get("migrate", False)),
        )
    if "network" in d:
        for body in _listify(d["network"]):
            tg.networks.append(parse_network(body))
    for label, body in _labeled_blocks(d.get("volume")):
        tg.volumes[label] = VolumeRequest(
            name=label,
            type=body.get("type", "host"),
            source=body.get("source", ""),
            read_only=bool(body.get("read_only", False)),
        )
    for label, body in _labeled_blocks(d.get("task")):
        tg.tasks.append(parse_task(label, body))
    return tg


def parse_job(src: str) -> Job:
    """Parse an HCL jobspec into a Job (ref jobspec/parse.go:27)."""
    root = hcl_parse(src)
    jobs = _labeled_blocks(root.get("job"))
    if len(jobs) != 1:
        raise HCLError(f"expected exactly one job block, found {len(jobs)}")
    job_id, d = jobs[0]

    job = Job(
        id=d.get("id", job_id),
        name=d.get("name", job_id),
        type=d.get("type", "service"),
        priority=int(d.get("priority", 50)),
        region=d.get("region", "global"),
        all_at_once=bool(d.get("all_at_once", False)),
        datacenters=[str(x) for x in _listify(d.get("datacenters"))] or ["dc1"],
        namespace=d.get("namespace", "default"),
        meta={k: str(v) for k, v in (d.get("meta") or {}).items()},
    )
    for body in _listify(d.get("constraint")):
        job.constraints.append(parse_constraint(body))
    for body in _listify(d.get("affinity")):
        job.affinities.append(parse_affinity(body))
    for body in _listify(d.get("spread")):
        job.spreads.append(parse_spread(body))
    if "update" in d:
        job.update = parse_update(d["update"] or {})
    if "periodic" in d:
        body = d["periodic"] or {}
        job.periodic = PeriodicConfig(
            enabled=bool(body.get("enabled", True)),
            spec=body.get("cron", body.get("spec", "")),
            spec_type="cron",
            prohibit_overlap=bool(body.get("prohibit_overlap", False)),
            time_zone=body.get("time_zone", "UTC"),
        )
    if "parameterized" in d:
        body = d["parameterized"] or {}
        job.parameterized_job = ParameterizedJobConfig(
            payload=body.get("payload", ""),
            meta_required=[str(x) for x in _listify(body.get("meta_required"))],
            meta_optional=[str(x) for x in _listify(body.get("meta_optional"))],
        )
    for label, body in _labeled_blocks(d.get("group")):
        job.task_groups.append(parse_group(label, body))

    # standalone task at job level becomes its own group (HCL1 behavior)
    for label, body in _labeled_blocks(d.get("task")):
        job.task_groups.append(
            parse_group(label, {"task": {label: body}})
        )
    return job
