"""Task environment builder + interpolation
(ref client/taskenv/env.go: the ${NOMAD_*} variables every task sees, and
the ${node.*}/${attr.*}/${meta.*}/${env.*} interpolation applied to task
configs and templates)."""

from __future__ import annotations

import re
from typing import Any, Optional

_VAR = re.compile(r"\$\{([^}]+)\}")


def build_env(alloc, task, node, task_dir: str, alloc_dir: str) -> dict[str, str]:
    """The NOMAD_* environment for one task (ref taskenv/env.go:100-210)."""
    job = alloc.job
    env: dict[str, str] = {
        "NOMAD_ALLOC_ID": alloc.id,
        "NOMAD_ALLOC_NAME": alloc.name,
        "NOMAD_ALLOC_INDEX": str(_alloc_index(alloc.name)),
        "NOMAD_TASK_NAME": task.name,
        "NOMAD_GROUP_NAME": alloc.task_group,
        "NOMAD_JOB_ID": alloc.job_id,
        "NOMAD_JOB_NAME": job.name if job is not None else "",
        "NOMAD_NAMESPACE": alloc.namespace,
        "NOMAD_REGION": job.region if job is not None else "",
        "NOMAD_DC": node.datacenter if node is not None else "",
        "NOMAD_ALLOC_DIR": alloc_dir,
        "NOMAD_TASK_DIR": f"{task_dir}/local",
        "NOMAD_SECRETS_DIR": f"{task_dir}/secrets",
        "NOMAD_CPU_LIMIT": str(task.resources.cpu),
        "NOMAD_MEMORY_LIMIT": str(task.resources.memory_mb),
    }
    # task meta → NOMAD_META_<KEY> (group/job meta merged, task wins)
    meta: dict[str, str] = {}
    if job is not None:
        meta.update(job.meta)
        tg = job.lookup_task_group(alloc.task_group)
        if tg is not None:
            meta.update(tg.meta)
    meta.update(task.meta)
    for k, v in meta.items():
        env[f"NOMAD_META_{k.upper().replace('-', '_')}"] = str(v)
        env[f"NOMAD_META_{k}"] = str(v)

    # network/port variables from the allocated resources
    resources = alloc.allocated_resources
    task_res = resources.tasks.get(task.name) if resources is not None else None
    if task_res is not None:
        for net in task_res.networks:
            for port in list(net.reserved_ports) + list(net.dynamic_ports):
                label = port.label.upper().replace("-", "_")
                env[f"NOMAD_IP_{task.name}_{port.label}"] = net.ip
                env[f"NOMAD_PORT_{task.name}_{port.label}"] = str(port.value)
                env[f"NOMAD_ADDR_{task.name}_{port.label}"] = f"{net.ip}:{port.value}"
                env[f"NOMAD_HOST_PORT_{label}"] = str(port.value)
    return env


def _alloc_index(name: str) -> int:
    m = re.search(r"\[(\d+)\]$", name or "")
    return int(m.group(1)) if m else 0


def interpolate(value: Any, env: dict[str, str], node=None) -> Any:
    """Replace ${...} references in strings (recursively through lists and
    dicts): ${env.X} and bare ${NOMAD_*} from the task env, ${node.*},
    ${attr.*} and ${meta.*} from the node (ref taskenv ReplaceEnv)."""
    if isinstance(value, str):
        return _VAR.sub(lambda m: _resolve(m.group(1), env, node), value)
    if isinstance(value, list):
        return [interpolate(v, env, node) for v in value]
    if isinstance(value, dict):
        return {k: interpolate(v, env, node) for k, v in value.items()}
    return value


def _resolve(ref: str, env: dict[str, str], node) -> str:
    if ref.startswith("env."):
        return env.get(ref[4:], "")
    if ref in env:
        return env[ref]
    if node is not None:
        if ref.startswith("node."):
            key = ref[5:]
            direct = {
                "datacenter": node.datacenter,
                "class": node.node_class,
                "unique.id": node.id,
                "unique.name": node.name,
            }
            if key in direct:
                return direct[key]
        if ref.startswith("attr."):
            return str(node.attributes.get(ref[5:], ""))
        if ref.startswith("meta."):
            return str(node.meta.get(ref[5:], ""))
    return ""
