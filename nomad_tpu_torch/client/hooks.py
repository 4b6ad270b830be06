"""Task prestart hooks (ref client/allocrunner/taskrunner/
task_runner_hooks.go:48-118: validate → taskdir → logmon → dispatch
payload → artifacts → templates → env; logmon lives in the drivers'
_spawn log capture here).

Hooks run before every driver start, in order; a hook failure fails the
start attempt, which routes through the task's restart policy exactly like
a driver start failure."""

from __future__ import annotations

import base64
import logging
import os
import shutil
import urllib.request
from urllib.parse import urlparse

from . import taskenv

logger = logging.getLogger("nomad_tpu.client.hooks")


class HookError(RuntimeError):
    pass


def _contained(base: str, rel: str) -> str:
    from ..util import contained_path

    try:
        return contained_path(base, rel)
    except ValueError as e:
        raise HookError(str(e)) from e


def task_dir_hook(task_dir: str, alloc_dir: str):
    """allocdir layout (ref client/allocdir/): shared alloc dir plus the
    task's local/secrets/tmp tree."""
    for d in (
        alloc_dir,
        os.path.join(alloc_dir, "data"),
        os.path.join(alloc_dir, "tmp"),
        os.path.join(task_dir, "local"),
        os.path.join(task_dir, "secrets"),
        os.path.join(task_dir, "tmp"),
    ):
        os.makedirs(d, exist_ok=True)


def dispatch_payload_hook(alloc, task, task_dir: str):
    """Write the dispatch payload into local/ (ref dispatch_hook.go)."""
    if task.dispatch_payload is None or not task.dispatch_payload.file:
        return
    job = alloc.job
    payload = getattr(job, "payload", "") if job is not None else ""
    if not payload:
        return
    try:
        data = base64.b64decode(payload)
    except Exception:
        data = payload.encode()
    # user-controlled filename: must stay inside the task dir
    dest = _contained(task_dir, os.path.join("local", task.dispatch_payload.file))
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    with open(dest, "wb") as f:
        f.write(data)


def artifacts_hook(task, task_dir: str, env: dict, node=None):
    """Fetch artifacts into local/ (ref artifact_hook.go + go-getter).
    Supported getters: file:// and bare paths (copy, dir or file) and
    http(s):// via urllib; failures raise and route through the restart
    policy like the reference's artifact failures."""
    for artifact in task.artifacts:
        source = taskenv.interpolate(artifact.getter_source, env, node)
        rel = taskenv.interpolate(artifact.relative_dest, env, node) or "local/"
        dest_base = _contained(task_dir, rel)
        os.makedirs(dest_base, exist_ok=True)
        parsed = urlparse(source)
        try:
            if parsed.scheme in ("", "file"):
                path = parsed.path if parsed.scheme == "file" else source
                if os.path.isdir(path):
                    shutil.copytree(
                        path,
                        os.path.join(dest_base, os.path.basename(path.rstrip("/"))),
                        dirs_exist_ok=True,
                    )
                else:
                    shutil.copy(path, dest_base)
            elif parsed.scheme in ("http", "https"):
                name = os.path.basename(parsed.path) or "artifact"
                local = os.path.join(dest_base, name)
                with urllib.request.urlopen(source, timeout=30) as resp:
                    with open(local, "wb") as f:
                        shutil.copyfileobj(resp, f)
                _maybe_unpack(local, dest_base)
            elif parsed.scheme == "git" or source.startswith("git::"):
                # go-getter's git mode: git::<url>[?ref=<ref>]
                url = source[len("git::"):] if source.startswith("git::") else source
                ref = ""
                if "?ref=" in url:
                    url, _, ref = url.partition("?ref=")
                import subprocess

                target = os.path.join(
                    dest_base,
                    os.path.basename(url.rstrip("/")).removesuffix(".git"),
                )
                cmd = ["git", "clone", "--depth", "1"]
                if ref:
                    cmd += ["--branch", ref]
                cmd += [url, target]
                out = subprocess.run(
                    cmd, capture_output=True, text=True, timeout=120
                )
                if out.returncode != 0:
                    raise HookError(
                        f"git clone failed: {out.stderr.strip()[:300]}"
                    )
            else:
                raise HookError(f"unsupported artifact getter: {source}")
        except HookError:
            raise
        except Exception as e:
            raise HookError(f"artifact fetch failed for {source}: {e}") from e


def _maybe_unpack(path: str, dest: str):
    """go-getter auto-unpacks recognized archives; same here. The archive
    file is removed after a successful extraction."""
    import tarfile
    import zipfile

    lowered = path.lower()
    try:
        if lowered.endswith((".tar.gz", ".tgz", ".tar.bz2", ".tar")):
            with tarfile.open(path) as tf:
                tf.extractall(dest, filter="data")
        elif lowered.endswith(".zip"):
            with zipfile.ZipFile(path) as zf:
                for info in zf.infolist():
                    target = os.path.join(dest, info.filename)
                    if not os.path.realpath(target).startswith(
                        os.path.realpath(dest)
                    ):
                        raise HookError(f"zip escapes dest: {info.filename}")
                zf.extractall(dest)
        else:
            return
    except (tarfile.TarError, zipfile.BadZipFile) as e:
        raise HookError(f"archive unpack failed for {path}: {e}") from e
    os.remove(path)


def templates_hook(task, task_dir: str, env: dict, node=None):
    """Render templates (ref template_hook.go; the reference runs
    consul-template — here embedded templates interpolate the task env and
    node attributes through the same ${...} syntax)."""
    for template in task.templates:
        content = template.embedded_tmpl
        if not content and template.source_path:
            source = _contained(task_dir, template.source_path)
            try:
                with open(source) as f:
                    content = f.read()
            except OSError as e:
                raise HookError(f"template source unreadable: {e}") from e
        rendered = taskenv.interpolate(content, env, node)
        dest = _contained(task_dir, template.dest_path)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with open(dest, "w") as f:
            f.write(rendered)
        try:
            os.chmod(dest, int(template.perms or "0644", 8))
        except (ValueError, OSError):
            pass


def volumes_hook(alloc, task, node, task_dir: str):
    """Materialize host-volume mounts into the task dir as symlinks
    (ref taskrunner/volume_hook.go: the group's volume{} requests bound
    through the node's client host_volume config)."""
    import os

    job = alloc.job
    tg = job.lookup_task_group(alloc.task_group) if job else None
    requests = tg.volumes if tg is not None else {}
    for mount in task.volume_mounts:
        req = requests.get(mount.volume)
        if req is None:
            raise RuntimeError(f"task mounts unknown volume {mount.volume!r}")
        host = node.host_volumes.get(req.source)
        if host is None:
            raise RuntimeError(
                f"node is missing host volume {req.source!r}"
            )
        target = os.path.join(task_dir, mount.destination.lstrip("/"))
        os.makedirs(os.path.dirname(target) or task_dir, exist_ok=True)
        if os.path.islink(target):
            os.unlink(target)
        elif os.path.exists(target):
            continue  # restart of a recovered task: mount already present
        os.symlink(host.path, target)


def run_prestart(
    alloc, task, node, task_dir: str, alloc_dir: str, extra_env=None,
    skip_templates: bool = False,
):
    """The prestart pipeline; returns the prepared (interpolated) task copy
    and its full environment. ``skip_templates`` hands template rendering
    to the caller's TemplateManager (the live-template path renders once
    with dynamic sources instead of a static pass here)."""
    task_dir_hook(task_dir, alloc_dir)
    volumes_hook(alloc, task, node, task_dir)
    env = taskenv.build_env(alloc, task, node, task_dir, alloc_dir)
    env.update(extra_env or {})
    dispatch_payload_hook(alloc, task, task_dir)
    artifacts_hook(task, task_dir, env, node)
    if not skip_templates:
        templates_hook(task, task_dir, env, node)

    prepared = task.copy()
    prepared.env = {
        **{k: taskenv.interpolate(v, env, node) for k, v in task.env.items()},
        **env,
    }
    prepared.config = taskenv.interpolate(task.config, prepared.env, node)
    # drivers see the ALLOCATED networks (NetworkIndex's granted host
    # ports), not the jobspec ask whose dynamic ports are still 0 — the
    # reference builds the driver TaskConfig from the alloc's resources
    # (drivers/task_handle + driver.go createContainerConfig port binds)
    ar = getattr(alloc, "allocated_resources", None)
    if ar is not None:
        tr = ar.tasks.get(task.name)
        if tr is not None and tr.networks:
            prepared.resources.networks = [n.copy() for n in tr.networks]
    return prepared, env
