"""Live template rendering with change_mode (ref client/allocrunner/
taskrunner/template/template.go:408-445: the reference runs consul-template,
re-renders when upstream data — service catalog entries, vault secrets —
changes, and restarts or signals the task per the template's change_mode).

Template language: the task-env ${...} interpolation (taskenv) extended
with two DYNAMIC sources, each recorded into the template's watch set so
the poll loop re-queries only what the template actually reads:

    ${service.<name>}           all passing addresses, "ip:port,ip:port"
    ${service.<name>.first}     first passing address (stable choice)
    ${vault.<path>.<field>}     field of a Vault KV secret (v1 or v2),
                                read with the task's own vault token

A change in any watched value re-renders; a changed destination file then
applies change_mode: "noop" (nothing), "restart" (restart the task outside
the restart-policy budget), or "signal" (deliver change_signal)."""

from __future__ import annotations

import logging
import os
import re
import threading
from typing import Callable, Optional

from . import taskenv

logger = logging.getLogger("nomad_tpu.template")

_DYNAMIC = re.compile(r"\$\{(service|vault)\.([^}]+)\}")


def resolve_service(entries: list) -> dict:
    """Catalog entries → the template's value forms."""
    addrs = [
        f"{e.get('Address', '')}:{e.get('Port', 0)}"
        for e in entries
        if e.get("Status", "passing") == "passing"
    ]
    return {"all": ",".join(addrs), "first": addrs[0] if addrs else ""}


class TemplateSources:
    """Dynamic lookups for one task's templates: the service catalog via
    the client's server transport, Vault KV via the task's own token."""

    def __init__(
        self,
        catalog: Optional[Callable[[str], list]] = None,
        vault_addr: str = "",
        vault_token: str = "",
    ):
        self.catalog = catalog
        self.vault_addr = vault_addr.rstrip("/")
        self.vault_token = vault_token

    def service(self, name: str) -> dict:
        if self.catalog is None:
            return {"all": "", "first": ""}
        try:
            return resolve_service(self.catalog(name))
        except Exception:
            logger.warning("service lookup failed for %s", name, exc_info=True)
            return {"all": "", "first": ""}

    def vault_read(self, path: str) -> dict:
        """Read a KV secret's data dict; v2 responses nest data.data."""
        if not self.vault_addr:
            return {}
        import json
        import urllib.request

        req = urllib.request.Request(
            f"{self.vault_addr}/v1/{path.lstrip('/')}",
            headers={"X-Vault-Token": self.vault_token},
        )
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                doc = json.loads(resp.read() or b"{}")
        except Exception:
            logger.warning("vault read failed for %s", path, exc_info=True)
            return {}
        data = doc.get("data") or {}
        inner = data.get("data")
        if isinstance(inner, dict) and "metadata" in data:
            return inner  # KV v2
        return data


def render(
    content: str,
    env: dict,
    node,
    sources: TemplateSources,
    watch: Optional[dict] = None,
) -> str:
    """Render one template: dynamic refs first (recording each into
    ``watch`` as {("service", name) | ("vault", path): observed-value}),
    then the standard task-env interpolation."""

    def sub(m: re.Match) -> str:
        kind, rest = m.group(1), m.group(2)
        if kind == "service":
            name, _, attr = rest.partition(".")
            values = sources.service(name)
            if watch is not None:
                watch[("service", name)] = values["all"]
            return values["first"] if attr == "first" else values["all"]
        path, _, field = rest.rpartition(".")
        if not path:  # no field separator: whole-secret ref is invalid
            path, field = rest, ""
        data = sources.vault_read(path)
        value = str(data.get(field, "")) if field else ""
        if watch is not None:
            watch[("vault", path)] = tuple(sorted(data.items()))
        return value

    content = _DYNAMIC.sub(sub, content)
    return taskenv.interpolate(content, env, node)


class TemplateManager:
    """Re-render loop for one task (the template_hook's poststart half).

    Polls the watch set; on change re-renders every template and applies
    change_mode for those whose DESTINATION content changed (the
    reference's render-event → task-runner restart/signal path)."""

    def __init__(
        self,
        task,
        task_dir: str,
        env: dict,
        node,
        sources: TemplateSources,
        restart_fn: Callable[[], None],
        signal_fn: Callable[[str], None],
        event_fn: Callable[[str, str], None],
        poll_interval: float = 3.0,
    ):
        self.task = task
        self.task_dir = task_dir
        self.env = env
        self.node = node
        self.sources = sources
        self.restart_fn = restart_fn
        self.signal_fn = signal_fn
        self.event_fn = event_fn
        self.poll_interval = poll_interval
        self._watch: dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- rendering ------------------------------------------------------
    def _dest(self, template) -> str:
        from .hooks import _contained

        return _contained(self.task_dir, template.dest_path)

    def render_all(self, first: bool = False) -> list:
        """Render every template; returns the templates whose destination
        content changed. ``first`` renders unconditionally (prestart)."""
        changed = []
        self._watch.clear()
        for template in self.task.templates:
            content = template.embedded_tmpl
            if not content and template.source_path:
                from .hooks import HookError, _contained

                try:
                    with open(
                        _contained(self.task_dir, template.source_path)
                    ) as f:
                        content = f.read()
                except OSError as e:
                    if first:
                        # prestart contract: a broken template fails the
                        # start (templates_hook semantics)
                        raise HookError(
                            f"template source unreadable: {e}"
                        ) from e
                    continue  # transientally unreadable mid-flight: skip
            rendered = render(
                content, self.env, self.node, self.sources, self._watch
            )
            dest = self._dest(template)
            previous = None
            if not first and os.path.exists(dest):
                try:
                    with open(dest) as f:
                        previous = f.read()
                except OSError:
                    previous = None
            if first or previous != rendered:
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                with open(dest, "w") as f:
                    f.write(rendered)
                try:
                    os.chmod(dest, int(template.perms or "0644", 8))
                except (ValueError, OSError):
                    pass
                if not first:
                    changed.append(template)
        return changed

    def _watched_current(self) -> dict:
        now: dict = {}
        for key in list(self._watch):
            kind, ident = key
            if kind == "service":
                now[key] = self.sources.service(ident)["all"]
            else:
                now[key] = tuple(sorted(self.sources.vault_read(ident).items()))
        return now

    # -- loop -----------------------------------------------------------
    def start(self):
        """Start the re-render loop; only worthwhile when some template
        watches a dynamic source."""
        if not self._watch:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="template-manager"
        )
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(self.poll_interval):
            try:
                if self._watched_current() == self._watch:
                    continue
                changed = self.render_all()
            except Exception:
                logger.exception("template re-render failed")
                continue
            if not changed:
                continue
            self._apply_change_modes(changed)

    def _apply_change_modes(self, changed: list):
        """One restart covers any number of changed restart-templates
        (template.go:408-445 coalesces); each signal template delivers its
        own signal."""
        modes = {t.change_mode or "restart" for t in changed}
        signals = {
            t.change_signal
            for t in changed
            if (t.change_mode or "restart") == "signal" and t.change_signal
        }
        if "restart" in modes:
            self.event_fn(
                "Template", "Template with change_mode restart re-rendered"
            )
            try:
                self.restart_fn()
            except Exception as e:
                logger.warning("template restart failed: %s", e)
            return
        for sig in signals:
            self.event_fn(
                "Template", f"Template re-rendered, signaling {sig}"
            )
            try:
                self.signal_fn(sig)
            except Exception as e:
                logger.warning("template signal failed: %s", e)
