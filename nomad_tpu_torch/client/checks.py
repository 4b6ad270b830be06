"""Service health-check runner (ref command/agent/consul/ ServiceClient +
script_checks: the reference registers check definitions with Consul and
runs script checks itself; this nomad-native analog runs script/http/tcp
checks in the client and publishes results through task state, which the
cluster's service catalog reads).

Each running task with service checks gets one runner thread that cycles
its checks on their configured intervals. Results transition between
"passing" and "critical"; transitions mark the task state dirty so the
client's update loop pushes them to the servers."""

from __future__ import annotations

import logging
import socket
import subprocess
import threading
import time
import urllib.request

logger = logging.getLogger("nomad_tpu.client.checks")

PASSING = "passing"
CRITICAL = "critical"

DEFAULT_INTERVAL_S = 10.0
MIN_INTERVAL_S = 0.05
DEFAULT_TIMEOUT_S = 5.0


def _service_address(alloc, task_name: str, port_label: str):
    """(ip, port) a check should probe, from the task's allocated network
    resources (the same resolution the service catalog performs)."""
    resources = alloc.allocated_resources
    tr = resources.tasks.get(task_name) if resources is not None else None
    if tr is None:
        return None
    for net in tr.networks:
        for p in list(net.reserved_ports) + list(net.dynamic_ports):
            if p.label == port_label:
                return net.ip or "127.0.0.1", p.value
    return None


def run_check(check, alloc, task_name: str, task_dir: str, env: dict) -> tuple[str, str]:
    """Execute one check; returns (status, output)."""
    timeout = (check.timeout / 1e9) if check.timeout else DEFAULT_TIMEOUT_S
    kind = (check.type or "").lower()
    try:
        if kind == "script":
            out = subprocess.run(
                [check.command, *[str(a) for a in check.args]],
                cwd=task_dir or None,
                env={"PATH": "/usr/bin:/bin:/usr/local/bin", **(env or {})},
                capture_output=True,
                text=True,
                timeout=timeout,
            )
            status = PASSING if out.returncode == 0 else CRITICAL
            return status, (out.stdout or out.stderr)[:512]
        addr = _service_address(alloc, task_name, check.port_label)
        if addr is None:
            return CRITICAL, f"no port labelled {check.port_label!r}"
        ip, port = addr
        if kind == "tcp":
            with socket.create_connection((ip, port), timeout=timeout):
                return PASSING, f"tcp connect {ip}:{port} ok"
        if kind == "http":
            proto = check.protocol or "http"
            url = f"{proto}://{ip}:{port}{check.path or '/'}"
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                code = resp.status
            if 200 <= code < 400:
                return PASSING, f"HTTP {code}"
            return CRITICAL, f"HTTP {code}"
        return CRITICAL, f"unknown check type {check.type!r}"
    except subprocess.TimeoutExpired:
        return CRITICAL, "check timed out"
    except Exception as e:  # connection refused, DNS, non-2xx, ...
        return CRITICAL, str(e)[:512]


class CheckRunner:
    """Cycles a task's service checks while the task runs."""

    def __init__(self, task_runner):
        self.task_runner = task_runner
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # (service, check) → next fire time
        # nta: ignore[unbounded-cache] WHY: keyed by the task's
        # (service, check) set; the runner dies with its task
        self._schedule: dict[tuple[str, str], float] = {}
        # check name → consecutive critical results (check_restart)
        # nta: ignore[unbounded-cache] WHY: keyed by the task's check
        # names; the runner dies with its task
        self._fail_streak: dict[str, int] = {}
        self._started_at = time.monotonic()

    def start(self):
        checks = [
            (svc, chk)
            for svc in self.task_runner.task.services
            for chk in svc.checks
        ]
        if not checks:
            return
        self._checks = checks
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="client-check-watcher"
        )
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _run(self):
        tr = self.task_runner
        alloc_runner = tr.alloc_runner
        task_dir = alloc_runner.task_dir(tr.task.name)
        now = time.monotonic()
        for svc, chk in self._checks:
            self._schedule[(svc.name, chk.name)] = now
        while not self._stop.is_set() and tr.state.state == "running":
            now = time.monotonic()
            next_fire = now + DEFAULT_INTERVAL_S
            for svc, chk in self._checks:
                key = (svc.name, chk.name)
                due = self._schedule[key]
                if now >= due:
                    status, output = run_check(
                        chk,
                        alloc_runner.alloc,
                        tr.task.name,
                        task_dir,
                        getattr(tr, "_env", None) or {},
                    )
                    self._publish(chk.name or svc.name, status, output)
                    if self._maybe_restart(chk, status):
                        return  # restart kills the process; this run ends
                    interval = max(
                        (chk.interval / 1e9) if chk.interval else DEFAULT_INTERVAL_S,
                        MIN_INTERVAL_S,
                    )
                    due = now + interval
                    self._schedule[key] = due
                next_fire = min(next_fire, due)
            self._stop.wait(max(next_fire - time.monotonic(), MIN_INTERVAL_S))

    def _maybe_restart(self, check, status: str) -> bool:
        """check_restart (ref structs.go CheckRestart + taskrunner's
        checkRestarter): ``limit`` consecutive critical results after the
        ``grace`` window restart the task through the normal user-restart
        path (outside the restart-policy budget, like the reference's
        Restart(force))."""
        cr = check.check_restart
        if cr is None or cr.limit <= 0:
            return False
        name = check.name
        if status == PASSING:
            self._fail_streak[name] = 0
            return False
        if time.monotonic() - self._started_at < (cr.grace / 1e9):
            return False
        self._fail_streak[name] = self._fail_streak.get(name, 0) + 1
        if self._fail_streak[name] < cr.limit:
            return False
        tr = self.task_runner
        logger.warning(
            "check %s failed %d times; restarting task %s",
            name, self._fail_streak[name], tr.task.name,
        )
        tr._event(
            "Restart Signaled",
            f"healthcheck: check {name!r} unhealthy",
        )
        try:
            tr.restart()
        except ValueError:
            pass  # already stopping/stopped
        return True

    def _publish(self, name: str, status: str, output: str):
        tr = self.task_runner
        prev = tr.state.check_status.get(name)
        if prev == status:
            return
        tr.state.check_status = dict(tr.state.check_status, **{name: status})
        if status == CRITICAL:
            tr._event("Check", f"check {name!r} {status}: {output}")
        logger.info("check %s for task %s: %s", name, tr.task.name, status)
        tr.alloc_runner.task_state_updated()
