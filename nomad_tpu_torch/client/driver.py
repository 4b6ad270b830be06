"""Task drivers (ref plugins/drivers/ + drivers/{mock,rawexec}).

The driver interface mirrors the reference's gRPC Driver service surface
(plugins/drivers/proto/driver.proto:13-84) in-process: fingerprint,
start/wait/stop/destroy/inspect/signal. The mock driver reproduces the
reference's scriptable test driver (drivers/mock): configurable run duration,
exit codes, and start errors. RawExecDriver runs real subprocesses with no
isolation (drivers/rawexec); the isolated exec driver arrives with the C++
executor.
"""

from __future__ import annotations

import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..structs.model import Task


def task_log_dir(task_dir: str) -> str:
    """Log directory inside a task dir (ref allocdir: alloc/logs)."""
    import os

    return os.path.join(task_dir, "logs")


def parse_duration(v) -> float:
    """Seconds from a number or a Go-style duration string ("250ms",
    "1m30s" — the format the reference's mock driver configs use,
    drivers/mock/driver.go run_for). Delegates to the jobspec parser so
    compound durations behave identically everywhere."""
    if isinstance(v, (int, float)):
        return float(v)
    from ..jobspec.hcl import parse_duration as _hcl_duration

    return _hcl_duration(str(v)) / 1e9


@dataclass
class TaskHandle:
    task_name: str = ""
    driver: str = ""
    proc: Optional[object] = None
    pid: int = 0
    exit_code: Optional[int] = None
    error: str = ""
    started_at: int = 0
    finished_at: int = 0
    recovered: bool = False
    _done: threading.Event = field(default_factory=threading.Event)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def finish(self, exit_code: int, error: str = ""):
        self.exit_code = exit_code
        self.error = error
        self.finished_at = time.time_ns()
        self._done.set()


class Driver:
    """Driver plugin interface (ref plugins/drivers/driver.go)."""

    name = "driver"

    def __init__(self):
        # per-instance: callers mutate in place (plugin_config.update),
        # so a class-level shared dict would leak config across drivers
        self.plugin_config: dict = {}

    def fingerprint(self) -> dict:
        """Returns {detected, healthy, attributes}."""
        return {"detected": True, "healthy": True, "attributes": {}}

    def start_task(self, task: Task, task_dir: str) -> TaskHandle:
        raise NotImplementedError

    def stop_task(self, handle: TaskHandle, timeout: float = 5.0,
                  signal_name: str = ""):
        """Gracefully stop: deliver ``signal_name`` (or the platform
        default), escalate to a hard kill after ``timeout`` (ref
        driver.proto StopTask's kill_timeout + the task kill_signal)."""
        raise NotImplementedError

    def destroy_task(self, handle: TaskHandle):
        pass

    def inspect_task(self, handle: TaskHandle) -> dict:
        return {
            "exit_code": handle.exit_code,
            "error": handle.error,
            "running": not handle._done.is_set(),
        }

    def signal_task(self, handle: TaskHandle, signal_name: str):
        """Deliver a signal to the running task (ref driver.proto
        SignalTask). Drivers without signal support raise."""
        raise ValueError(f"driver {self.name} does not support signals")

    def exec_streaming(
        self,
        handle: TaskHandle,
        cmd: list,
        tty: bool = False,
        task_dir: str = "",
        env: Optional[dict] = None,
    ):
        """Run a command INSIDE the task's execution context with
        bidirectional streaming IO (ref driver.proto:72-76
        ExecTaskStreaming); returns a client.execstream.ExecProcess.
        Drivers without an execution context to enter raise."""
        raise ValueError(f"driver {self.name} does not support exec")

    def task_stats(self, handle: TaskHandle) -> dict:
        """Per-task resource usage (ref driver.proto:59 TaskStats →
        TaskResourceUsage): cumulative cpu seconds, sampled cpu percent,
        RSS and pid count. The default walks the handle's process tree —
        right for every driver whose task is a local child (exec family,
        java, qemu); container runtimes override with their own stats
        source (docker stats)."""
        from .stats import task_resource_usage

        return task_resource_usage(handle)

    # -- plugin config (ref plugins/base/proto base.proto: ConfigSchema +
    # SetConfig, with hclspec's schema-validation role) -----------------
    def config_schema(self) -> dict:
        """{key: {"type": "string|number|bool", "required": bool,
        "default": ...}} describing the driver's plugin config."""
        return {}

    def set_config(self, config: dict):
        """Apply validated plugin configuration."""
        self.plugin_config = dict(config)

    # -- recovery (ref plugins/drivers/proto/driver.proto:35 RecoverTask) --
    def handle_data(self, handle: TaskHandle) -> dict:
        """Serializable reattach info persisted in the client state DB."""
        return {"driver": self.name, "task_name": handle.task_name}

    def recover_task(self, task: Task, data: dict) -> Optional[TaskHandle]:
        """Reattach to a task started by a previous client process; returns
        None when the task can't be recovered (the runner restarts it)."""
        return None


class MockDriver(Driver):
    """Scriptable driver for tests (ref drivers/mock/driver.go).

    Task config keys:
      run_for          seconds to run before exiting (default 0: exit now)
      exit_code        exit code to report (default 0)
      start_error      error string raised at start
      start_block_for  seconds to block in start
    """

    name = "mock_driver"

    def __init__(self):
        super().__init__()
        self._timers: dict[int, threading.Timer] = {}

    def config_schema(self) -> dict:
        """ref drivers/mock config options (subset), exercised by the
        plugin-protocol ConfigSchema/SetConfig tests."""
        return {
            "fingerprint_attr": {"type": "string"},
            "shutdown_delay_s": {"type": "number", "default": 0},
            "fail_fingerprint": {"type": "bool", "default": False},
        }

    def fingerprint(self) -> dict:
        if self.plugin_config.get("fail_fingerprint"):
            return {"detected": True, "healthy": False, "attributes": {}}
        attrs = {}
        if self.plugin_config.get("fingerprint_attr"):
            attrs["driver.mock.config"] = self.plugin_config["fingerprint_attr"]
        return {"detected": True, "healthy": True, "attributes": attrs}

    def start_task(self, task: Task, task_dir: str) -> TaskHandle:
        cfg = task.config or {}
        if cfg.get("start_error"):
            raise RuntimeError(str(cfg["start_error"]))
        if cfg.get("start_block_for"):
            time.sleep(parse_duration(cfg["start_block_for"]))

        handle = TaskHandle(
            task_name=task.name, driver=self.name, started_at=time.time_ns()
        )
        handle._cfg = dict(cfg)
        run_for = parse_duration(cfg.get("run_for", 0))
        exit_code = int(cfg.get("exit_code", 0))
        handle._run_for = run_for
        handle._exit_code = exit_code
        if run_for <= 0:
            handle.finish(exit_code)
        else:
            key = id(handle)

            def _finish():
                self._timers.pop(key, None)
                handle.finish(exit_code)

            # nta: ignore[thread-unnamed] WHY: Timer() takes no name
            # kwarg; named on the next line before start()
            t = threading.Timer(run_for, _finish)
            t.name = "driver-mock-finish-timer"
            t.daemon = True
            self._timers[key] = t
            t.start()
        return handle

    def stop_task(self, handle: TaskHandle, timeout: float = 5.0,
                  signal_name: str = ""):
        t = self._timers.pop(id(handle), None)
        if t is not None:
            t.cancel()
        if signal_name:
            handle.stop_signal = signal_name
        if not handle._done.is_set():
            handle.finish(130, "killed")

    def signal_task(self, handle: TaskHandle, signal_name: str):
        """Records delivered signals for assertions (ref drivers/mock
        scriptable signals); ``signal_error`` in the task config makes the
        delivery fail, ``exit_on_signal`` ends the task."""
        cfg = getattr(handle, "_cfg", {})
        if cfg.get("signal_error"):
            raise RuntimeError(str(cfg["signal_error"]))
        signals = getattr(handle, "signals", None)
        if signals is None:
            signals = handle.signals = []
        signals.append(signal_name)
        if cfg.get("exit_on_signal") and not handle._done.is_set():
            self.stop_task(handle)

    def exec_streaming(
        self,
        handle: TaskHandle,
        cmd: list,
        tty: bool = False,
        task_dir: str = "",
        env: Optional[dict] = None,
    ):
        """Test hook: mock tasks have no real process, so exec runs the
        command in the task dir (exercises the full streaming path)."""
        from .execstream import ExecProcess

        if handle._done.is_set():
            raise ValueError("task is not running")
        return ExecProcess(
            list(cmd),
            cwd=task_dir or None,
            env={"PATH": "/usr/bin:/bin:/usr/local/bin", **(env or {})},
            tty=tty,
        )

    def handle_data(self, handle: TaskHandle) -> dict:
        return {
            "driver": self.name,
            "task_name": handle.task_name,
            "started_at": handle.started_at,
            "run_for": getattr(handle, "_run_for", 0.0),
            "exit_code": getattr(handle, "_exit_code", 0),
        }

    def recover_task(self, task: Task, data: dict) -> Optional[TaskHandle]:
        """Scriptable recovery (the reference's mock driver RecoverTask):
        config fail_recover forces the unrecoverable path; otherwise the
        handle resumes with whatever run time remains."""
        cfg = task.config or {}
        if cfg.get("fail_recover"):
            return None
        handle = TaskHandle(
            task_name=task.name,
            driver=self.name,
            started_at=int(data.get("started_at", 0)),
            recovered=True,
        )
        exit_code = int(data.get("exit_code", 0))
        # carry the reattach info so handle_data round-trips through a
        # SECOND crash/recovery without zeroing run_for/exit_code
        handle._run_for = float(data.get("run_for", 0.0))
        handle._exit_code = exit_code
        remaining = (
            data.get("started_at", 0) / 1e9
            + float(data.get("run_for", 0.0))
            - time.time()
        )
        if remaining <= 0:
            handle.finish(exit_code)
            return handle
        key = id(handle)

        def _finish():
            self._timers.pop(key, None)
            handle.finish(exit_code)

        # nta: ignore[thread-unnamed] WHY: Timer() takes no name kwarg;
        # named on the next line before start()
        t = threading.Timer(remaining, _finish)
        t.name = "driver-mock-finish-timer"
        t.daemon = True
        self._timers[key] = t
        t.start()
        return handle


class RawExecDriver(Driver):
    """Run a real subprocess with no isolation (ref drivers/rawexec)."""

    name = "raw_exec"

    def _spawn(self, task: Task, argv: list, cwd, log_base=None) -> TaskHandle:
        """Shared Popen → TaskHandle → waiter tail for the exec family.
        stdout/stderr flow through in-process logmon copiers into rotated
        ``<log_base or cwd>/logs/<task>.<stream>.<n>`` files honoring the
        task's LogConfig (ref client/logmon/ + logging/logrotator)."""
        import os

        from .logmon import RotatingWriter, start_copier

        log_base = log_base or cwd
        log_dir = task_log_dir(log_base) if log_base else None
        stdout = stderr = subprocess.DEVNULL
        pipes = []  # (read_fd, writer)
        if log_dir is not None:
            cfg = task.log_config
            max_files = cfg.max_files if cfg is not None else 10
            max_mb = cfg.max_file_size_mb if cfg is not None else 10
            raw_fds: list[int] = []
            writers: list[RotatingWriter] = []
            try:
                out_r, stdout = os.pipe()
                raw_fds += [out_r, stdout]
                err_r, stderr = os.pipe()
                raw_fds += [err_r, stderr]
                writers.append(
                    RotatingWriter(log_dir, task.name, "stdout",
                                   max_files, max_mb)
                )
                writers.append(
                    RotatingWriter(log_dir, task.name, "stderr",
                                   max_files, max_mb)
                )
                pipes = [(out_r, writers[0]), (err_r, writers[1])]
            except Exception:
                # a half-built io setup must not leak fds per restart
                for fd in raw_fds:
                    try:
                        os.close(fd)
                    except OSError:
                        pass
                for writer in writers:
                    writer.close()
                raise
        try:
            proc = subprocess.Popen(
                argv,
                cwd=cwd,
                stdout=stdout,
                stderr=stderr,
                env={"PATH": "/usr/bin:/bin:/usr/local/bin", **task.env},
            )
        except Exception:
            for fd, writer in pipes:
                os.close(fd)
                writer.close()
            raise
        finally:
            # the child holds the write ends now (or Popen raised)
            for end in (stdout, stderr):
                if end is not subprocess.DEVNULL:
                    os.close(end)
        copiers = [start_copier(fd, writer) for fd, writer in pipes]
        handle = TaskHandle(
            task_name=task.name,
            driver=self.name,
            proc=proc,
            pid=proc.pid,
            started_at=time.time_ns(),
        )
        handle._proc_start = _proc_start_time(proc.pid)

        def waiter():
            code = proc.wait()
            # drain the pipes before completion is observable: a caller
            # reacting to the exit must find the final log bytes on disk
            # (copiers end at EOF, which the child's exit guarantees soon;
            # the timeout guards grandchildren holding the pipe open)
            for t in copiers:
                t.join(timeout=5.0)
            handle.finish(code)

        threading.Thread(
            target=waiter, daemon=True, name="driver-exec-waiter"
        ).start()
        return handle

    def start_task(self, task: Task, task_dir: str) -> TaskHandle:
        cfg = task.config or {}
        command = cfg.get("command")
        if not command:
            raise RuntimeError("raw_exec requires a command")
        args = [command] + list(cfg.get("args", []))
        return self._spawn(task, args, task_dir or None)

    def stop_task(self, handle: TaskHandle, timeout: float = 5.0,
                  signal_name: str = ""):
        import signal as signal_mod

        sig = signal_mod.SIGTERM
        if signal_name:
            name = str(signal_name).upper()
            if not name.startswith("SIG"):
                name = "SIG" + name
            resolved = getattr(signal_mod, name, None)
            if isinstance(resolved, signal_mod.Signals):
                sig = resolved
        proc = handle.proc
        if proc is not None:
            if proc.poll() is not None:
                return
            proc.send_signal(sig)
            try:
                proc.wait(timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
            return
        # recovered handle: not our child; signal by pid with the same
        # graceful → wait → kill escalation the child path gets
        if handle.pid and not handle._done.is_set():
            import os
            import signal

            try:
                os.kill(handle.pid, sig)
            except ProcessLookupError:
                return
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                if not _pid_alive(handle.pid):
                    return
                time.sleep(0.05)
            try:
                os.kill(handle.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass

    def exec_streaming(
        self,
        handle: TaskHandle,
        cmd: list,
        tty: bool = False,
        task_dir: str = "",
        env: Optional[dict] = None,
    ):
        """raw_exec's context is the task dir + env (no isolation to
        enter, ref drivers/rawexec): the command runs beside the task."""
        from .execstream import ExecProcess

        if handle._done.is_set():
            raise ValueError("task is not running")
        return ExecProcess(
            list(cmd),
            cwd=task_dir or None,
            env={"PATH": "/usr/bin:/bin:/usr/local/bin", **(env or {})},
            tty=tty,
        )

    def signal_task(self, handle: TaskHandle, signal_name: str):
        """os-level signal delivery by pid (ref drivers/rawexec SignalTask)."""
        import os
        import signal as signal_mod

        if handle._done.is_set() or not handle.pid:
            raise ValueError("task is not running")
        name = str(signal_name).upper()
        if not name.startswith("SIG"):
            name = "SIG" + name
        sig = getattr(signal_mod, name, None)
        if not isinstance(sig, signal_mod.Signals):
            raise ValueError(f"unknown signal: {signal_name}")
        try:
            os.kill(handle.pid, sig)
        except ProcessLookupError:
            raise ValueError("task process has already exited")

    def handle_data(self, handle: TaskHandle) -> dict:
        return {
            "driver": self.name,
            "task_name": handle.task_name,
            "pid": handle.pid,
            "started_at": handle.started_at,
            "proc_start": getattr(handle, "_proc_start", 0),
        }

    def recover_task(self, task: Task, data: dict) -> Optional[TaskHandle]:
        """Reattach to a still-running process from a previous client
        process. The pid is no longer our child (reparented at client
        death), so liveness is polled and the exit code of a process that
        finishes after recovery is unknowable — it reports 0, the price of
        raw (executor-less) exec; the exec driver's shepherd process keeps
        real exit codes across client restarts. The persisted /proc start
        time guards against pid reuse: a recycled pid would make us adopt
        (and later kill) an unrelated process."""
        pid = int(data.get("pid", 0))
        if pid <= 0 or not _pid_alive(pid):
            return None
        persisted_start = int(data.get("proc_start", 0))
        if persisted_start and _proc_start_time(pid) != persisted_start:
            return None  # pid recycled by another process
        handle = TaskHandle(
            task_name=task.name,
            driver=self.name,
            pid=pid,
            started_at=int(data.get("started_at", 0)),
            recovered=True,
        )
        handle._proc_start = persisted_start

        def poller():
            while _pid_alive(pid):
                time.sleep(0.2)
            if not handle._done.is_set():
                handle.finish(0)

        threading.Thread(
            target=poller, daemon=True, name="driver-pid-poller"
        ).start()
        return handle


def _pid_alive(pid: int) -> bool:
    import os

    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _proc_start_time(pid: int) -> int:
    """Kernel start time of a pid (clock ticks since boot, field 22 of
    /proc/<pid>/stat) — the stable identity that survives everything but
    pid reuse. 0 when unreadable."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read().decode("ascii", "replace")
        # comm may contain spaces/parens; field 22 counts after the last ')'
        rest = stat.rsplit(")", 1)[1].split()
        return int(rest[19])  # state is rest[0] → starttime is rest[19]
    except Exception:
        return 0


class ExecDriver(RawExecDriver):
    """Isolated exec via the nsexec shepherd (ref drivers/exec +
    drivers/shared/executor/executor_linux.go:29: libcontainer-backed
    isolation; here a small C++ namespace shepherd, SURVEY §2.9). Tasks run
    in fresh PID/mount/IPC/UTS namespaces with a namespace-local /proc; the
    persisted pid is the shepherd's, which forwards signals and propagates
    the task's exit status — so recovery-by-pid works exactly like
    raw_exec's but kills the whole namespace tree."""

    name = "exec"

    def __init__(self):
        super().__init__()
        self._nsexec = None
        self._healthy = False
        try:
            from ..native import isolation_available, nsexec_path

            if isolation_available():
                self._nsexec = nsexec_path()
                self._healthy = True
        except Exception:
            self._healthy = False
        self._sweep_stale_cgroups()

    def config_schema(self) -> dict:
        return {
            # node-wide default for tasks that don't set their own
            # seccomp stanza ("default" turns filtering on fleet-wide)
            "default_seccomp": {"type": "string", "default": "off"},
        }

    def set_config(self, config: dict):
        # a typo'd node-wide profile must fail HERE (one clear SetConfig
        # error), not at every subsequent task start
        profile = config.get("default_seccomp", "off")
        if profile not in ("default", "off"):
            raise ValueError(
                f"default_seccomp must be default|off, got {profile!r}"
            )
        super().set_config(config)

    def handle_data(self, handle: TaskHandle) -> dict:
        data = super().handle_data(handle)
        data["seccomp"] = getattr(handle, "_seccomp", "off")
        return data

    def recover_task(self, task: Task, data: dict) -> Optional[TaskHandle]:
        handle = super().recover_task(task, data)
        if handle is not None:
            # exec-into-task after a client restart still applies the filter
            handle._seccomp = data.get("seccomp", "off")
        return handle

    @staticmethod
    def _sweep_stale_cgroups():
        """A SIGKILL'd shepherd never runs its cgroup cleanup; empty
        nomad-* groups left behind are reclaimed here at driver startup so
        a churning node can't accumulate them forever."""
        import glob
        import os

        import time as _time

        now = _time.time()
        for root in (
            "/sys/fs/cgroup",
            "/sys/fs/cgroup/memory",
            "/sys/fs/cgroup/cpu",
        ):
            for d in glob.glob(os.path.join(root, "nomad-*")):
                try:
                    # age gate: a freshly created group may belong to a task
                    # whose child hasn't joined yet (another client's nsexec
                    # between setup and enter)
                    if now - os.stat(d).st_mtime < 300:
                        continue
                    os.rmdir(d)  # only succeeds when the group is empty
                except OSError:
                    pass

    def fingerprint(self) -> dict:
        return {
            "detected": self._nsexec is not None,
            "healthy": self._healthy,
            "attributes": {"driver.exec.isolation": "namespaces"},
        }

    def start_task(self, task: Task, task_dir: str) -> TaskHandle:
        if not self._healthy:
            raise RuntimeError("exec driver requires namespace isolation")
        cfg = task.config or {}
        command = cfg.get("command")
        if not command:
            raise RuntimeError("exec requires a command")
        args = [self._nsexec, "--workdir", task_dir or "/"]
        if cfg.get("chroot") and task_dir:
            # filesystem isolation (ref exec's default chroot env +
            # alloc-dir bind): the task dir becomes "/", system paths are
            # read-only binds, the shared alloc dir mounts at /alloc —
            # NOMAD_* dir vars are re-rooted to the in-chroot paths
            import os as os_mod

            alloc_shared = os_mod.path.join(
                os_mod.path.dirname(task_dir), "alloc"
            )
            os_mod.makedirs(alloc_shared, exist_ok=True)
            args += ["--chroot", task_dir, "--bind", f"{alloc_shared}:/alloc"]
            task = task.copy()
            task.env = {
                **task.env,
                "NOMAD_TASK_DIR": "/local",
                "NOMAD_ALLOC_DIR": "/alloc",
                "NOMAD_SECRETS_DIR": "/secrets",
            }
            cfg = task.config or {}
        # resource enforcement via the shepherd's cgroup (the executor's
        # resource-container role): best-effort, keyed uniquely per start
        if cfg.get("enforce_resources", True):
            import uuid as _uuid

            args += ["--cgroup", f"{task.name}-{_uuid.uuid4().hex[:8]}"]
            if task.resources.memory_mb:
                args += ["--memory-mb", str(task.resources.memory_mb)]
            if task.resources.cpu:
                args += ["--cpu-shares", str(task.resources.cpu)]
        # syscall filtering (SURVEY §2.9; ref libcontainer's seccomp
        # profile): task config seccomp = "default"|"off", defaulting to
        # the plugin config's default_seccomp (off unless configured)
        profile = cfg.get(
            "seccomp", self.plugin_config.get("default_seccomp", "off")
        )
        if profile not in ("default", "off"):
            raise RuntimeError(
                f"exec seccomp profile must be default|off, got {profile!r}"
            )
        if profile == "default":
            args += ["--seccomp", "default"]
        args += ["--", command] + list(cfg.get("args", []))
        handle = self._spawn(task, args, None, log_base=task_dir)
        # exec_streaming must re-apply the task's filter when it joins the
        # namespaces; recovery restores it from handle_data
        handle._seccomp = profile
        return handle

    def exec_streaming(
        self,
        handle: TaskHandle,
        cmd: list,
        tty: bool = False,
        task_dir: str = "",
        env: Optional[dict] = None,
    ):
        """Exec INSIDE the task's namespaces: nsexec --enter joins the
        namespace init's pid/mnt/ipc/uts via setns (the reference re-enters
        through its nsenter shim for ExecTaskStreaming). The namespace
        init is the shepherd's direct child (handle.pid is the shepherd,
        which lives OUTSIDE the pid namespace it created)."""
        from .execstream import ExecProcess

        if handle._done.is_set():
            raise ValueError("task is not running")
        child = _first_child(handle.pid)
        if child is None:
            raise ValueError("task namespace init not found")
        argv = [self._nsexec, "--enter", str(child)]
        if getattr(handle, "_seccomp", "off") == "default":
            # the exec'd process inherits the task's syscall filter — an
            # unfiltered shell inside a filtered sandbox defeats the point
            argv += ["--seccomp", "default"]
        argv += ["--"] + list(cmd)
        return ExecProcess(
            argv,
            env={"PATH": "/usr/bin:/bin:/usr/local/bin", **(env or {})},
            tty=tty,
        )


def _first_child(pid: int) -> Optional[int]:
    """First child of a pid (/proc children list); None when childless."""
    try:
        with open(
            f"/proc/{pid}/task/{pid}/children", "r", encoding="ascii"
        ) as f:
            kids = f.read().split()
        return int(kids[0]) if kids else None
    except (OSError, ValueError, IndexError):
        return None


BUILTIN_DRIVERS = {
    MockDriver.name: MockDriver,
    RawExecDriver.name: RawExecDriver,
    ExecDriver.name: ExecDriver,
}


def default_drivers() -> dict:
    """Instantiate every driver family a node agent carries by default:
    the builtin exec family plus the external-runtime tier (java, qemu,
    docker — ref helper/pluginutils/catalog/register.go's builtin driver
    registrations). Runtime-gated drivers report detected=False via
    fingerprint when their binary is absent."""
    out = {name: cls() for name, cls in BUILTIN_DRIVERS.items()}
    from ..drivers import EXTENDED_DRIVERS

    for name, cls in EXTENDED_DRIVERS.items():
        try:
            out[name] = cls()
        except Exception:  # a broken runtime probe must not kill the agent
            pass
    return out
