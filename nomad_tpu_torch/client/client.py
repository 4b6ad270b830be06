"""Client agent: fingerprint, register, heartbeat, watch allocations, and run
them (ref client/client.go), with durable local state + task recovery,
prestart hook pipelines (hooks.py), device plugins, and periodic
re-fingerprinting.

The client talks to the server through a transport interface; in-process
(dev agent) that is the Server object directly, matching how the reference's
dev mode embeds both.
"""

from __future__ import annotations

import logging
import os
import platform
import threading
import time
from typing import Optional

from ..structs.model import (
    ALLOC_CLIENT_STATUS_COMPLETE,
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_CLIENT_STATUS_RUNNING,
    Allocation,
    DriverInfo,
    NetworkResource,
    Node,
    NodeCpuResources,
    NodeDiskResources,
    NodeMemoryResources,
    NodeResources,
    TaskState,
    generate_uuid,
    now_ns,
)
from ..structs.node_class import compute_class
from .driver import BUILTIN_DRIVERS, Driver, TaskHandle, default_drivers

logger = logging.getLogger("nomad_tpu.client")


class TaskRunner:
    """Per-task lifecycle with restart policy
    (ref client/allocrunner/taskrunner/task_runner.go:423-533)."""

    def __init__(
        self,
        alloc_runner,
        task,
        driver: Driver,
        recovered_handle=None,
        restored_state: Optional[dict] = None,
    ):
        self.alloc_runner = alloc_runner
        self.task = task
        self.driver = driver
        self.state = TaskState(state="pending")
        self.handle: Optional[TaskHandle] = None
        # handle reattached by the driver's RecoverTask after a client
        # restart; consumed by the first run-loop iteration
        self._recovered_handle = recovered_handle
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # wall-clock restart attempt times: persisted with the task state so
        # a client restart does NOT hand a crash-looping task a fresh
        # restart-policy budget (ref restarts/restarts.go)
        self._restarts_in_interval: list[float] = []
        # bounded event timeline surviving state transitions
        # (ref structs.TaskEvent + TaskState.Events)
        self._events: list[dict] = []
        # one vault token per task lifecycle: restarts reuse it instead of
        # minting (and leaking) a fresh accessor per attempt
        self._vault_token: Optional[str] = None
        # user-initiated restart in flight: the run loop re-launches
        # without consuming the restart-policy budget
        self._restarting = False
        if restored_state:
            self.state.restarts = int(restored_state.get("restarts", 0))
            self._restarts_in_interval = [
                float(t) for t in restored_state.get("restart_times", [])
            ]
            self._events = list(restored_state.get("events", []))[-10:]
        self._event("Received", "Task received by client")

    def _event(self, etype: str, message: str):
        self._events = (self._events + [
            {"type": etype, "message": message, "time": now_ns()}
        ])[-10:]
        self.state.events = list(self._events)

    def start(self):
        self._thread = threading.Thread(
            target=self.run, daemon=True,
            name=f"client-task-runner-{self.task.name}",
        )
        self._thread.start()

    def run(self):
        restart_policy = None
        tg = None
        if self.alloc_runner.alloc.job is not None:
            tg = self.alloc_runner.alloc.job.lookup_task_group(
                self.alloc_runner.alloc.task_group
            )
        if tg is not None:
            restart_policy = tg.restart_policy

        while not self._stop.is_set():
            tmpl_mgr = None
            recovered_changed: list = []
            if self._recovered_handle is not None:
                # reattached by RecoverTask after a client restart: skip
                # driver start, resume supervision of the live handle
                self.handle = self._recovered_handle
                self._recovered_handle = None
                self._event("Recovered", "Task reattached after client restart")
                # live templates resume watching across client restarts
                # (env rebuilt; rendered files already on disk, so only
                # genuinely changed content rewrites/restarts)
                try:
                    from . import hooks, taskenv

                    task_dir = self.alloc_runner.task_dir(self.task.name)
                    env = taskenv.build_env(
                        self.alloc_runner.alloc,
                        self.task,
                        self.alloc_runner.client.node,
                        task_dir,
                        self.alloc_runner.alloc_dir(),
                    )
                    self._env = env
                    tmpl_mgr = self._template_manager(task_dir, env)
                    if tmpl_mgr is not None:
                        # content that changed while the client was down
                        # still owes its change_mode once running
                        recovered_changed = tmpl_mgr.render_all()
                except Exception:
                    logger.exception("template recovery failed")
            else:
                try:
                    self._event("Task Setup", "Building task directory and environment")
                    from . import hooks

                    task_dir = self.alloc_runner.task_dir(self.task.name)
                    # prestart pipeline (task_runner_hooks.go:48-118):
                    # dirs → dispatch payload → artifacts → templates →
                    # NOMAD_* env + ${...} interpolation + device env
                    task, env = hooks.run_prestart(
                        self.alloc_runner.alloc,
                        self.task,
                        self.alloc_runner.client.node,
                        task_dir,
                        self.alloc_runner.alloc_dir(),
                        extra_env=self.alloc_runner.device_env(self.task.name),
                        # the TemplateManager below is the single renderer
                        # (dynamic sources resolved, no blank first write)
                        skip_templates=bool(self.task.templates),
                    )
                    self._env = env  # service checks interpolate against it
                    self._vault_hook(task, task_dir)
                    # live templates: dynamic sources (${service.*},
                    # ${vault.*}) render before start and are then watched
                    # for change_mode restart/signal (template.go:408-445)
                    tmpl_mgr = self._template_manager(task_dir, env)
                    if tmpl_mgr is not None:
                        tmpl_mgr.render_all(first=True)
                    self.handle = self.driver.start_task(task, task_dir)
                except Exception as e:
                    # Start failures route through the restart policy like any
                    # other failure (ref taskrunner restart tracker)
                    if restart_policy is not None and self._restart_or_wait(
                        restart_policy
                    ):
                        continue
                    self.state = TaskState(
                        state="dead", failed=True, finished_at=now_ns()
                    )
                    self._event("Driver Failure", str(e))
                    self.alloc_runner.task_state_updated()
                    return
            self.alloc_runner.driver_handle_updated(self)

            self.state = TaskState(
                state="running",
                started_at=self.handle.started_at,
                restarts=self.state.restarts,
            )
            self._event("Started", "Task started by client")
            self.alloc_runner.task_state_updated()

            # service-check runner rides the running window
            # (ref task_runner_hooks.go script-checks hook)
            from .checks import CheckRunner

            check_runner = CheckRunner(self)
            check_runner.start()
            if tmpl_mgr is not None:
                tmpl_mgr.start()
                if recovered_changed:
                    tmpl_mgr._apply_change_modes(recovered_changed)
            try:
                self.handle.wait()
            finally:
                check_runner.stop()
                if tmpl_mgr is not None:
                    tmpl_mgr.stop()
            exit_code = self.handle.exit_code or 0
            failed = exit_code != 0

            if self._restarting and not self._stop.is_set():
                # user-initiated restart (ref taskrunner Restart): loop
                # without touching the restart-policy budget
                self._restarting = False
                self._destroy_handle()  # release container/image refs
                self.state = TaskState(
                    state="pending", restarts=self.state.restarts + 1
                )
                self._event("Restarting", "Task restarting by user request")
                self.alloc_runner.task_state_updated()
                continue

            if self._stop.is_set():
                self.state = TaskState(
                    state="dead",
                    failed=False,
                    started_at=self.state.started_at,
                    finished_at=now_ns(),
                    restarts=self.state.restarts,
                )
                self.alloc_runner.task_state_updated()
                self._destroy_handle()
                return

            if not failed:
                self.state = TaskState(
                    state="dead",
                    failed=False,
                    started_at=self.state.started_at,
                    finished_at=self.handle.finished_at,
                    restarts=self.state.restarts,
                )
                self._event("Terminated", f"Exit Code: {exit_code}")
                self.alloc_runner.task_state_updated()
                self._destroy_handle()
                return

            # Restart policy (ref client/allocrunner/taskrunner/restarts/)
            if restart_policy is not None and self._restart_or_wait(restart_policy):
                self._destroy_handle()  # release container/image refs
                self.state = TaskState(
                    state="pending", restarts=self.state.restarts + 1
                )
                self._event(
                    "Restarting", f"Task restarting (exit code {exit_code})"
                )
                self.alloc_runner.task_state_updated()
                continue

            self.state = TaskState(
                state="dead",
                failed=True,
                started_at=self.state.started_at,
                finished_at=self.handle.finished_at,
                restarts=self.state.restarts,
            )
            self._event("Terminated", f"Exit Code: {exit_code}, failed")
            self.alloc_runner.task_state_updated()
            self._destroy_handle()
            return

    def _template_manager(self, task_dir: str, env: dict):
        """Build the live-template manager when the task has templates
        (dynamic refs populate its watch set on the first render; a task
        with only static templates gets a manager that never starts)."""
        if not self.task.templates:
            return None
        from .template import TemplateManager, TemplateSources

        client = self.alloc_runner.client
        vault_cfg = getattr(client, "vault_config", None) or {}
        sources = TemplateSources(
            catalog=getattr(client.server, "catalog_service", None),
            vault_addr=vault_cfg.get("address", ""),
            vault_token=self._vault_token or "",
        )
        return TemplateManager(
            self.task,
            task_dir,
            env,
            client.node,
            sources,
            restart_fn=self.restart,
            signal_fn=self.signal,
            event_fn=self._event,
            poll_interval=getattr(client, "template_poll_interval", 3.0),
        )

    def _destroy_handle(self):
        """Release driver-held task resources (containers, image refs) at
        terminal exit — loudly: a failed cleanup lands on the task
        timeline instead of leaking (ref taskrunner destroy path)."""
        if self.handle is None:
            return
        try:
            self.driver.destroy_task(self.handle)
        except Exception as e:
            self._event("Driver Failure", f"failed to destroy task: {e}")
            logger.error(
                "destroy_task failed for %s: %s", self.task.name, e
            )

    def _vault_hook(self, task, task_dir: str):
        """Derive the task's vault token and deliver it into secrets/
        (+ VAULT_TOKEN when the stanza asks; ref vault_hook.go)."""
        if self.task.vault is None:
            return
        if self._vault_token is None:
            server = self.alloc_runner.client.server
            derive = getattr(server, "derive_vault_token", None)
            if derive is None:
                raise RuntimeError("server transport lacks vault token derivation")
            self._vault_token = derive(
                self.alloc_runner.alloc.id, self.task.name
            )
        token = self._vault_token
        secrets = os.path.join(task_dir, "secrets")
        os.makedirs(secrets, exist_ok=True)
        token_path = os.path.join(secrets, "vault_token")
        with open(token_path, "w") as f:
            f.write(token)
        os.chmod(token_path, 0o600)
        if self.task.vault.env:
            task.env = {**task.env, "VAULT_TOKEN": token}

    def _restart_or_wait(self, policy) -> bool:
        """Decide whether to restart and sleep out the backoff. In 'delay'
        mode with the budget exhausted, wait until the oldest attempt ages out
        of the interval before restarting (ref restarts/restarts.go);
        returns False when the task should fail permanently."""
        if policy.mode not in ("delay", "fail"):
            return False
        now = time.time()
        interval_s = (policy.interval or 0) / 1e9
        if interval_s > 0:
            # prune attempts outside the rolling interval; interval 0 means
            # the budget never resets (attempts are a lifetime limit)
            self._restarts_in_interval = [
                t for t in self._restarts_in_interval if now - t < interval_s
            ]
        wait = (policy.delay or 0) / 1e9
        if len(self._restarts_in_interval) >= policy.attempts:
            if policy.mode != "delay":
                return False
            # throttle: restart only once the interval budget frees up
            oldest = min(self._restarts_in_interval, default=now)
            wait = max(wait, (oldest + interval_s) - now)
        self._restarts_in_interval.append(now)
        cap = self.alloc_runner.client.max_restart_delay
        if cap is not None:
            wait = min(wait, cap)
        return not self._stop.wait(max(wait, 0))

    def stop(self):
        self._stop.set()
        if self.handle is not None:
            # shutdown_delay: hold the kill so service deregistration can
            # propagate (ref task_runner kill path + shutdown_delay docs);
            # capped so a misconfigured job can't wedge alloc teardown
            delay = min(self.task.shutdown_delay / 1e9, 30.0)
            if delay > 0 and not self.handle._done.is_set():
                self._event(
                    "Waiting", f"Shutdown delay of {delay:g}s before kill"
                )
                self.handle.wait(delay)
            self._event("Killing", "Task being killed")
            try:
                self.driver.stop_task(
                    self.handle,
                    timeout=max(self.task.kill_timeout / 1e9, 0.1),
                    signal_name=self.task.kill_signal,
                )
            except Exception as e:
                # a failed kill must be LOUD on the task timeline — a
                # wedged container/process is an operator problem, not a
                # silent leak (ref TaskEvent TaskKilling failures)
                self._event("Driver Failure", f"failed to stop task: {e}")
                logger.error("stop_task failed for %s: %s", self.task.name, e)

    def restart(self):
        """User-initiated restart (ref client_alloc_endpoint.go Restart →
        TaskRunner.Restart): kill the running process; the run loop
        re-launches it outside the restart-policy budget."""
        if (
            self.handle is None
            or self._stop.is_set()
            or self.state.state != "running"
        ):
            raise ValueError(f"task {self.task.name!r} is not running")
        self._restarting = True
        self._event("Restart Signaled", "User requested task restart")
        try:
            self.driver.stop_task(
                self.handle,
                timeout=max(self.task.kill_timeout / 1e9, 0.1),
                signal_name=self.task.kill_signal,
            )
        except Exception as e:
            # the task is still running: clear the flag so its NEXT exit
            # isn't misread as a user restart (which would bypass the
            # restart-policy budget)
            self._restarting = False
            self._event("Driver Failure", f"failed to stop task: {e}")
            raise

    def signal(self, signal_name: str):
        """Deliver a signal to the running task (ref SignalTask RPC)."""
        if (
            self.handle is None
            or self._stop.is_set()
            or self.state.state != "running"
        ):
            raise ValueError(f"task {self.task.name!r} is not running")
        self._event("Signaling", f"Task being sent signal {signal_name}")
        self.driver.signal_task(self.handle, signal_name)


class AllocRunner:
    """Per-allocation supervisor (ref client/allocrunner/alloc_runner.go)."""

    def __init__(self, client, alloc: Allocation):
        self.client = client
        self.alloc = alloc
        # nta: ignore[unbounded-cache] WHY: one entry per task in the
        # group; the alloc runner dies with its alloc
        self.task_runners: dict[str, TaskRunner] = {}
        self._destroyed = False
        self._connect = None  # ConnectHook when the group runs sidecars
        self._lock = threading.Lock()

    def task_dir(self, task_name: str) -> str:
        d = os.path.join(
            self.client.data_dir, "allocs", self.alloc.id, task_name
        )
        os.makedirs(d, exist_ok=True)
        return d

    def alloc_dir(self) -> str:
        """Shared dir all the alloc's tasks see (ref allocdir SharedDir)."""
        return os.path.join(self.client.data_dir, "allocs", self.alloc.id, "alloc")

    def device_env(self, task_name: str) -> dict:
        """Env vars for the task's reserved device instances."""
        resources = self.alloc.allocated_resources
        if resources is None:
            return {}
        task_resources = resources.tasks.get(task_name)
        if task_resources is None or not task_resources.devices:
            return {}
        return self.client.device_manager.reserve_env(task_resources.devices)

    def run(self, recovered_handles: Optional[dict] = None, restored_states=None):
        """Start (or, with ``recovered_handles``, resume) the alloc's tasks.
        ``recovered_handles`` maps task name → live TaskHandle reattached by
        the driver's RecoverTask; ``restored_states`` maps task name → the
        persisted task-state doc (client.go:979 restoreState)."""
        job = self.alloc.job
        tg = job.lookup_task_group(self.alloc.task_group) if job else None
        if tg is None:
            return
        if recovered_handles is None and self.alloc.previous_allocation:
            # prerun hook: await the predecessor + inherit its ephemeral
            # disk (ref alloc_runner_hooks.go:98 await-prev → disk migrate)
            from . import allocwatcher

            try:
                allocwatcher.await_previous(self.client, self.alloc, tg)
            except Exception:
                logger.exception("previous-alloc migration failed")
        # Connect sidecars bind before any task starts so upstream ports
        # are live from the task's first instruction (ref
        # alloc_runner_hooks.go network/group-services ordering)
        try:
            from .connect import ConnectHook

            hook = ConnectHook(self.client, self.alloc, tg)
            if hook.start():
                self._connect = hook
                self.alloc.connect_proxies = dict(hook.proxies)
        except Exception:
            logger.exception("connect sidecar setup failed")
        # Fully populate the runner map before starting any task thread:
        # task threads iterate it from task_state_updated()
        missing_driver = []
        for task in tg.tasks:
            driver = self.client.drivers.get(task.driver)
            recovered = (recovered_handles or {}).get(task.name)
            tr = TaskRunner(
                self,
                task,
                driver,
                recovered_handle=recovered,
                restored_state=(restored_states or {}).get(task.name),
            )
            if driver is None:
                tr.state = TaskState(state="dead", failed=True, finished_at=now_ns())
                tr._event("Driver Failure", f"unknown driver {task.driver}")
                missing_driver.append(tr)
            self.task_runners[task.name] = tr
        for tr in self.task_runners.values():
            if tr.driver is not None:
                tr.start()
        if self.alloc.deployment_id:
            # Health watcher hook (ref allocrunner/health_hook.go +
            # allochealth/tracker.go): report deployment health once all
            # tasks have been running for min_healthy_time, or unhealthy
            # on failure / healthy_deadline expiry. Started only after the
            # runner map is fully populated (it iterates task_runners).
            t = threading.Thread(
                target=self._watch_health, daemon=True,
                name="client-health-watcher",
            )
            t.start()
        if missing_driver:
            self.task_state_updated()

    def restart_task(self, task_name: str = "") -> list[str]:
        """Restart one task, or every running task when unnamed
        (ref client_alloc_endpoint.go Restart). Returns the restarted
        task names."""
        runners = self._select_runners(task_name)
        for tr in runners:
            tr.restart()
        return [tr.task.name for tr in runners]

    def signal_task(self, signal_name: str, task_name: str = "") -> list[str]:
        """Signal one task, or every running task when unnamed
        (ref client_alloc_endpoint.go Signal)."""
        runners = self._select_runners(task_name)
        for tr in runners:
            tr.signal(signal_name)
        return [tr.task.name for tr in runners]

    def _select_runners(self, task_name: str) -> list["TaskRunner"]:
        if task_name:
            tr = self.task_runners.get(task_name)
            if tr is None:
                raise KeyError(f"unknown task: {task_name}")
            return [tr]
        running = [
            tr
            for tr in self.task_runners.values()
            if tr.state.state == "running"
        ]
        if not running:
            raise ValueError("allocation has no running tasks")
        return running

    def _watch_health(self):
        """ref allochealth/tracker.go: watch task states until the alloc
        is provably healthy or unhealthy, then report once."""
        job = self.alloc.job
        tg = job.lookup_task_group(self.alloc.task_group) if job else None
        strategy = tg.update if tg is not None else None
        min_healthy = (strategy.min_healthy_time if strategy else 0) / 1e9
        deadline_ns = strategy.healthy_deadline if strategy else 0
        deadline = time.monotonic() + (deadline_ns / 1e9 if deadline_ns else 300.0)
        # with health_check="checks" (the default), service checks must be
        # passing for the min_healthy window too (ref allochealth/tracker.go
        # watchConsulEvents)
        use_checks = strategy is None or strategy.health_check in ("", "checks")
        healthy_since = None
        while not self._destroyed:
            states = [tr.state for tr in self.task_runners.values()]
            if any(s.failed for s in states):
                self._set_health(False)
                return
            running = bool(states) and all(s.state == "running" for s in states)
            checks_ok = not use_checks or all(
                v == "passing"
                for s in states
                for v in s.check_status.values()
            )
            if running and checks_ok:
                if healthy_since is None:
                    healthy_since = time.monotonic()
                if time.monotonic() - healthy_since >= min_healthy:
                    self._set_health(True)
                    return
            else:
                healthy_since = None
            if time.monotonic() > deadline:
                self._set_health(False)
                return
            time.sleep(0.05)

    def _set_health(self, healthy: bool):
        from ..structs.model import DeploymentStatus

        with self._lock:
            ds = self.alloc.deployment_status or DeploymentStatus()
            ds.healthy = healthy
            ds.timestamp = now_ns()
            self.alloc.deployment_status = ds
        self.task_state_updated()

    def client_status(self) -> str:
        """Aggregate task states into the alloc's client status
        (ref alloc_runner.go clientAlloc)."""
        states = [tr.state for tr in self.task_runners.values()]
        if not states:
            return ALLOC_CLIENT_STATUS_PENDING
        if any(s.state == "running" for s in states):
            return ALLOC_CLIENT_STATUS_RUNNING
        if all(s.state == "dead" for s in states):
            if any(s.failed for s in states):
                return ALLOC_CLIENT_STATUS_FAILED
            return ALLOC_CLIENT_STATUS_COMPLETE
        return ALLOC_CLIENT_STATUS_PENDING

    def task_state_updated(self):
        self.client.alloc_state_updated(self)

    def driver_handle_updated(self, tr: "TaskRunner"):
        """Persist the driver's reattach info so a restarted client can
        RecoverTask (state_database.go PutTaskRunnerState analog)."""
        db = self.client.state_db
        if db is None or tr.driver is None or tr.handle is None:
            return
        try:
            db.put_driver_handle(
                self.alloc.id, tr.task.name, tr.driver.handle_data(tr.handle)
            )
        except Exception:
            logger.exception("persisting driver handle failed")

    def update(self, alloc: Allocation):
        with self._lock:
            self.alloc.desired_status = alloc.desired_status
            self.alloc.desired_description = alloc.desired_description
            if alloc.server_terminal_status():
                self.destroy()

    def destroy(self):
        if self._destroyed:
            return
        self._destroyed = True
        if self._connect is not None:
            self._connect.stop()
        for tr in self.task_runners.values():
            tr.stop()


class Client:
    """ref client/client.go"""

    def __init__(
        self,
        server,
        data_dir: Optional[str] = None,
        node: Optional[Node] = None,
        drivers: Optional[dict[str, Driver]] = None,
        persist: bool = True,
        device_plugins: Optional[list] = None,
    ):
        self.server = server
        if data_dir is None:
            # unique by default: the state DB carries node IDENTITY, so two
            # clients sharing a dir would register as the same node and
            # resurrect each other's allocs
            import tempfile

            data_dir = tempfile.mkdtemp(prefix="nomad_tpu_client_")
        self.data_dir = data_dir
        # Optional cap on restart backoff (dev/test speedup); None = honor
        # the task group's configured delay in full
        self.max_restart_delay: Optional[float] = None
        #: vault{address} for template ${vault.*} reads (agent config)
        self.vault_config: dict = {}
        #: live-template watch poll cadence (template.go's retry ticker)
        self.template_poll_interval = 3.0
        self.drivers = drivers or default_drivers()
        from .devices import DeviceManager

        self.device_manager = DeviceManager(device_plugins)
        # durable local state: alloc docs, task states, driver handles and
        # the node identity (ref client/state/state_database.go:107)
        #: terminal alloc dirs retained for log/fs access, reclaimed FIFO
        #: beyond gc_max_allocs (ref client config gc_max_allocs=50)
        self.gc_max_allocs = 50
        self._terminal_alloc_dirs: list[str] = []
        self.state_db = None
        if persist:
            from .state import ClientStateDB

            self.state_db = ClientStateDB(data_dir)
        self.node = node or self.fingerprint()
        if self.state_db is not None:
            # a restarted client must be the SAME node (same id AND secret,
            # which authenticates its client RPC) or its allocs orphan
            persisted = self.state_db.get_meta("node_id")
            persisted_secret = self.state_db.get_meta("node_secret")
            if node is None and persisted:
                self.node.id = persisted
                if persisted_secret:
                    self.node.secret_id = persisted_secret
                compute_class(self.node)
            else:
                self.state_db.put_meta("node_id", self.node.id)
                self.state_db.put_meta("node_secret", self.node.secret_id)
        self.alloc_runners: dict[str, AllocRunner] = {}
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._update_lock = threading.Lock()
        self._pending_updates: dict[str, Allocation] = {}
        self._heartbeat_ttl = 30.0
        #: seconds between driver/storage re-fingerprints
        self.fingerprint_interval = 30.0

    # ------------------------------------------------------------------
    def fingerprint(self) -> Node:
        """Host fingerprinting (ref client/fingerprint/ +
        fingerprint_manager.go): real cpu/memory/storage/network detection,
        driver health, and device plugins, merged into the node."""
        from . import fingerprint as fp_mod

        cpu = fp_mod.cpu_fingerprint()
        memory_mb = fp_mod.memory_fingerprint()
        disk_total, disk_free = fp_mod.storage_fingerprint(self.data_dir)
        host = fp_mod.host_fingerprint()
        networks = fp_mod.network_fingerprint()

        node = Node(
            id=generate_uuid(),
            secret_id=generate_uuid(),
            name=host["hostname"],
            datacenter="dc1",
            attributes={
                "kernel.name": host["kernel.name"],
                "kernel.version": host["kernel.version"],
                "os.name": host["os.name"],
                "arch": host["arch"],
                "nomad.version": "0.1.0",
                "cpu.numcores": str(cpu["cores"]),
                "cpu.frequency": str(int(cpu["mhz"])),
                "cpu.totalcompute": str(cpu["total_compute"]),
                "memory.totalbytes": str(memory_mb * 1024 * 1024),
                "unique.storage.volume": self.data_dir,
                "unique.storage.bytestotal": str(disk_total * 1024 * 1024),
                "unique.storage.bytesfree": str(disk_free * 1024 * 1024),
                # cloud env probes: empty off-cloud (env_aws.go/env_gce.go)
                **fp_mod.env_aws_fingerprint(),
                **fp_mod.env_gce_fingerprint(),
            },
            node_resources=NodeResources(
                cpu=NodeCpuResources(cpu_shares=cpu["total_compute"]),
                memory=NodeMemoryResources(memory_mb=memory_mb),
                disk=NodeDiskResources(disk_mb=disk_free),
                networks=networks,
            ),
            status="initializing",
        )
        self._fingerprint_drivers(node)
        # device plugins: TPU chips → node device groups (SURVEY §2.6)
        self.device_manager.fingerprint_node(node)
        compute_class(node)
        return node

    def _fingerprint_drivers(self, node: Node) -> bool:
        """(Re-)run driver fingerprints into the node; True when any
        driver's health changed (ref drivermanager health re-checks)."""
        changed = False
        for name, driver in self.drivers.items():
            try:
                fp = driver.fingerprint()
            except Exception:
                logger.exception("driver %s fingerprint failed", name)
                fp = {"detected": False, "healthy": False}
            prev = node.drivers.get(name)
            if (
                prev is None
                or prev.detected != fp["detected"]
                or prev.healthy != fp["healthy"]
            ):
                changed = True
            node.drivers[name] = DriverInfo(
                detected=fp["detected"], healthy=fp["healthy"]
            )
            # the driver.<name> attribute exists only while detected, and
            # driver-reported attributes (versions etc) ride along
            # (ref drivermanager → fingerprint attribute merge)
            if fp["detected"]:
                node.attributes[f"driver.{name}"] = "1"
                for k, v in (fp.get("attributes") or {}).items():
                    node.attributes[k] = str(v)
            else:
                node.attributes.pop(f"driver.{name}", None)
        return changed

    # ------------------------------------------------------------------
    def start(self):
        self._stop.clear()
        if self.state_db is not None and self.state_db.closed:
            # a stopped Client can be started again (tests and the agent's
            # restart path do); stop() closed the handle
            from .state import ClientStateDB

            self.state_db = ClientStateDB(self.data_dir)
        self._restore_state()
        resp = self.server.node_register(self.node)
        self._heartbeat_ttl = resp.get("heartbeat_ttl", 30.0)
        self.server.node_update_status(self.node.id, "ready")
        # track our own status: re-registrations (periodic re-fingerprint)
        # send the full node, and upsert preserves drain but NOT status — a
        # stale 'initializing' would knock the node out of scheduling
        self.node.status = "ready"
        for target in (
            self._heartbeat_loop,
            self._watch_allocations,
            self._update_loop,
            self._fingerprint_loop,
        ):
            t = threading.Thread(
                target=target, daemon=True,
                name=f"client-{target.__name__.strip('_').replace('_', '-')}",
            )
            t.start()
            self._threads.append(t)
        # external device plugins stream fingerprint changes (chip health
        # transitions, hotplug); a change re-registers the node so the
        # scheduler sees the new device groups (device.proto Fingerprint)
        self.device_manager.start_watches(self._on_device_change)

    def _on_device_change(self):
        try:
            self.device_manager.fingerprint_node(self.node)
            compute_class(self.node)
            self.server.node_register(self.node)
        except Exception:
            logger.exception("device-change node re-registration failed")

    def stop(self, destroy_allocs: bool = True):
        """``destroy_allocs=False`` leaves tasks running (the crash/restart
        path: a real client death can't stop its raw_exec children either —
        the next client recovers them from the state DB)."""
        self._stop.set()
        if destroy_allocs:
            # snapshot: the watch thread keeps mutating the runner map
            # until its join below
            for ar in list(self.alloc_runners.values()):
                ar.destroy()
        for t in self._threads:
            t.join(timeout=1.0)
        self._threads = []
        self.device_manager.shutdown()
        # external driver plugins own subprocesses; in-process drivers
        # have no shutdown and are skipped
        for driver in self.drivers.values():
            stop_fn = getattr(driver, "shutdown", None)
            if stop_fn is not None:
                try:
                    stop_fn()
                except Exception:
                    logger.exception("driver %s shutdown failed", driver.name)
        if self.state_db is not None:
            self.state_db.close()

    # ------------------------------------------------------------------
    def _restore_state(self):
        """Restore alloc runners from the durable DB and reattach to tasks
        still running from the previous client process via the drivers'
        RecoverTask (ref client.go:979 restoreState)."""
        if self.state_db is None:
            return
        for alloc_dict in self.state_db.get_allocs():
            try:
                alloc = Allocation.from_dict(alloc_dict)
            except Exception:
                logger.exception("restore: undecodable alloc doc; dropping")
                continue
            if alloc.server_terminal_status() or alloc.client_terminal_status():
                # the alloc was stopping/stopped when we died: recover any
                # persisted handles purely to make sure the task is dead
                # (a crash between the stop decision and the actual kill
                # would otherwise orphan a live process forever)
                self._kill_orphans(alloc)
                self._forget_alloc(alloc.id)
                continue
            job = alloc.job
            tg = job.lookup_task_group(alloc.task_group) if job else None
            recovered = {}
            if tg is not None:
                for task in tg.tasks:
                    data = self.state_db.get_driver_handle(alloc.id, task.name)
                    driver = self.drivers.get(task.driver)
                    if data is None or driver is None:
                        continue
                    try:
                        handle = driver.recover_task(task, data)
                    except Exception:
                        logger.exception("RecoverTask failed")
                        handle = None
                    if handle is not None:
                        recovered[task.name] = handle
                    else:
                        self.state_db.delete_driver_handle(alloc.id, task.name)
            runner = AllocRunner(self, alloc)
            self.alloc_runners[alloc.id] = runner
            runner.run(
                recovered_handles=recovered,
                restored_states=self.state_db.get_task_states(alloc.id),
            )
            logger.info(
                "restored alloc %s (%d/%d tasks recovered)",
                alloc.id[:8], len(recovered),
                len(tg.tasks) if tg is not None else 0,
            )

    # ------------------------------------------------------------------
    def _kill_orphans(self, alloc: Allocation):
        """Best-effort stop of any still-running tasks of an alloc that is
        not being restored (terminal before the crash)."""
        job = alloc.job
        tg = job.lookup_task_group(alloc.task_group) if job else None
        if tg is None:
            return
        for task in tg.tasks:
            data = self.state_db.get_driver_handle(alloc.id, task.name)
            driver = self.drivers.get(task.driver)
            if data is None or driver is None:
                continue
            try:
                handle = driver.recover_task(task, data)
                if handle is not None and not handle._done.is_set():
                    logger.info(
                        "killing orphaned task %s of terminal alloc %s",
                        task.name, alloc.id[:8],
                    )
                    driver.stop_task(handle)
            except Exception:
                logger.exception("orphan kill failed")

    def _fingerprint_loop(self):
        """Periodic re-fingerprint (ref fingerprint_manager.go: drivers and
        volatile fingerprints re-run on an interval; changes re-register
        the node so the scheduler sees current health/capacity)."""
        interval = self.fingerprint_interval
        while not self._stop.is_set():
            if self._stop.wait(interval):
                return
            try:
                from . import fingerprint as fp_mod

                changed = self._fingerprint_drivers(self.node)
                _, disk_free = fp_mod.storage_fingerprint(self.data_dir)
                current = self.node.node_resources.disk.disk_mb
                # hysteresis: free space jitters constantly; re-advertise
                # only when it moves enough to matter for bin-packing
                if abs(disk_free - current) > max(1024, current // 20):
                    self.node.node_resources.disk.disk_mb = disk_free
                    self.node.attributes["unique.storage.bytesfree"] = str(
                        disk_free * 1024 * 1024
                    )
                    changed = True
                if changed:
                    compute_class(self.node)
                    self.server.node_register(self.node)
            except Exception:
                logger.exception("re-fingerprint failed")

    def _heartbeat_loop(self):
        """ref client.go:1421 registerAndHeartbeat"""
        while not self._stop.is_set():
            interval = max(self._heartbeat_ttl / 2, 0.05)
            if self._stop.wait(interval):
                return
            try:
                self.server.node_heartbeat(self.node.id)
            except Exception:
                logger.exception("heartbeat failed")

    def _watch_allocations(self):
        """Long-poll the server for alloc changes (ref client.go:1861)."""
        index = 0
        # WHY: the node's single alloc-watch long-poll — one in-flight
        # query per node by construction, paced by the blocking-query
        # wait; severing it on budget would blind the node to its work
        while not self._stop.is_set():  # nta: ignore[retry-without-budget]
            try:
                allocs, new_index = self.server.get_client_allocs(
                    self.node.id, min_index=index, timeout=0.5
                )
            except Exception:
                logger.exception("alloc watch failed")
                time.sleep(0.5)
                continue
            if new_index == index:
                continue
            index = new_index
            self._run_allocs(allocs)

    def _run_allocs(self, allocs: list[Allocation]):
        """Diff desired allocs against runners (ref client.go:2079 runAllocs)."""
        desired = {a.id: a for a in allocs}
        for alloc_id, alloc in desired.items():
            runner = self.alloc_runners.get(alloc_id)
            if runner is None:
                if alloc.server_terminal_status() or alloc.client_terminal_status():
                    continue
                # Copy: in-process transport hands us the state store's own
                # objects; the reference's msgpack RPC boundary implies a
                # copy, and runner hooks mutate alloc fields (health).
                runner = AllocRunner(self, alloc.copy())
                self.alloc_runners[alloc_id] = runner
                self._persist_alloc(runner)
                runner.run()
            else:
                runner.update(alloc)
                self._persist_alloc(runner)
        # GC: destroy runners for allocs removed server-side (job purge /
        # alloc GC) and drop terminal runners (ref client.go removeAlloc)
        for alloc_id in list(self.alloc_runners):
            runner = self.alloc_runners[alloc_id]
            if alloc_id not in desired:
                runner.destroy()
                del self.alloc_runners[alloc_id]
                self._forget_alloc(alloc_id, reclaim=True)
            elif runner._destroyed and runner.client_status() in (
                "complete",
                "failed",
            ):
                del self.alloc_runners[alloc_id]
                self._forget_alloc(alloc_id)

    def _persist_alloc(self, runner: AllocRunner):
        """State-DB writes must never kill the alloc-watch thread."""
        if self.state_db is None:
            return
        try:
            self.state_db.put_alloc(runner.alloc.to_dict())
        except Exception:
            logger.exception("persisting alloc failed")

    def _forget_alloc(self, alloc_id: str, reclaim: bool = False):
        """Drop a runner's durable state. Alloc-dir GC (ref client/gc.go
        AllocGarbageCollector): with ``reclaim`` (the alloc vanished
        server-side — purge/GC) the directory goes immediately; otherwise
        terminal dirs are RETAINED until gc_max_allocs is exceeded, so
        `alloc logs`/`alloc fs` keep working on recently stopped allocs."""
        if self.state_db is not None:
            try:
                self.state_db.delete_alloc(alloc_id)
            except Exception:
                logger.exception("deleting alloc state failed")
        if reclaim:
            self._reclaim_alloc_dir(alloc_id)
            return
        self._terminal_alloc_dirs.append(alloc_id)
        while len(self._terminal_alloc_dirs) > self.gc_max_allocs:
            self._reclaim_alloc_dir(self._terminal_alloc_dirs.pop(0))

    def _reclaim_alloc_dir(self, alloc_id: str):
        import shutil

        d = os.path.join(self.data_dir, "allocs", alloc_id)
        if os.path.isdir(d):
            try:
                shutil.rmtree(d)
            except OSError:
                logger.exception("alloc dir GC failed for %s", alloc_id)

    # ------------------------------------------------------------------
    def host_stats(self) -> dict:
        """Sampled host cpu/mem/disk/uptime stats (ref client/stats/host.go;
        served as /v1/client/stats)."""
        from .stats import HostStatsCollector

        if getattr(self, "_stats_collector", None) is None:
            self._stats_collector = HostStatsCollector(self.data_dir)
        stats = self._stats_collector.collect()
        stats["node_id"] = self.node.id
        stats["allocs_running"] = len(self.alloc_runners)
        stats["devices"] = self.device_manager.stats()
        # workload rollup: total task usage across local allocs (the
        # reference aggregates TaskResourceUsage into client metrics).
        # TTL-cached: driver stats can shell out (docker stats ~2s per
        # container), which must not ride every /v1/client/stats poll
        cached = getattr(self, "_rollup_cache", None)
        now = time.monotonic()
        if cached is not None and now - cached[1] < 10.0:
            stats["allocs_usage"] = cached[0]
            return stats
        rollup = {"cpu_time_s": 0.0, "rss_bytes": 0, "pids": 0}
        for alloc_id in list(self.alloc_runners):
            try:
                total = self.alloc_stats(alloc_id).get("resource_usage", {})
            except KeyError:
                continue
            rollup["cpu_time_s"] = round(
                rollup["cpu_time_s"] + total.get("cpu_time_s", 0.0), 3
            )
            rollup["rss_bytes"] += total.get("rss_bytes", 0)
            rollup["pids"] += total.get("pids", 0)
        self._rollup_cache = (rollup, now)
        stats["allocs_usage"] = rollup
        return stats

    def alloc_stats(self, alloc_id: str) -> dict:
        """Per-task resource usage for a local alloc (ref
        client_alloc_endpoint.go Stats → TaskResourceUsage), sourced from
        each task's DRIVER (driver.proto:59 TaskStats): the exec family
        walks the process tree, docker asks the engine — container
        processes aren't our children."""
        runner = self.alloc_runners.get(alloc_id)
        if runner is None:
            raise KeyError(f"alloc not found on this client: {alloc_id}")
        tasks = {}
        total = {"cpu_time_s": 0.0, "rss_bytes": 0, "pids": 0}
        for name, tr in runner.task_runners.items():
            usage = (
                tr.driver.task_stats(tr.handle)
                if tr.handle is not None
                else {
                    "cpu_time_s": 0.0,
                    "cpu_percent": 0.0,
                    "rss_bytes": 0,
                    "pids": 0,
                    "timestamp": now_ns(),
                }
            )
            usage["state"] = tr.state.state
            tasks[name] = usage
            total["cpu_time_s"] = round(
                total["cpu_time_s"] + usage["cpu_time_s"], 3
            )
            total["rss_bytes"] += usage["rss_bytes"]
            total["pids"] += usage["pids"]
        return {
            "alloc_id": alloc_id,
            "tasks": tasks,
            "resource_usage": total,
            "timestamp": now_ns(),
        }

    def alloc_restart(self, alloc_id: str, task_name: str = "") -> list[str]:
        """Restart a local allocation's task(s); ref client Allocations
        endpoint Restart."""
        runner = self.alloc_runners.get(alloc_id)
        if runner is None:
            raise KeyError(f"alloc not found on this client: {alloc_id}")
        return runner.restart_task(task_name)

    def exec_session(
        self, alloc_id: str, task_name: str, cmd: list, tty: bool = False
    ):
        """Open a streaming exec INSIDE a running task's execution context
        (ref client Allocations.Exec → driver ExecTaskStreaming,
        plugins/drivers/proto/driver.proto:72-76); returns an
        execstream.ExecProcess the caller bridges to a duplex stream."""
        runner = self.alloc_runners.get(alloc_id)
        if runner is None:
            raise KeyError(f"alloc not found on this client: {alloc_id}")
        if not cmd:
            raise ValueError("exec requires a command")
        tr = runner.task_runners.get(task_name)
        if tr is None:
            if len(runner.task_runners) == 1 and not task_name:
                tr = next(iter(runner.task_runners.values()))
            else:
                raise KeyError(f"task not found in alloc: {task_name}")
        if tr.handle is None:
            raise ValueError("task has not started")
        task_dir = runner.task_dir(tr.task.name)
        return tr.driver.exec_streaming(
            tr.handle,
            list(cmd),
            tty=tty,
            task_dir=task_dir,
            env=dict(tr.task.env),
        )

    def alloc_signal(
        self, alloc_id: str, signal_name: str, task_name: str = ""
    ) -> list[str]:
        """Signal a local allocation's task(s); ref client Allocations
        endpoint Signal."""
        runner = self.alloc_runners.get(alloc_id)
        if runner is None:
            raise KeyError(f"alloc not found on this client: {alloc_id}")
        return runner.signal_task(signal_name, task_name)

    def alloc_state_updated(self, runner: AllocRunner):
        """Batch alloc status updates back to the server
        (ref client.go AllocStateUpdated + allocSync)."""
        update = runner.alloc.copy()
        update.client_status = runner.client_status()
        update.task_states = {
            name: tr.state for name, tr in runner.task_runners.items()
        }
        update.modify_time = now_ns()
        # keep the runner's own copy in sync so later persistence points
        # (runner.update → put_alloc) don't resurrect a stale status
        runner.alloc.client_status = update.client_status
        if self.state_db is not None:
            try:
                # one transaction: the alloc doc (carrying the aggregated
                # client_status so a restore prunes terminal allocs) plus
                # each task's state with its restart-budget timestamps
                task_docs = {}
                for name, tr in runner.task_runners.items():
                    doc = tr.state.to_dict()
                    doc["restart_times"] = list(tr._restarts_in_interval)
                    doc["events"] = list(tr._events)
                    task_docs[name] = doc
                self.state_db.put_alloc_update(update.to_dict(), task_docs)
            except Exception:
                logger.exception("persisting task state failed")
        with self._update_lock:
            self._pending_updates[update.id] = update

    def _update_loop(self):
        while not self._stop.is_set():
            if self._stop.wait(0.1):
                return
            with self._update_lock:
                updates = list(self._pending_updates.values())
                self._pending_updates.clear()
            if updates:
                try:
                    self.server.update_allocs(updates)
                except Exception:
                    logger.exception("alloc update failed")
