"""Client-side driver plugin proxy (ref helper/pluginutils/loader +
plugins/drivers/client.go: the go-plugin managed subprocess and its gRPC
client shim).

ExternalDriver spawns ``python -m nomad_tpu_torch.plugins.serve`` with a driver
spec, connects over the unix socket, and implements the ordinary Driver
interface by RPC. Wait semantics are preserved by a per-task poller thread
long-polling Driver.WaitTask and completing a local TaskHandle, so runner
code is identical for in-process and subprocess drivers. If the plugin
process dies, in-flight handles fail; RecoverTask after a client restart
spawns a fresh plugin process and reattaches by the persisted handle data
(driver.proto:35)."""

from __future__ import annotations

import logging
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

from ..client.driver import Driver, TaskHandle
from ..rpc.codec import ConnectionClosed, read_frame, write_frame
from ..structs.model import Task

logger = logging.getLogger("nomad_tpu.plugins.external")

LAUNCH_TIMEOUT = 10.0


def validate_plugin_config(schema: dict, config: dict) -> dict:
    """Validate a plugin config against its declared schema and fold in
    defaults (the hclspec role, plugins/shared/hclspec). Flat entries
    ({key: {"type", "required", "default"}}) and typed nested spec nodes
    (hclspec.Attr/Block/BlockList) both work; errors carry the failing
    field's full path."""
    from .hclspec import SpecError, validate_spec

    try:
        return validate_spec(schema or {}, config)
    except SpecError as e:
        raise PluginError(str(e))


class PluginError(RuntimeError):
    pass


class _Conn:
    """Seq-matched request/response client over the framed socket."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._seq = 0
        self._lock = threading.Lock()
        self._pending: dict[int, tuple[threading.Event, list]] = {}
        self._closed = False
        threading.Thread(
            target=self._read_loop, daemon=True, name="plugin-rpc-reader"
        ).start()

    def _read_loop(self):
        while True:
            try:
                seq, error, payload = read_frame(self._sock)
            except (ConnectionClosed, OSError):
                break
            with self._lock:
                waiter = self._pending.pop(seq, None)
            if waiter is not None:
                waiter[1].extend([error, payload])
                waiter[0].set()
        with self._lock:
            self._closed = True
            pending, self._pending = self._pending, {}
        for event, box in pending.values():
            box.extend(["plugin connection closed", None])
            event.set()

    def call(self, method: str, payload: dict, timeout: float = 30.0):
        event = threading.Event()
        box: list = []
        with self._lock:
            if self._closed:
                raise PluginError("plugin connection closed")
            self._seq += 1
            seq = self._seq
            self._pending[seq] = (event, box)
            try:
                write_frame(self._sock, [seq, method, payload])
            except OSError as e:
                self._pending.pop(seq, None)
                raise PluginError(f"plugin write failed: {e}")
        if not event.wait(timeout):
            with self._lock:
                self._pending.pop(seq, None)
            raise PluginError(f"plugin call {method} timed out")
        error, result = box
        if error is not None:
            raise PluginError(str(error))
        return result

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


class PluginProcess:
    """Subprocess lifecycle + base-protocol handshake shared by every
    external plugin kind (ref helper/pluginutils/loader: go-plugin's managed
    process + the base.proto Info/ConfigSchema/SetConfig handshake). Owns
    launch, reconnect-after-crash, config push, and teardown; the typed
    wrappers (ExternalDriver, ExternalDevicePlugin) add their protocol."""

    def __init__(self, kind_flag: str, spec: str, config: Optional[dict] = None):
        self.kind_flag = kind_flag  # "--driver" | "--device"
        self.spec = spec
        self.config = dict(config or {})
        self.info: dict = {}
        self._proc: Optional[subprocess.Popen] = None
        self._conn: Optional[_Conn] = None
        self._lock = threading.Lock()

    @property
    def conn(self) -> Optional[_Conn]:
        return self._conn

    def ensure(self) -> _Conn:
        with self._lock:
            if self._conn is not None and self._proc is not None and self._proc.poll() is None:
                return self._conn
            return self._launch_locked()

    def _launch_locked(self) -> _Conn:
        sock_path = os.path.join(
            tempfile.mkdtemp(prefix="nomad_plugin_"), "plugin.sock"
        )
        self._proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "nomad_tpu_torch.plugins.serve",
                self.kind_flag,
                self.spec,
                "--socket",
                sock_path,
            ],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        deadline = time.monotonic() + LAUNCH_TIMEOUT
        last_err = None
        while time.monotonic() < deadline:
            if self._proc.poll() is not None:
                raise PluginError(
                    f"plugin process exited at launch (rc={self._proc.returncode})"
                )
            try:
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.connect(sock_path)
                conn = _Conn(s)
                try:
                    self.info = conn.call("Plugin.Info", {})
                    # base.proto handshake tail: fetch the schema, validate
                    # our config against it, push it (every (re)launch — a
                    # crashed plugin must come back configured)
                    schema = conn.call("Plugin.ConfigSchema", {}) or {}
                    config = validate_plugin_config(schema, self.config)
                    if config or schema:
                        conn.call("Plugin.SetConfig", {"config": config})
                except Exception:
                    # a half-shaken-hands plugin must not be reused: tear
                    # down so the next attempt (and this error) are clean
                    conn.close()
                    self._proc.terminate()
                    self._proc = None
                    raise
                self._conn = conn
                return self._conn
            except (FileNotFoundError, ConnectionRefusedError, OSError) as e:
                last_err = e
                time.sleep(0.05)
        raise PluginError(f"plugin socket never came up: {last_err}")

    def shutdown(self):
        # detach under the lock, reap outside it: wait(timeout=5.0) on a
        # wedged plugin otherwise blocks every concurrent ensure() for
        # the full grace period (analyzer: lock-held-blocking-call)
        with self._lock:
            conn, self._conn = self._conn, None
            proc, self._proc = self._proc, None
        if conn is not None:
            conn.close()
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                proc.kill()


class ExternalDriver(Driver):
    """A Driver whose implementation runs in a plugin subprocess."""

    def __init__(
        self,
        driver_spec: str,
        name: Optional[str] = None,
        config: Optional[dict] = None,
    ):
        """``driver_spec`` is 'pkg.module:factory' resolved inside the
        plugin process (e.g. 'nomad_tpu_torch.client.driver:MockDriver').
        ``config`` is validated against the plugin's declared schema at
        handshake and pushed via SetConfig (base.proto)."""
        self.spec = driver_spec
        self.name = name or driver_spec.rsplit(":", 1)[-1].lower()
        self._pp = PluginProcess("--driver", driver_spec, config)

    # -- process management --------------------------------------------
    @property
    def _conn(self) -> Optional[_Conn]:
        return self._pp.conn

    @property
    def _proc(self) -> Optional[subprocess.Popen]:
        return self._pp._proc

    @property
    def config(self) -> dict:
        """The live handshake config (mutations flow to the next
        SetConfig on relaunch) — one source of truth in the process."""
        return self._pp.config

    def _ensure(self) -> _Conn:
        conn = self._pp.ensure()
        self.name = self._pp.info.get("name", self.name)
        return conn

    def shutdown(self):
        self._pp.shutdown()

    # -- handle plumbing ------------------------------------------------
    def _local_handle(self, desc: dict, task: Task) -> TaskHandle:
        handle = TaskHandle(
            task_name=task.name,
            driver=self.name,
            pid=int(desc.get("pid", 0)),
            started_at=int(desc.get("started_at", 0)),
            recovered=bool(desc.get("recovered", False)),
        )
        handle._plugin_id = desc["handle_id"]
        conn = self._conn

        def poller():
            while not handle._done.is_set():
                try:
                    r = conn.call(
                        "Driver.WaitTask",
                        {"handle_id": handle._plugin_id, "timeout": 1.0},
                        timeout=30.0,
                    )
                except PluginError as e:
                    handle.finish(128, f"plugin died: {e}")
                    return
                if r.get("done"):
                    handle.exit_code = r.get("exit_code")
                    handle.error = r.get("error", "")
                    handle.finished_at = r.get("finished_at") or time.time_ns()
                    handle._done.set()
                    return

        threading.Thread(
            target=poller, daemon=True, name="plugin-task-poller"
        ).start()
        return handle

    # -- Driver interface -----------------------------------------------
    def fingerprint(self) -> dict:
        try:
            return self._ensure().call("Driver.Fingerprint", {})
        except PluginError as e:
            logger.warning("plugin fingerprint failed: %s", e)
            return {"detected": False, "healthy": False, "attributes": {}}

    def start_task(self, task: Task, task_dir: str) -> TaskHandle:
        desc = self._ensure().call(
            "Driver.StartTask",
            {"task": task.to_dict(), "task_dir": task_dir},
        )
        return self._local_handle(desc, task)

    def stop_task(self, handle: TaskHandle, timeout: float = 5.0,
                  signal_name: str = ""):
        conn = self._conn
        if conn is None or not hasattr(handle, "_plugin_id"):
            return
        try:
            conn.call(
                "Driver.StopTask",
                {
                    "handle_id": handle._plugin_id,
                    "timeout": timeout,
                    "signal": signal_name,
                },
                timeout=timeout + 10.0,
            )
        except PluginError as e:
            logger.warning("plugin stop failed: %s", e)

    def inspect_task(self, handle: TaskHandle) -> dict:
        conn = self._conn
        if conn is None or not hasattr(handle, "_plugin_id"):
            return super().inspect_task(handle)
        return conn.call("Driver.InspectTask", {"handle_id": handle._plugin_id})

    def handle_data(self, handle: TaskHandle) -> dict:
        conn = self._conn
        if conn is not None and hasattr(handle, "_plugin_id"):
            try:
                data = conn.call(
                    "Driver.HandleData", {"handle_id": handle._plugin_id}
                )
                data["plugin_spec"] = self.spec
                return data
            except PluginError:
                pass
        return {"driver": self.name, "task_name": handle.task_name}

    def recover_task(self, task: Task, data: dict) -> Optional[TaskHandle]:
        try:
            desc = self._ensure().call(
                "Driver.RecoverTask", {"task": task.to_dict(), "data": data}
            )
        except PluginError as e:
            logger.warning("plugin recover failed: %s", e)
            return None
        if not desc.get("recovered"):
            return None
        return self._local_handle(desc, task)


class ExternalDevicePlugin:
    """A DevicePlugin served from a plugin subprocess (the framework's
    analog of the reference's out-of-process gRPC device plugins,
    plugins/device/proto/device.proto:1-40: a vendor ships a binary; the
    client manages its process and talks Fingerprint/Reserve/Stats).

    Implements the same duck-typed surface the in-process plugins expose
    (client/devices.py DevicePlugin), so DeviceManager treats both kinds
    identically. ``watch`` mirrors the reference's streaming Fingerprint:
    a long-poll thread that fires ``on_change`` whenever the plugin's
    detected device set changes (new chip, health transition), letting the
    client re-register the node."""

    #: long-poll window for the change watch (device.proto's stream has no
    #: polling; one server-side blocked call per window is the analog)
    WATCH_TIMEOUT = 30.0

    def __init__(
        self,
        device_spec: str,
        name: Optional[str] = None,
        config: Optional[dict] = None,
    ):
        self.spec = device_spec
        self.name = name or device_spec.rsplit(":", 1)[-1].lower()
        self._pp = PluginProcess("--device", device_spec, config)
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self._generation: Optional[int] = None

    def _ensure(self) -> _Conn:
        conn = self._pp.ensure()
        self.name = self._pp.info.get("name", self.name)
        return conn

    @property
    def config(self) -> dict:
        return self._pp.config

    # -- DevicePlugin surface ------------------------------------------
    def fingerprint(self) -> list:
        from ..structs.model import NodeDeviceResource

        r = self._ensure().call("Device.Fingerprint", {})
        self._generation = r.get("generation")
        return [NodeDeviceResource.from_dict(g) for g in r.get("groups", [])]

    def reserve(self, device_ids: list) -> dict:
        return self._ensure().call(
            "Device.Reserve", {"device_ids": list(device_ids)}
        )

    def stats(self) -> dict:
        try:
            return self._ensure().call("Device.Stats", {}) or {}
        except PluginError as e:
            logger.warning("device plugin stats failed: %s", e)
            return {}

    # -- streaming fingerprint (device.proto Fingerprint stream) --------
    def watch(self, on_change) -> None:
        """Start the change watch: ``on_change()`` fires whenever the
        plugin's device set generation moves past the last fingerprint()."""
        if self._watch_thread is not None:
            return
        # fresh event per watch: a stopped client can start again, and the
        # new watch must not inherit the previous shutdown's stop flag
        self._watch_stop = threading.Event()

        def loop():
            while not self._watch_stop.is_set():
                try:
                    r = self._ensure().call(
                        "Device.Fingerprint",
                        {
                            "generation": self._generation,
                            "timeout": self.WATCH_TIMEOUT,
                        },
                        timeout=self.WATCH_TIMEOUT + 15.0,
                    )
                except PluginError as e:
                    if self._watch_stop.is_set():
                        return
                    logger.warning("device plugin watch failed: %s", e)
                    self._watch_stop.wait(1.0)
                    continue
                gen = r.get("generation")
                if self._generation is not None and gen != self._generation:
                    self._generation = gen
                    try:
                        on_change()
                    except Exception:
                        logger.exception("device change callback failed")
                elif self._generation is None:
                    self._generation = gen

        self._watch_thread = threading.Thread(
            target=loop, daemon=True, name="plugin-device-watcher"
        )
        self._watch_thread.start()

    def shutdown(self):
        self._watch_stop.set()
        self._pp.shutdown()
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=2.0)
            self._watch_thread = None
