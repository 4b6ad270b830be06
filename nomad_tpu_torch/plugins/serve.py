"""Plugin-process side of the driver protocol (ref plugins/serve.go +
plugins/drivers/server.go: the gRPC DriverPlugin server).

A plugin process hosts one Driver implementation behind a unix socket.
Requests are ``[seq, method, payload]`` frames (rpc/codec.py); each request
is dispatched on its own thread so a blocked WaitTask long-poll never
stalls StartTask/StopTask — the same concurrency gRPC gives the reference.

Run directly for external plugin binaries:
    python -m nomad_tpu_torch.plugins.serve --driver pkg.module:factory --socket P
"""

from __future__ import annotations

import argparse
import importlib
import logging
import os
import socket
import threading
import traceback

from ..rpc.codec import ConnectionClosed, read_frame, write_frame
from ..structs.model import Task

logger = logging.getLogger("nomad_tpu.plugins.serve")


class _DriverService:
    """Method table mapping the wire protocol onto a Driver instance
    (ref plugins/drivers/proto/driver.proto:13-84)."""

    def __init__(self, driver):
        self.driver = driver
        self._handles: dict[str, object] = {}
        self._next = 0
        self._lock = threading.Lock()

    def _register(self, handle) -> str:
        with self._lock:
            self._next += 1
            hid = f"h{self._next}"
            self._handles[hid] = handle
        return hid

    def _handle(self, hid: str):
        with self._lock:
            handle = self._handles.get(hid)
        if handle is None:
            raise KeyError(f"unknown handle {hid}")
        return handle

    @staticmethod
    def _describe(hid: str, handle) -> dict:
        return {
            "handle_id": hid,
            "pid": handle.pid,
            "started_at": handle.started_at,
            "recovered": handle.recovered,
        }

    # -- protocol methods ----------------------------------------------
    def plugin_info(self, payload: dict) -> dict:
        return {
            "name": self.driver.name,
            "type": "driver",
            "api_version": 1,
        }

    def config_schema(self, payload: dict) -> dict:
        """ref base.proto ConfigSchema (the hclspec role)."""
        return getattr(self.driver, "config_schema", dict)() or {}

    def set_config(self, payload: dict) -> dict:
        """ref base.proto SetConfig."""
        setter = getattr(self.driver, "set_config", None)
        if setter is not None:
            setter(payload.get("config") or {})
        return {}

    def fingerprint(self, payload: dict) -> dict:
        return self.driver.fingerprint()

    def start_task(self, payload: dict) -> dict:
        task = Task.from_dict(payload["task"])
        handle = self.driver.start_task(task, payload.get("task_dir", ""))
        return self._describe(self._register(handle), handle)

    def wait_task(self, payload: dict) -> dict:
        handle = self._handle(payload["handle_id"])
        done = handle.wait(timeout=payload.get("timeout", 1.0))
        return {
            "done": done,
            "exit_code": handle.exit_code,
            "error": handle.error,
            "finished_at": handle.finished_at,
        }

    def stop_task(self, payload: dict) -> dict:
        handle = self._handle(payload["handle_id"])
        self.driver.stop_task(
            handle,
            timeout=payload.get("timeout", 5.0),
            signal_name=payload.get("signal", ""),
        )
        return {}

    def destroy_task(self, payload: dict) -> dict:
        hid = payload["handle_id"]
        handle = self._handle(hid)
        self.driver.destroy_task(handle)
        with self._lock:
            self._handles.pop(hid, None)
        return {}

    def inspect_task(self, payload: dict) -> dict:
        return self.driver.inspect_task(self._handle(payload["handle_id"]))

    def handle_data(self, payload: dict) -> dict:
        return self.driver.handle_data(self._handle(payload["handle_id"]))

    def recover_task(self, payload: dict) -> dict:
        task = Task.from_dict(payload["task"])
        handle = self.driver.recover_task(task, payload["data"])
        if handle is None:
            return {"recovered": False}
        desc = self._describe(self._register(handle), handle)
        desc["recovered"] = True
        return desc

    METHODS = {
        "Plugin.Info": plugin_info,
        "Plugin.ConfigSchema": config_schema,
        "Plugin.SetConfig": set_config,
        "Driver.Fingerprint": fingerprint,
        "Driver.StartTask": start_task,
        "Driver.WaitTask": wait_task,
        "Driver.StopTask": stop_task,
        "Driver.DestroyTask": destroy_task,
        "Driver.InspectTask": inspect_task,
        "Driver.HandleData": handle_data,
        "Driver.RecoverTask": recover_task,
    }


class _DeviceService:
    """Method table mapping the wire protocol onto a DevicePlugin instance
    (ref plugins/device/proto/device.proto:1-40: Fingerprint is a server
    stream pushing device-group changes; here the same liveness comes from
    a generation-tagged long poll — the client repolls with the last
    generation it saw and the call returns early when the detected set
    changes, e.g. a chip going unhealthy)."""

    POLL_INTERVAL = 0.25

    def __init__(self, plugin):
        self.plugin = plugin
        self._lock = threading.Lock()
        self._generation = 0
        self._last_blob: object = None

    def _current(self) -> tuple[int, list]:
        groups = self.plugin.fingerprint()
        blob = [g.to_dict() for g in groups]
        with self._lock:
            if blob != self._last_blob:
                self._generation += 1
                self._last_blob = blob
            return self._generation, blob

    # -- protocol methods ----------------------------------------------
    def plugin_info(self, payload: dict) -> dict:
        return {
            "name": getattr(self.plugin, "name", "device"),
            "type": "device",
            "api_version": 1,
        }

    def config_schema(self, payload: dict) -> dict:
        return getattr(self.plugin, "config_schema", dict)() or {}

    def set_config(self, payload: dict) -> dict:
        setter = getattr(self.plugin, "set_config", None)
        if setter is not None:
            setter(payload.get("config") or {})
        return {}

    def fingerprint(self, payload: dict) -> dict:
        """Long-poll: returns immediately when the caller has no generation
        (or a stale one), otherwise blocks until the detected device set
        changes or ``timeout`` elapses (device.proto Fingerprint stream)."""
        import time as _time

        known = payload.get("generation")
        deadline = _time.monotonic() + float(payload.get("timeout", 0.0))
        while True:
            gen, blob = self._current()
            if known is None or gen != known or _time.monotonic() >= deadline:
                return {"generation": gen, "groups": blob}
            _time.sleep(self.POLL_INTERVAL)

    def reserve(self, payload: dict) -> dict:
        """ref device.proto Reserve → ContainerReservation."""
        return self.plugin.reserve(list(payload.get("device_ids") or []))

    def stats(self, payload: dict) -> dict:
        return self.plugin.stats() or {}

    METHODS = {
        "Plugin.Info": plugin_info,
        "Plugin.ConfigSchema": config_schema,
        "Plugin.SetConfig": set_config,
        "Device.Fingerprint": fingerprint,
        "Device.Reserve": reserve,
        "Device.Stats": stats,
    }


def serve_driver(driver, socket_path: str, ready_event=None):
    """Serve one Driver on a unix socket until the client disconnects."""
    return _serve(_DriverService(driver), socket_path, ready_event)


def serve_device(plugin, socket_path: str, ready_event=None):
    """Serve one DevicePlugin on a unix socket until the client disconnects."""
    return _serve(_DeviceService(plugin), socket_path, ready_event)


def _serve(service, socket_path: str, ready_event=None):
    try:
        os.unlink(socket_path)
    except FileNotFoundError:
        pass
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(socket_path)
    listener.listen(1)
    if ready_event is not None:
        ready_event.set()
    conn, _ = listener.accept()
    listener.close()

    write_lock = threading.Lock()

    def dispatch(seq, method, payload):
        try:
            fn = service.METHODS.get(method)
            if fn is None:
                raise KeyError(f"unknown method {method}")
            result = fn(service, payload or {})
            response = [seq, None, result]
        except Exception as e:
            logger.debug("plugin method %s failed: %s", method, traceback.format_exc())
            response = [seq, f"{type(e).__name__}: {e}", None]
        with write_lock:
            try:
                write_frame(conn, response)
            except OSError:
                pass

    try:
        while True:
            try:
                seq, method, payload = read_frame(conn)
            except (ConnectionClosed, OSError):
                return
            t = threading.Thread(
                target=dispatch, args=(seq, method, payload), daemon=True,
                name="plugin-serve-dispatch",
            )
            t.start()
    finally:
        conn.close()
        try:
            os.unlink(socket_path)
        except FileNotFoundError:
            pass


def _resolve(spec: str):
    """'pkg.module:attr' → the driver factory/class it names."""
    module_name, _, attr = spec.partition(":")
    module = importlib.import_module(module_name)
    obj = getattr(module, attr) if attr else module
    return obj


def main(argv=None):
    parser = argparse.ArgumentParser(prog="nomad-tpu-plugin")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--driver", help="pkg.module:factory")
    group.add_argument("--device", help="pkg.module:factory")
    parser.add_argument("--socket", required=True)
    args = parser.parse_args(argv)
    factory = _resolve(args.driver or args.device)
    plugin = factory() if callable(factory) else factory
    if args.driver:
        serve_driver(plugin, args.socket)
    else:
        serve_device(plugin, args.socket)


if __name__ == "__main__":
    main()
