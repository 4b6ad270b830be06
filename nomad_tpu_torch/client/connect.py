"""Connect service-mesh sidecars (ref Nomad 0.10's Consul Connect
integration: job_endpoint_hook_connect.go injects an envoy sidecar task,
Consul routes sidecar→sidecar). The nomad-native analog runs lightweight
TCP proxies inside the client:

- every task service with ``connect { sidecar_service {} }`` gets an
  inbound sidecar listener that forwards to the service's local port; its
  address is published through alloc updates as ``connect_proxies`` and
  appears in the catalog as ``<svc>-sidecar-proxy``,
- every declared upstream gets a local listener on ``local_bind_port``
  whose connections are dialed to a live ``<destination>-sidecar-proxy``
  instance resolved from the catalog at connect time.

No mTLS (the reference delegates that to Consul's CA); the mesh topology,
discovery, and port indirection are faithful."""

from __future__ import annotations

import logging
import socket
import threading
from typing import Optional

logger = logging.getLogger("nomad_tpu.client.connect")

BUFSIZE = 65536


def _pump(a: socket.socket, b: socket.socket):
    """One direction of a proxied connection."""
    try:
        while True:
            data = a.recv(BUFSIZE)
            if not data:
                break
            b.sendall(data)
    except OSError:
        pass
    finally:
        for s in (a, b):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class _Listener:
    """Accept loop forwarding each connection to dial()'s target.
    ``tls_context`` (server-side) wraps accepted connections — the
    inbound half of sidecar mTLS."""

    def __init__(self, bind: tuple[str, int], dial, name: str,
                 tls_context=None):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(bind)
        self._sock.listen(64)
        self.addr = self._sock.getsockname()
        self._dial = dial
        self._name = name
        self._tls = tls_context
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"connect-accept-{name}",
        )
        self._thread.start()

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._handle, args=(conn,), daemon=True,
                name="connect-proxy-conn",
            ).start()

    def _handle(self, conn: socket.socket):
        if self._tls is not None:
            try:
                conn = self._tls.wrap_socket(conn, server_side=True)
            except Exception as e:
                logger.warning("%s: mTLS handshake failed: %s", self._name, e)
                try:
                    conn.close()
                except OSError:
                    pass
                return
        target = None
        try:
            target = self._dial()
        except Exception as e:
            logger.warning("%s: dial failed: %s", self._name, e)
        if target is None:
            conn.close()
            return
        threading.Thread(
            target=_pump, args=(conn, target), daemon=True,
            name="connect-proxy-pump",
        ).start()
        _pump(target, conn)


class ConnectHook:
    """Per-alloc sidecar manager: inbound listeners for connect services,
    outbound listeners for their upstreams."""

    def __init__(self, client, alloc, tg):
        self.client = client
        self.alloc = alloc
        self.tg = tg
        self._listeners: list[_Listener] = []
        #: service name → {"ip", "port"} for the alloc update publisher
        self.proxies: dict[str, dict] = {}

    def _connect_services(self):
        for task in self.tg.tasks:
            for svc in task.services:
                if svc.connect is not None and svc.connect.sidecar_service is not None:
                    yield task, svc

    def _service_local_port(self, task, svc) -> Optional[int]:
        resources = self.alloc.allocated_resources
        tr = resources.tasks.get(task.name) if resources is not None else None
        if tr is None:
            return None
        for net in tr.networks:
            for p in list(net.reserved_ports) + list(net.dynamic_ports):
                if p.label == svc.port_label:
                    return p.value
        return None

    def start(self) -> bool:
        """Returns True when any sidecar was started (the caller then
        publishes an alloc update carrying the endpoints)."""
        started = False
        for task, svc in self._connect_services():
            sidecar = svc.connect.sidecar_service
            local_port = self._service_local_port(task, svc)

            if local_port is not None:
                def dial_local(port=local_port):
                    return socket.create_connection(("127.0.0.1", port), 10)

                inbound = _Listener(
                    ("127.0.0.1", 0),
                    dial_local,
                    f"sidecar:{svc.name}",
                    # inbound hop authenticates peers under the cluster CA
                    tls_context=getattr(
                        self.client, "tls_server_context", None
                    ),
                )
                self._listeners.append(inbound)
                self.proxies[svc.name] = {
                    "ip": inbound.addr[0],
                    "port": inbound.addr[1],
                }
                started = True

            proxy = sidecar.proxy
            for upstream in (proxy.upstreams if proxy is not None else []):
                dest = upstream.destination_name

                def dial_upstream(dest=dest):
                    resolved = self._resolve(dest)
                    if resolved is None:
                        raise OSError(f"no live sidecar for {dest!r}")
                    target, is_sidecar = resolved
                    sock = socket.create_connection(target, 10)
                    ctx = getattr(self.client, "tls_client_context", None)
                    if ctx is not None and is_sidecar:
                        # sidecar→sidecar hop presents our cluster
                        # identity; plain-service fallbacks stay raw TCP
                        sock = ctx.wrap_socket(sock)
                    return sock

                outbound = _Listener(
                    ("127.0.0.1", upstream.local_bind_port),
                    dial_upstream,
                    f"upstream:{dest}",
                )
                self._listeners.append(outbound)
                started = True
        return started

    def _resolve(self, dest: str) -> Optional[tuple[tuple[str, int], bool]]:
        """((ip, port), is_sidecar) of a live sidecar for the destination,
        else the plain service (non-connect destinations stay reachable)."""
        lookup = getattr(self.client.server, "catalog_service", None)
        if lookup is None:
            return None
        for name, is_sidecar in (
            (f"{dest}-sidecar-proxy", True),
            (dest, False),
        ):
            try:
                entries = lookup(name)
            except Exception:
                logger.exception("catalog lookup for %s failed", name)
                return None
            for entry in entries:
                if entry.get("Status") == "passing" and entry.get("Port"):
                    return (
                        entry.get("Address") or "127.0.0.1",
                        entry["Port"],
                    ), is_sidecar
        return None

    def stop(self):
        for listener in self._listeners:
            listener.stop()
        self._listeners = []
