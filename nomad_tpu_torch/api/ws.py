"""Minimal WebSocket (RFC 6455) framing for the interactive exec surface.

The reference serves `/v1/client/allocation/:id/exec` as a websocket of
JSON frames (command/agent/alloc_endpoint.go execStream; api/allocations.go
Exec): stdin/tty-size frames up, stdout/stderr/exited frames down, with
byte payloads base64-encoded inside the JSON. This module implements just
enough of RFC 6455 for that: the upgrade handshake, unfragmented
text/binary frames, close, and ping/pong — server side (on a hijacked
http.server connection) and client side (for the CLI/API client).
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
from typing import Optional

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


class WsClosed(Exception):
    pass


def accept_key(key: str) -> str:
    digest = hashlib.sha1((key + GUID).encode()).digest()
    return base64.b64encode(digest).decode()


# -- server side --------------------------------------------------------


def server_handshake(handler) -> socket.socket:
    """Upgrade a BaseHTTPRequestHandler connection to a websocket; returns
    the raw socket (the HTTP layer must not touch it afterwards)."""
    key = handler.headers.get("Sec-WebSocket-Key", "")
    if not key:
        raise ValueError("missing Sec-WebSocket-Key")
    handler.wfile.write(
        (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept_key(key)}\r\n"
            "\r\n"
        ).encode()
    )
    handler.wfile.flush()
    return handler.connection


# -- shared framing -----------------------------------------------------


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise WsClosed()
        buf.extend(chunk)
    return bytes(buf)


def read_message(sock: socket.socket) -> tuple[int, bytes]:
    """Read one complete message; transparently answers pings. Returns
    (opcode, payload); raises WsClosed on close/EOF."""
    payload = bytearray()
    opcode = None
    while True:
        b1, b2 = _read_exact(sock, 2)
        fin = b1 & 0x80
        op = b1 & 0x0F
        masked = b2 & 0x80
        length = b2 & 0x7F
        if length == 126:
            (length,) = struct.unpack(">H", _read_exact(sock, 2))
        elif length == 127:
            (length,) = struct.unpack(">Q", _read_exact(sock, 8))
        mask = _read_exact(sock, 4) if masked else None
        data = _read_exact(sock, length) if length else b""
        if mask:
            data = bytes(c ^ mask[i % 4] for i, c in enumerate(data))
        if op == OP_CLOSE:
            raise WsClosed()
        if op == OP_PING:
            send_message(sock, data, opcode=OP_PONG)
            continue
        if op == OP_PONG:
            continue
        if op in (OP_TEXT, OP_BINARY):
            opcode = op
        payload.extend(data)
        if fin:
            return opcode or OP_TEXT, bytes(payload)


def send_message(
    sock: socket.socket,
    data: bytes,
    opcode: int = OP_TEXT,
    mask: bool = False,
) -> None:
    if isinstance(data, str):
        data = data.encode()
    header = bytearray([0x80 | opcode])
    length = len(data)
    mask_bit = 0x80 if mask else 0
    if length < 126:
        header.append(mask_bit | length)
    elif length < 1 << 16:
        header.append(mask_bit | 126)
        header += struct.pack(">H", length)
    else:
        header.append(mask_bit | 127)
        header += struct.pack(">Q", length)
    if mask:
        key = os.urandom(4)
        header += key
        data = bytes(c ^ key[i % 4] for i, c in enumerate(data))
    sock.sendall(bytes(header) + data)


def send_close(sock: socket.socket, mask: bool = False) -> None:
    try:
        send_message(sock, b"", opcode=OP_CLOSE, mask=mask)
    except OSError:
        pass


# -- client side --------------------------------------------------------


class WsClient:
    """Dial-side websocket for the CLI/API client. Client frames are
    masked per RFC 6455."""

    def __init__(
        self, address: str, path: str, token: str = "", tls: bool = False
    ):
        host, port = address.rsplit(":", 1)
        self.sock = socket.create_connection((host, int(port)), timeout=10.0)
        if tls:
            import ssl

            ctx = ssl.create_default_context()
            self.sock = ctx.wrap_socket(self.sock, server_hostname=host)
        key = base64.b64encode(os.urandom(16)).decode()
        headers = (
            f"GET {path} HTTP/1.1\r\n"
            f"Host: {address}\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n"
        )
        if token:
            headers += f"X-Nomad-Token: {token}\r\n"
        self.sock.sendall((headers + "\r\n").encode())
        status = self._read_headers()
        if "101" not in status[0]:
            raise ValueError(f"websocket upgrade refused: {status[0].strip()}")
        want = accept_key(key)
        accept = next(
            (
                line.split(":", 1)[1].strip()
                for line in status
                if line.lower().startswith("sec-websocket-accept")
            ),
            "",
        )
        if accept != want:
            raise ValueError("bad Sec-WebSocket-Accept")
        self.sock.settimeout(None)

    def _read_headers(self) -> list[str]:
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = self.sock.recv(1024)
            if not chunk:
                raise WsClosed()
            data += chunk
        head, _, rest = data.partition(b"\r\n\r\n")
        self._buffer = rest  # any early ws bytes
        return head.decode("latin1").split("\r\n")

    def recv(self, timeout: Optional[float] = None) -> bytes:
        # replay bytes that arrived with the handshake response first
        if getattr(self, "_buffer", b""):
            import io

            buf = self._buffer

            class _Replay:
                def __init__(self, data, sock):
                    self.data = io.BytesIO(data)
                    self.sock = sock

                def recv(self, n):
                    chunk = self.data.read(n)
                    if chunk:
                        return chunk
                    return self.sock.recv(n)

                def sendall(self, b):
                    return self.sock.sendall(b)

            replay = _Replay(buf, self.sock)
            self._buffer = b""
            self.sock.settimeout(timeout)
            try:
                _, payload = read_message(replay)
                leftover = replay.data.read()
                self._buffer = leftover
                return payload
            finally:
                self.sock.settimeout(None)
        self.sock.settimeout(timeout)
        try:
            _, payload = read_message(self.sock)
            return payload
        finally:
            self.sock.settimeout(None)

    def send(self, data) -> None:
        if isinstance(data, str):
            data = data.encode()
        send_message(self.sock, data, opcode=OP_TEXT, mask=True)

    def close(self) -> None:
        send_close(self.sock, mask=True)
        try:
            self.sock.close()
        except OSError:
            pass
