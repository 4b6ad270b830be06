"""Framed msgpack wire format shared by both RPC protocols.

Frame = [u32 big-endian length][msgpack body]. Requests are
``[seq, method, payload]``; responses ``[seq, error|None, payload]`` —
the shape of net/rpc + msgpack codec the reference uses
(helper/codec, nomad/rpc.go msgpackrpc).
"""

from __future__ import annotations

import socket
import struct

import msgpack

_LEN = struct.Struct(">I")

# first-byte protocol selector (ref rpc.go:170-223)
RPC_NOMAD = 0x01
RPC_RAFT = 0x02
RPC_STREAMING = 0x04

MAX_FRAME = 256 * 1024 * 1024


class ConnectionClosed(Exception):
    pass


def write_frame(sock: socket.socket, obj) -> None:
    body = msgpack.packb(obj, use_bin_type=True)
    sock.sendall(_LEN.pack(len(body)) + body)


def read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionClosed()
        buf.extend(chunk)
    return bytes(buf)


def read_frame(sock: socket.socket):
    (length,) = _LEN.unpack(read_exact(sock, _LEN.size))
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    return msgpack.unpackb(read_exact(sock, length), raw=False)
