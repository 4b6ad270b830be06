"""msgpack-RPC transport layer (ref nomad/rpc.go + helper/pool/).

The reference multiplexes everything over one TCP listener with first-byte
protocol selection (rpc.go:170-223: RpcNomad / RpcRaft / RpcMultiplex /
RpcStreaming), msgpack-encoded frames, connection pooling, and
follower→leader + region→region forwarding. This package provides the
same: `RpcServer` (listener + endpoint registry + protocol select),
`ConnPool` (persistent pooled client connections), `TcpRaftTransport`
(raft protocol riding the same listener), and `ServerProxy` (the typed
client surface the node agent and CLI use — the api/ package analog).
"""

from .client import ConnPool, RpcError, ServerProxy  # noqa: F401
from .server import RpcServer  # noqa: F401
from .raft_transport import TcpRaftTransport  # noqa: F401
