"""Raft consensus for the replicated control plane.

The reference replicates server state with vendored hashicorp/raft on a
boltdb log (SURVEY.md §2.8 item 3; nomad/server.go:1075 setupRaft). This
package is a from-scratch implementation of the same protocol surface the
framework needs: leader election, log replication, commitment, FSM apply,
durable segmented logs, snapshots with install-snapshot catch-up, and a
pluggable transport (in-memory for tests, msgpack-RPC over TCP in
production — nomad_tpu.rpc).
"""

from .log import FileLogStore, InmemLogStore, LogEntry  # noqa: F401
from .raft import ApplyTimeout, NotLeaderError, Raft, RaftConfig  # noqa: F401
from .transport import InmemTransport, Transport  # noqa: F401
