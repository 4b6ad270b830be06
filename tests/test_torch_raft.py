"""The port's raft against the JAX package's on a shutdown race (ROADMAP C2).

A vote request that lands between ``Raft.shutdown()`` and the run loop's
next look at the role sets the role back to follower. The JAX package's
raft then stands for election and, once elected, re-enters its leader
loop, which returns at once because the node is shut down: the run thread
spins for as long as the process lives. The port's run loop also reads the
shutdown flag and ends. The race is held open with the raft's own lock, so
the case is deterministic. ``torch_for_tests.end_revived_rafts``, which
the port tests' autouse fixture calls, ends such a reference loop.
"""

import os
import time

from torch_for_tests import end_revived_rafts, gil_handoff, torch  # noqa: F401

from nomad_tpu import raft as jraft
from nomad_tpu_torch import raft as traft

VOTERS = {"a": "ra", "b": "rb"}


class _FSM:
    def apply(self, entry):
        return None

    def snapshot(self):
        return b""

    def restore(self, data):
        pass


def _cpu_s(thread) -> float:
    with open(f"/proc/self/task/{thread.native_id}/stat") as f:
        rest = f.read().rsplit(")", 1)[1].split()
    return (int(rest[11]) + int(rest[12])) / os.sysconf("SC_CLK_TCK")


def _race(pkg) -> tuple:
    """Two nodes elect a leader; the leader is shut down and, before its
    run loop looks again, handed the other node's vote request at a higher
    term. Returns (the leader's run thread, the leader, both nodes)."""
    transport = pkg.InmemTransport()
    cfg = pkg.RaftConfig(heartbeat_interval=0.03, election_timeout_min=0.1,
                         election_timeout_max=0.2)
    nodes = [pkg.Raft(n, a, VOTERS, _FSM(), transport, config=cfg) for n, a in VOTERS.items()]
    for r in nodes:
        r.start()
    deadline = time.monotonic() + 10
    while not any(r.role == "leader" for r in nodes):
        assert time.monotonic() < deadline, "no leader"
        time.sleep(0.01)
    leader = next(r for r in nodes if r.role == "leader")
    other = next(r for r in nodes if r is not leader)
    run = leader._threads[0]  # start() starts the run loop first
    assert run.name == f"raft-{leader.node_id}"
    with leader._lock:
        leader.shutdown()
        leader.handle_request_vote({"_from": other.address, "term": leader.current_term + 5,
                                    "candidate_id": other.node_id, "last_log_index": 0,
                                    "last_log_term": 0})
    return run, leader, nodes


def test_a_shut_down_raft_stays_down_where_the_jax_one_spins():
    jrun, jleader, jnodes = _race(jraft)
    trun, tleader, tnodes = _race(traft)
    try:
        trun.join(timeout=5.0)
        assert not trun.is_alive()
        # the reference's run thread is alive a second later, and busy
        time.sleep(1.0)
        assert jrun.is_alive()
        before = _cpu_s(jrun)
        time.sleep(0.5)
        assert _cpu_s(jrun) - before > 0.1
        # the port tests' fixture ends it (the loop reads only the role)
        assert end_revived_rafts() == [jleader.node_id]
        jrun.join(timeout=5.0)
        assert not jrun.is_alive()
    finally:
        for r in (*jnodes, *tnodes):
            r.shutdown()
        end_revived_rafts()
        for t in (t for r in (*jnodes, *tnodes) for t in r._threads):
            t.join(timeout=5.0)
    assert not [t.name for r in (*jnodes, *tnodes) for t in r._threads if t.is_alive()]
