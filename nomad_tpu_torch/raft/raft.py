"""Raft consensus core: leader election, log replication, commitment,
snapshots (the role vendored hashicorp/raft plays in the reference —
nomad/server.go:1075 setupRaft; protocol semantics per the raft paper).

Threading model: one state lock guards term/role/log bookkeeping; a
replicator thread per peer pushes AppendEntries; an apply thread delivers
committed entries to the FSM and resolves proposer futures. The election
timer runs in the main role loop. All waits are condition-based so an
in-process 3-node cluster elects in tens of milliseconds (the same
property the reference's in-memory raft gives its TestServer clusters).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from .log import CMD, CONFIG, NOOP, InmemLogStore, LogEntry, SnapshotStore, StableStore
from .transport import Transport

logger = logging.getLogger("nomad_tpu.raft")

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"
SHUTDOWN = "shutdown"


class NotLeaderError(Exception):
    def __init__(self, leader_addr: Optional[str] = None, leader_id: Optional[str] = None):
        super().__init__(f"node is not the leader (leader={leader_id}@{leader_addr})")
        self.leader_addr = leader_addr
        self.leader_id = leader_id


class ApplyTimeout(TimeoutError):
    """The apply wait expired with the entry's outcome still UNKNOWN: it is
    already stored in the leader's log and may yet commit and apply. Callers
    must not treat this as "nothing happened" — a later write computed
    against state missing this entry can double-apply its effects (the plan
    applier resolves the outcome through a barrier instead). Carries the
    entry's log index and the term it was proposed in: a resolver must
    prove the term never changed, or the entry may have been truncated
    under an intervening leader."""

    def __init__(self, index: int, term: int = 0):
        super().__init__(
            f"raft apply timed out (entry {index} term {term} still in flight)"
        )
        self.raft_index = index
        self.raft_term = term


@dataclass
class RaftConfig:
    heartbeat_interval: float = 0.05
    election_timeout_min: float = 0.15
    election_timeout_max: float = 0.30
    snapshot_threshold: int = 8192  # log entries between snapshots
    snapshot_trailing: int = 128  # entries kept behind a snapshot for catch-up
    max_append_entries: int = 64
    apply_timeout: float = 10.0


class _Future:
    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error = None

    def resolve(self, result, error=None):
        self.result = result
        self.error = error
        self.event.set()

    def wait(self, timeout):
        if not self.event.wait(timeout):
            raise TimeoutError("raft apply timed out")
        if self.error is not None:
            raise self.error
        return self.result


class Raft:
    def __init__(
        self,
        node_id: str,
        address: str,
        voters: dict[str, str],
        fsm,
        transport: Transport,
        log_store=None,
        stable: Optional[StableStore] = None,
        snapshots: Optional[SnapshotStore] = None,
        config: Optional[RaftConfig] = None,
        on_leadership: Optional[Callable[[bool], None]] = None,
    ):
        self.node_id = node_id
        self.address = address
        self.voters = dict(voters)  # id -> address (must include self)
        self.fsm = fsm
        self.transport = transport
        self.log = log_store if log_store is not None else InmemLogStore()
        self.stable = stable if stable is not None else StableStore()
        self.snapshots = snapshots if snapshots is not None else SnapshotStore()
        self.config = config or RaftConfig()
        self.on_leadership = on_leadership

        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self.current_term = int(self.stable.get("term", 0))
        self.voted_for = self.stable.get("voted_for")
        self.role = FOLLOWER
        self.leader_id: Optional[str] = None
        self.commit_index = 0
        self.last_applied = 0
        self.term_start_index = 0
        self.last_snapshot_index = 0
        self.last_snapshot_term = 0
        self._last_contact = time.monotonic()
        self._futures: dict[int, _Future] = {}
        # nta: ignore[unbounded-cache] WHY: the three per-peer maps
        # below are keyed by voter id — bounded by the configured peer
        # set (membership changes republish the voter map)
        self._match_index: dict[str, int] = {}
        # nta: ignore[unbounded-cache] WHY: per-voter, see above
        self._peer_contact: dict[str, float] = {}  # last successful append ack
        # nta: ignore[unbounded-cache] WHY: per-voter, see above
        self._next_index: dict[str, int] = {}
        self._replicators: dict[str, threading.Thread] = {}
        self._repl_conds: dict[str, threading.Condition] = {}
        self._threads: list[threading.Thread] = []
        self._shutdown = False
        self._leadership_epoch = 0
        # leadership notifications are delivered IN ORDER from a single
        # dispatcher thread — concurrent unordered callbacks could let a
        # stale revoke land after a newer establish on a flap
        self._leadership_queue: list[bool] = []
        self._leadership_cond = threading.Condition()
        # snapshot staged by handle_install_snapshot; the apply thread is
        # the only FSM mutator (apply AND restore), so a restore can never
        # interleave with an in-flight entry apply
        self._pending_snapshot = None

        self._restore_on_boot()
        self.transport.register(
            self.address,
            {
                "request_vote": self.handle_request_vote,
                "append_entries": self.handle_append_entries,
                "install_snapshot": self.handle_install_snapshot,
            },
        )

    # ------------------------------------------------------------------
    def _restore_on_boot(self):
        # The per-line ignores below share one WHY: this runs during
        # construction, before start() spawns any raft thread —
        # pre-spawn publication (Thread.start() is the h-b edge).
        snap = self.snapshots.latest()
        if snap is not None:
            self.fsm.restore(snap.data)
            self.last_snapshot_index = snap.last_index  # nta: ignore[unsynchronized-shared-write]
            self.last_snapshot_term = snap.last_term  # nta: ignore[unsynchronized-shared-write]
            self.commit_index = snap.last_index  # nta: ignore[unsynchronized-shared-write]
            self.last_applied = snap.last_index  # nta: ignore[unsynchronized-shared-write]
            if snap.voters:
                self.voters = dict(snap.voters)  # nta: ignore[unsynchronized-shared-write]
        # adopt the newest CONFIG entry in the log, if any
        for i in range(self.log.first_index(), self.log.last_index() + 1):
            e = self.log.get(i)
            if e is not None and e.etype == CONFIG:
                self.voters = dict(e.data["voters"])  # nta: ignore[unsynchronized-shared-write]

    def start(self):
        t = threading.Thread(target=self._run, daemon=True, name=f"raft-{self.node_id}")
        t.start()
        self._threads.append(t)
        a = threading.Thread(
            target=self._apply_loop, daemon=True, name=f"raft-apply-{self.node_id}"
        )
        a.start()
        self._threads.append(a)
        if self.on_leadership is not None:
            n = threading.Thread(
                target=self._leadership_loop,
                daemon=True,
                name=f"raft-lead-{self.node_id}",
            )
            n.start()
            self._threads.append(n)

    def _notify_leadership(self, leader: bool):
        with self._leadership_cond:
            self._leadership_queue.append(leader)
            self._leadership_cond.notify()

    def _leadership_loop(self):
        while True:
            with self._leadership_cond:
                while not self._leadership_queue and not self._shutdown:
                    self._leadership_cond.wait(0.2)
                if self._shutdown and not self._leadership_queue:
                    return
                leader = self._leadership_queue.pop(0)
                # collapse a flap: only the latest state matters, and
                # delivering stale transitions in order is still correct
            try:
                self.on_leadership(leader)
            except Exception:
                logger.exception("leadership callback failed")

    def shutdown(self):
        with self._cond:
            self._shutdown = True
            self.role = SHUTDOWN
            self._cond.notify_all()
        for c in self._repl_conds.values():
            with c:
                c.notify_all()
        with self._leadership_cond:
            self._leadership_cond.notify_all()
        for f in list(self._futures.values()):
            f.resolve(None, NotLeaderError())
        self._futures.clear()

    # ------------------------------------------------------------------
    # helpers (hold lock)
    # ------------------------------------------------------------------
    def _last_log(self) -> tuple[int, int]:
        li = self.log.last_index()
        if li == 0:
            return self.last_snapshot_index, self.last_snapshot_term
        e = self.log.get(li)
        return li, e.term if e else 0

    def _term_at(self, index: int) -> int:
        if index == 0:
            return 0
        if index == self.last_snapshot_index:
            return self.last_snapshot_term
        e = self.log.get(index)
        return e.term if e is not None else -1

    def _set_term(self, term: int):
        self.current_term = term
        self.voted_for = None
        self.stable.set_many(term=term, voted_for=None)

    def _become_follower(self, term: int, leader_id: Optional[str] = None):
        was_leader = self.role == LEADER
        if term > self.current_term:
            self._set_term(term)
        self.role = FOLLOWER
        if leader_id is not None:
            self.leader_id = leader_id
        self._cond.notify_all()
        if was_leader:
            self._leadership_epoch += 1
            self._fail_pending_futures()
            if self.on_leadership is not None:
                self._notify_leadership(False)

    def _fail_pending_futures(self):
        for f in self._futures.values():
            f.resolve(None, NotLeaderError(self.leader_address(), self.leader_id))
        self._futures.clear()

    def leader_address(self) -> Optional[str]:
        lid = self.leader_id
        return self.voters.get(lid) if lid else None

    def voters_snapshot(self) -> dict[str, str]:
        """Copy of the voter map safe to iterate off-thread (membership
        changes mutate ``voters`` under the raft lock)."""
        with self._lock:
            return dict(self.voters)

    def peer_progress(self) -> dict:
        """Leader-side replication progress per voter (for autopilot
        server-health; ref autopilot ServerStats / raft.Stats)."""
        now = time.monotonic()
        with self._lock:
            last, _ = self._last_log()
            out = {}
            for pid in self.voters:
                if pid == self.node_id:
                    out[pid] = {
                        "match_index": last,
                        "last_contact_s": 0.0,
                        "leader": self.role == LEADER,
                    }
                    continue
                contact = self._peer_contact.get(pid)
                out[pid] = {
                    "match_index": self._match_index.get(pid, 0),
                    "last_contact_s": (
                        round(now - contact, 3) if contact is not None else None
                    ),
                    "leader": False,
                }
            return out

    def is_leader(self) -> bool:
        return self.role == LEADER

    # ------------------------------------------------------------------
    # main role loop
    # ------------------------------------------------------------------
    def _election_timeout(self) -> float:
        return random.uniform(
            self.config.election_timeout_min, self.config.election_timeout_max
        )

    def _run(self):
        while True:
            with self._lock:
                role = self.role
            if role == SHUTDOWN:
                return
            if role == FOLLOWER:
                self._run_follower()
            elif role == CANDIDATE:
                self._run_candidate()
            elif role == LEADER:
                self._run_leader()

    def _run_follower(self):
        timeout = self._election_timeout()
        while True:
            with self._cond:
                if self.role != FOLLOWER:
                    return
                remaining = timeout - (time.monotonic() - self._last_contact)
                if remaining <= 0:
                    if self.node_id not in self.voters:
                        # non-voting joiner (gossip auto-discovery): wait to
                        # be added by the leader via a CONFIG entry instead
                        # of standing for election as a one-node cluster
                        self._last_contact = time.monotonic()
                        continue
                    # no heartbeat: stand for election
                    self.role = CANDIDATE
                    return
                self._cond.wait(remaining)

    def _run_candidate(self):
        with self._lock:
            if self.role != CANDIDATE:
                return
            self._set_term(self.current_term + 1)
            term = self.current_term
            self.voted_for = self.node_id
            self.stable.set("voted_for", self.node_id)
            self.leader_id = None
            last_index, last_term = self._last_log()
            peers = {i: a for i, a in self.voters.items() if i != self.node_id}
            quorum = len(self.voters) // 2 + 1

        votes = [1]  # self-vote
        vote_lock = threading.Lock()
        done = threading.Event()

        def ask(peer_id, addr):
            try:
                resp = self.transport.request_vote(
                    addr,
                    {
                        "_from": self.address,
                        "term": term,
                        "candidate_id": self.node_id,
                        "last_log_index": last_index,
                        "last_log_term": last_term,
                    },
                )
            except Exception:
                return
            with self._lock:
                if resp["term"] > self.current_term:
                    self._become_follower(resp["term"])
                    done.set()
                    return
            if resp.get("granted"):
                with vote_lock:
                    votes[0] += 1
                    if votes[0] >= quorum:
                        done.set()

        threads = [
            threading.Thread(
                target=ask, args=(pid, addr), daemon=True,
                name=f"raft-vote-{pid}",
            )
            for pid, addr in peers.items()
        ]
        for t in threads:
            t.start()
        if not peers:
            done.set()
        done.wait(self._election_timeout())

        with self._lock:
            if self.role != CANDIDATE or self.current_term != term:
                return
            if votes[0] >= quorum:
                self.role = LEADER
                self.leader_id = self.node_id
                logger.info(
                    "raft: %s elected leader (term %d)", self.node_id, term
                )
            # else: loop re-enters candidate with a fresh randomized timeout
            elif self.role == CANDIDATE:
                self.role = FOLLOWER  # back off; follower loop re-times
                self._last_contact = time.monotonic()

    # ------------------------------------------------------------------
    # leader
    # ------------------------------------------------------------------
    def _run_leader(self):
        with self._lock:
            term = self.current_term
            epoch = self._leadership_epoch
            self._replicators.clear()
            self._repl_conds.clear()
            last_index, _ = self._last_log()
            for pid in self.voters:
                if pid == self.node_id:
                    continue
                self._next_index[pid] = last_index + 1
                self._match_index[pid] = 0
            # commit a noop to establish leadership over prior-term entries
            noop = LogEntry(index=last_index + 1, term=term, etype=NOOP, data=None)
            self.log.store_entries([noop])
            #: index of this term's noop: once APPLIED, the FSM provably
            #: covers every entry committed by prior leaders (the
            #: server-level establishment barrier rides it instead of
            #: proposing a second entry)
            self.term_start_index = noop.index
        self._start_replicators(epoch)
        self._maybe_advance_commit()
        if self.on_leadership is not None:
            self._notify_leadership(True)

        # leader loop: watch for step-down
        while True:
            with self._cond:
                if self.role != LEADER or self._shutdown:
                    return
                self._cond.wait(self.config.heartbeat_interval)

    def _start_replicators(self, epoch: int):
        with self._lock:
            peers = {i: a for i, a in self.voters.items() if i != self.node_id}
        for pid, addr in peers.items():
            cond = threading.Condition()
            self._repl_conds[pid] = cond
            t = threading.Thread(
                target=self._replicate_loop,
                args=(pid, addr, epoch, cond),
                daemon=True,
                name=f"raft-repl-{self.node_id}->{pid}",
            )
            self._replicators[pid] = t
            t.start()

    def _replicate_loop(self, peer_id: str, addr: str, epoch: int, cond):
        backoff = 0.01
        # WHY: raft replication IS the recovery path — one loop per peer,
        # capped backoff; budget-severing it turns overload into
        # unavailability, the opposite of shedding
        while True:  # nta: ignore[retry-without-budget]
            with self._lock:
                if (
                    self.role != LEADER
                    or self._leadership_epoch != epoch
                    or self._shutdown
                    or peer_id not in self.voters  # removed by remove_voter
                ):
                    self._replicators.pop(peer_id, None)
                    self._repl_conds.pop(peer_id, None)
                    return
                term = self.current_term
                next_idx = self._next_index.get(peer_id, 1)
                need_snapshot = (
                    next_idx <= self.last_snapshot_index
                    and self.log.get(next_idx) is None
                )

            try:
                if need_snapshot:
                    self._send_snapshot(peer_id, addr, term)
                    backoff = 0.01
                else:
                    ok = self._send_append(peer_id, addr, term, next_idx)
                    backoff = 0.01 if ok else min(backoff * 2, 0.5)
            except Exception:
                time.sleep(backoff)
                backoff = min(backoff * 2, 0.5)

            # wait for new entries or the heartbeat tick
            with cond:
                cond.wait(self.config.heartbeat_interval)

    def _send_append(self, peer_id, addr, term, next_idx) -> bool:
        with self._lock:
            prev_index = next_idx - 1
            prev_term = self._term_at(prev_index)
            entries = []
            last = self.log.last_index()
            i = next_idx
            while i <= last and len(entries) < self.config.max_append_entries:
                e = self.log.get(i)
                if e is None:
                    break
                entries.append([e.index, e.term, e.etype, e.data])
                i += 1
            commit = self.commit_index
        resp = self.transport.append_entries(
            addr,
            {
                "_from": self.address,
                "term": term,
                "leader_id": self.node_id,
                "prev_log_index": prev_index,
                "prev_log_term": prev_term,
                "entries": entries,
                "leader_commit": commit,
            },
        )
        with self._lock:
            if resp["term"] > self.current_term:
                self._become_follower(resp["term"])
                return False
            if self.role != LEADER:
                return False
            if resp.get("success"):
                self._peer_contact[peer_id] = time.monotonic()
                if entries:
                    self._match_index[peer_id] = entries[-1][0]
                    self._next_index[peer_id] = entries[-1][0] + 1
                else:
                    self._match_index[peer_id] = max(
                        self._match_index.get(peer_id, 0), prev_index
                    )
        if resp.get("success"):
            self._maybe_advance_commit()
            return True
        with self._lock:
            hint = resp.get("conflict_index")
            self._next_index[peer_id] = max(
                1, hint if hint else self._next_index.get(peer_id, 2) - 1
            )
        return False

    def _send_snapshot(self, peer_id, addr, term):
        snap = self.snapshots.latest()
        if snap is None:
            return
        resp = self.transport.install_snapshot(
            addr,
            {
                "_from": self.address,
                "term": term,
                "leader_id": self.node_id,
                "last_index": snap.last_index,
                "last_term": snap.last_term,
                "voters": snap.voters or self.voters,
                "data": snap.data,
            },
        )
        with self._lock:
            if resp["term"] > self.current_term:
                self._become_follower(resp["term"])
                return
            self._match_index[peer_id] = snap.last_index
            self._next_index[peer_id] = snap.last_index + 1

    def _maybe_advance_commit(self):
        notify = False
        with self._lock:
            if self.role != LEADER:
                return
            last = self.log.last_index()
            for n in range(last, self.commit_index, -1):
                e = self.log.get(n)
                if e is None or e.term != self.current_term:
                    break  # only commit current-term entries by counting
                votes = 1  # self
                for pid in self.voters:
                    if pid == self.node_id:
                        continue
                    if self._match_index.get(pid, 0) >= n:
                        votes += 1
                if votes >= len(self.voters) // 2 + 1:
                    self.commit_index = n
                    notify = True
                    break
            if notify:
                self._cond.notify_all()

    # ------------------------------------------------------------------
    # apply pipeline
    # ------------------------------------------------------------------
    def _apply_loop(self):
        while True:
            with self._cond:
                while (
                    self.last_applied >= self.commit_index
                    and self._pending_snapshot is None
                    and not self._shutdown
                ):
                    self._cond.wait(0.2)
                if self._shutdown:
                    return
                pending = self._pending_snapshot
                self._pending_snapshot = None
            if pending is not None:
                data, last_index, last_term = pending
                self.fsm.restore(data)
                with self._cond:
                    self.last_snapshot_index = last_index
                    self.last_snapshot_term = last_term
                    if self.last_applied < last_index:
                        self.last_applied = last_index
                    self._cond.notify_all()
                continue
            with self._cond:
                # one entry at a time: a concurrent InstallSnapshot may jump
                # last_applied forward, and re-reading under the lock keeps
                # this loop from double-applying pre-snapshot entries
                i = self.last_applied + 1
                e = self.log.get(i)
                if e is None:
                    # compacted/cleared beneath us (snapshot install):
                    # skip forward rather than spinning
                    if i <= self.last_snapshot_index:
                        self.last_applied = self.last_snapshot_index
                    else:
                        self._cond.wait(0.05)
                    continue
            result, error = None, None
            if e.etype == CMD:
                msg_type, payload = e.data
                try:
                    result = self.fsm.apply(i, msg_type, payload)
                except Exception as exc:  # surfaced to the proposer
                    logger.exception("fsm apply failed at index %d", i)
                    error = exc
            elif e.etype == CONFIG:
                pass  # voters adopted at append time
            with self._lock:
                # if a snapshot install advanced past us while we applied,
                # keep the further-ahead value (its state already contains
                # this entry's effect)
                if self.last_applied < i:
                    self.last_applied = i
                fut = self._futures.pop(i, None)
            if fut is not None:
                fut.resolve(result, error)
            self._maybe_snapshot()

    def _maybe_snapshot(self):
        with self._lock:
            applied_since = self.last_applied - self.last_snapshot_index
            if applied_since < self.config.snapshot_threshold:
                return
            last_applied = self.last_applied
            term = self._term_at(last_applied)
            voters = dict(self.voters)
        data = self.fsm.snapshot()
        from .log import Snapshot

        self.snapshots.save(
            Snapshot(
                last_index=last_applied,
                last_term=term if term > 0 else self.current_term,
                data=data,
                voters=voters,
            )
        )
        with self._lock:
            self.last_snapshot_index = last_applied
            self.last_snapshot_term = term
            trail_lo = self.log.first_index()
            trail_hi = last_applied - self.config.snapshot_trailing
            if trail_lo and trail_hi >= trail_lo:
                self.log.delete_range(trail_lo, trail_hi)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def apply(self, msg_type: str, payload, timeout: Optional[float] = None):
        """Propose an FSM command; blocks until committed+applied and
        returns the FSM response (ref nomad/rpc.go raftApply)."""
        fut = _Future()
        with self._lock:
            if self.role != LEADER:
                raise NotLeaderError(self.leader_address(), self.leader_id)
            index = self.log.last_index() + 1
            entry = LogEntry(
                index=index, term=self.current_term, etype=CMD,
                data=[msg_type, payload],
            )
            self.log.store_entries([entry])
            self._futures[index] = fut
        self._kick_replicators()
        self._maybe_advance_commit()
        try:
            return fut.wait(timeout or self.config.apply_timeout)
        except ApplyTimeout:
            raise
        except TimeoutError:
            raise ApplyTimeout(index, entry.term) from None

    def barrier(self, timeout: Optional[float] = None):
        """Commit + apply a noop, guaranteeing all prior entries applied."""
        return self.apply("noop", {}, timeout=timeout)

    def add_voter(self, node_id: str, address: str, timeout: float = 5.0):
        """Single-server membership change via a CONFIG entry (adopted at
        append time, as in standard single-server-change raft)."""
        fut = _Future()
        with self._lock:
            if self.role != LEADER:
                raise NotLeaderError(self.leader_address(), self.leader_id)
            voters = dict(self.voters)
            voters[node_id] = address
            index = self.log.last_index() + 1
            entry = LogEntry(
                index=index, term=self.current_term, etype=CONFIG,
                data={"voters": voters},
            )
            self.log.store_entries([entry])
            self.voters = voters
            self._futures[index] = fut
        self._kick_replicators_new_peer()
        self._maybe_advance_commit()
        fut.wait(timeout)

    def remove_voter(self, node_id: str, timeout: float = 5.0):
        """Single-server membership removal via a CONFIG entry (the
        dead-server cleanup autopilot performs in the reference)."""
        fut = _Future()
        with self._lock:
            if self.role != LEADER:
                raise NotLeaderError(self.leader_address(), self.leader_id)
            if node_id not in self.voters:
                return
            voters = dict(self.voters)
            del voters[node_id]
            index = self.log.last_index() + 1
            entry = LogEntry(
                index=index, term=self.current_term, etype=CONFIG,
                data={"voters": voters},
            )
            self.log.store_entries([entry])
            self.voters = voters
            self._futures[index] = fut
        # wake every replicator: the removed peer's loop observes its
        # eviction and exits instead of retrying a dead address forever
        self._kick_replicators()
        self._maybe_advance_commit()
        fut.wait(timeout)

    def _kick_replicators(self):
        for cond in self._repl_conds.values():
            with cond:
                cond.notify_all()

    def _kick_replicators_new_peer(self):
        with self._lock:
            epoch = self._leadership_epoch
            missing = [
                (pid, addr)
                for pid, addr in self.voters.items()
                if pid != self.node_id and pid not in self._replicators
            ]
            last_index, _ = self._last_log()
            for pid, _ in missing:
                self._next_index[pid] = max(1, last_index)
                self._match_index[pid] = 0
        for pid, addr in missing:
            cond = threading.Condition()
            self._repl_conds[pid] = cond
            t = threading.Thread(
                target=self._replicate_loop,
                args=(pid, addr, epoch, cond),
                daemon=True,
                name=f"raft-repl-{pid}",
            )
            self._replicators[pid] = t
            t.start()
        self._kick_replicators()

    # ------------------------------------------------------------------
    # RPC handlers (invoked by the transport)
    # ------------------------------------------------------------------
    def handle_request_vote(self, req: dict) -> dict:
        with self._lock:
            if req["term"] < self.current_term:
                return {"term": self.current_term, "granted": False}
            if req["term"] > self.current_term:
                self._become_follower(req["term"])
            last_index, last_term = self._last_log()
            up_to_date = req["last_log_term"] > last_term or (
                req["last_log_term"] == last_term
                and req["last_log_index"] >= last_index
            )
            if up_to_date and self.voted_for in (None, req["candidate_id"]):
                self.voted_for = req["candidate_id"]
                self.stable.set("voted_for", self.voted_for)
                self._last_contact = time.monotonic()
                return {"term": self.current_term, "granted": True}
            return {"term": self.current_term, "granted": False}

    def handle_append_entries(self, req: dict) -> dict:
        with self._cond:
            if req["term"] < self.current_term:
                return {"term": self.current_term, "success": False}
            if req["term"] > self.current_term or self.role != FOLLOWER:
                self._become_follower(req["term"], req["leader_id"])
            self.leader_id = req["leader_id"]
            self._last_contact = time.monotonic()

            prev_index, prev_term = req["prev_log_index"], req["prev_log_term"]
            if prev_index > 0:
                local_term = self._term_at(prev_index)
                if local_term == -1:
                    # missing entirely: hint the leader where our log ends
                    last_index, _ = self._last_log()
                    return {
                        "term": self.current_term,
                        "success": False,
                        "conflict_index": last_index + 1,
                    }
                if local_term != prev_term and prev_index > self.last_snapshot_index:
                    # conflicting entry: find first index of that term
                    ci = prev_index
                    while (
                        ci > self.log.first_index()
                        and self._term_at(ci - 1) == local_term
                    ):
                        ci -= 1
                    self.log.delete_range(prev_index, self.log.last_index())
                    return {
                        "term": self.current_term,
                        "success": False,
                        "conflict_index": ci,
                    }

            new_entries = []
            for index, term, etype, data in req["entries"]:
                existing = self.log.get(index)
                if existing is not None:
                    if existing.term == term:
                        continue
                    self.log.delete_range(index, self.log.last_index())
                e = LogEntry(index=index, term=term, etype=etype, data=data)
                new_entries.append(e)
                if etype == CONFIG:
                    self.voters = dict(data["voters"])
            if new_entries:
                self.log.store_entries(new_entries)

            if req["leader_commit"] > self.commit_index:
                last_index, _ = self._last_log()
                self.commit_index = min(req["leader_commit"], last_index)
                self._cond.notify_all()
            return {"term": self.current_term, "success": True}

    def handle_install_snapshot(self, req: dict) -> dict:
        with self._cond:
            if req["term"] < self.current_term:
                return {"term": self.current_term}
            self._become_follower(req["term"], req["leader_id"])
            self._last_contact = time.monotonic()
            if req["last_index"] <= self.last_snapshot_index:
                return {"term": self.current_term}
            first = self.log.first_index()
            if first:
                self.log.delete_range(first, self.log.last_index())
            # stage for the apply thread (the only FSM mutator); raft
            # bookkeeping advances now so replication can proceed, and the
            # apply loop installs the FSM state before touching any entry
            # appended after the snapshot
            self._pending_snapshot = (
                req["data"], req["last_index"], req["last_term"],
            )
            self.last_snapshot_index = req["last_index"]
            self.last_snapshot_term = req["last_term"]
            self.commit_index = req["last_index"]
            if req.get("voters"):
                self.voters = dict(req["voters"])
            self._cond.notify_all()
            return {"term": self.current_term}

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self.role,
                "term": self.current_term,
                "leader_id": self.leader_id,
                "commit_index": self.commit_index,
                "last_applied": self.last_applied,
                "last_log_index": self.log.last_index(),
                "last_snapshot_index": self.last_snapshot_index,
                "num_peers": len(self.voters) - 1,
            }
