"""SWIM-lite gossip membership over UDP
(ref vendored hashicorp/memberlist + serf as consumed by nomad/serf.go).

Protocol, deliberately the minimal SWIM shape that covers Nomad's use of
serf — server discovery, failure detection, and leave/reap:

- every message piggybacks the sender's full membership view (anti-entropy
  push; fine at server-cluster scale, which is what serf's LAN pool covers),
- a probe loop pings one random alive peer per interval; a missed ack makes
  the peer *suspect*, suspicion times out to *dead*, dead members are
  reaped after a hold-down (so a flapping node can refute first),
- merges resolve by incarnation number, then by status precedence
  (dead > suspect > alive at equal incarnation),
- a node hearing itself called suspect/dead refutes by bumping its
  incarnation and gossiping an alive record,
- ``leave()`` broadcasts an intentional *left* record, which consumers
  treat distinctly from failure (no dead-server alarm).

Members carry opaque ``tags`` (raft address, RPC address, role) exactly
like serf tags — the server layer uses them to wire discovered peers into
raft membership and the RPC retry tables.
"""

from __future__ import annotations

import logging
import random
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import msgpack

from ..testing import faults as _faults

logger = logging.getLogger("nomad_tpu.gossip")

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"
LEFT = "left"

_STATUS_RANK = {ALIVE: 0, SUSPECT: 1, DEAD: 2, LEFT: 2}


@dataclass
class Member:
    name: str
    host: str
    port: int
    tags: dict = field(default_factory=dict)
    status: str = ALIVE
    incarnation: int = 0
    status_time: float = field(default_factory=time.monotonic)

    @property
    def addr(self) -> tuple[str, int]:
        return (self.host, self.port)

    def to_wire(self) -> dict:
        return {
            "n": self.name,
            "h": self.host,
            "p": self.port,
            "t": self.tags,
            "s": self.status,
            "i": self.incarnation,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "Member":
        return cls(
            name=d["n"],
            host=d["h"],
            port=d["p"],
            tags=d.get("t", {}),
            status=d.get("s", ALIVE),
            incarnation=d.get("i", 0),
        )


class Gossip:
    """One gossip agent: a UDP endpoint plus the membership table."""

    def __init__(
        self,
        name: str,
        bind: tuple[str, int] = ("127.0.0.1", 0),
        tags: Optional[dict] = None,
        probe_interval: float = 0.3,
        ack_timeout: float = 0.3,
        suspect_timeout: float = 1.5,
        reap_timeout: float = 3.0,
        on_event: Optional[Callable[[str, Member], None]] = None,
        rng: Optional[random.Random] = None,
        encrypt_key: str = "",
        keyring_path: str = "",
    ):
        #: AES-GCM keyring sealing every frame (ref serf encryption);
        #: None = plaintext gossip
        self.keyring = None
        if encrypt_key:
            from .keyring import Keyring

            self.keyring = Keyring(encrypt_key, path=keyring_path)
        self.name = name
        self.probe_interval = probe_interval
        self.ack_timeout = ack_timeout
        self.suspect_timeout = suspect_timeout
        self.reap_timeout = reap_timeout
        self.on_event = on_event
        self.rng = rng or random.Random()

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(bind)
        self._sock.settimeout(0.2)
        host, port = self._sock.getsockname()
        self.addr = (host, port)

        self._lock = threading.Lock()
        self._me = Member(name=name, host=host, port=port, tags=dict(tags or {}))
        self.members: dict[str, Member] = {name: self._me}
        self._acks: dict[int, threading.Event] = {}
        self._seq = 0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # ------------------------------------------------------------------
    def start(self):
        for target in (self._listen_loop, self._probe_loop):
            t = threading.Thread(
                target=target, daemon=True,
                name=f"swim-{target.__name__.strip('_').replace('_', '-')}",
            )
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)
        self._sock.close()

    # ------------------------------------------------------------------
    def join(self, seed: tuple[str, int], timeout: float = 5.0) -> bool:
        """Push our record at a seed and wait until *that seed's* view
        merges back (ref serf Join). Success requires a member at the seed
        address — an earlier successful join must not vouch for a dead
        seed."""
        seed = (seed[0], int(seed[1]))

        def seed_merged() -> bool:
            with self._lock:
                return any(
                    m.addr == seed
                    for m in self.members.values()
                    if m.name != self.name
                )

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not self._stop.is_set():
            self._send(seed, {"t": "join", "view": self._view()})
            time.sleep(0.2)
            if seed_merged():
                return True
        return seed_merged()

    def leave(self):
        """Broadcast an intentional departure (ref serf Leave)."""
        with self._lock:
            self._me.incarnation += 1
            self._me.status = LEFT
            peers = [m for m in self.members.values() if m.name != self.name]
            view = self._view_locked()
        for m in peers:
            if m.status == ALIVE:
                self._send(m.addr, {"t": "state", "view": view})

    def force_leave(self, name: str) -> bool:
        """Mark a (possibly unreachable) member as left and gossip the
        tombstone at the same incarnation+1 so it dominates the member's
        own alive record (ref serf RemoveFailedNode). The target can still
        refute by rejoining with a higher incarnation."""
        with self._lock:
            m = self.members.get(name)
            if m is None or m.name == self.name:
                return False
            m.incarnation += 1
            m.status = LEFT
            m.status_time = time.monotonic()
            peers = [
                p
                for p in self.members.values()
                if p.name not in (self.name, name) and p.status == ALIVE
            ]
            view = self._view_locked()
        for p in peers:
            self._send(p.addr, {"t": "state", "view": view})
        self._emit("leave", m)
        return True

    def set_tags(self, tags: dict):
        """Merge tag updates into our record and bump the incarnation so
        the new tags dominate peers' stale copies (ref serf SetTags)."""
        with self._lock:
            self._me.tags.update(tags)
            self._me.incarnation += 1

    def alive_members(self) -> list[Member]:
        with self._lock:
            return [m for m in self.members.values() if m.status == ALIVE]

    # ------------------------------------------------------------------
    def _region_of_addr(self, addr: tuple[str, int]) -> Optional[str]:
        """Region tag of the member at ``addr`` (None when unknown) —
        the fault plane's WAN rules are keyed by region, not address."""
        addr = (addr[0], int(addr[1]))
        with self._lock:
            for m in self.members.values():
                if m.addr == addr:
                    return m.tags.get("region", "global")
        return None

    def _view(self) -> list[dict]:
        with self._lock:
            return self._view_locked()

    def _view_locked(self) -> list[dict]:
        return [m.to_wire() for m in self.members.values()]

    def _send(self, addr: tuple[str, int], msg: dict):
        # inter-region fault seam (testing/faults.py region scope): a
        # region partition drops the WAN datagrams here, so cross-region
        # members go suspect -> dead through the normal SWIM detector —
        # exactly the observable shape of a real network partition.
        # Addresses whose member (and therefore region) is unknown are
        # never dropped: a first join must be able to reach its seed.
        if _faults.ACTIVE is not None:
            dst_region = self._region_of_addr(addr)
            if dst_region is not None:
                act = _faults.ACTIVE.on_region(
                    self._me.tags.get("region", "global"), dst_region, "gossip"
                )
                if act in ("drop", "sever"):
                    return
        msg["from"] = self.name
        data = msgpack.packb(msg, use_bin_type=True)
        if self.keyring is not None:
            data = self.keyring.seal(data)
        try:
            self._sock.sendto(data, tuple(addr))
        except OSError:
            pass

    # ------------------------------------------------------------------
    def _listen_loop(self):
        while not self._stop.is_set():
            try:
                data, addr = self._sock.recvfrom(64 * 1024)
            except socket.timeout:
                continue
            except OSError:
                return
            if self.keyring is not None:
                data = self.keyring.open(data)
                if data is None:
                    continue  # unauthenticated frame: drop silently
            try:
                msg = msgpack.unpackb(data, raw=False)
            except Exception:
                continue
            kind = msg.get("t")
            if "view" in msg:
                self._merge(msg["view"])
            if kind == "ping":
                self._send(addr, {"t": "ack", "seq": msg.get("seq", 0), "view": self._view()})
            elif kind == "ack":
                ev = self._acks.pop(msg.get("seq", 0), None)
                if ev is not None:
                    ev.set()
            elif kind == "join":
                self._send(addr, {"t": "state", "view": self._view()})

    def _probe_loop(self):
        while not self._stop.wait(self.probe_interval):
            self._expire()
            target = self._pick_probe_target()
            if target is None:
                continue
            seq = self._next_seq()
            ev = threading.Event()
            self._acks[seq] = ev
            self._send(target.addr, {"t": "ping", "seq": seq, "view": self._view()})
            if not ev.wait(self.ack_timeout):
                self._acks.pop(seq, None)
                self._mark_suspect(target.name)

    def _pick_probe_target(self) -> Optional[Member]:
        with self._lock:
            candidates = [
                m
                for m in self.members.values()
                if m.name != self.name and m.status in (ALIVE, SUSPECT)
            ]
        if not candidates:
            return None
        return self.rng.choice(candidates)

    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    # ------------------------------------------------------------------
    def _mark_suspect(self, name: str):
        with self._lock:
            m = self.members.get(name)
            if m is None or m.status != ALIVE:
                return
            m.status = SUSPECT
            m.status_time = time.monotonic()
            logger.info("%s: member %s suspect", self.name, name)
        self._emit("suspect", m)

    def _expire(self):
        """Suspect → dead after suspect_timeout; dead/left reaped after
        reap_timeout (ref serf reap/tombstone timers)."""
        now = time.monotonic()
        dead_events = []
        reaped = []
        with self._lock:
            for m in list(self.members.values()):
                if m.name == self.name:
                    continue
                if m.status == SUSPECT and now - m.status_time > self.suspect_timeout:
                    m.status = DEAD
                    m.status_time = now
                    dead_events.append(m)
                elif m.status in (DEAD, LEFT) and now - m.status_time > self.reap_timeout:
                    del self.members[m.name]
                    reaped.append(m)
        for m in dead_events:
            logger.info("%s: member %s dead", self.name, m.name)
            self._emit("dead", m)
        for m in reaped:
            self._emit("reap", m)

    # ------------------------------------------------------------------
    def _merge(self, view: list[dict]):
        events = []
        with self._lock:
            for wire in view:
                try:
                    incoming = Member.from_wire(wire)
                except Exception:
                    continue
                if incoming.name == self.name:
                    # refutation: someone holds a non-alive record of us —
                    # bump incarnation so our alive record dominates. LEFT
                    # must refute too (ref serf aliveNode): a restarted
                    # process rejoins at incarnation 0 while the cluster
                    # holds its own leave tombstone at N+1 — without the
                    # bump the rejoiner is permanently invisible, which
                    # under a rolling region restart splits the voter map
                    # and erases the region from every forwarding table
                    if (
                        incoming.status in (SUSPECT, DEAD, LEFT)
                        and incoming.incarnation >= self._me.incarnation
                        and self._me.status != LEFT
                    ):
                        self._me.incarnation = incoming.incarnation + 1
                    continue
                current = self.members.get(incoming.name)
                if current is None:
                    incoming.status_time = time.monotonic()
                    self.members[incoming.name] = incoming
                    if incoming.status == ALIVE:
                        events.append(("join", incoming))
                    continue
                if incoming.incarnation < current.incarnation:
                    continue
                if (
                    incoming.incarnation == current.incarnation
                    and _STATUS_RANK[incoming.status] <= _STATUS_RANK[current.status]
                ):
                    continue
                old_status = current.status
                current.incarnation = incoming.incarnation
                current.tags = incoming.tags
                # a member that restarted and rebound carries a new
                # endpoint; adopt it or probes flap at the dead address
                current.host = incoming.host
                current.port = incoming.port
                if incoming.status != old_status:
                    current.status = incoming.status
                    current.status_time = time.monotonic()
                    if incoming.status == ALIVE:
                        events.append(("join", current))
                    elif incoming.status == LEFT:
                        events.append(("leave", current))
                    elif incoming.status == DEAD:
                        events.append(("dead", current))
                    elif incoming.status == SUSPECT:
                        events.append(("suspect", current))
        for event, member in events:
            logger.info("%s: member %s %s", self.name, member.name, event)
            self._emit(event, member)

    def _emit(self, event: str, member: Member):
        if self.on_event is not None:
            try:
                self.on_event(event, member)
            except Exception:
                logger.exception("gossip event handler failed")
