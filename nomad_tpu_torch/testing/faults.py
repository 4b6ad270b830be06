"""Deterministic, seeded fault-injection plane (the Jepsen-style nemesis
for in-process clusters; cf. PAPERS.md partition-testing entries).

A ``FaultPlane`` holds an ordered list of :class:`FaultRule`. Production
seams call the module-level gates at well-known points:

- ``on_rpc(src, dst, method)`` — ConnPool (rpc/client.py) before every
  call: drop, delay, duplicate, or sever the session to ``dst``.
- ``on_raft(src, dst, method)`` — the raft transport
  (raft/transport.py): drop/delay/duplicate AppendEntries, votes, and
  snapshots per (src, dst, method).
- ``fault_point(name)`` — process-level points: ``worker.post_dequeue``
  and ``worker.pre_submit`` (kill a scheduler worker mid-eval),
  ``plan.raft_apply`` (fail/partition the leader mid plan-commit batch),
  ``tpu.kernel`` (device error / NaN at kernel dispatch),
  ``fsm.apply.pre`` / ``fsm.apply.post_state`` (kill -9 around an FSM
  apply — before the applier ran, or after state mutated but before
  events published; the committed-plane crash-recovery storm's seams).
- ``on_region(src_region, dst_region, channel)`` — every INTER-REGION
  link: gossip datagrams (gossip/swim.py), HTTP region forwarding
  (api/http.py) and ACL replication (core/server.py). ``src``/``dst``
  patterns match *region names*, ``method`` matches the channel
  (``gossip`` | ``http.forward`` | ``acl.replication``), so a full
  region partition is ONE declarative rule — not N per-connection
  severs keyed to intra-region transport addresses.

Region-scale helpers: :meth:`FaultPlane.partition_regions` installs the
(symmetric or asymmetric) sever rules for a region pair and returns
them; :meth:`FaultPlane.expire_rules` heals by retiring rules in place
(the rule list order — and therefore the seeded decision sequence of
every other rule — is untouched, keeping replay deterministic).

Every decision is drawn from one seeded ``random.Random`` under a lock,
so a deterministic call sequence yields a deterministic fault schedule.
Rules record ``matches``/``trips`` and the plane keeps a ``log`` of every
injected fault for test assertions.

Install with ``install(FaultPlane(seed=...))`` (or the ``plane()``
context manager) and always ``uninstall()`` — the pointer is global to
the process.
"""

from __future__ import annotations

import contextlib
import fnmatch
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


class SimulatedCrash(BaseException):
    """A fault-plane "kill -9": derives from BaseException so no ordinary
    ``except Exception`` recovery path (nack handlers, retry loops) can
    observe it — exactly like a process death, the component simply stops
    mid-operation and the cluster's leases/timers must clean up."""


@dataclass
class FaultRule:
    """One match-and-inject rule. Patterns are fnmatch globs; ``scope``
    selects the seam ("rpc", "raft", or "point"). ``action`` is one of
    drop | delay | duplicate | sever | crash | error | callback."""

    scope: str
    action: str
    src: str = "*"
    dst: str = "*"
    method: str = "*"  # RPC/raft method, or the fault-point name
    p: float = 1.0  # trip probability per match (seeded)
    delay: float = 0.0  # seconds, for action == "delay"
    count: Optional[int] = None  # max trips; None = unlimited
    after: int = 0  # skip the first N matches
    error: Optional[BaseException] = None  # payload for action == "error"
    callback: Optional[Callable[[], None]] = None  # runs on every trip
    matches: int = 0
    trips: int = 0

    def _matches(self, scope: str, src: str, dst: str, method: str) -> bool:
        return (
            self.scope == scope
            and fnmatch.fnmatch(src, self.src)
            and fnmatch.fnmatch(dst, self.dst)
            and fnmatch.fnmatch(method, self.method)
        )


class FaultPlane:
    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        # nta: ignore[unbounded-cache] WHY: a plane is scenario-scoped
        # and its rule list is the test's specification
        self.rules: list[FaultRule] = []
        #: every injected fault as (scope, src, dst, method, action)
        # nta: ignore[unbounded-cache] WHY: scenario-scoped assertion
        # surface (tests read it); dies with the plane
        self.log: list[tuple] = []
        self._lock = threading.Lock()

    # -- rule construction ---------------------------------------------
    def rule(self, scope: str, action: str, **kw) -> FaultRule:
        r = FaultRule(scope=scope, action=action, **kw)
        with self._lock:
            self.rules.append(r)
        return r

    def trips(self, scope: Optional[str] = None) -> int:
        with self._lock:
            return sum(
                r.trips for r in self.rules if scope is None or r.scope == scope
            )

    def partition_regions(
        self,
        a: str,
        b: str,
        symmetric: bool = True,
        channel: str = "*",
        **kw,
    ) -> list[FaultRule]:
        """Sever every inter-region channel from region ``a`` to region
        ``b`` (and the reverse when ``symmetric``): gossip goes dark, HTTP
        forwards fail, ACL replication stalls — one declarative rule per
        direction. Heal with :meth:`expire_rules` on the returned list."""
        rules = [self.rule("region", "sever", src=a, dst=b, method=channel, **kw)]
        if symmetric:
            rules.append(
                self.rule("region", "sever", src=b, dst=a, method=channel, **kw)
            )
        return rules

    def expire_rules(self, rules: list[FaultRule]):
        """Retire rules in place (heal): each stops tripping by capping
        ``count`` at its current trip total. Removal would re-index the
        ordered rule list and perturb the seeded decision sequence of
        every later rule — expiry keeps replays byte-stable."""
        with self._lock:
            for r in rules:
                r.count = r.trips

    # -- decision core -------------------------------------------------
    def _decide(
        self, scope: str, src: str, dst: str, method: str,
        exclude: tuple = (),
    ) -> Optional[FaultRule]:
        """First rule that matches AND trips (probability, after, count
        all drawn/checked under the lock for determinism). Rules whose
        action is in ``exclude`` are skipped entirely — no match, no trip
        — so a seam that cannot honor an action (duplicating a stream)
        never falsely reports it injected."""
        with self._lock:
            for r in self.rules:
                if r.action in exclude:
                    continue
                if not r._matches(scope, src, dst, method):
                    continue
                r.matches += 1
                if r.matches <= r.after:
                    continue
                if r.count is not None and r.trips >= r.count:
                    continue
                if r.p < 1.0 and self.rng.random() >= r.p:
                    continue
                r.trips += 1
                self.log.append((scope, src, dst, method, r.action))
                return r
        return None

    def _fire(self, rule: FaultRule, what: str) -> Optional[str]:
        """Run the rule's side effects; returns the action the caller must
        apply itself ("drop"/"duplicate"/"sever"), or None."""
        if rule.callback is not None:
            rule.callback()
        if rule.action == "delay":
            time.sleep(rule.delay)
            return None
        if rule.action == "crash":
            raise SimulatedCrash(what)
        if rule.action == "error":
            raise rule.error if rule.error is not None else RuntimeError(
                f"injected fault: {what}"
            )
        if rule.action == "callback":
            return None
        return rule.action

    # -- seams ----------------------------------------------------------
    def on_rpc(
        self, src: str, dst: str, method: str, exclude: tuple = ()
    ) -> Optional[str]:
        rule = self._decide("rpc", src, dst, method, exclude=exclude)
        if rule is None:
            return None
        return self._fire(rule, f"rpc {src}->{dst} {method}")

    def on_raft(self, src: str, dst: str, method: str) -> Optional[str]:
        rule = self._decide("raft", src, dst, method)
        if rule is None:
            return None
        return self._fire(rule, f"raft {src}->{dst} {method}")

    def on_point(self, point: str) -> Optional[str]:
        rule = self._decide("point", "", "", point)
        if rule is None:
            return None
        return self._fire(rule, point)

    def on_region(
        self, src_region: str, dst_region: str, channel: str
    ) -> Optional[str]:
        """Inter-region link gate. Same-region traffic never matches —
        region rules model the WAN, not the local fabric."""
        if src_region == dst_region:
            return None
        rule = self._decide("region", src_region, dst_region, channel)
        if rule is None:
            return None
        return self._fire(rule, f"region {src_region}->{dst_region} {channel}")


#: the installed plane; production seams read this once per fault point
ACTIVE: Optional[FaultPlane] = None


def install(plane_: FaultPlane) -> FaultPlane:
    global ACTIVE
    ACTIVE = plane_
    return plane_


def uninstall():
    global ACTIVE
    ACTIVE = None


@contextlib.contextmanager
def plane(seed: int = 0):
    p = install(FaultPlane(seed=seed))
    try:
        yield p
    finally:
        uninstall()


def fault_point(point: str):
    """Process-level fault gate: no-op unless a plane is installed and a
    "point"-scoped rule matches ``point``. May sleep (delay), raise
    SimulatedCrash (crash) or an injected error, or run a test callback
    (e.g. partition the leader at exactly this moment)."""
    p = ACTIVE
    if p is not None:
        p.on_point(point)


def region_link(src_region: str, dst_region: str, channel: str) -> Optional[str]:
    """Inter-region link gate for production seams: returns the action
    the seam must apply itself ("drop"/"sever" — both mean the traffic
    does not cross the WAN), or None. May also sleep (delay) or raise
    like any other seam."""
    p = ACTIVE
    if p is None:
        return None
    return p.on_region(src_region or "global", dst_region or "global", channel)
