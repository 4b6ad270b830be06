"""Seeded, deterministic workload grammar.

A :class:`Scenario` is a list of :class:`Phase` definitions; compiling it
with a seed produces an :class:`OpStream` — a time-ordered list of
:class:`Op` whose canonical encoding is byte-identical for the same
(scenario, seed), which is the determinism contract the smoke soak pins.

Every random draw comes from a *named* RNG stream
(``named_rng(seed, scenario, phase, stream)``): adding a new op kind or
reordering unrelated draws cannot perturb the draws of existing streams,
so scenarios stay replayable across edits that don't touch their phases.

Compilation walks a :class:`World` — the grammar's model of which job
slots/nodes exist and their current counts/versions — so the emitted
stream is coherent (no scaling a job that was never submitted, no
draining an unregistered node). The driver re-derives the same world at
fire time purely from op args; nothing about the stream depends on the
cluster's responses.
"""

from __future__ import annotations

import hashlib
import json
import random
from dataclasses import dataclass, field
from typing import Optional

#: op kinds, in one place so driver/score can enumerate them
OP_KINDS = (
    "node.register",
    "node.down",
    "node.up",
    "node.drain",
    "node.drain_off",
    "job.submit",
    "job.scale",
    "job.update",
    "job.stop",
    "job.dispatch_register",
    "job.dispatch",
    "job.evaluate",
    "system.gc",
)


def named_rng(seed: int, *names: str) -> random.Random:
    """One independent deterministic stream per (seed, *names): the name
    path is hashed (not Python ``hash()``, which is salted per process)
    into the Random seed."""
    key = ("%d/" % seed + "/".join(names)).encode()
    return random.Random(int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "big"))


@dataclass(frozen=True)
class Op:
    """One scheduled operation. ``t`` is seconds from storm start; ``seq``
    breaks ties so ordering is total and stable. ``args`` must be
    JSON-serializable with deterministic content."""

    t: float
    seq: int
    kind: str
    args: dict

    def encode(self) -> str:
        return "%010.4f %06d %s %s" % (
            self.t,
            self.seq,
            self.kind,
            json.dumps(self.args, sort_keys=True, separators=(",", ":")),
        )


class OpStream:
    """The compiled, time-ordered storm."""

    def __init__(self, scenario_name: str, seed: int, ops: list[Op]):
        self.scenario_name = scenario_name
        self.seed = seed
        self.ops = sorted(ops, key=lambda o: (o.t, o.seq))

    def encode(self) -> bytes:
        header = f"# loadgen stream scenario={self.scenario_name} seed={self.seed} ops={len(self.ops)}\n"
        return (header + "\n".join(op.encode() for op in self.ops) + "\n").encode()

    def digest(self) -> str:
        return hashlib.sha256(self.encode()).hexdigest()

    def duration(self) -> float:
        return self.ops[-1].t if self.ops else 0.0

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for op in self.ops:
            out[op.kind] = out.get(op.kind, 0) + 1
        return out


# ---------------------------------------------------------------------------
# the compile-time world
# ---------------------------------------------------------------------------


@dataclass
class JobSlot:
    slot: int
    category: str  # "svc" | "bat" | "dsp"
    live: bool = False
    count: int = 0
    version: int = 0
    cpu: int = 100
    memory_mb: int = 64


class World:
    """Entity registry shared by compile time (here) and fire time (the
    driver): both sides derive identical state from the op stream alone."""

    def __init__(self):
        self.jobs: dict[int, JobSlot] = {}
        #: node slot -> status ("ready" | "down" | "draining")
        self.nodes: dict[int, str] = {}
        #: first slot that might be unregistered — slots never leave
        #: ``nodes``, so this cursor only moves forward and the register
        #: scan is O(1) amortized instead of O(fleet) per op (which made
        #: a 100K-node ramp compile O(fleet^2))
        self._next_node_slot = 0

    # -- helpers used by phase compilation -------------------------------
    def live_jobs(self, category: Optional[str] = None) -> list[JobSlot]:
        return [
            s
            for s in self.jobs.values()
            if s.live and (category is None or s.category == category)
        ]

    def apply(self, op: Op):
        """Advance the world by one op (also used by the driver)."""
        a = op.args
        if op.kind == "node.register":
            self.nodes[a["node"]] = "ready"
        elif op.kind == "node.down":
            self.nodes[a["node"]] = "down"
        elif op.kind == "node.up":
            self.nodes[a["node"]] = "ready"
        elif op.kind == "node.drain":
            self.nodes[a["node"]] = "draining"
        elif op.kind == "node.drain_off":
            self.nodes[a["node"]] = "ready"
        elif op.kind in ("job.submit", "job.dispatch_register"):
            slot = self.jobs.setdefault(
                a["slot"], JobSlot(slot=a["slot"], category=a["category"])
            )
            slot.category = a["category"]
            slot.live = True
            slot.count = a.get("count", 0)
            slot.version = a.get("version", 0)
            slot.cpu = a.get("cpu", 100)
            slot.memory_mb = a.get("memory_mb", 64)
        elif op.kind == "job.scale":
            s = self.jobs.get(a["slot"])
            if s is not None:
                s.count = a["count"]
        elif op.kind == "job.update":
            s = self.jobs.get(a["slot"])
            if s is not None:
                s.version = a["version"]
        elif op.kind == "job.stop":
            s = self.jobs.get(a["slot"])
            if s is not None:
                s.live = False
                s.count = 0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


@dataclass
class Phase:
    """One storm phase: ``rate`` ops/s for ``duration`` seconds, op kinds
    drawn from ``mix`` (kind -> weight). Arrivals are a seeded Poisson
    process (open-loop arrivals, the production-traffic shape) unless
    ``uniform=True`` (evenly spaced — used by ramps that must finish a
    fixed amount of work inside the phase). ``params`` hold per-phase
    draw ranges (job counts, resources, drain deadlines...)."""

    name: str
    duration: float
    rate: float
    mix: dict[str, float]
    uniform: bool = False
    params: dict = field(default_factory=dict)

    # -- arg synthesis per kind ------------------------------------------
    def _draw_args(self, kind: str, rng: random.Random, world: World) -> Optional[dict]:
        p = self.params
        if kind == "node.register":
            # next unregistered slot (forward-only cursor; see World)
            fleet = p.get("node_fleet", 100)
            i = world._next_node_slot
            while i < fleet and i in world.nodes:
                i += 1
            world._next_node_slot = i
            if i >= fleet:
                return None  # fleet fully registered: skip (no-op)
            return {"node": i}
        if kind in ("node.down", "node.drain"):
            ready = sorted(i for i, st in world.nodes.items() if st == "ready")
            # never take out the whole fleet: keep a floor of ready nodes
            floor = p.get("ready_floor", max(2, len(world.nodes) // 4))
            if len(ready) <= floor:
                return None
            args = {"node": ready[rng.randrange(len(ready))]}
            if kind == "node.drain":
                args["deadline_s"] = round(rng.uniform(*p.get("drain_deadline_s", (5.0, 30.0))), 2)
            return args
        if kind == "node.up":
            down = sorted(i for i, st in world.nodes.items() if st == "down")
            if not down:
                return None
            return {"node": down[rng.randrange(len(down))]}
        if kind == "node.drain_off":
            draining = sorted(i for i, st in world.nodes.items() if st == "draining")
            if not draining:
                return None
            return {"node": draining[rng.randrange(len(draining))]}
        if kind == "job.submit":
            cats = sorted(p.get("job_categories", {"svc": 1.0}).items())
            cat = rng.choices([c for c, _ in cats], weights=[w for _, w in cats])[0]
            slots = p.get("job_slots", 64)
            free = [i for i in range(slots) if i not in world.jobs or not world.jobs[i].live]
            if not free:
                return None
            lo, hi = (
                p.get("count_range_by_category", {}).get(cat)
                or p.get("count_range", (1, 4))
            )
            args = {
                "slot": free[rng.randrange(len(free))],
                "category": cat,
                "type": "batch" if cat == "bat" else "service",
                "count": rng.randint(lo, hi),
                "cpu": rng.choice(p.get("cpu_choices", (50, 100, 250))),
                "memory_mb": rng.choice(p.get("memory_choices", (32, 64, 128))),
                "version": 0,
            }
            # overload storms shed by priority class; the key is only
            # drawn when the param exists so pre-existing scenarios keep
            # their stream digests byte-identical
            pri = p.get("priority_by_category", {}).get(cat)
            if pri is not None:
                args["priority"] = int(pri)
            return args
        if kind == "job.scale":
            live = world.live_jobs()
            live = [s for s in live if s.category != "dsp"]
            if not live:
                return None
            s = live[rng.randrange(len(live))]
            # relative step (so a 10K-count soak job churns hundreds of
            # allocs per scale while a 3-count smoke job steps by 1),
            # biased upward to keep the working set from decaying
            frac = p.get("scale_frac", 0.25)
            delta = max(1, int(s.count * frac * rng.uniform(0.2, 1.0)))
            new = max(1, s.count + (delta if rng.random() < 0.6 else -delta))
            if new == s.count:
                new = s.count + 1
            return {"slot": s.slot, "count": new}
        if kind == "job.update":
            live = [s for s in world.live_jobs("svc")]
            if not live:
                return None
            s = live[rng.randrange(len(live))]
            # version bump drives a rolling deploy (update stanza on svc jobs)
            return {"slot": s.slot, "version": s.version + 1}
        if kind == "job.stop":
            live = world.live_jobs()
            keep_floor = p.get("job_floor", 2)
            if len(live) <= keep_floor:
                return None
            s = live[rng.randrange(len(live))]
            return {"slot": s.slot, "purge": rng.random() < p.get("purge_p", 0.3)}
        if kind == "job.dispatch_register":
            slots = p.get("dispatch_slots", 4)
            free = [
                i for i in range(10_000, 10_000 + slots)
                if i not in world.jobs or not world.jobs[i].live
            ]
            if not free:
                return None
            return {
                "slot": free[0],
                "category": "dsp",
                "type": "batch",
                "count": 1,
                "cpu": 50,
                "memory_mb": 32,
                "version": 0,
            }
        if kind == "job.dispatch":
            live = world.live_jobs("dsp")
            if not live:
                return None
            s = live[rng.randrange(len(live))]
            fan = self.params.get("dispatch_fanout", (1, 4))
            return {"slot": s.slot, "fanout": rng.randint(*fan)}
        if kind == "job.evaluate":
            live = [s for s in world.live_jobs() if s.category != "dsp"]
            if not live:
                return None
            return {"slot": live[rng.randrange(len(live))].slot}
        if kind == "system.gc":
            return {}
        raise ValueError(f"unknown op kind: {kind}")

    def compile(
        self, seed: int, scenario: str, t0: float, seq0: int, world: World
    ) -> list[Op]:
        arrival = named_rng(seed, scenario, self.name, "arrivals")
        kind_rng = named_rng(seed, scenario, self.name, "mix")
        arg_rngs = {
            k: named_rng(seed, scenario, self.name, "args", k) for k in self.mix
        }
        kinds = sorted(self.mix)
        weights = [self.mix[k] for k in kinds]
        ops: list[Op] = []
        n_uniform = max(1, int(self.rate * self.duration))
        t = 0.0
        i = 0
        seq = seq0
        while True:
            if self.uniform:
                if i >= n_uniform:
                    break
                t = (i + 0.5) * self.duration / n_uniform
            else:
                t += arrival.expovariate(self.rate)
                if t >= self.duration:
                    break
            kind = kind_rng.choices(kinds, weights=weights)[0]
            args = self._draw_args(kind, arg_rngs[kind], world)
            i += 1
            if args is None:
                continue  # kind not applicable in this world state: skip
            op = Op(t=round(t0 + t, 4), seq=seq, kind=kind, args=args)
            world.apply(op)
            ops.append(op)
            seq += 1
        return ops


@dataclass
class Scenario:
    """A named storm: the cluster it runs against plus its phases and the
    SLO targets the scorekeeper grades at the end."""

    name: str
    description: str
    phases: list[Phase]
    n_workers: int = 2
    server_config: dict = field(default_factory=dict)
    #: extra seconds the runner waits for evals to quiesce after the storm
    quiesce_timeout: float = 60.0
    #: SLO targets consumed by score.grade(); keys documented there
    slos: dict = field(default_factory=dict)
    #: scorekeeper cadence (seconds between samples)
    sample_interval: float = 1.0
    #: run incremental invariants every N samples
    invariants_every: int = 5
    #: event-stream probe subscribers measuring delivery lag over HTTP
    probes: int = 2


def compile_stream(scenario: Scenario, seed: int) -> OpStream:
    """Compile the scenario's phases, in order, against one shared world."""
    world = World()
    ops: list[Op] = []
    t0 = 0.0
    for phase in scenario.phases:
        ops.extend(phase.compile(seed, scenario.name, t0, len(ops), world))
        t0 += phase.duration
    return OpStream(scenario.name, seed, ops)


# ---------------------------------------------------------------------------
# spec builders: op args -> model objects (used at fire time by the driver,
# and by tests that need the same specs without a cluster)
# ---------------------------------------------------------------------------

JOB_PREFIX = "ldg"
NODE_PREFIX = "ldgnode"


def job_id_for(slot: int, category: str, prefix: str = JOB_PREFIX) -> str:
    """``prefix`` scopes the id space: federated storms run one grammar
    per region against separate raft domains, and the cross-region
    oracle (job present in exactly its home region) is only meaningful
    when region A's slot 3 and region B's slot 3 are different jobs."""
    return f"{prefix}-{category}-{slot:05d}"


def node_id_for(slot: int) -> str:
    # a stable fake-uuid so prefix lookups and store keys behave like
    # production ids; derived only from the slot
    h = hashlib.blake2b(b"ldgnode-%d" % slot, digest_size=16).hexdigest()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:32]}"


def build_node(slot: int, datacenters: tuple = ("dc1", "dc2"), resources: Optional[dict] = None):
    """Deterministic node for a slot: same id every time so down/up cycles
    re-register the SAME node (the client-restart shape)."""
    from .. import mock
    from ..structs import compute_class

    rng = named_rng(slot, "node-template")
    node = mock.node()
    node.id = node_id_for(slot)
    node.name = f"{NODE_PREFIX}-{slot:05d}"
    node.datacenter = datacenters[slot % len(datacenters)]
    res = resources or {}
    node.node_resources.cpu.cpu_shares = res.get(
        "cpu", rng.choice((4000, 8000, 16000))
    )
    node.node_resources.memory.memory_mb = res.get(
        "memory_mb", rng.choice((8192, 16384, 32768))
    )
    node.node_resources.networks = []
    node.reserved_resources.networks.reserved_host_ports = ""
    compute_class(node)
    return node


def build_job(args: dict, datacenters: tuple = ("dc1", "dc2"),
              prefix: str = JOB_PREFIX):
    """Job object for submit/update args. Everything that varies is drawn
    at compile time and carried in ``args`` — rebuilding from the same
    args yields an equivalent job (ids, counts, resources, version
    nonce)."""
    from .. import mock
    from ..structs.model import ParameterizedJobConfig, UpdateStrategy

    category = args["category"]
    job = mock.batch_job() if args.get("type") == "batch" else mock.job()
    job.id = job_id_for(args["slot"], category, prefix)
    job.name = job.id
    job.datacenters = list(datacenters)
    tg = job.task_groups[0]
    tg.count = args.get("count", 1)
    if args.get("priority") is not None:
        job.priority = int(args["priority"])
    task = tg.tasks[0]
    task.driver = "mock_driver"
    task.resources.cpu = args.get("cpu", 100)
    task.resources.memory_mb = args.get("memory_mb", 64)
    task.resources.networks = []
    tg.ephemeral_disk.size_mb = 10
    version = args.get("version", 0)
    # the version nonce lands in env: an in-place (non-destructive) task
    # update, which is what drives the rolling-deploy path
    task.env = dict(task.env or {})
    task.env["LDG_VERSION"] = str(version)
    if category == "svc":
        # the reconciler keys rolling deploys off the TASK GROUP's update
        # stanza (reconcile.py:540-581); short healthy deadlines keep
        # clientless soak deployments from pinning progress timers
        strategy = UpdateStrategy(
            max_parallel=2, stagger=int(1e9), min_healthy_time=0,
            healthy_deadline=int(5e9), progress_deadline=int(30e9),
        )
        job.update = strategy
        tg.update = strategy
    if category == "dsp":
        job.parameterized_job = ParameterizedJobConfig(
            payload="optional", meta_optional=["wave"]
        )
    job.constraints = []
    job.spreads = []
    return job
