"""The scheduler front: real evals through the port's ``tpu-batch``.

Each case builds nodes and a job with the JAX package's fixtures (the
shapes of tests/test_tpu_parity.py and tests/test_tpu_devices.py), runs
one eval through the JAX package's Harness, and carries the same
``to_dict()`` documents, in the same order and at the same raft indexes,
into the port's state store (``nomad_tpu_torch.state.carry``). The port's
Harness then processes the same eval with the same seed. Both must give
the same ``alloc name -> node id`` placements, the same failure metrics
(``failed_tg_allocs``) and the same routing (the mode or the fallback
reason ``SCHED_COUNTERS`` counts), with no tolerance:

- the JAX ``tpu-batch`` under the deterministic flavor against the port's
  ``tpu-batch`` on the CPU (its planners' plain versions);
- ``service`` against ``service`` (the Go-iterator oracle copy), and
  ``oracle-np`` against ``oracle-np``.

The small-eval oracle gate is 0 in both packages so every eval that the
kernel covers reaches a planner. The wavefront and paged routes run with
their stanzas on in both packages; the drain branch runs four evals on
threads through one collector in each package.
"""

import random
import threading

import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

import test_tpu_devices as devices
import test_tpu_parity as parity
from nomad_tpu import mock as jmock
from nomad_tpu.scheduler import Harness as JHarness
from nomad_tpu.state import planes as jplanes
from nomad_tpu.structs import compute_class
from nomad_tpu.structs.model import (
    Affinity,
    Constraint,
    Evaluation,
    NetworkResource,
    Port,
    Spread,
    SpreadTarget,
    TaskGroup,
)
from nomad_tpu.tpu import batch_sched as jsched
from nomad_tpu.tpu import drain as jdrain
from nomad_tpu.tpu import kernel as jk
from nomad_tpu.tpu import paging as jpaging
from nomad_tpu.tpu import wavefront as jwf
from nomad_tpu_torch.scheduler import Harness as THarness
from nomad_tpu_torch.state.carry import carry_state
from nomad_tpu_torch.structs.model import Evaluation as TEvaluation
from nomad_tpu_torch.tpu import batch_sched as tsched
from nomad_tpu_torch.tpu import drain as tdrain
from nomad_tpu_torch.tpu import kernel as tk
from nomad_tpu_torch.tpu import paging as tpaging
from nomad_tpu_torch.tpu import planner as tplanner
from nomad_tpu_torch.tpu import wavefront as twf

STANZAS = (jwf, twf, jpaging, tpaging)
SEED = 5


@pytest.fixture(autouse=True)
def _gates(monkeypatch):
    """Every kernel-covered eval reaches a planner, in both packages; the
    stanzas start and end off."""
    tile_rows = jplanes.TILE_ROWS
    for m in STANZAS:
        m.reset()
    for m in (jsched, tsched):
        monkeypatch.setattr(m, "SMALL_EVAL_ORACLE_MAX", 0)
        monkeypatch.setattr(m, "EXACT_ONLY", False)
    yield
    for m in STANZAS:
        m.reset()
    jplanes.TILE_ROWS = tile_rows


def _route(route, monkeypatch):
    """``wavefront``: the exact scan's evals go to the wavefront planner;
    ``paged``: a budget below the planes sends windowed evals to the paged
    planner, in 64-row tiles. In both packages."""
    if route == "wavefront":
        for m in (jwf, twf):
            m.configure(enabled=True)
    elif route == "paged":
        for m in (jpaging, tpaging):
            m.configure(enabled=True, tile_nodes=64)
            monkeypatch.setattr(m, "budget_mb", lambda: 0)


# ---------------------------------------------------------------------------
# the shapes
# ---------------------------------------------------------------------------

def _dcs(n):
    return tuple(f"dc{i}" for i in range(1, n + 1))


def _dcs_spread(n):
    def mutate(job):
        job.datacenters = list(_dcs(n))
        job.spreads = [Spread(
            attribute="${node.datacenter}", weight=100,
            spread_target=[SpreadTarget(value=d, percent=100 // n) for d in _dcs(n)],
        )]
    return mutate


def _even_spread(n):
    def mutate(job):
        job.datacenters = list(_dcs(n))
        job.spreads = [Spread(attribute="${node.datacenter}", weight=100)]
    return mutate


def _ssd_affinity(job):
    job.affinities = [Affinity(l_target="${meta.ssd}", r_target="true", operand="=", weight=50)]


def _ssd_nodes(n, every=4):
    nodes = parity.build_cluster(n)
    for i, node in enumerate(nodes):
        node.meta["ssd"] = "true" if i % every == 0 else "false"
    return nodes


def _rack_nodes(n):
    nodes = parity.build_cluster(n)
    for i, node in enumerate(nodes):
        node.attributes["rack_class"] = "a" if i % 2 == 0 else "b"
        compute_class(node)
    return nodes


def _rack_constraint(job):
    job.constraints.append(Constraint(l_target="${attr.rack_class}", r_target="a", operand="="))


def _net(mbits, cpu=None):
    def mutate(job):
        task = job.task_groups[0].tasks[0]
        if cpu is not None:
            task.resources.cpu = cpu
            task.resources.memory_mb = cpu
        task.resources.networks = [
            NetworkResource(mbits=mbits, dynamic_ports=[Port(label="http"), Port(label="admin")])
        ]
    return mutate


def _roomy(nodes, mbits):
    for n in nodes:
        n.node_resources.cpu.cpu_shares = 100000
        n.node_resources.memory.memory_mb = 100000
        n.node_resources.networks[0].mbits = mbits
    return nodes


def _multi_nic_nodes():
    nodes = _roomy(parity.build_cluster(10), 300)
    for i, n in enumerate(nodes):
        if i < 5:
            n.node_resources.networks = [
                NetworkResource(device="eth0", ip="192.168.1.1", cidr="192.168.1.1/32", mbits=150),
                NetworkResource(device="eth1", ip="192.168.1.2", cidr="192.168.1.2/32", mbits=150),
            ]
    return nodes


def _distinct_hosts(job):
    job.constraints.append(Constraint(operand="distinct_hosts"))


def _two_groups(count):
    def mutate(job):
        tg = job.task_groups[0]
        other = TaskGroup.from_dict(tg.to_dict())
        other.name = "api"
        other.count = count
        other.tasks[0].resources.cpu = 300
        job.task_groups.append(other)
    return mutate


def _device_affinity_job(count):
    job = devices.device_job(count)
    _ssd_affinity(job)
    return job


def _device_nodes(n):
    nodes = devices.build_nodes(n)
    for i, node in enumerate(nodes):
        node.meta["ssd"] = "true" if i % 3 == 0 else "false"
    return nodes


#: name -> (nodes, job, the routing each package must count for tpu-batch)
CASES = {
    "binpack": (lambda: (parity.build_cluster(20), parity.make_job(15)), "windowed"),
    "wide_binpack": (lambda: (parity.build_cluster(200), parity.make_job(150)), "windowed"),
    "constraints": (lambda: (_rack_nodes(20), parity.make_job(12, _rack_constraint)), "windowed"),
    "affinity": (lambda: (_ssd_nodes(16), parity.make_job(10, _ssd_affinity)), "exact-scan"),
    "spread_targets": (lambda: (parity.build_cluster(12, dcs=_dcs(2)),
                                parity.make_job(10, _dcs_spread(2))), "exact-scan"),
    "even_spread": (lambda: (parity.build_cluster(12, dcs=_dcs(3)),
                             parity.make_job(9, _even_spread(3))), "exact-scan"),
    "exhaustion": (lambda: (parity.build_cluster(2), parity.make_job(40)), "exact-scan"),
    "dynamic_ports": (lambda: (parity.build_cluster(24), parity.make_job(40, _net(10))),
                      "windowed"),
    "bandwidth_label": (lambda: (_roomy(parity.build_cluster(4), 50),
                                 parity.make_job(12, _net(40, cpu=10))), "windowed"),
    "multi_nic": (lambda: (_multi_nic_nodes(), parity.make_job(25, _net(100, cpu=10))),
                  "fallback:multi_nic_network"),
    "distinct_hosts": (lambda: (parity.build_cluster(12), parity.make_job(10, _distinct_hosts)),
                       "fallback:unsupported_group"),
    "two_groups": (lambda: (parity.build_cluster(30), parity.make_job(14, _two_groups(11))),
                   "exact-scan"),
    "runs_spread": (lambda: (parity.build_cluster(60, dcs=_dcs(4)),
                             parity.make_job(160, _dcs_spread(4))), "runs"),
    "runs_affinity": (lambda: (_ssd_nodes(50, every=5), parity.make_job(100, _ssd_affinity)),
                      "runs"),
    "devices": (lambda: (devices.build_nodes(16), devices.device_job(12)), "windowed"),
    "devices_exhausted": (lambda: (devices.build_nodes(16), devices.device_job(20)), "windowed"),
    "devices_exact": (lambda: (_device_nodes(24), _device_affinity_job(14)), "exact-scan"),
}


# ---------------------------------------------------------------------------
# one eval in each package
# ---------------------------------------------------------------------------

def _eval(job, eval_id="eval-1"):
    return Evaluation(
        id=eval_id, namespace=job.namespace, priority=job.priority, type="service",
        triggered_by="job-register", job_id=job.id, status="pending",
    )


def _counts(module) -> dict:
    snap = module.counters_snapshot()
    out = {f"mode:{k}": v for k, v in snap["modes"].items()}
    out.update({f"fallback:{k}": v for k, v in snap["fallback_reasons"].items()})
    return out


def _routing(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _metrics(sched) -> dict:
    out = {}
    for name, m in sched.failed_tg_allocs.items():
        d = m.to_dict()
        d.pop("allocation_time")
        out[name] = d
    return out


def _outcome(h, sched, jobs) -> dict:
    placements = {
        (job.id, a.name): a.node_id
        for job in jobs for a in h.state.allocs_by_job(job.namespace, job.id)
    }
    return dict(placements=placements, failed=_metrics(sched))


class JaxRun:
    """A JAX Harness that records the documents it stores."""

    def __init__(self):
        self.h = JHarness(seed=SEED)
        self.records = []

    def put(self, kind, obj):
        index = self.h.next_index()
        if kind == "node":
            self.records.append((index, kind, obj.to_dict()))
            self.h.state.upsert_node(index, obj)
        elif kind == "job":
            self.records.append((index, kind, obj.to_dict()))
            self.h.state.upsert_job(index, obj)
        else:
            self.records.append((index, kind, [o.to_dict() for o in obj]))
            self.h.state.upsert_evals(index, obj)

    def process(self, factory, ev):
        return self.h.process(factory, ev)


def _carried(ev):
    """The port's copy of an eval the JAX Harness processes."""
    return TEvaluation.from_dict(ev.to_dict())


def _port_harness(records):
    h = THarness(state=carry_state(records), seed=SEED, device="cpu")
    for _ in records:  # the next raft index follows the carried ones
        h.next_index()
    return h


def _both(nodes, job, factory):
    """(JAX outcome, port outcome) of one eval, with each package's routing."""
    run = JaxRun()
    for n in nodes:
        run.put("node", n)
    run.put("job", job)
    ev = _eval(job)
    run.put("evals", [ev])
    records = list(run.records)
    before = _counts(jsched)
    with jk.deterministic_scope():
        sched = run.process(factory, ev)
    want = dict(_outcome(run.h, sched, [job]), routing=_routing(before, _counts(jsched)))

    th = _port_harness(records)
    before = _counts(tsched)
    tsched_ = th.process(factory, _carried(ev))
    got = dict(_outcome(th, tsched_, [job]), routing=_routing(before, _counts(tsched)))
    return want, got


def _expected_routing(kind: str) -> dict:
    return {kind if kind.startswith("fallback:") else f"mode:{kind}": 1}


@pytest.mark.parametrize("factory", ["tpu-batch", "service", "oracle-np"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_places_as_the_jax_package(case, factory):
    build, mode = CASES[case]
    nodes, job = build()
    want, got = _both(nodes, job, factory)
    assert got["placements"] == want["placements"]
    assert got["failed"] == want["failed"]
    assert got["routing"] == want["routing"]
    if factory == "tpu-batch":
        assert got["routing"] == _expected_routing(mode)
        assert want["placements"], "the eval placed nothing"
    if case in ("exhaustion", "bandwidth_label", "devices_exhausted"):
        assert got["failed"], "the case must exhaust the cluster"
    if case == "bandwidth_label":
        assert "network: bandwidth exceeded" in got["failed"]["web"]["dimension_exhausted"]
    if case == "devices_exhausted" and factory != "service":
        assert "devices" in got["failed"]["web"]["dimension_exhausted"]


#: route -> (case, the mode it gives)
ROUTES = {
    "wavefront": [("affinity", "wavefront"), ("two_groups", "wavefront"),
                  ("devices_exact", "wavefront")],
    "paged": [("wide_binpack", "paged"), ("dynamic_ports", "paged")],
}


@pytest.mark.parametrize("route,case,mode", [(r, c, m) for r, cases in sorted(ROUTES.items())
                                             for c, m in cases])
def test_routes_place_as_the_jax_package(route, case, mode, monkeypatch):
    _route(route, monkeypatch)
    nodes, job = CASES[case][0]()
    want, got = _both(nodes, job, "tpu-batch")
    assert got == want
    assert got["routing"] == {f"mode:{mode}": 1}
    if case == "wide_binpack":  # 200 nodes pad to 256: four tiles
        assert tsched.LAST_KERNEL_STATS["paged_tiles"] == 4


def test_eval_on_a_loaded_cluster():
    """A job scaled up over its own running allocs: the carried allocations
    give the planes their usage, collisions and spread counts."""
    nodes = parity.build_cluster(40, dcs=_dcs(4))
    job = parity.make_job(30, _dcs_spread(4))
    run = JaxRun()
    for n in nodes:
        run.put("node", n)
    run.put("job", job)
    first = _eval(job, "eval-0")
    run.put("evals", [first])
    with jk.deterministic_scope():
        run.process("service", first)
    placed = run.h.state.allocs_by_job(job.namespace, job.id)
    assert len(placed) == 30
    index = run.h.state.latest_index()
    run.records.append((index, "allocs", [a.to_dict() for a in placed]))
    while run.h._next_index <= index:
        run.h.next_index()
    bigger = run.h.state.job_by_id(job.namespace, job.id).copy()
    bigger.task_groups[0].count = 120
    run.put("job", bigger)
    ev = _eval(bigger)
    run.put("evals", [ev])
    records = list(run.records)
    with jk.deterministic_scope():
        sched = run.process("tpu-batch", ev)
    want = _outcome(run.h, sched, [bigger])

    th = _port_harness(records)
    got = _outcome(th, th.process("tpu-batch", _carried(ev)), [bigger])
    assert got == want
    assert len(got["placements"]) == 120
    stats = tsched.LAST_KERNEL_STATS
    assert stats["mode"] == "runs"
    assert stats["device_s"] is None and 0 < stats["kernel_s"] <= stats["dispatch_s"]


# ---------------------------------------------------------------------------
# the drain branch
# ---------------------------------------------------------------------------

def _drain_jobs():
    rng = random.Random(17)
    nodes = []
    for _ in range(24):
        n = jmock.node()
        n.node_resources.cpu.cpu_shares = rng.choice([2000, 4000])
        n.node_resources.memory.memory_mb = 8192
        n.node_resources.networks = []
        nodes.append(n)
    jobs = []
    for i, count in enumerate((9, 12, 7, 10)):
        job = parity.make_job(count)
        job.priority = 50 + 10 * (i % 2)
        jobs.append(job)
    return nodes, jobs


def _drain(sched_cls, collector, snapshot, harness, evs, **kw):
    errors = []

    def run_one(ev):
        sched = sched_cls(snapshot, harness, rng=random.Random(SEED), **kw)
        sched.drain_collector = collector
        try:
            sched.process(ev)
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)
        finally:
            if not collector.consumed(ev.id):
                collector.leave(ev.id)

    threads = [threading.Thread(target=run_one, args=(ev,), daemon=True) for ev in evs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), "a drain thread is stuck"
    assert not errors, errors


@pytest.mark.parametrize("route", ["exact", "wavefront"])
def test_drain_batch_places_as_the_jax_package(route, monkeypatch):
    if route == "wavefront":
        _route("wavefront", monkeypatch)
    nodes, jobs = _drain_jobs()
    run = JaxRun()
    for n in nodes:
        run.put("node", n)
    evs = []
    for i, job in enumerate(jobs):
        run.put("job", job)
        ev = _eval(job, f"ev-{i}")
        ev.create_index = run.h._next_index
        run.put("evals", [ev])
        evs.append(ev)
    records = list(run.records)
    snapshot = run.h.state.snapshot()
    collector = jdrain.KernelBatchCollector(jdrain.SharedCluster(snapshot), expected=len(evs),
                                            timeout=20)
    with jk.deterministic_scope():
        _drain(jsched.TPUBatchScheduler, collector, snapshot, run.h, evs)
    assert collector.invocations == 1
    want = _outcome(run.h, jsched.TPUBatchScheduler(snapshot, run.h), jobs)

    th = _port_harness(records)
    snapshot = th.state.snapshot()
    before = tsched.counters_snapshot()["drain_evals"]
    tcollector = tdrain.KernelBatchCollector(tdrain.SharedCluster.from_snapshot(snapshot),
                                             expected=len(evs), timeout=20, device="cpu")
    _drain(tsched.TPUBatchScheduler, tcollector, snapshot, th, [_carried(ev) for ev in evs],
           device="cpu")
    assert tcollector.invocations == 1
    assert tsched.counters_snapshot()["drain_evals"] - before == len(evs)
    assert tdrain.LAST_DRAIN_STATS["planner"] == route
    got = _outcome(th, tsched.TPUBatchScheduler(snapshot, th), jobs)
    assert got["placements"] == want["placements"]
    assert len(got["placements"]) == sum(j.task_groups[0].count for j in jobs)


# ---------------------------------------------------------------------------
# no hidden fallback
# ---------------------------------------------------------------------------

def _port_eval(nodes, job):
    run = JaxRun()
    for n in nodes:
        run.put("node", n)
    run.put("job", job)
    ev = _eval(job)
    run.put("evals", [ev])
    return _port_harness(run.records), _carried(ev)


def _placements(h, job):
    return {a.name: a.node_id for a in h.state.allocs_by_job(job.namespace, job.id)}


def test_a_kernel_sized_eval_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CUDA-less refusal is not observable")
    nodes, job = parity.build_cluster(20), parity.make_job(15)
    th, ev = _port_eval(nodes, job)
    th.device = None
    with pytest.raises(RuntimeError, match="CUDA"):
        th.process("tpu-batch", ev)
    assert _placements(th, job) == {}
    # the host oracle needs no card
    th.process("oracle-np", ev)
    assert len(_placements(th, job)) == 15


def test_a_kernel_fault_degrades_to_exact_np(monkeypatch):
    nodes, job = _ssd_nodes(16), parity.make_job(10, _ssd_affinity)
    th, ev = _port_eval(nodes, job)
    th.process("oracle-np", ev)
    want = _placements(th, job)

    th, ev = _port_eval(nodes, job)

    def refuse(*args, **kwargs):
        raise tk.KernelFault("injected: the exact scan takes 2 to 6 resource columns, not 7")

    assert issubclass(tk.KernelFault, ValueError) and tsched.KernelFault is tk.KernelFault
    monkeypatch.setattr(tplanner, "launch_eval", refuse)
    before = tsched.counters_snapshot()
    th.process("tpu-batch", ev)
    after = tsched.counters_snapshot()
    assert _placements(th, job) == want
    assert after["fallback_reasons"].get("kernel_fault", 0) - \
        before["fallback_reasons"].get("kernel_fault", 0) == 1
    assert after["modes"].get("exact-np-degraded", 0) - \
        before["modes"].get("exact-np-degraded", 0) == 1
    assert tsched.LAST_KERNEL_STATS["mode"] == "exact-np-degraded"


def test_other_errors_at_dispatch_propagate(monkeypatch):
    nodes, job = _ssd_nodes(16), parity.make_job(10, _ssd_affinity)
    th, ev = _port_eval(nodes, job)

    def fail(*args, **kwargs):
        raise RuntimeError("exact_scan kernel launch failed: injected (700)")

    monkeypatch.setattr(tplanner, "launch_eval", fail)
    before = tsched.counters_snapshot()["fallback_reasons"].get("kernel_fault", 0)
    with pytest.raises(RuntimeError, match="injected"):
        th.process("tpu-batch", ev)
    assert tsched.counters_snapshot()["fallback_reasons"].get("kernel_fault", 0) == before
    assert _placements(th, job) == {}
