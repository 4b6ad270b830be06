"""The port's server: evals sent to a running in-process ``Server``.

Each case runs the same seeded data through the JAX package and through
the port on the CPU, carried across as ``to_dict()`` documents in the
same order (``nomad_tpu_torch.state.carry``), and compares what each
commits, with no tolerance:

- (a) a drain of ``batch_drain`` 8 through one ``BatchDrainWorker``,
  started after the broker is loaded so the evals fuse into one batch
  (the ``Server.start_workers`` recipe of tests/test_drain.py), and the
  same evals through one plain worker that plans each one solo;
- (b) tests/test_tpu_parity.py's system-planes cases through each
  package's ``tpu-system``;
- (c) tests/test_plan_apply.py's ``TestDeviceVerifyParity`` plans through
  the port's ``Planner`` and ``ColumnarMirror`` against the JAX package's
  host ``evaluate_plan``;
- (d) the ``tpu.kernel`` fault point, which degrades an eval to exact-np
  and a dense verify to the host oracle, counted.

Every server is stopped in ``finally``, and after each test a fixture
checks within ``STOP_S`` that no thread it started is still alive (the
process-wide timer wheels of both packages excepted: one idle thread
each, parked on a condition). Every wait has a deadline.
"""

import contextlib
import random
import threading
import time

import pytest

from torch_for_tests import gil_handoff, torch  # noqa: F401

import test_torch_sched as tts
import test_tpu_parity as parity
from nomad_tpu import metrics as jmetrics
from nomad_tpu import mock as jmock
from nomad_tpu.core import broker as jbroker
from nomad_tpu.core import plan_apply as jpa
from nomad_tpu.core.server import Server as JServer
from nomad_tpu.raft import InmemTransport as JTransport
from nomad_tpu.raft import RaftConfig as JRaftConfig
from nomad_tpu.state import StateStore as JStateStore
from nomad_tpu.structs import compute_class
from nomad_tpu.structs import model as jmodel
from nomad_tpu.structs.model import (
    NODE_SCHED_INELIGIBLE,
    Constraint,
    Evaluation,
    NetworkResource,
    Plan,
    Port,
)
from nomad_tpu.testing import faults as jfaults
from nomad_tpu.tpu import batch_sched as jsched
from nomad_tpu.tpu import drain as jdrain
from nomad_tpu.tpu import kernel as jk
from nomad_tpu_torch import metrics as tmetrics
from nomad_tpu_torch.core import broker as tbroker
from nomad_tpu_torch.core import plan_apply as tpa
from nomad_tpu_torch.core.server import Server as TServer
from nomad_tpu_torch.raft import InmemTransport as TTransport
from nomad_tpu_torch.raft import RaftConfig as TRaftConfig
from nomad_tpu_torch.state import StateStore as TStateStore
from nomad_tpu_torch.structs import model as tmodel
from nomad_tpu_torch.testing import faults as tfaults
from nomad_tpu_torch.tpu import batch_sched as tsched
from nomad_tpu_torch.tpu import drain as tdrain
from nomad_tpu_torch.tpu import mirror as tmirror

#: seconds a stopped server's threads get to end
STOP_S = 10.0
#: seconds a server gets to complete its evals
EVALS_S = 30.0


# ---------------------------------------------------------------------------
# servers and their threads
# ---------------------------------------------------------------------------

def _wheel_threads() -> set:
    return {w._thread for w in (jbroker.shared_timer_wheel(), tbroker.shared_timer_wheel())}


@pytest.fixture(autouse=True)
def _threads_end():
    """After each test, every thread it started (the process-wide timer
    wheels excepted) has ended within ``STOP_S``."""
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + STOP_S
    while True:
        left = [t for t in threading.enumerate()
                if t not in before and t not in _wheel_threads() and t.is_alive()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, f"threads still alive {STOP_S} s after the test: {[t.name for t in left]}"


@contextlib.contextmanager
def _servers():
    """Yields a list to append started servers to; stops each in
    ``finally``."""
    started: list = []
    try:
        yield started
    finally:
        for s in started:
            s.stop()


def _config(port: bool, extra: dict) -> dict:
    transport, raft_config = (TTransport, TRaftConfig) if port else (JTransport, JRaftConfig)
    cfg = {"seed": 42, "heartbeat_ttl": 600.0, **extra}
    cfg["raft"] = {
        "node_id": "s0", "address": "raft0", "voters": {"s0": "raft0"},
        "transport": transport(),
        "config": raft_config(heartbeat_interval=0.02, election_timeout_min=0.05,
                              election_timeout_max=0.10),
    }
    return cfg


def _wait_evals(server, eval_ids) -> list:
    deadline = time.monotonic() + EVALS_S
    while True:
        evs = [server.state.eval_by_id(e) for e in eval_ids]
        if all(e is not None and e.status == "complete" for e in evs):
            return evs
        assert time.monotonic() < deadline, (
            f"evals not complete in {EVALS_S} s: {[e and e.status for e in evs]}")
        time.sleep(0.02)


def _serve(started, port: bool, extra: dict, node_docs, job_docs, workers: int = 1) -> dict:
    """Start a server with no worker, register the nodes and the jobs,
    start ``workers`` workers, wait for every eval; returns
    (job id, alloc name) -> node id."""
    model = tmodel if port else jmodel
    cfg = _config(port, extra)
    server = TServer(cfg, device="cpu") if port else JServer(cfg)
    started.append(server)
    server.start(num_workers=0, wait_for_leader=5.0)
    for d in node_docs:
        server.node_register(model.Node.from_dict(d))
    jobs = [model.Job.from_dict(d) for d in job_docs]
    eval_ids = [server.job_register(j) for j in jobs]
    server.start_workers(workers)
    _wait_evals(server, eval_ids)
    return {(j.id, a.name): a.node_id
            for j in jobs for a in server.state.allocs_by_job(j.namespace, j.id)}


def _cluster_docs(n_nodes: int = 32, seed: int = 17) -> list:
    rng = random.Random(seed)
    docs = []
    for i in range(n_nodes):
        n = jmock.node()
        n.node_resources.cpu.cpu_shares = rng.choice([2000, 4000])
        n.node_resources.memory.memory_mb = rng.choice([4096, 8192])
        n.datacenter = ("dc1", "dc2")[i % 2]
        compute_class(n)
        docs.append(n.to_dict())
    return docs


def _job_docs(counts) -> list:
    docs = []
    for i, count in enumerate(counts):
        j = jmock.job()
        j.datacenters = ["dc1", "dc2"]
        tg = j.task_groups[0]
        tg.count = count
        tg.tasks[0].resources.networks = []
        tg.tasks[0].resources.cpu = (250, 500)[i % 2]
        tg.tasks[0].resources.memory_mb = (128, 512)[i % 2]
        docs.append(j.to_dict())
    return docs


# ---------------------------------------------------------------------------
# (a) a seeded drain, and solo evals, through both servers
# ---------------------------------------------------------------------------

def test_server_drain_places_as_the_jax_server():
    nodes, jobs = _cluster_docs(), _job_docs([12, 16, 10, 20, 14, 9])
    extra = {"default_scheduler": "tpu-batch", "batch_drain": 8, "plan_apply_batch": 8}
    with _servers() as started:
        jb = dict(jdrain.DRAIN_COUNTERS)
        with jk.deterministic_scope():
            want = _serve(started, False, extra, nodes, jobs)
        tb = dict(tdrain.DRAIN_COUNTERS)
        got = _serve(started, True, extra, nodes, jobs)
        port_server = started[1]
        stats = port_server.columnar_mirror.stats()
    assert len(want) == sum([12, 16, 10, 20, 14, 9])
    assert got == want
    # one fused batch of all six evals in each package, the port's on the
    # mirror's device planes
    assert jdrain.DRAIN_COUNTERS["batches"] - jb["batches"] == 1
    assert tdrain.DRAIN_COUNTERS["batches"] - tb["batches"] == 1
    assert tdrain.DRAIN_COUNTERS["evals"] - tb["evals"] == 6
    assert tdrain.LAST_DRAIN_STATS["mirror"] and tdrain.LAST_DRAIN_STATS["device_state"]
    assert stats["uploads"] >= 1 and stats["rebuilds"] == 0


def test_server_solo_worker_places_as_the_jax_server():
    nodes, jobs = _cluster_docs(), _job_docs([12, 16, 10, 20])
    extra = {"default_scheduler": "tpu-batch"}
    with _servers() as started:
        jm = tts._counts(jsched)
        with jk.deterministic_scope():
            want = _serve(started, False, extra, nodes, jobs)
        jm = tts._routing(jm, tts._counts(jsched))
        tm = tts._counts(tsched)
        got = _serve(started, True, extra, nodes, jobs)
        tm = tts._routing(tm, tts._counts(tsched))
    assert len(want) == sum([12, 16, 10, 20])
    assert got == want
    assert tm == jm and sum(tm.values()) == 4


# ---------------------------------------------------------------------------
# (b) tpu-system: tests/test_tpu_parity.py's system-planes cases
# ---------------------------------------------------------------------------

def _system_both(nodes, job):
    """(JAX, port) outcomes of one tpu-system eval over carried nodes."""
    run = tts.JaxRun()
    for n in nodes:
        run.put("node", n)
    run.put("job", job)
    ev = Evaluation(id="eval-1", namespace=job.namespace, priority=job.priority,
                    type=job.type, triggered_by="job-register", job_id=job.id,
                    status="pending")
    run.put("evals", [ev])
    records = list(run.records)
    outs = []
    for pkg, h, e in ((jsched, run.h, ev), (tsched, tts._port_harness(records), tts._carried(ev))):
        before = tts._counts(pkg)
        sched = h.process("tpu-system", e)
        placed = {a.node_id for a in h.state.allocs_by_job(job.namespace, job.id)}
        outs.append(dict(placed=placed, failed=tts._metrics(sched),
                         routing=tts._routing(before, tts._counts(pkg))))
    return outs


def test_system_planes_parity():
    nodes = parity.build_cluster(60)
    for i, n in enumerate(nodes):
        n.attributes["rack_class"] = "a" if i % 3 else "b"
        compute_class(n)
    job = jmock.system_job()
    job.constraints = [
        Constraint(l_target="${attr.kernel.name}", r_target="linux", operand="="),
        Constraint(l_target="${attr.rack_class}", r_target="a", operand="="),
    ]
    job.task_groups[0].tasks[0].resources.networks = []
    want, got = _system_both(nodes, job)
    assert got == want
    assert len(got["placed"]) == 40
    assert got["routing"] == {"mode:system-planes": 1}


def test_system_planes_fit_fallback():
    nodes = parity.build_cluster(40)
    nodes[0].node_resources.cpu.cpu_shares = 10  # too small for the task
    job = jmock.system_job()
    job.task_groups[0].tasks[0].resources.networks = []
    job.task_groups[0].tasks[0].resources.cpu = 100
    want, got = _system_both(nodes, job)
    assert got == want
    assert len(got["placed"]) == 39 and nodes[0].id not in got["placed"]
    assert got["failed"], "the full node's walk reports its metrics"


# ---------------------------------------------------------------------------
# (c) the applier: TestDeviceVerifyParity's seeded plans
# ---------------------------------------------------------------------------

_JOB = jmock.job()


def _alloc(node_id, rng_cpu, rng_mem, ports=None):
    from nomad_tpu.structs.model import (
        AllocatedCpuResources, AllocatedMemoryResources, AllocatedResources,
        AllocatedSharedResources, AllocatedTaskResources, Allocation, generate_uuid,
    )

    tr = AllocatedTaskResources(cpu=AllocatedCpuResources(cpu_shares=rng_cpu),
                                memory=AllocatedMemoryResources(memory_mb=rng_mem))
    if ports is not None:
        tr.networks = [NetworkResource(device="eth0", ip="192.168.0.100", mbits=5,
                                       reserved_ports=[Port(label="x", value=ports)])]
    return Allocation(id=generate_uuid(), job_id=_JOB.id, job=_JOB, node_id=node_id,
                      task_group="web",
                      allocated_resources=AllocatedResources(
                          tasks={"web": tr}, shared=AllocatedSharedResources(disk_mb=10)),
                      desired_status="run", client_status="pending")


class _Stores:
    """The same writes on a JAX store and on the port's."""

    def __init__(self):
        self.j, self.t = JStateStore(), TStateStore()

    def nodes(self, index, nodes):
        self.j.upsert_nodes(index, nodes)
        self.t.upsert_nodes(index, [tmodel.Node.from_dict(n.to_dict()) for n in nodes])

    def allocs(self, index, allocs):
        self.j.upsert_allocs(index, allocs)
        self.t.upsert_allocs(index, [tmodel.Allocation.from_dict(a.to_dict()) for a in allocs])

    def status(self, index, node_id, status):
        self.j.update_node_status(index, node_id, status)
        self.t.update_node_status(index, node_id, status)


def _verify_cluster(rng, n_nodes=24):
    """TestDeviceVerifyParity._cluster in both stores: plain and exotic
    preloaded allocs, one node down, one ineligible."""
    stores = _Stores()
    nodes = []
    for i in range(n_nodes):
        n = jmock.node()
        n.node_resources.cpu.cpu_shares = rng.choice([1000, 2000, 4000])
        n.node_resources.memory.memory_mb = rng.choice([2048, 4096])
        nodes.append(n)
    nodes[1].scheduling_eligibility = NODE_SCHED_INELIGIBLE
    stores.nodes(1, nodes)
    preloaded = []
    for n in nodes:
        for _ in range(rng.randint(0, 3)):
            cpu, mem = rng.choice([100, 400, 900]), rng.choice([64, 256])
            ports = rng.randint(8000, 8005) if rng.random() < 0.2 else None
            preloaded.append(_alloc(n.id, cpu, mem, ports))
    stores.allocs(2, preloaded)
    stores.status(3, nodes[0].id, "down")
    return stores, nodes, preloaded


def _seeded_plan(rng, nodes, preloaded):
    plan = Plan(priority=50)
    for n in rng.sample(nodes, rng.randint(1, len(nodes))):
        allocs = []
        for _ in range(rng.randint(1, 4)):
            cpu, mem = rng.choice([50, 300, 1200]), rng.choice([16, 128, 1024])
            allocs.append(_alloc(n.id, cpu, mem, 9000 if rng.random() < 0.1 else None))
        plan.node_allocation[n.id] = allocs
        if rng.random() < 0.3:
            stops = [a for a in preloaded if a.node_id == n.id and rng.random() < 0.5]
            if stops:
                plan.node_update[n.id] = stops
        if rng.random() < 0.1:
            preempt = [a for a in preloaded if a.node_id == n.id][:1]
            if preempt:
                plan.node_preemptions[n.id] = preempt
    if rng.random() < 0.1:
        plan.all_at_once = True
    return plan


def _committed_sets(result):
    return (
        {k: [a.id for a in v] for k, v in result.node_allocation.items()},
        {k: [a.id for a in v] for k, v in result.node_update.items()},
        {k: [a.id for a in v] for k, v in result.node_preemptions.items()},
        bool(result.refresh_index),
    )


class _FakePending:
    def __init__(self, plan):
        self.plan = plan


def _port_planner(store):
    planner = tpa.Planner(store)
    mirror = tmirror.ColumnarMirror(store, device="cpu")
    planner.mirror_fn = lambda: mirror
    planner.device_verify_min = 1
    return planner, mirror


def _device_result(planner, snap, plan):
    """The port's dense device verify of ``plan`` (None: degraded)."""
    dev_ctx = planner._device_ctx(snap, [_FakePending(plan)])
    if dev_ctx is None:
        return None
    return planner._evaluate_plan_device(dev_ctx, snap, plan, planner.overlay.deltas(),
                                         tpa._OverlayEpoch(), lambda: snap)


def _port_plan(plan):
    return tmodel.Plan.from_dict(plan.to_dict())


def test_applier_commits_as_the_jax_host_oracle():
    rng = random.Random(20260804)
    stores, nodes, preloaded = _verify_cluster(rng)
    planner, mirror = _port_planner(stores.t)
    jsnap, tsnap = stores.j.snapshot(), stores.t.snapshot()
    device_checked = 0
    try:
        for i in range(120):
            plan = _seeded_plan(rng, nodes, preloaded)
            want = jpa.evaluate_plan(jsnap, plan)
            tplan = _port_plan(plan)
            assert _committed_sets(tpa.evaluate_plan(tsnap, tplan)) == _committed_sets(want)
            got = _device_result(planner, tsnap, tplan)
            if i == 60:
                # node-axis churn: the planes bump their epoch and the next
                # sync re-derives the view, a refresh and not a rebuild
                stores.nodes(stores.j.latest_index() + 1, [jmock.node()])
                jsnap, tsnap = stores.j.snapshot(), stores.t.snapshot()
            if got is None:
                continue
            device_checked += 1
            assert _committed_sets(got) == _committed_sets(want), f"seeded plan {i}"
            assert got.refresh_index == want.refresh_index
    finally:
        mirror.close()
    assert device_checked >= 100
    assert mirror.counters["view_refreshes"] >= 1 and mirror.counters["rebuilds"] == 0


def test_applier_int32_clip_row_takes_the_exact_check():
    stores = _Stores()
    n = jmock.node()
    n.node_resources.cpu.cpu_shares = 2**31 - 1
    n.node_resources.memory.memory_mb = 4096
    stores.nodes(1, [n])
    stores.allocs(2, [_alloc(n.id, 2**30 + 7, 1)])
    planner, mirror = _port_planner(stores.t)
    plan = Plan(priority=50)
    plan.node_allocation[n.id] = [_alloc(n.id, 100, 1)]
    try:
        got = _device_result(planner, stores.t.snapshot(), _port_plan(plan))
    finally:
        mirror.close()
    assert got is not None
    assert _committed_sets(got) == _committed_sets(jpa.evaluate_plan(stores.j.snapshot(), plan))


def test_applier_closed_or_stale_mirror_degrades_to_the_host():
    rng = random.Random(13)
    stores, nodes, preloaded = _verify_cluster(rng, n_nodes=4)
    planner, mirror = _port_planner(stores.t)
    plan = _port_plan(_seeded_plan(rng, nodes, preloaded))
    stale = stores.t.snapshot()
    stores.nodes(stores.j.latest_index() + 1, [jmock.node()])
    counters = tmetrics.snapshot()["counters"]
    before = counters.get("plan.verify_device_degrade.stale", 0)
    assert planner._device_ctx(stale, [_FakePending(plan)]) is None
    after = tmetrics.snapshot()["counters"]["plan.verify_device_degrade.stale"]
    assert after == before + 1
    mirror.close()
    assert planner._device_ctx(stores.t.snapshot(), [_FakePending(plan)]) is None


def test_applier_under_device_verify_min_takes_the_host():
    rng = random.Random(5)
    stores, nodes, preloaded = _verify_cluster(rng, n_nodes=4)
    planner, mirror = _port_planner(stores.t)
    planner.device_verify_min = 10_000
    try:
        plan = _port_plan(_seeded_plan(rng, nodes, preloaded))
        assert planner._device_ctx(stores.t.snapshot(), [_FakePending(plan)]) is None
    finally:
        mirror.close()


def test_applier_device_error_fails_the_plan_not_the_loop(monkeypatch):
    """A device error in the verify or in the mirror's planes (a CUDA error
    on the card, raised here by a stand-in) is no degrade: the plan gets the
    error back, and the running apply loop answers the next plan."""
    stores = _Stores()
    nodes = [jmock.node() for _ in range(3)]
    stores.nodes(1, nodes)
    planner, mirror = _port_planner(stores.t)

    def plan():
        p = Plan(priority=50)
        for n in nodes:
            p.node_allocation[n.id] = [_alloc(n.id, 100, 64)]
        return _port_plan(p)

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with monkeypatch.context() as m:
        m.setattr(tpa.kernel, "verify_rows", broken)
        with pytest.raises(RuntimeError, match="CUDA"):
            _device_result(planner, stores.t.snapshot(), plan())
    planner.start()
    fresh = tmirror.ColumnarMirror(stores.t, device="cpu")
    try:
        # the verify's launch fails
        with monkeypatch.context() as m:
            m.setattr(tpa.kernel, "verify_rows", broken)
            result, err = planner.queue.enqueue(plan()).wait(timeout=10.0)
        assert result is None and "CUDA" in str(err)
        # the mirror's device planes fail to upload (a fresh mirror builds them)
        planner.mirror_fn = lambda: fresh
        with monkeypatch.context() as m:
            m.setattr(tmirror, "DeviceState", broken)
            result, err = planner.queue.enqueue(plan()).wait(timeout=10.0)
        assert result is None and "CUDA" in str(err)
        result, err = planner.queue.enqueue(plan()).wait(timeout=10.0)
    finally:
        planner.stop()
        mirror.close()
        fresh.close()
    assert err is None and len(result.node_allocation) == len(nodes)


# ---------------------------------------------------------------------------
# (d) the tpu.kernel fault point
# ---------------------------------------------------------------------------

def _fault(faults, **kw):
    plane = faults.install(faults.FaultPlane(seed=7))
    return plane.rule("point", "error", method="tpu.kernel",
                      error=FloatingPointError("injected NaN in placement kernel"), **kw)


def test_kernel_fault_degrades_the_eval_to_exact_np():
    """One solo tpu-batch eval of 12 placements through each server, with
    the fault point tripping once: the eval completes on exact-np in both
    packages, with the same placements and the same counters."""
    nodes, jobs = _cluster_docs(16), _job_docs([12])
    extra = {"default_scheduler": "tpu-batch"}
    names = ("tpu.kernel_fault", "scheduler.kernel_fault_degrade")
    outs = []
    with _servers() as started:
        for port, faults, metrics, pkg in ((False, jfaults, jmetrics, jsched),
                                           (True, tfaults, tmetrics, tsched)):
            before = [metrics.snapshot()["counters"].get(n, 0) for n in names]
            rule = _fault(faults, count=1)
            try:
                with jk.deterministic_scope():
                    placed = _serve(started, port, extra, nodes, jobs)
            finally:
                faults.uninstall()
            after = [metrics.snapshot()["counters"].get(n, 0) for n in names]
            outs.append((placed, rule.trips, [a - b for a, b in zip(after, before)],
                         pkg.LAST_KERNEL_STATS.get("mode")))
    assert outs[1] == outs[0]
    placed, trips, counted, mode = outs[1]
    assert len(placed) == 12 and trips == 1 and counted == [1, 1]
    assert mode == "exact-np-degraded"


def test_kernel_fault_degrades_the_verify_to_the_host():
    stores = _Stores()
    nodes = [jmock.node() for _ in range(3)]
    stores.nodes(1, nodes)
    planner, mirror = _port_planner(stores.t)
    plan = Plan(priority=50)
    for n in nodes:
        plan.node_allocation[n.id] = [_alloc(n.id, 100, 64)]
    name = "plan.verify_device_degrade.kernel_fault"
    before = tmetrics.snapshot()["counters"].get(name, 0)
    _fault(tfaults)
    try:
        got = _device_result(planner, stores.t.snapshot(), _port_plan(plan))
    finally:
        tfaults.uninstall()
        mirror.close()
    assert got is None
    assert tmetrics.snapshot()["counters"][name] == before + 1


# ---------------------------------------------------------------------------
# the mirror's dirty rows under concurrent commits
# ---------------------------------------------------------------------------

def test_mirror_refresh_loses_no_dirty_row_under_concurrent_commits():
    """The store marks dirty rows into a DeviceState from the commit
    thread while readers refresh it: the refresh reads and clears the rows
    under the plane lock, so once the writes stop, the device plane equals
    the committed plane (a row lost between the read and the clear would
    leave its usage behind)."""
    import sys

    import numpy as np

    from nomad_tpu_torch import mock as tmock
    from nomad_tpu_torch.structs.model import generate_uuid
    from nomad_tpu_torch.tpu.problems import bucket

    store = TStateStore()
    nodes = [tmock.node() for _ in range(64)]
    store.upsert_nodes(1, nodes)
    mirror = tmirror.ColumnarMirror(store, device="cpu")
    n_pad = bucket(len(nodes))
    assert mirror.device_state(n_pad, store.snapshot()._gen) is not None
    stop = threading.Event()
    errors: list = []

    def write():
        rng = random.Random(3)
        try:
            for i in range(400):
                a = tmock.alloc()
                a.id, a.node_id = generate_uuid(), rng.choice(nodes).id
                store.upsert_allocs(store.latest_index() + 1, [a])
        except Exception as e:  # reported below
            errors.append(e)
        finally:
            stop.set()

    def read():
        try:
            while not stop.is_set():
                mirror.device_state(n_pad, store.snapshot()._gen)
        except Exception as e:  # reported below
            errors.append(e)

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=write, daemon=True)] + [
        threading.Thread(target=read, daemon=True) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(before)
        stop.set()
    assert not any(t.is_alive() for t in threads) and not errors, errors
    _, _, used = mirror.device_state(n_pad, store.snapshot()._gen)
    want = np.clip(store.planes.used, 0, 2**30)
    mirror.close()
    assert mirror.counters["refreshes"] >= 1
    np.testing.assert_array_equal(used[: len(nodes)].numpy(), want)
