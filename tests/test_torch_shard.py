"""The port's mesh (``nomad_tpu_torch.tpu.shard``) against the JAX package's.

The JAX side runs on the 8-device virtual CPU mesh (tests/conftest.py),
its planners under ``NamedSharding(P("nodes"))``; the port's mesh is S
shards on the CPU (``configure(S, device="cpu")``), its planners the
sharded plain versions. The cases are tests/test_multichip.py's shapes and
seeds, so JAX's compiled programs are shared within the process. With no
tolerance:

- ``node_bucket`` and every spec tree split each leaf as the JAX package
  splits it: the port's slabs hold what the JAX shards hold;
- ``put``'s slabs concatenate back to its input and their bytes land in
  the transfer ledger;
- the sharded plain exact scan, run planner and windowed planner equal the
  JAX package's sharded runs and the port's unsharded plain versions,
  placement for placement and state for state;
- the ``tpu-batch`` scheduler under a mesh equals the JAX scheduler under
  its mesh and the port's unsharded run, with ``shards`` 8 in its stats,
  and under the ``tpu.kernel`` fault point degrades to the same exact-np
  placements;
- the wavefront and paged routes run under the mesh and place as
  unsharded (tests/test_torch_mesh_paths.py holds them against the JAX
  package); only a mesh over several cards raises ``NotImplementedError``,
  naming ROADMAP A12c; the server path's seams (the fused drain, the
  wavefront drain among them, the mirror's device state, the drain
  warm-up) run under the mesh (tests/test_torch_mesh_server.py holds them
  against the JAX package).

tests/test_torch_gpu.py holds the sharded kernels against these plain
versions on the card.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from torch_for_tests import gil_handoff, torch  # noqa: F401

import test_tpu_parity as parity
from nomad_tpu.tpu import batch_sched as jsched
from nomad_tpu.tpu import kernel as jk
from nomad_tpu.tpu import multichip as jmc
from nomad_tpu.tpu import shard as jshard
from nomad_tpu.tpu import warmup as jwarmup
from nomad_tpu_torch.debug import devprof
from nomad_tpu_torch.tpu import batch_sched as tsched
from nomad_tpu_torch.tpu import kernel as tk
from nomad_tpu_torch.tpu import paging as tpaging
from nomad_tpu_torch.tpu import planner as tplanner
from nomad_tpu_torch.tpu import problems
from nomad_tpu_torch.tpu import shard as tshard
from nomad_tpu_torch.tpu import wavefront as twf
from nomad_tpu_torch.tpu import warmup as twarmup

N_DEV = 8
N_UNEVEN = 2059  # buckets to 3072 = 8 x 384: shard 5 part real, 6-7 padding


@pytest.fixture(autouse=True)
def _mesh_off():
    """Every test starts and ends with both packages' meshes off."""
    for m in (jshard, tshard):
        m.configure(enabled=False)
    yield
    for m in (jshard, tshard):
        m.configure(enabled=False)
    assert tshard.active_mesh() is None and jshard.active_mesh() is None


def jmesh(s):
    devices = jax.devices()
    if len(devices) < s:
        pytest.skip(f"need {s} virtual devices, have {len(devices)}")
    return JMesh(np.array(devices[:s]), ("nodes",))


def tmesh(s):
    return tshard.Mesh(s, "cpu")


def _cpu(tree):
    return tk.from_numpy(tree, "cpu")


# ---------------------------------------------------------------------------
# buckets, spec trees, put
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_node_bucket_matches_the_jax_package(s):
    jm = None if s == 1 else jmesh(s)
    tm = None if s == 1 else tmesh(s)
    for n in (1, 7, 100, 1000, 1024, 1500, N_UNEVEN, 4096, 10_000, 50_000):
        assert tshard.node_bucket(n, tm) == jshard.node_bucket(n, jm)
        assert twarmup.bucket_shape(n, 700, tm) == jwarmup.bucket_shape(n, 700, jm)
    assert tshard.mesh_size(tm) == jshard.mesh_size(jm)
    if s > 1:
        assert tshard.shard_tags(tm) == jshard.shard_tags(jm)


def _jax_leaf_split(spec) -> str:
    """The port marker a JAX PartitionSpec leaf maps to."""
    return {(): tshard.REP, (jshard.AXIS,): tshard.LANE, (jshard.AXIS, None): tshard.ROWS,
            (None, jshard.AXIS): tshard.COLS}[tuple(spec)]


def _flat(tree):
    if hasattr(tree, "_fields") or isinstance(tree, tuple):
        return [x for el in tree for x in _flat(el)]
    return [tree]


SPECS = ("batch_specs", "wavefront_specs", "run_specs", "window_specs", "paged_specs")


@pytest.mark.parametrize("name", SPECS)
def test_spec_trees_split_as_the_jax_package(name):
    jtree, ttree = getattr(jshard, name)(), getattr(tshard, name)()
    jleaves = jax.tree_util.tree_leaves(jtree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert [_jax_leaf_split(p) for p in jleaves] == _flat(ttree)


def _exact_tree(n=1024, a=96, seed=0):
    args, init = problems.exact_problem(problems.build_cluster(n, a, seed=seed))
    return tk.BatchArgs(**args), tk.BatchState(**init)


@pytest.mark.parametrize("s", [2, 4, 8])
def test_put_slabs_hold_what_the_jax_shards_hold(s):
    """Each split leaf's slab s is the data JAX places on device s; each
    slab concatenates back to the input; the bytes enter the ledger."""
    args, init = _exact_tree()
    aspec, sspec = tshard.batch_specs()
    before = devprof.totals()["h2d_bytes"]
    placed = tshard.put(args, aspec, tmesh(s))
    moved = devprof.totals()["h2d_bytes"] - before
    assert moved == sum(np.asarray(x).nbytes for x in args)
    jplaced = jshard.put(jk.BatchArgs(*[jnp.asarray(x) for x in args]), jshard.batch_specs()[0],
                         jmesh(s))
    for name, src, got, jgot in zip(args._fields, args, placed, jplaced):
        if not isinstance(got, tshard.Sharded):
            assert torch.equal(got, torch.from_numpy(np.asarray(src))), name
            continue
        assert len(got.slabs) == s and all(t.is_contiguous() for t in got.slabs)
        np.testing.assert_array_equal(got.full().numpy(), np.asarray(src), err_msg=name)
        shards = sorted(jgot.addressable_shards, key=lambda sh: sh.device.id)
        for slab, sh in zip(got.slabs, shards):
            np.testing.assert_array_equal(slab.numpy(), np.asarray(sh.data), err_msg=name)
    sinit = tshard.put(init, sspec, tmesh(s))
    back = tshard.split_like(tshard.gather(sinit), sinit)
    assert tshard.shards_of(back) == s
    for x, y in zip(back, sinit):
        if isinstance(y, tshard.Sharded):
            assert all(torch.equal(a, b) for a, b in zip(x.slabs, y.slabs))


# ---------------------------------------------------------------------------
# the sharded plain versions against JAX's sharded runs and the unsharded
# ---------------------------------------------------------------------------

def _shard_counts(case: str) -> tuple:
    """S = 8 for every case, S = 4 too for the 1,024-node ones."""
    return (N_DEV, 4) if case in ("1k", "multi_group") else (N_DEV,)


def _jax_exact(args, init, n_real, mesh=None):
    jargs = jk.BatchArgs(*[jnp.asarray(a) for a in args])
    jinit = jk.BatchState(*[jnp.asarray(x) for x in init])
    if mesh is not None:
        aspec, sspec = jshard.batch_specs()
        jargs, jinit = jshard.put(jargs, aspec, mesh), jshard.put(jinit, sspec, mesh)
    state, placements = jk.plan_batch(jargs, jinit, n_real)
    return [np.asarray(x) for x in state], np.asarray(placements)


def _exact_case(n, a, seed, uneven):
    c = problems.build_cluster(n, a, seed=seed)
    if uneven:
        c = problems.pad_cluster(c, tshard.node_bucket(n, tmesh(N_DEV)))
    args, init = problems.exact_problem(c)
    return tk.BatchArgs(**args), tk.BatchState(**init), n


def _multi_group_case():
    """tests/test_multichip.py's two groups sharing the usage plane."""
    n_nodes, n_allocs = 512, 64
    c = problems.build_cluster(n_nodes, n_allocs, seed=9)
    args, init = problems.exact_problem(c, spread=False)
    args = dict(args, **dict(
        feasible=np.concatenate([args["feasible"]] * 2),
        affinity=np.concatenate([args["affinity"]] * 2),
        affinity_present=np.concatenate([args["affinity_present"]] * 2),
        group_count=np.array([n_allocs // 2] * 2, dtype=np.int32),
        group_eval=np.zeros(2, dtype=np.int32),
        node_value=np.concatenate([args["node_value"]] * 2),
        spread_desired=np.full((2, c["n_values"]), -1.0, dtype=np.float32),
        spread_implicit=np.full(2, -1.0, dtype=np.float32),
        spread_weight_frac=np.zeros(2, dtype=np.float32),
        spread_even=np.zeros(2, dtype=bool),
        spread_active=np.zeros(2, dtype=bool),
        demands=np.where((np.arange(n_allocs) % 2 == 0)[:, None], c["demand"],
                         c["demand"] * 2).astype(np.int32),
        groups=(np.arange(n_allocs) % 2).astype(np.int32),
    ))
    init = dict(init, collisions=np.zeros((2, n_nodes), dtype=np.int32),
                spread_counts=np.zeros((2, c["n_values"]), dtype=np.int32),
                spread_present=np.zeros((2, c["n_values"]), dtype=bool))
    return tk.BatchArgs(**args), tk.BatchState(**init), n_nodes


EXACT_CASES = {
    "1k": lambda: _exact_case(1024, 96, 0, False),
    "multi_group": _multi_group_case,
    "uneven_13": lambda: _exact_case(N_UNEVEN, 96, 13, True),
    "uneven_31": lambda: _exact_case(N_UNEVEN, 96, 31, True),
}


@pytest.mark.parametrize("case", sorted(EXACT_CASES))
def test_sharded_exact_scan_equals_jax_and_unsharded(case):
    args, init, n_real = EXACT_CASES[case]()
    want_state, want = _jax_exact(args, init, n_real, jmesh(N_DEV))
    aspec, sspec = tshard.batch_specs()
    for s in _shard_counts(case):
        sargs, sinit = tshard.put(args, aspec, tmesh(s)), tshard.put(init, sspec, tmesh(s))
        assert tshard.is_sharded((sargs, sinit)) and tshard.shards_of(sargs) == s
        state, placements = tk.plan_batch(sargs, sinit, n_real)
        np.testing.assert_array_equal(placements.numpy(), want)
        for name, got, ref in zip(tk.BatchState._fields, tshard.gather(state), want_state):
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"S={s} state.{name}")
        assert isinstance(state.used, tshard.Sharded) and len(state.used.slabs) == s
    ustate, uplacements = tk.plan_batch(_cpu(args), _cpu(init), n_real)
    np.testing.assert_array_equal(uplacements.numpy(), want)
    for got, ref in zip(ustate, want_state):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert (want >= 0).sum() == len(want)


def _runs_case(n, a, seed, uneven, n_values=4):
    c = problems.build_cluster(n, a, n_values=n_values, seed=seed)
    if uneven:
        c = problems.pad_cluster(c, tshard.node_bucket(n, tmesh(N_DEV)))
    rargs, init = problems.runs_problem(c)
    return tk.RunArgs(**rargs), tuple(init), a, c


RUNS_CASES = {
    "1k": lambda: _runs_case(1024, 512, 3, False),
    "uneven_11": lambda: _runs_case(N_UNEVEN, 384, 11, True),
    "uneven_29": lambda: _runs_case(N_UNEVEN, 384, 29, True),
    "uneven_47": lambda: _runs_case(N_UNEVEN, 384, 47, True),
    # more spread values than one warp's lanes: the kernel ranks ties by
    # class without a cap on the class count
    "values_40": lambda: _runs_case(1024, 512, 3, False, n_values=40),
}


@pytest.mark.parametrize("case", sorted(RUNS_CASES))
def test_sharded_run_planner_equals_jax_and_unsharded(case):
    args, init, a_pad, c = RUNS_CASES[case]()
    aspec, ispec = jshard.run_specs()
    want = np.asarray(jk.plan_batch_runs(
        jshard.put(jk.RunArgs(*[jnp.asarray(x) for x in args]), aspec, jmesh(N_DEV)),
        jshard.put(tuple(jnp.asarray(x) for x in init), ispec, jmesh(N_DEV)), a_pad, False))
    taspec, tispec = tshard.run_specs()
    rounds = set()
    for s in _shard_counts(case):
        got, r = tk.plan_batch_runs(tshard.put(args, taspec, tmesh(s)),
                                    tshard.put(init, tispec, tmesh(s)), a_pad)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"S={s}")
        rounds.add(r)
    plain, r = tk.plan_batch_runs(_cpu(args), _cpu(init), a_pad)
    np.testing.assert_array_equal(plain.numpy(), want)
    assert rounds == {r}
    assert (want >= 0).sum() == a_pad
    if case.startswith("uneven"):
        # the placements cross every real shard (test_multichip.py's property)
        rows = c["capacity"].shape[0] // N_DEV
        assert len({int(n) // rows for n in want[want >= 0]}) >= 5


def test_sharded_windowed_planner_equals_jax_and_unsharded():
    c = problems.build_cluster(1024, 512, seed=5)
    wargs, used0, coll0 = problems.window_problem(c, limit=10)
    args = tk.WindowArgs(**wargs)
    aspec, (uspec, cspec) = jshard.window_specs()
    mesh = jmesh(N_DEV)
    want = np.asarray(jk.plan_batch_windowed(
        jshard.put(jk.WindowArgs(*[jnp.asarray(x) for x in args]), aspec, mesh),
        jshard.put(jnp.asarray(used0), uspec, mesh), jshard.put(jnp.asarray(coll0), cspec, mesh),
        1024, 512))
    taspec, (tuspec, tcspec) = tshard.window_specs()
    rounds = set()
    for s in (N_DEV, 4):
        m = tmesh(s)
        got, r = tk.plan_batch_windowed(tshard.put(args, taspec, m), tshard.put(used0, tuspec, m),
                                        tshard.put(coll0, tcspec, m), 1024, 512)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"S={s}")
        rounds.add(r)
    plain, r = tk.plan_batch_windowed(_cpu(args), *_cpu((used0, coll0)), 1024, 512)
    np.testing.assert_array_equal(plain.numpy(), want)
    assert rounds == {r} and (want >= 0).sum() > 0


def test_sharded_launches_enter_the_ledger_as_sharded():
    args, init, n_real = EXACT_CASES["1k"]()
    aspec, sspec = tshard.batch_specs()
    m = tmesh(4)
    before = devprof.totals()
    tk.plan_batch(tshard.put(args, aspec, m), tshard.put(init, sspec, m), n_real, n_valid=96)
    after = devprof.totals()
    assert after["collective_rounds"] - before["collective_rounds"] == 96
    assert devprof.snapshot()["last_dispatch"]["exact"]["sharded"] is True


# ---------------------------------------------------------------------------
# the tpu-batch scheduler under a mesh
# ---------------------------------------------------------------------------

def _dcs_spread(n):
    from nomad_tpu.structs.model import Spread, SpreadTarget

    dcs = [f"dc{i}" for i in range(1, n + 1)]

    def mutate(job):
        job.datacenters = dcs
        job.spreads = [Spread(attribute="${node.datacenter}", weight=100,
                              spread_target=[SpreadTarget(value=d, percent=100 // n)
                                             for d in dcs])]
    return mutate


def _two_groups(job):
    from nomad_tpu.structs.model import TaskGroup

    other = TaskGroup.from_dict(job.task_groups[0].to_dict())
    other.name = "api"
    other.count = 20
    other.tasks[0].resources.cpu = 300
    job.task_groups.append(other)


#: name -> (nodes, job, mode); clusters past the lowered MIN_NODES gate
SCHED_CASES = {
    "runs": (lambda: (parity.build_cluster(300, dcs=("dc1", "dc2", "dc3", "dc4")),
                      parity.make_job(100, _dcs_spread(4))), "runs"),
    "windowed": (lambda: (parity.build_cluster(300), parity.make_job(200)), "windowed"),
    "exact": (lambda: (parity.build_cluster(300), parity.make_job(30, _two_groups)),
              "exact-scan"),
}


@pytest.fixture
def _sched_gates(monkeypatch):
    for m in (jsched, tsched):
        monkeypatch.setattr(m, "SMALL_EVAL_ORACLE_MAX", 0)
        monkeypatch.setattr(m, "EXACT_ONLY", False)
    # shard small clusters too, as tests/test_multichip.py does
    for m in (jshard, tshard):
        monkeypatch.setattr(m, "MIN_NODES", 256)


def _both(nodes, job):
    """(JAX placements under its mesh, port placements under its mesh, port
    placements unsharded, the port's stats under its mesh)."""
    from test_torch_sched import JaxRun, _carried, _eval, _outcome, _port_harness

    run = JaxRun()
    for n in nodes:
        run.put("node", n)
    run.put("job", job)
    ev = _eval(job)
    run.put("evals", [ev])
    records = list(run.records)
    jshard.configure(N_DEV)
    try:
        with jk.deterministic_scope():
            sched = run.process("tpu-batch", ev)
        jstats = dict(jsched.LAST_KERNEL_STATS)
    finally:
        jshard.configure(enabled=False)
    want = _outcome(run.h, sched, [job])["placements"]
    outs = []
    for sharded in (True, False):
        tshard.configure(N_DEV if sharded else None, enabled=sharded, device="cpu")
        try:
            th = _port_harness(records)
            tsched_ = th.process("tpu-batch", _carried(ev))
            outs.append((_outcome(th, tsched_, [job])["placements"], dict(tsched.LAST_KERNEL_STATS)))
        finally:
            tshard.configure(enabled=False)
    return want, jstats, outs


@pytest.mark.parametrize("case", sorted(SCHED_CASES))
def test_scheduler_under_a_mesh_places_as_the_jax_package(case, _sched_gates):
    build, mode = SCHED_CASES[case]
    nodes, job = build()
    want, jstats, ((got, stats), (plain, plain_stats)) = _both(nodes, job)
    assert want and got == want and plain == want
    assert jstats["mode"] == stats["mode"] == mode
    assert jstats["shards"] == stats["shards"] == N_DEV
    assert plain_stats["shards"] == 1
    assert stats["n_padded_nodes"] == jstats["n_padded_nodes"]


def test_faulted_sharded_eval_degrades_to_the_same_host_placements(_sched_gates):
    """tests/test_multichip.py's fallback leg, in the port: with the device
    tier faulted, the sharded eval degrades to exact-np and places as the
    unsharded degraded one."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler import Harness
    from nomad_tpu_torch.structs import compute_class
    from nomad_tpu_torch.structs.model import Evaluation
    from nomad_tpu_torch.testing import faults

    def run(sharded: bool) -> dict:
        plane = faults.install(faults.FaultPlane(seed=3))
        plane.rule("point", "error", method="tpu.kernel", count=100)
        try:
            tshard.configure(N_DEV if sharded else None, enabled=sharded, device="cpu")
            h = Harness(seed=17, device="cpu")
            rng = random.Random(5)
            for i in range(520):
                n = mock.node()
                n.id = f"node-{i:04d}"
                n.node_resources.cpu.cpu_shares = rng.choice([8000, 16000])
                n.node_resources.memory.memory_mb = rng.choice([16384, 32768])
                n.node_resources.networks = []
                n.reserved_resources.networks.reserved_host_ports = ""
                compute_class(n)
                h.state.upsert_node(h.next_index(), n)
            job = mock.job()
            job.id = "job-fallback"
            job.task_groups[0].count = 64
            job.task_groups[0].tasks[0].resources.networks = []
            h.state.upsert_job(h.next_index(), job)
            ev = Evaluation(id="eval-fallback", namespace=job.namespace, priority=job.priority,
                            type=job.type, triggered_by="job-register", job_id=job.id,
                            status="pending")
            h.state.upsert_evals(h.next_index(), [ev])
            h.process("tpu-batch", ev)
            assert tsched.LAST_KERNEL_STATS["mode"] == "exact-np-degraded"
            return {a.name: a.node_id for allocs in h.plans[0].node_allocation.values()
                    for a in allocs}
        finally:
            faults.uninstall()
            tshard.configure(enabled=False)

    sharded = run(True)
    assert sharded and sharded == run(False)


# ---------------------------------------------------------------------------
# the routes that raised before their sharded forms were ported, and what
# still raises
# ---------------------------------------------------------------------------

def _planes(n=300, a=200, **kw):
    c = problems.build_cluster(n, a, seed=1)
    args, init = problems.exact_problem(c, **kw)
    return problems.eval_planes(args, init)


def test_unported_routes_raise_under_a_mesh(monkeypatch):
    """The wavefront and paged routes, which raised under a mesh before
    their sharded forms were ported, run under it and place as unsharded."""
    monkeypatch.setattr(tshard, "MIN_NODES", 256)
    try:
        twf.configure(enabled=True)
        tpaging.configure(tile_nodes=64)
        monkeypatch.setattr(tpaging, "budget_mb", lambda: 0)
        paged = _planes(spread=False)
        paged["affinity_present"][:] = False
        paged["limits"][:] = 8
        for route, planes in (("wavefront", _planes(a=40)), ("paged", paged)):
            tpaging.configure(enabled=route == "paged")
            want, want_stats = tplanner.plan_eval(planes, device="cpu")
            tshard.configure(N_DEV, device="cpu")
            got, stats = tplanner.plan_eval(planes, device="cpu")
            tshard.configure(enabled=False)
            assert stats["mode"] == want_stats["mode"] == route
            assert (stats["shards"], want_stats["shards"]) == (N_DEV, 1)
            np.testing.assert_array_equal(got, want)
    finally:
        twf.reset()
        tpaging.reset()


def test_server_path_seams_raise_under_a_mesh(monkeypatch):
    """The server path's seams run under the mesh (its sharded forms are
    ported), the wavefront drive of the fused batch among them."""
    from nomad_tpu_torch.tpu import drain, mirror

    monkeypatch.setattr(tshard, "MIN_NODES", 256)
    mesh = tshard.configure(N_DEV, device="cpu")
    n = 300
    cap = np.full((n, 4), 1000, dtype=np.int32)
    usable = np.full((n, 2), 1000.0, dtype=np.float32)
    used = np.zeros((n, 4), dtype=np.int32)
    shared = drain.SharedCluster(cap, usable, used)
    assert drain.KernelBatchCollector(shared, 1, device="cpu").shared is shared
    ds = mirror.DeviceState(0, 512, cap, usable, used, device="cpu", mesh=mesh)
    assert ds.mesh is mesh and len(ds.used.slabs) == N_DEV
    devprof.reset()
    devprof.forget_launches()
    assert twarmup.prewarm_drain(n, 8, device="cpu", mesh=mesh) == 4
    assert all(e["sharded"] for e in devprof.snapshot()["compile_ledger"])
    twf.configure(enabled=True)
    try:
        # the wavefront collector runs sharded: a batch of one eval
        prep = problems.drain_problem(problems.build_cluster(n, 1, seed=3), 1, seed=3)[1][0]
        collector = drain.KernelBatchCollector(shared, 1, device="cpu")
        placements, base = collector.submit(drain.DrainPrep.from_dict(prep))
        stats = drain.LAST_DRAIN_STATS
        assert stats["planner"] == "wavefront" and stats["shards"] == N_DEV
        assert isinstance(base, tshard.Sharded) and (placements.numpy() >= 0).any()
    finally:
        twf.reset()
    # below the gate the unsharded seams run
    assert mirror.DeviceState(0, 256, cap[:200], usable[:200], used[:200], device="cpu").n_pad == 256


def test_a_mesh_over_several_cards_raises(monkeypatch, caplog):
    assert tshard.configure(8) is None  # no card here: warn, stay unsharded
    assert "staying unsharded" in caplog.text
    monkeypatch.setattr(tshard, "_visible_cards", lambda: 8)
    with pytest.raises(NotImplementedError, match="A12c"):
        tshard.configure(4)
    assert tshard.active_mesh() is None
    assert tshard.configure(1, device="cpu") is None
    mesh = tshard.configure(2, device="cpu")
    assert mesh.size == 2 and tshard.active_mesh(tshard.MIN_NODES) is mesh
    assert tshard.active_mesh(tshard.MIN_NODES - 1) is None
