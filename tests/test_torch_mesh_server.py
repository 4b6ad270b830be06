"""The port's server path under a mesh against the JAX package's, on the CPU.

The JAX side runs on the 8-device virtual CPU mesh (tests/conftest.py);
the port's mesh is S shards on the CPU (``shard.configure(S,
device="cpu")`` or ``shard.Mesh``), its kernels the sharded plain
versions. ``MIN_NODES`` is lowered in both packages, as
tests/test_devprof.py and tests/test_torch_shard.py lower it, so small
clusters shard. With no tolerance:

- the sharded plain dense verify (K8s), usage bases (K9s) and dirty-row
  scatter (K10s) at S = 8 and 4 equal the JAX programs run on inputs
  placed with the JAX mesh's shardings and the port's unsharded plain
  versions: a last shard part real and part padding, duplicate rows, rows
  on both sides of a shard boundary; the out-of-range lanes the port's
  rules define against the unsharded plain versions;
- the sharded exact scan over a fused multi-eval batch (E = 32, the
  drain-bench and drain-tenant mixes) equals the JAX scan under
  ``batch_specs`` and the unsharded plain version, final state included;
- ``DeviceState`` under a mesh holds in its slabs what the JAX shards
  hold, refreshes into new row slabs and leaves the old ones alone, and
  the mirror rebuilds a cached state whose mesh differs;
- a running ``Server`` under an 8-shard mesh places as the JAX ``Server``
  with ``shard_devices: 8`` and as the unsharded port, in one fused
  batch, with only sharded drain, scatter and verify launches in its
  ledger; the applier's verify under the mesh commits as the host oracle;
- a faulted sharded drain or verify degrades, counted; the wavefront
  drain under a mesh runs sharded (K11s's plain version) and places as
  the unsharded wavefront drain;
- the drain warm-up under a mesh launches the sharded kernels at the
  fused shape (unsharded below the gate) and warms as many programs as
  the JAX warm-up compiles; ``prewarm``'s mesh expansion warms both
  flavors of a bucket that straddles the gate.

Every server is stopped in ``finally`` and its threads must end
(tests/test_torch_server.py's fixture). tests/test_torch_gpu.py holds the
kernels against these plain versions on the card.
"""

import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch_for_tests import gil_handoff, torch  # noqa: F401

from nomad_tpu import metrics as jmetrics
from nomad_tpu.core.plan_apply import evaluate_plan as jevaluate_plan
from nomad_tpu.testing import faults as jfaults
from nomad_tpu.tpu import drain as jdrain
from nomad_tpu.tpu import kernel as jk
from nomad_tpu.tpu import mirror as jmirror
from nomad_tpu.tpu import shard as jshard
from nomad_tpu.tpu import warmup as jwarmup
from nomad_tpu_torch import metrics as tmetrics
from nomad_tpu_torch.core import plan_apply as tpa
from nomad_tpu_torch.debug import devprof
from nomad_tpu_torch.state import StateStore as TStateStore
from nomad_tpu_torch.testing import faults as tfaults
from nomad_tpu_torch.tpu import batch_sched as tsched
from nomad_tpu_torch.tpu import drain as tdrain
from nomad_tpu_torch.tpu import kernel as tk
from nomad_tpu_torch.tpu import mirror as tmirror
from nomad_tpu_torch.tpu import problems
from nomad_tpu_torch.tpu import shard as tshard
from nomad_tpu_torch.tpu import wavefront as twf
from nomad_tpu_torch.tpu import warmup as twarmup
from test_torch_server import (  # noqa: F401  (_threads_end: every started thread ends)
    _committed_sets,
    _config,
    _FakePending,
    _fault,
    _port_plan,
    _seeded_plan,
    _servers,
    _threads_end,
    _verify_cluster,
    _wait_evals,
)

N_DEV = 8
SHARDS = (N_DEV, 4)
#: the lowered gate of the mesh tests' small clusters
GATE = 16


@pytest.fixture(autouse=True)
def _mesh_off(monkeypatch):
    """Every test starts and ends with both meshes off and the gate
    lowered in both packages."""
    for m in (jshard, tshard):
        m.configure(enabled=False)
        monkeypatch.setattr(m, "MIN_NODES", GATE)
    yield
    for m in (jshard, tshard):
        m.configure(enabled=False)
    twf.reset()


def jmesh(s):
    devices = jax.devices()
    if len(devices) < s:
        pytest.skip(f"need {s} virtual devices, have {len(devices)}")
    return JMesh(np.array(devices[:s]), (jshard.AXIS,))


def tmesh(s):
    return tshard.Mesh(s, "cpu")


def _jput(mesh, x, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


JROWS, JREP = P(jshard.AXIS, None), P()


def _rows_put(s, *planes):
    return tshard.put(tuple(planes), (tshard.ROWS,) * len(planes), tmesh(s))


# ---------------------------------------------------------------------------
# K8s, K9s, K10s: the sharded plain versions against JAX and the unsharded
# ---------------------------------------------------------------------------

#: real nodes, seed: the last shard holds real rows and padding rows at S = 8
#: and 4 (1,000 of 1,024 and 300 of 512)
LANE_CASES = {"n1000": (1000, 1), "n300": (300, 2)}


def _node_planes(n_real, seed, s):
    """(rng, N, capacity, used) as ``DeviceState`` pads them: pad rows with
    no capacity and a poisoned usage."""
    rng = np.random.default_rng(seed)
    N = tshard.node_bucket(n_real, tmesh(s))
    capacity = np.zeros((N, 4), np.int32)
    capacity[:n_real] = rng.integers(1000, 9000, (n_real, 4))
    used = np.full((N, 4), 2**30, np.int32)
    used[:n_real] = capacity[:n_real] - rng.integers(0, 600, (n_real, 4))
    return rng, N, capacity, used


def _lane_rows(rng, N, n_real, s, R):
    """R lane rows: both sides of every shard boundary among the real rows,
    the rest random, and the first five repeated at the end."""
    per = N // s
    edges = [r for k in range(1, s) for r in (k * per - 1, k * per) if r < n_real]
    rows = np.concatenate([edges, rng.integers(0, n_real, R - len(edges) - 5)])
    return np.concatenate([rows, rows[:5]]).astype(np.int32)


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("case", sorted(LANE_CASES))
def test_sharded_verify_equals_jax_and_unsharded(case, s):
    n_real, seed = LANE_CASES[case]
    rng, N, capacity, used = _node_planes(n_real, seed, s)
    rows = _lane_rows(rng, N, n_real, s, 256)
    deltas = rng.integers(-300, 400, (len(rows), 4)).astype(np.int32)
    jm = jmesh(s)
    want = np.asarray(jk.verify_rows(_jput(jm, capacity, JROWS), _jput(jm, used, JROWS),
                                     _jput(jm, rows, JREP), _jput(jm, deltas, JREP)))
    cap_s, used_s = _rows_put(s, capacity, used)
    r, d = torch.from_numpy(rows), torch.from_numpy(deltas)
    got = tk.verify_rows(cap_s, used_s, r, d)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tk.verify_rows_ref(*map(torch.from_numpy, (capacity, used)), r,
                                                     d).numpy(), want)
    assert 0 < want.sum() < len(want)  # verdicts both ways
    # the planes are read, not written
    np.testing.assert_array_equal(used_s.full().numpy(), used)


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("case", sorted(LANE_CASES))
def test_sharded_usage_bases_equal_jax_and_unsharded(case, s):
    n_real, seed = LANE_CASES[case]
    rng, N, _, used0 = _node_planes(n_real, seed, s)
    E, C = 8, 4
    placements = _lane_rows(rng, N, n_real, s, 384)
    placements[::11] = -1
    placements[5::13] = rng.integers(n_real, N, len(placements[5::13]))  # padding rows
    demands = rng.integers(0, 500, (len(placements), C)).astype(np.int32)
    eval_of = rng.integers(0, E, len(placements)).astype(np.int32)
    jm = jmesh(s)
    want = np.asarray(jdrain._used_bases_fn()(
        _jput(jm, used0, JROWS), _jput(jm, placements, JREP), _jput(jm, demands, JREP),
        _jput(jm, eval_of, JREP), E, _jput(jm, np.int32(n_real), JREP)))
    (used_s,) = _rows_put(s, used0)
    lanes = [torch.from_numpy(a) for a in (placements, demands, eval_of)]
    got = tdrain.used_bases(used_s, *lanes, E, n_real)
    assert got.split == tshard.COLS and len(got.slabs) == s
    assert all(t.shape == (E, N // s, C) and t.is_contiguous() for t in got.slabs)
    np.testing.assert_array_equal(got.full().numpy(), want)
    plain = tdrain.used_bases_ref(torch.from_numpy(used0), *lanes, E, n_real)
    np.testing.assert_array_equal(plain.numpy(), want)
    # each eval's base, taken from the slabs as the collector hands it back,
    # gathers to one host plane
    for e in (0, E - 1):
        base = tshard.Sharded(tshard.ROWS, (t[e] for t in got.slabs))
        np.testing.assert_array_equal(tsched._to_host(base), want[e])


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("case", sorted(LANE_CASES))
def test_sharded_scatter_equals_jax_and_unsharded(case, s):
    n_real, seed = LANE_CASES[case]
    rng, N, _, used = _node_planes(n_real, seed, s)
    rows = _lane_rows(rng, N, n_real, s, 64)
    # duplicates carry one value, as the dirty-row lanes do (JAX leaves the
    # order of differing duplicate writes open)
    table = rng.integers(0, 2**30, (N, 4)).astype(np.int32)
    vals = table[rows]
    jm = jmesh(s)
    jout = jmirror._scatter_fn(jm)(_jput(jm, used, JROWS), _jput(jm, rows, JREP),
                                   _jput(jm, vals, JREP))
    (used_s,) = _rows_put(s, used)
    before = [t.clone() for t in used_s.slabs]
    r, v = torch.from_numpy(rows), torch.from_numpy(vals)
    got = tmirror.scatter_rows(used_s, r, v)
    assert got.split == tshard.ROWS and len(got.slabs) == s
    shards = sorted(jout.addressable_shards, key=lambda sh: sh.device.id)
    for slab, sh in zip(got.slabs, shards):
        np.testing.assert_array_equal(slab.numpy(), np.asarray(sh.data))
    np.testing.assert_array_equal(
        tmirror.scatter_rows_ref(torch.from_numpy(used), r, v).numpy(), np.asarray(jout))
    # the slabs handed in are never written
    assert all(torch.equal(a, b) for a, b in zip(before, used_s.slabs))


@pytest.mark.parametrize("kernel_name", ["verify", "bases", "scatter"])
def test_sharded_rules_for_lanes_outside_the_planes(kernel_name):
    """The port's rules for what the JAX programs never see: a verify lane
    on a row outside [0, N) adds nothing and fails, a lane of an eval
    outside [0, E) adds nothing to the bases, a scatter lane outside
    [0, N) writes nothing; the sharded plain versions keep them as the
    unsharded ones do."""
    rng, N, capacity, used = _node_planes(1000, 3, N_DEV)
    rows = _lane_rows(rng, N, 1000, N_DEV, 64)
    rows[[3, 9, 20]] = (-1, N, N + 7)
    deltas = rng.integers(0, 50, (len(rows), 4)).astype(np.int32)
    r, d = torch.from_numpy(rows), torch.from_numpy(deltas)
    full = [torch.from_numpy(a) for a in (capacity, used)]
    sharded = _rows_put(N_DEV, capacity, used)
    if kernel_name == "verify":
        got, want = tk.verify_rows(*sharded, r, d), tk.verify_rows_ref(*full, r, d)
        assert not got[[3, 9, 20]].any()
    elif kernel_name == "bases":
        placements = torch.from_numpy(np.clip(rows, 0, 999))
        eval_of = torch.from_numpy(rng.integers(-2, 10, len(rows)).astype(np.int32))
        got = tdrain.used_bases(sharded[1], placements, d, eval_of, 8, 1000).full()
        want = tdrain.used_bases_ref(full[1], placements, d, eval_of, 8, 1000)
        assert ((eval_of < 0) | (eval_of >= 8)).any()
    else:
        got = tmirror.scatter_rows(sharded[1], r, d).full()
        want = tmirror.scatter_rows_ref(full[1], r, d)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K5s over a fused multi-eval batch
# ---------------------------------------------------------------------------

#: name -> (drain mix, evals, seed): E pads to 32 either way; drain-tenant's
#: 32 evals cut to 3 (384 lanes of 512) to keep the plain versions' walk short
FUSED_CASES = {"drain_bench": ("drain-bench", 32, 5), "drain_tenant": ("drain-tenant", 3, 6)}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_sharded_fused_scan_equals_jax_and_unsharded(case):
    mix, n_evals, seed = FUSED_CASES[case]
    n_real = 1000
    shared, preps = problems.drain_problem(problems.build_cluster(n_real, 1, seed=seed), n_evals,
                                           mix, seed=seed)
    order = [tdrain.DrainPrep.from_dict(d) for d in preps]
    mesh = tmesh(N_DEV)
    shape = tdrain.batch_shape(order, n_real, 32, mesh)
    E, G, A, N, V = shape
    args_np, state_np, _ = tdrain.assemble(order, n_real, shape)
    planes = tdrain.host_planes(tdrain.SharedCluster(shared["capacity"], shared["usable"],
                                                     shared["used0"]), N)
    # several evals, each with its own ring and cursor, and padded lanes
    assert E == 32 and len(set(args_np["group_eval"][args_np["groups"][args_np["valid"]]])) > 1
    assert len({args_np["perm"][e].tobytes() for e in range(n_evals)}) == n_evals
    assert not args_np["valid"].all()
    if mix == "drain-tenant":  # rings over 1-4 datacenters, spread on some groups
        assert len(set(args_np["ring"][:n_evals].tolist())) > 1
        assert args_np["spread_active"].any() and not args_np["spread_active"].all()

    jargs = jk.BatchArgs(capacity=planes[0], usable=planes[1], **args_np)
    jinit = jk.BatchState(used=planes[2], **state_np)
    aspec, sspec = jshard.batch_specs()
    jm = jmesh(N_DEV)
    with jk.deterministic_scope():
        jstate, jplaced = jk.plan_batch(jshard.put(jargs, aspec, jm),
                                        jshard.put(jinit, sspec, jm), n_real)
    want, want_state = np.asarray(jplaced), [np.asarray(x) for x in jstate]

    sargs, sinit = tdrain.batch_inputs(planes, args_np, state_np, "cpu", mesh)
    assert tshard.shards_of((sargs, sinit)) == N_DEV
    state, placed = tk.plan_batch(sargs, sinit, n_real)
    uargs, uinit = tdrain.batch_inputs(planes, args_np, state_np, "cpu")
    ustate, uplaced = tk.plan_batch(uargs, uinit, n_real)
    for got, got_state in ((placed, tshard.gather(state)), (uplaced, ustate)):
        np.testing.assert_array_equal(got.numpy(), want)
        for name, x, ref in zip(tk.BatchState._fields, got_state, want_state):
            np.testing.assert_array_equal(x.numpy(), ref, err_msg=name)
    assert (want >= 0).sum() > 0


# ---------------------------------------------------------------------------
# the mirror's device planes under a mesh
# ---------------------------------------------------------------------------

def test_sharded_device_state_holds_the_jax_shards_and_refreshes_into_new_slabs():
    """tests/test_mirror.py's TestDeviceStateSharded in the port."""
    rng = np.random.default_rng(0)
    n, n_pad = 1000, 1024
    capacity = rng.integers(1000, 64000, (n, 4)).astype(np.int64)
    usable = rng.random((n, 2)).astype(np.float32) * 1000 + 1
    used = rng.integers(0, 900, (n, 4)).astype(np.int64)
    jds = jmirror.DeviceState(1, n_pad, capacity, usable, used, mesh=jmesh(N_DEV))
    ds = tmirror.DeviceState(1, n_pad, capacity, usable, used, device="cpu", mesh=tmesh(N_DEV))
    plain = tmirror.DeviceState(1, n_pad, capacity, usable, used, device="cpu")
    assert ds.mesh is not None and plain.mesh is None

    def same_shards(got, jarr):
        assert isinstance(got, tshard.Sharded) and got.split == tshard.ROWS
        shards = sorted(jarr.addressable_shards, key=lambda sh: sh.device.id)
        assert len(got.slabs) == len(shards) == N_DEV
        for slab, sh in zip(got.slabs, shards):
            np.testing.assert_array_equal(slab.numpy(), np.asarray(sh.data))

    for got, jarr in zip(ds.arrays(), jds.arrays()):
        same_shards(got, jarr)
    handed = [t.clone() for t in ds.used.slabs]
    old = ds.used
    used_host = used.copy()
    used_host[7] += 5
    used_host[999] += 3
    used_host[127:129] += 11  # both sides of the first shard boundary
    for d in (jds, ds, plain):
        d.pending.update({7, 127, 128, 999})
        d.refresh(used_host)
    same_shards(ds.used, jds.used)
    np.testing.assert_array_equal(ds.used.full().numpy(), plain.used.numpy())
    assert ds.used is not old and all(torch.equal(a, b) for a, b in zip(handed, old.slabs))
    assert ds.refresh_bytes == plain.refresh_bytes > 0


def test_mirror_rebuilds_the_device_state_when_the_mesh_changes():
    from nomad_tpu_torch import mock

    store = TStateStore()
    store.upsert_nodes(1, [mock.node() for _ in range(40)])
    mirror = tmirror.ColumnarMirror(store, device="cpu")
    mesh = tmesh(N_DEV)
    try:
        snap = store.snapshot()
        n_pad = tshard.node_bucket(40, mesh)
        plain = mirror.device_state(n_pad, snap._gen)
        assert isinstance(plain[2], torch.Tensor)
        sharded = mirror.device_state(n_pad, snap._gen, mesh=mesh)
        assert isinstance(sharded[2], tshard.Sharded) and len(sharded[2].slabs) == N_DEV
        again = mirror.device_state(n_pad, snap._gen, mesh=mesh)
        assert again[2] is sharded[2]  # cached for its own mesh
        assert mirror.counters["uploads"] == 2
        cluster, arrays, _ = mirror.verify_handles(snap, n_pad, mesh=mesh)
        assert arrays[0] is sharded[0]
        np.testing.assert_array_equal(sharded[0].full().numpy(), plain[0].numpy())
    finally:
        mirror.close()


# ---------------------------------------------------------------------------
# the server under a mesh
# ---------------------------------------------------------------------------

def _job_docs(counts, cpu=(250, 500), mem=(128, 512)):
    from nomad_tpu import mock as jmock

    docs = []
    for i, count in enumerate(counts):
        j = jmock.job()
        j.datacenters = ["dc1", "dc2"]
        tg = j.task_groups[0]
        tg.count = count
        tg.tasks[0].resources.networks = []
        tg.tasks[0].resources.cpu = cpu[i % 2]
        tg.tasks[0].resources.memory_mb = mem[i % 2]
        docs.append(j.to_dict())
    return docs


def _cluster_docs(n_nodes, seed=17):
    from nomad_tpu import mock as jmock
    from nomad_tpu.structs import compute_class

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


#: 30 nodes: 32 rows over 8 shards, the last shard part real, part padding
MESH_NODES = 30
SERVER_EXTRA = {"default_scheduler": "tpu-batch", "batch_drain": 8, "plan_apply_batch": 8,
                "plan_pipeline": {"device_verify_min": 1}}


def _serve_rounds(started, port, extra, node_docs, rounds) -> dict:
    """Start a server with no worker, register the nodes and the first
    round's jobs, start one worker (so the round's evals fuse into one
    batch), wait; then each later round's jobs, waiting for each; returns
    (job id, alloc name) -> node id."""
    from nomad_tpu.structs import model as jmodel
    from nomad_tpu_torch.core.server import Server as TServer
    from nomad_tpu_torch.structs import model as tmodel
    from nomad_tpu.core.server import Server as JServer

    model = tmodel if port else jmodel
    cfg = _config(port, extra)
    server = TServer(cfg, device="cpu") if port else JServer(cfg)
    started.append(server)
    server.start(num_workers=0, wait_for_leader=5.0)
    for d in node_docs:
        server.node_register(model.Node.from_dict(d))
    jobs = []
    for i, docs in enumerate(rounds):
        batch = [model.Job.from_dict(d) for d in docs]
        jobs += batch
        ids = [server.job_register(j) for j in batch]
        if i == 0:
            server.start_workers(1)
        _wait_evals(server, ids)
    return {(j.id, a.name): a.node_id
            for j in jobs for a in server.state.allocs_by_job(j.namespace, j.id)}


def test_server_under_a_mesh_places_as_the_jax_server():
    """A fused batch of six evals, then a solo eval whose verify refreshes
    the mirror's sharded planes: the JAX server with ``shard_devices: 8``,
    the port's server over the 8-shard CPU mesh and the port's unsharded
    server place alike; the port's mesh run fuses one batch and its
    ledger holds only sharded drain, scatter and verify launches."""
    nodes = _cluster_docs(MESH_NODES)
    rounds = [_job_docs([12, 16, 10, 20, 14, 9]), _job_docs([11])]
    server_kernels = ("exact", "wavefront", "used_bases", "scatter_rows", "verify_rows")
    with _servers() as started:
        jb = dict(jdrain.DRAIN_COUNTERS)
        try:
            with jk.deterministic_scope():
                want = _serve_rounds(started, False, {**SERVER_EXTRA, "shard_devices": N_DEV},
                                     nodes, rounds)
        finally:
            jshard.configure(enabled=False)
        assert jdrain.LAST_DRAIN_STATS["shards"] == N_DEV
        assert jdrain.DRAIN_COUNTERS["batches"] - jb["batches"] == 1

        devprof.reset()
        devprof.forget_launches()
        tb = dict(tdrain.DRAIN_COUNTERS)
        tshard.configure(N_DEV, device="cpu")
        try:
            got = _serve_rounds(started, True, SERVER_EXTRA, nodes, rounds)
            stats = dict(tdrain.LAST_DRAIN_STATS)
            ledger = devprof.snapshot()["compile_ledger"]
        finally:
            tshard.configure(enabled=False)
        batches = tdrain.DRAIN_COUNTERS["batches"] - tb["batches"]
        plain = _serve_rounds(started, True, SERVER_EXTRA, nodes, rounds)
    assert len(want) == sum([12, 16, 10, 20, 14, 9, 11])
    assert got == want and plain == want
    assert batches == 1 and stats["shards"] == N_DEV and stats["device_state"]
    assert stats["padded"][3] == tshard.node_bucket(MESH_NODES, tmesh(N_DEV))
    launched = {(e["planner"], e["sharded"]) for e in ledger}
    assert {("exact", True), ("used_bases", True), ("scatter_rows", True),
            ("verify_rows", True)} <= launched
    assert not [e for e in ledger if e["planner"] in server_kernels and not e["sharded"]]


def test_applier_under_a_mesh_commits_as_the_jax_host_oracle():
    """tests/test_torch_server.py's seeded plans through the applier's
    sharded verify: every result equals the JAX host oracle's."""
    rng = random.Random(20261019)
    stores, nodes, preloaded = _verify_cluster(rng)
    planner = tpa.Planner(stores.t)
    mirror = tmirror.ColumnarMirror(stores.t, device="cpu")
    planner.mirror_fn = lambda: mirror
    planner.device_verify_min = 1
    tshard.configure(N_DEV, device="cpu")
    checked = 0
    try:
        snap, jsnap = stores.t.snapshot(), stores.j.snapshot()
        for i in range(40):
            plan = _seeded_plan(rng, nodes, preloaded)
            want = jevaluate_plan(jsnap, plan)
            dev_ctx = planner._device_ctx(snap, [_FakePending(_port_plan(plan))])
            assert dev_ctx is not None
            assert isinstance(dev_ctx[2][0], tshard.Sharded)
            got = planner._evaluate_plan_device(dev_ctx, snap, _port_plan(plan),
                                                planner.overlay.deltas(), tpa._OverlayEpoch(),
                                                lambda: snap)
            if got is None:
                continue
            checked += 1
            assert _committed_sets(got) == _committed_sets(want), f"seeded plan {i}"
    finally:
        tshard.configure(enabled=False)
        mirror.close()
    assert checked >= 30
    assert devprof.snapshot()["last_dispatch"]["verify_rows"]["sharded"] is True


def test_faulted_sharded_verify_degrades_to_the_host_oracle():
    rng = random.Random(7)
    stores, nodes, preloaded = _verify_cluster(rng)
    planner = tpa.Planner(stores.t)
    mirror = tmirror.ColumnarMirror(stores.t, device="cpu")
    planner.mirror_fn = lambda: mirror
    planner.device_verify_min = 1
    name = "plan.verify_device_degrade.kernel_fault"
    before = tmetrics.snapshot()["counters"].get(name, 0)
    tshard.configure(N_DEV, device="cpu")
    _fault(tfaults)
    try:
        snap = stores.t.snapshot()
        plan = _port_plan(_seeded_plan(rng, nodes, preloaded))
        dev_ctx = planner._device_ctx(snap, [_FakePending(plan)])
        assert isinstance(dev_ctx[2][2], tshard.Sharded)
        got = planner._evaluate_plan_device(dev_ctx, snap, plan, planner.overlay.deltas(),
                                            tpa._OverlayEpoch(), lambda: snap)
    finally:
        tfaults.uninstall()
        tshard.configure(enabled=False)
        mirror.close()
    assert got is None
    assert tmetrics.snapshot()["counters"][name] == before + 1


def test_faulted_sharded_drain_degrades_as_the_unsharded_one(monkeypatch):
    """Two evals fused under the mesh with the ``tpu.kernel`` fault point
    tripping: the sharded batch refuses, each eval degrades to the host
    oracle, counted, and places as the same faulted drain without a mesh
    (small asks: the two evals' plans never contend for a node)."""
    nodes = _cluster_docs(MESH_NODES)
    rounds = [_job_docs([10, 12], cpu=(50, 60), mem=(32, 48))]
    name = "scheduler.kernel_fault_degrade"
    scans = []
    real = tk.plan_batch

    def spy(args, init, *rest, **kw):
        scans.append(tshard.shards_of((args, init)))
        return real(args, init, *rest, **kw)

    monkeypatch.setattr(tk, "plan_batch", spy)
    outs = []
    with _servers() as started:
        for sharded in (True, False):
            if sharded:
                tshard.configure(N_DEV, device="cpu")
            before = tmetrics.snapshot()["counters"].get(name, 0)
            rule = _fault(tfaults, count=100)
            try:
                placed = _serve_rounds(started, True, SERVER_EXTRA, nodes, rounds)
            finally:
                tfaults.uninstall()
                tshard.configure(enabled=False)
            outs.append((placed, tmetrics.snapshot()["counters"][name] - before, rule.trips > 0))
    assert outs[0] == outs[1]
    placed, counted, tripped = outs[0]
    assert len(placed) == 22 and counted == 2 and tripped
    # one fused scan a run, refused: over the 8 shards, then unsharded
    assert scans == [N_DEV, 1]


def test_wavefront_drain_under_a_mesh_raises():
    """The wavefront drain under a mesh (which raised before its sharded
    form was ported) runs the sharded wavefront over the fused batch and
    places as the unsharded wavefront drain; below the gate it runs
    unsharded."""
    n = 300
    shared_np, preps = problems.drain_problem(problems.build_cluster(n, 1, seed=4), 4,
                                              "drain-tenant", seed=4)
    twf.configure(enabled=True)
    out = {}
    for mesh_on in (True, False):
        tshard.configure(N_DEV if mesh_on else None, enabled=mesh_on, device="cpu")
        shared = tdrain.SharedCluster(shared_np["capacity"], shared_np["usable"],
                                      shared_np["used0"])
        collector = tdrain.KernelBatchCollector(shared, len(preps), device="cpu")
        got = {}

        def one(d):
            placements, base = collector.submit(tdrain.DrainPrep.from_dict(d))
            got[d["eval_id"]] = (placements.numpy(), tshard.gather(base).numpy()
                                 if isinstance(base, tshard.Sharded) else base.numpy())

        threads = [threading.Thread(target=one, args=(d,)) for d in preps]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        stats = tdrain.LAST_DRAIN_STATS
        assert stats["planner"] == "wavefront" and stats["shards"] == (N_DEV if mesh_on else 1)
        out[mesh_on] = got
    tshard.configure(enabled=False)
    assert sorted(out[True]) == sorted(out[False]) and len(out[True]) == len(preps)
    for eval_id, (placements, base) in out[False].items():
        np.testing.assert_array_equal(out[True][eval_id][0], placements)
        np.testing.assert_array_equal(out[True][eval_id][1][: base.shape[0]], base)
    # below the gate the wavefront drain runs unsharded
    tshard.configure(N_DEV, device="cpu")
    rng, N, capacity, used = _node_planes(300, 4, N_DEV)
    usable = np.ones((300, 2), np.float32)
    small = tdrain.SharedCluster(capacity[:GATE - 1], usable[:GATE - 1], used[:GATE - 1])
    assert tdrain.KernelBatchCollector(small, 2, device="cpu").shared is small


# ---------------------------------------------------------------------------
# warm-up under a mesh
# ---------------------------------------------------------------------------

#: the fused drain's warm-up: (real nodes, drain size); 300 nodes shard
#: (512 rows) once the gate is 256, 200 stay under it (256 rows)
WARM_GATE = 256


@pytest.mark.parametrize("n_nodes,sharded", [(300, True), (200, False)])
def test_drain_warm_up_under_a_mesh(n_nodes, sharded, monkeypatch):
    for m in (jshard, tshard):
        monkeypatch.setattr(m, "MIN_NODES", WARM_GATE)
    want = jwarmup.prewarm_drain(n_nodes, 4, mesh=jmesh(N_DEV))
    devprof.reset()
    devprof.forget_launches()
    mesh = tmesh(N_DEV)
    assert twarmup.prewarm_drain(n_nodes, 4, device="cpu", mesh=mesh) == want == 4
    N = tshard.node_bucket(n_nodes, mesh if sharded else None)
    ledger = {(e["planner"], e["shape"], e["sharded"])
              for e in devprof.snapshot()["compile_ledger"]}
    want_ledger = {("exact", f"E8G8A16N{N}", sharded), ("verify_rows", f"N{N}R8", sharded),
                   ("verify_rows", f"N{N}R64", sharded)}
    if sharded:  # the unsharded bases and scatter keep out of the ledger, as JAX's do
        want_ledger |= {("used_bases", f"E8N{N}A16", True), ("scatter_rows", f"N{N}R8", True)}
    assert ledger == want_ledger
    assert devprof.totals()["rounds"] == 0  # the warm-up moves no counter


def test_prewarm_under_a_mesh_warms_both_flavors_of_a_straddling_bucket(monkeypatch):
    """``prewarm``'s mesh expansion (JAX warmup.py:46-98): the 256-row
    bucket holds real counts on both sides of a 256-node gate, so it warms
    the sharded and the unsharded planners, as many as JAX compiles."""
    for m in (jshard, tshard):
        monkeypatch.setattr(m, "MIN_NODES", WARM_GATE)
    shapes = ((256, 128),)
    want = jwarmup.prewarm(shapes, mesh=jmesh(N_DEV))
    devprof.reset()
    devprof.forget_launches()
    assert twarmup.prewarm(shapes, device="cpu", mesh=tmesh(N_DEV)) == want == 6
    ledger = {(e["planner"], e["sharded"]) for e in devprof.snapshot()["compile_ledger"]}
    assert ledger == {(p, s) for p in ("runs", "windowed", "exact") for s in (True, False)}
