"""The wavefront and paged routes under a mesh against the JAX package's.

The JAX side runs on the 8-device virtual CPU mesh (tests/conftest.py),
its wavefront and tile sweeps under ``NamedSharding(P("nodes"))``; the
port's mesh is S shards on the CPU (``configure(S, device="cpu")`` or a
``Mesh(S, "cpu")``), its sharded routes the sharded plain versions
(``wavefront.plan_batch_wavefront_sharded_ref``,
``paging.tile_count_sharded_ref``, ``paging.tile_window_sharded_ref``). The
size gate is lowered in both packages; ``NOMAD_TPU_DETERMINISTIC=1``. With
no tolerance:

- the sharded wavefront at S = 8 and 4 equals the JAX wavefront under the
  same mesh width, the JAX sequential scan and the port's unsharded
  wavefront (placements, final state, rounds), on an uneven node axis at
  M 1 and 4 and on a fused drain batch of several evals;
- the sharded tile sweeps equal the JAX sweeps on tiles placed by JAX's
  ``paged_specs()`` and the port's unsharded sweeps, on a tile that
  straddles the ring's end, tiles the cursor wraps and a tile with no
  feasible row;
- the paged planner over an 8-shard mesh equals the JAX paged planner over
  its mesh, the port's unsharded run and the flat windowed planner, with
  the same tile bytes uploaded;
- ``plan_eval`` under the mesh runs both routes sharded, the ``Server`` with
  the wavefront stanza places as the JAX ``Server`` with ``shard_devices``,
  and the warm-ups warm both routes at their sharded shapes;
- the port's multichip bench reports ok, and its artifact writer, noise
  filter and summary line behave as the JAX module's.

tests/test_torch_gpu.py holds K11s, K12s and K13s against these plain
versions on the card.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from torch_for_tests import gil_handoff, torch  # noqa: F401

from nomad_tpu.state import planes as state_planes
from nomad_tpu.tpu import drain as jdrain
from nomad_tpu.tpu import kernel as jk
from nomad_tpu.tpu import paging as jpaging
from nomad_tpu.tpu import shard as jshard
from nomad_tpu.tpu import warmup as jwarmup
from nomad_tpu.tpu import wavefront as jwf
from nomad_tpu_torch.debug import devprof
from nomad_tpu_torch.tpu import drain as tdrain
from nomad_tpu_torch.tpu import kernel as tk
from nomad_tpu_torch.tpu import multichip as tmc
from nomad_tpu_torch.tpu import paging as tpaging
from nomad_tpu_torch.tpu import planner as tplanner
from nomad_tpu_torch.tpu import problems
from nomad_tpu_torch.tpu import shard as tshard
from nomad_tpu_torch.tpu import warmup as twarmup
from nomad_tpu_torch.tpu import wavefront as twf
from test_torch_mesh_server import _cluster_docs, _job_docs, _serve_rounds
from test_torch_paging import _row_scores
from test_torch_server import _servers

N_DEV = 8
SHARDS = (N_DEV, 4)
N_UNEVEN = 2059  # buckets to 3072 = 8 x 384: shard 5 part real, 6-7 padding
#: the lowered gate of the small clusters here
GATE = 256


@pytest.fixture(autouse=True)
def _mesh_off(monkeypatch):
    """Every test starts and ends with both meshes off, both packages'
    stanzas at their defaults, the gate lowered in both and the JAX
    deterministic flavor on."""
    tile_rows = state_planes.TILE_ROWS
    monkeypatch.setenv("NOMAD_TPU_DETERMINISTIC", "1")
    for m in (jshard, tshard):
        m.configure(enabled=False)
        monkeypatch.setattr(m, "MIN_NODES", GATE)
    yield
    for m in (jshard, tshard):
        m.configure(enabled=False)
    for m in (jwf, twf, jpaging, tpaging):
        m.reset()
    state_planes.TILE_ROWS = tile_rows
    assert tshard.active_mesh() is None and jshard.active_mesh() is None


def jmesh(s):
    devices = jax.devices()
    if len(devices) < s:
        pytest.skip(f"need {s} virtual devices, have {len(devices)}")
    return JMesh(np.array(devices[:s]), (jshard.AXIS,))


def tmesh(s):
    return tshard.Mesh(s, "cpu")


def _jx(tree):
    """A port BatchArgs or BatchState as the JAX package's."""
    return getattr(jk, type(tree).__name__)(*[jnp.asarray(x) for x in tree])


# ---------------------------------------------------------------------------
# K11s's plain version: the wavefront over a mesh
# ---------------------------------------------------------------------------

def _wave_ab(args, init, n_real):
    """The JAX wavefront over each mesh width, the JAX sequential scan, and
    the port's wavefront over each width and unsharded, on one problem;
    every port run must equal the JAX runs."""
    _, seq = jk.plan_batch(_jx(args), _jx(init), n_real)
    seq = np.asarray(seq)
    aspec, sspec = tshard.wavefront_specs()
    jaspec, jsspec = jshard.wavefront_specs()
    rounds = set()
    for s in SHARDS:
        jm = jmesh(s)
        jstate, want, jrounds = jwf.plan_batch_wavefront(
            jshard.put(_jx(args), jaspec, jm), jshard.put(_jx(init), jsspec, jm), n_real,
            n_shards=s)
        want, want_state = np.asarray(want), [np.asarray(x) for x in jstate]
        np.testing.assert_array_equal(want, seq)
        m = tmesh(s)
        state, got, r = twf.plan_batch_wavefront(tshard.put(args, aspec, m),
                                                 tshard.put(init, sspec, m), n_real, n_shards=s)
        assert isinstance(state.used, tshard.Sharded) and len(state.used.slabs) == s
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"S={s}")
        for name, x, ref in zip(tk.BatchState._fields, tshard.gather(state), want_state):
            np.testing.assert_array_equal(x.numpy(), ref, err_msg=f"S={s} state.{name}")
        assert r == int(jrounds)
        rounds.add(r)
    ustate, uplaced, ur = twf.plan_batch_wavefront(tk.from_numpy(args, "cpu"),
                                                   tk.from_numpy(init, "cpu"), n_real)
    np.testing.assert_array_equal(uplaced.numpy(), seq)
    for x, y in zip(ustate, want_state):
        np.testing.assert_array_equal(x.numpy(), y)
    assert rounds == {ur}
    return ur


#: name -> (seed, M): the uneven axis of tests/test_wavefront.py at M 1 and 4
WAVE_CASES = {"uneven_m1": (11, 1), "uneven_m4": (29, 4)}


@pytest.mark.parametrize("case", sorted(WAVE_CASES))
def test_sharded_wavefront_equals_jax_sequential_and_unsharded(case):
    seed, top_m = WAVE_CASES[case]
    for m in (jwf, twf):
        m.configure(contention_top_m=top_m)
    c = problems.pad_cluster(problems.build_cluster(N_UNEVEN, 256, seed=seed),
                             tshard.node_bucket(N_UNEVEN, tmesh(N_DEV)))
    args, init = problems.wavefront_problem(c)
    rounds = _wave_ab(tk.BatchArgs(**args), tk.BatchState(**init), N_UNEVEN)
    assert rounds < 256


def test_sharded_wavefront_over_a_fused_batch_equals_jax():
    """drain-tenant's layout cut to 1,024 nodes and three evals (E pads to
    32): rings over one to four datacenters, spread on some groups, padded
    lanes."""
    n_real = 1024
    shared, preps = problems.drain_problem(problems.build_cluster(n_real, 1, seed=6), 3,
                                           "drain-tenant", seed=6)
    order = [tdrain.DrainPrep.from_dict(d) for d in preps]
    shape = tdrain.batch_shape(order, n_real, 32, tmesh(N_DEV))
    args_np, state_np, _ = tdrain.assemble(order, n_real, shape)
    planes = tdrain.host_planes(tdrain.SharedCluster(shared["capacity"], shared["usable"],
                                                     shared["used0"]), shape[3])
    assert len(set(args_np["group_eval"][args_np["groups"][args_np["valid"]]])) > 1
    assert not args_np["valid"].all()
    args = tk.BatchArgs(capacity=planes[0], usable=planes[1], **args_np)
    init = tk.BatchState(used=planes[2], **state_np)
    _wave_ab(args, init, n_real)


def _round_rule(args, init, window: int, top_m: int, s: int):
    """K11s's algorithm in plain PyTorch (``csrc/mesh.cu``,
    ``mesh_exact_kernel<true>``): every lane committed as it is selected,
    in lane order, and the rounds counted by the wavefront's rule, each lane
    tested against the records of its round's earlier lanes before its
    step."""
    used, coll, counts, present, offset = (t.clone() for t in init)
    valid, groups = args.valid.tolist(), args.groups.tolist()
    group_eval, ring, limits = args.group_eval.tolist(), args.ring.tolist(), args.limits.tolist()
    feasible = args.feasible.numpy()
    stop = max((k + 1 for k in range(len(valid)) if valid[k]), default=0)
    placements = torch.full((len(valid),), -1, dtype=torch.int32)
    rounds, records = 0, []
    for i in range(stop):
        g = groups[i]
        e = group_eval[g]
        blocked = len(records) == window or any(
            (adv and e_j == e) or any(n >= 0 and feasible[g, n] for n in top)
            for e_j, adv, top in records)
        if blocked or i == 0:
            rounds, records = rounds + 1, []
        if not valid[i]:
            records.append((e, False, [-1] * top_m))
            continue
        state = tk.BatchState(used, coll, counts, present, offset)
        best, place, adv, consumed, top = twf._select(args, state, s, top_m, args.demands[i], g,
                                                      limits[i], True)
        placements[i] = best
        if place:
            used[best] += args.demands[i]
            coll[g, best] += 1
            v = int(args.node_value[g, best])
            if bool(args.spread_active[g]) and v >= 0:
                counts[g, v] += 1
                present[g, v] = True
        if adv:
            offset[e] = (int(offset[e]) + consumed) % max(ring[e], 1)
        records.append((e, adv, top))
    return tk.BatchState(used, coll, counts, present, offset), placements, rounds


@pytest.mark.parametrize("window,top_m", [(32, 1), (32, 4), (8, 3)])
def test_k11s_round_rule_equals_the_wavefront(window, top_m):
    """Committing each lane as it is selected and counting rounds by the
    conflict rule gives the wavefront's placements, final state and rounds:
    an unblocked lane selects against the round-start state what it
    selects after the round's earlier lanes."""
    c = problems.pad_cluster(problems.build_cluster(N_UNEVEN, 256, seed=11),
                             tshard.node_bucket(N_UNEVEN, tmesh(N_DEV)))
    args, init = (tk.from_numpy(x, "cpu") for x in problems.wavefront_problem(c))
    args, init = tk.BatchArgs(*args), tk.BatchState(*init)
    want_state, want, want_rounds = twf.plan_batch_wavefront_ref(args, init, N_UNEVEN, window,
                                                                 top_m, 4)
    state, got, rounds = _round_rule(args, init, window, top_m, 4)
    assert rounds == want_rounds < 256
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for x, y in zip(state, want_state):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_wavefront_takes_its_shard_count_from_the_tree():
    c = problems.build_cluster(512, 64, seed=2)
    args, init = problems.wavefront_problem(c, n_groups=4)
    aspec, sspec = tshard.wavefront_specs()
    m = tmesh(4)
    sargs, sinit = tshard.put(tk.BatchArgs(**args), aspec, m), tshard.put(tk.BatchState(**init),
                                                                          sspec, m)
    with pytest.raises(ValueError, match="n_shards 8"):
        twf.plan_batch_wavefront(sargs, sinit, 512, n_shards=8)
    devprof.reset()
    devprof.forget_launches()
    twf.plan_batch_wavefront(sargs, sinit, 512, n_valid=64)
    [entry] = devprof.snapshot()["compile_ledger"]
    assert entry["planner"] == "wavefront" and entry["sharded"]
    assert entry["shape"] == "E1G4A64N512W32M1S4"
    assert devprof.rounds_snapshot()["wavefront"]["sharded_dispatches"] == 1
    with pytest.raises(ValueError, match="unsharded kernel"):
        twf.plan_batch_wavefront(sargs, sinit, 512, walked=torch.zeros(1, dtype=torch.int64))


# ---------------------------------------------------------------------------
# K12s's and K13s's plain versions: the tile sweeps on a split tile
# ---------------------------------------------------------------------------

T = 64


def _tiles(offset: int):
    """Every tile of one round of the paged planner over 150 ring rows in
    64-row tiles: tile 2 straddles the ring's end (rows 128-191, the ring
    150), tile 1 has no feasible row, and the cursor at ``offset`` wraps the
    rows before it. Each tile as tile_window's numpy arguments."""
    n, limit = 150, 4
    capacity, usable, feasible, perm, demand, gc, _, _, used0, coll0, _, _ = problems.paged_case(
        38, n, 40, limit=limit)
    rows = 3 * T
    real = np.arange(rows) < n

    def gathered(plane, fill):
        out = np.full((rows, *plane.shape[1:]), fill, plane.dtype)
        out[real] = plane[perm]
        return out

    cap_r, usable_r, used_r = gathered(capacity, 0), gathered(usable, 1.0), gathered(used0, 2**30)
    feas_r, coll_r = gathered(feasible, False), gathered(coll0, 0)
    coll_r[real] = np.arange(n) % 3  # some rows carry collisions
    feas_r[T:2 * T] = False
    nodes_r = np.where(real, np.concatenate([perm, np.zeros(rows - n, np.int32)]), 0)
    tiles = [tuple(np.ascontiguousarray(x[t * T:(t + 1) * T]) for x in
                   (cap_r, usable_r, feas_r, used_r, coll_r, nodes_r.astype(np.int32)))
             for t in range(3)]
    counts = [tpaging.tile_count_ref(*(torch.from_numpy(x) for x in (tl[0], tl[2], tl[3])),
                                     torch.from_numpy(demand), t * T, offset, n).numpy()
              for t, tl in enumerate(tiles)]
    counts = np.array(counts, np.int64)
    total, x0 = int(counts[:, 0].sum()), int(counts[:, 1].sum())
    flat_base = np.concatenate([[0], np.cumsum(counts[:, 0])[:-1]])
    w_use = max(total // limit, 1)
    return [(*tiles[t], demand, int(gc), limit, t * T, offset, n, int(flat_base[t]), x0, total,
             w_use) for t in range(3)]


@pytest.mark.parametrize("offset", [0, 100])
def test_sharded_tile_sweeps_equal_jax_and_unsharded(offset):
    static_specs, dyn_specs = jshard.paged_specs()
    for s in SHARDS:
        jm, m = jmesh(s), tmesh(s)
        for t, a in enumerate(_tiles(offset)):
            cap, usable, feas, used, coll, nodes, demand = a[:7]
            scalars = a[7:]
            jcap, jusable, jfeas, jnodes = jshard.put(
                tuple(jnp.asarray(x) for x in (cap, usable, feas, nodes)), static_specs, jm)
            jused, jcoll = jshard.put((jnp.asarray(used), jnp.asarray(coll)), dyn_specs, jm)
            with jk.deterministic_scope():
                jcount, _ = jk._dispatch("paged", jpaging._tile_count_jit, (
                    jcap, jfeas, jused, demand, *(np.int32(x) for x in scalars[2:5])), "count")
                jwin, _ = jk._dispatch("paged", jpaging._tile_window_jit, (
                    jcap, jusable, jfeas, jused, jcoll, jnodes, demand,
                    *(np.int32(x) for x in scalars)), "window")
            tstatic = tshard.put((cap, usable, feas, nodes), tshard.paged_specs()[0], m)
            tcap, tusable, tfeas, tnodes = tstatic
            tused, tcoll = tshard.put((used, coll), tshard.paged_specs()[1], m)
            assert tshard.shards_of((tstatic, tused, tcoll)) == s
            dem = torch.from_numpy(demand)
            got_c = tpaging.tile_count(tcap, tfeas, tused, dem, *scalars[2:5])
            np.testing.assert_array_equal(got_c.numpy(), [int(x) for x in jcount])
            flat = [torch.from_numpy(x) for x in (cap, usable, feas, used, coll, nodes)]
            np.testing.assert_array_equal(
                got_c.numpy(), tpaging.tile_count(flat[0], flat[2], flat[3], dem,
                                                  *scalars[2:5]).numpy())
            got = [x.numpy() for x in tpaging.tile_window(tcap, tusable, tfeas, tused, tcoll,
                                                          tnodes, dem, *scalars)]
            want = [np.asarray(x) for x in jwin]
            plain = [x.numpy() for x in tpaging.tile_window(*flat, dem, *scalars)]
            for k in range(5):
                np.testing.assert_array_equal(got[k].view(np.int32) if k == 1 else got[k],
                                              plain[k].view(np.int32) if k == 1 else plain[k])
            for k in (0, 2, 3, 4):  # bases, ranks, nodes, watermark
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"S={s} tile {t}")
            # a window's score is its winning row's: the port's without
            # contraction, JAX's CPU program's with _pow10's Horner chain
            # fused (tests/test_torch_paging.py)
            won = want[3] >= 0
            row_of = {}  # a pad row's node id repeats a real row's: the real one
            for i, x in enumerate(nodes):
                row_of.setdefault(int(x), i)
            rows = np.array([row_of[int(x)] for x in want[3][won]], dtype=np.int64)
            np.testing.assert_array_equal(got[1][~won].view(np.int32),
                                          want[1][~won].view(np.int32))
            np.testing.assert_array_equal(got[1][won].view(np.int32),
                                          _row_scores(a, fused=False)[rows].view(np.int32))
            np.testing.assert_array_equal(want[1][won].view(np.int32),
                                          _row_scores(a, fused=True)[rows].view(np.int32))
            if t == 1:
                assert int(got_c[0]) == 0 and (got[3] < 0).all()


def test_tile_rows_round_to_the_mesh():
    for tn in (64, 100, 1000, 65536):
        for m in (jpaging, tpaging):
            m.configure(tile_nodes=tn)
        for s in (1, 3, 4, 8):
            jm = None if s == 1 else jmesh(s)
            tm = None if s == 1 else tmesh(s)
            assert tpaging.tile_rows(tm) == jpaging.tile_rows(jm)
            assert tpaging.tile_rows(tm) % s == 0
    assert tpaging.sweep_keys(64, 8) == ("T64S8c", "T64S8w")


# ---------------------------------------------------------------------------
# the paged eval under a mesh
# ---------------------------------------------------------------------------

def test_paged_eval_under_a_mesh_equals_jax_unsharded_and_flat(monkeypatch):
    for m in (jpaging, tpaging):
        m.configure(tile_nodes=64)
        monkeypatch.setattr(m, "budget_mb", lambda: 0)
    case = problems.paged_case(7, 797, 96, limit=6)
    with jk.deterministic_scope():
        want, want_rounds, want_stats = jpaging.plan_batch_paged(*case, mesh=jmesh(N_DEV))
    devprof.reset()
    devprof.forget_launches()
    before = devprof.totals()["h2d_bytes"]
    got, rounds, stats = tpaging.plan_batch_paged(*case, device="cpu", mesh=tmesh(N_DEV))
    moved = devprof.totals()["h2d_bytes"] - before
    ledger = {(e["shape"], e["sharded"]) for e in devprof.snapshot()["compile_ledger"]}
    np.testing.assert_array_equal(got, want)
    assert rounds == want_rounds and stats == want_stats
    assert ledger == {("T64S8c", True), ("T64S8w", True)}
    assert devprof.rounds_snapshot()["paged"]["sharded_rounds"] == rounds
    flat, flat_rounds, flat_stats = tpaging.plan_batch_paged(*case, device="cpu")
    np.testing.assert_array_equal(got, flat)
    assert rounds == flat_rounds and stats == flat_stats
    assert moved == stats["upload_bytes"] > 0
    capacity, usable, feasible, perm, demand, gc, limit, n_allocs, used0, coll0, n_real, a_pad = case
    wargs = tk.from_numpy(dict(capacity=capacity, usable=usable, feasible=feasible, perm=perm,
                               demand=demand, group_count=np.int32(gc), limit=np.int32(limit),
                               n_allocs=np.int32(n_allocs)), "cpu")
    windowed, w_rounds = tk.plan_batch_windowed(wargs, *tk.from_numpy((used0, coll0), "cpu"),
                                                n_real, a_pad)
    np.testing.assert_array_equal(got, windowed.numpy())
    assert rounds == w_rounds


# ---------------------------------------------------------------------------
# the routes through plan_eval and the server
# ---------------------------------------------------------------------------

def _planes(n=300, a=200, **kw):
    c = problems.build_cluster(n, a, seed=1)
    args, init = problems.exact_problem(c, **kw)
    return problems.eval_planes(args, init)


def _paged_planes():
    planes = _planes(spread=False)
    planes["affinity_present"][:] = False
    planes["limits"][:] = 8
    return planes


@pytest.mark.parametrize("route", ["wavefront", "paged"])
def test_plan_eval_runs_both_routes_under_a_mesh(route, monkeypatch):
    if route == "wavefront":
        twf.configure(enabled=True)
        planes = _planes(a=40)
    else:
        tpaging.configure(enabled=True, tile_nodes=64)
        monkeypatch.setattr(tpaging, "budget_mb", lambda: 0)
        planes = _paged_planes()
    want, want_stats = tplanner.plan_eval(planes, device="cpu")
    tshard.configure(N_DEV, device="cpu")
    devprof.reset()
    devprof.forget_launches()
    got, stats = tplanner.plan_eval(planes, device="cpu")
    ledger = devprof.snapshot()["compile_ledger"]
    assert stats["mode"] == want_stats["mode"] == route
    assert stats["shards"] == N_DEV and want_stats["shards"] == 1
    assert stats["rounds"] == want_stats["rounds"]
    np.testing.assert_array_equal(got, want)
    assert ledger and all(e["sharded"] for e in ledger)


def test_server_with_the_wavefront_under_a_mesh_places_as_the_jax_server(monkeypatch):
    """tests/test_torch_mesh_server.py's server run (its 30 nodes, its gate
    of 16) with the wavefront stanza on: the JAX server with
    ``shard_devices: 8``, the port's server over the 8-shard CPU mesh and
    the port's unsharded server place alike; the port's mesh run fuses one
    batch through the sharded wavefront."""
    for m in (jshard, tshard):
        monkeypatch.setattr(m, "MIN_NODES", 16)
    nodes = _cluster_docs(30)
    rounds = [_job_docs([12, 16, 10, 20, 14, 9]), _job_docs([11])]
    extra = {"default_scheduler": "tpu-batch", "batch_drain": 8, "plan_apply_batch": 8,
             "plan_pipeline": {"device_verify_min": 1}, "wavefront": {"enabled": True}}
    with _servers() as started:
        jb = dict(jdrain.DRAIN_COUNTERS)
        try:
            with jk.deterministic_scope():
                want = _serve_rounds(started, False, {**extra, "shard_devices": N_DEV}, nodes,
                                     rounds)
        finally:
            jshard.configure(enabled=False)
        assert jdrain.LAST_DRAIN_STATS["shards"] == N_DEV
        assert jdrain.DRAIN_COUNTERS["batches"] - jb["batches"] == 1

        devprof.reset()
        devprof.forget_launches()
        tb = dict(tdrain.DRAIN_COUNTERS)
        tshard.configure(N_DEV, device="cpu")
        try:
            got = _serve_rounds(started, True, extra, nodes, rounds)
            stats = dict(tdrain.LAST_DRAIN_STATS)
            ledger = devprof.snapshot()["compile_ledger"]
        finally:
            tshard.configure(enabled=False)
        batches = tdrain.DRAIN_COUNTERS["batches"] - tb["batches"]
        plain = _serve_rounds(started, True, extra, nodes, rounds)
    assert len(want) == sum([12, 16, 10, 20, 14, 9, 11])
    assert got == want and plain == want
    assert batches == 1 and stats["shards"] == N_DEV and stats["planner"] == "wavefront"
    launched = {(e["planner"], e["sharded"]) for e in ledger}
    assert ("wavefront", True) in launched and ("exact", True) not in launched
    assert not [e for e in ledger if e["planner"] in ("exact", "wavefront", "used_bases")
                and not e["sharded"]]


# ---------------------------------------------------------------------------
# the warm-ups
# ---------------------------------------------------------------------------

def test_prewarm_warms_both_routes_at_their_sharded_shapes():
    """Both stanzas on: one shape past the gate warms the three flat
    planners and the wavefront sharded, the tile sweeps warm on a tile split
    over the mesh; the count is the JAX ladder's."""
    for m in (jwf, twf):
        m.configure(enabled=True)
    for m in (jpaging, tpaging):
        m.configure(enabled=True, tile_nodes=64)
    shapes = [twarmup.bucket_shape(1000, 100, tmesh(N_DEV))]
    want = jwarmup.prewarm(shapes, mesh=jmesh(N_DEV))
    devprof.reset()
    devprof.forget_launches()
    got = twarmup.prewarm(shapes, device="cpu", mesh=tmesh(N_DEV))
    assert got == want == 6
    ledger = {(e["planner"], e["shape"], e["sharded"])
              for e in devprof.snapshot()["compile_ledger"]}
    N, A = shapes[0]
    assert ("wavefront", f"E1G1A{A}N{N}W32M1S{N_DEV}", True) in ledger
    assert {("paged", "T64S8c", True), ("paged", "T64S8w", True)} <= ledger
    assert all(sharded for _, _, sharded in ledger)
    assert devprof.totals()["rounds"] == 0


def test_prewarm_drain_warms_the_sharded_wavefront():
    for m in (jwf, twf):
        m.configure(enabled=True)
    want = jwarmup.prewarm_drain(300, 4, mesh=jmesh(N_DEV))
    devprof.reset()
    devprof.forget_launches()
    assert twarmup.prewarm_drain(300, 4, device="cpu", mesh=tmesh(N_DEV)) == want == 5
    N = tshard.node_bucket(300, tmesh(N_DEV))
    ledger = {(e["planner"], e["shape"], e["sharded"])
              for e in devprof.snapshot()["compile_ledger"]}
    assert ("wavefront", f"E8G8A16N{N}W16M1S{N_DEV}", True) in ledger
    assert all(sharded for _, _, sharded in ledger)


# ---------------------------------------------------------------------------
# the multichip harness
# ---------------------------------------------------------------------------

def test_bench_multichip_reports_ok_for_the_four_planners():
    report = tmc.bench_multichip(N_DEV, 2048, 512, device="cpu", samples=1)
    assert report["ok"] and not report["skipped"]
    assert set(report["planners"]) == {"exact", "runs", "windowed", "wavefront"}
    for name, p in report["planners"].items():
        assert p["parity"] == 1.0 and p["placed"] > 0, name
        assert p["parity_mode"] == "deterministic" and p["recompiles"] == 0
    # the sharded rounds: one a placement for the scan, fewer for the others
    assert report["planners"]["exact"]["collective_rounds_per_placement"] == 1.0
    assert report["planners"]["wavefront"]["collective_rounds_per_placement"] < 0.2
    assert tshard.active_mesh() is None
    line = tmc.summary_line(report)
    assert line.startswith("MULTICHIP_SUMMARY devices=8 nodes=2048 allocs=512 ok=1")
    assert "/wfx" in line and "wavefront=" in line


def test_bench_multichip_skips_without_the_cards():
    report = tmc.bench_multichip(4)  # no card here: counted, too few
    assert report["skipped"] and not report["ok"]
    assert tmc.summary_line(report) == "MULTICHIP_SUMMARY skipped=1 reason=need 4 devices"


NOISE = ("E0731 00:12:00.683562 16739 cpu_aot_loader.cc:210] Loading XLA:CPU AOT result. "
         "Target machine feature +prefer-no-gather is not supported on the host machine.")
SIGNAL = "RuntimeError: sharded placements diverge at 3/512 positions"


@pytest.mark.parametrize("text,kept,dropped", [
    ("\n".join([NOISE, SIGNAL, NOISE, "", "ok line"]), [SIGNAL, "ok line"], ["cpu_aot_loader"]),
    ("F0801 12:00:00.1 pjrt_client.cc:99] device mesh lost",
     ["F0801 12:00:00.1 pjrt_client.cc:99] device mesh lost"], []),
])
def test_noise_filtered_and_signal_kept(text, kept, dropped):
    """Known noise goes, the signal and unknown error lines stay verbatim,
    as the JAX module's filter does."""
    from nomad_tpu.tpu import multichip as jmc

    out = tmc.filter_noise_tail(text)
    assert out == jmc.filter_noise_tail(text)
    for k in kept:
        assert k in out
    for d in dropped:
        assert d not in out


def test_tail_capped_at_a_line_boundary():
    text = "\n".join(f"line-{i:06d} " + "x" * 40 for i in range(200))
    out = tmc.filter_noise_tail(text, cap=500)
    assert len(out) <= 500
    assert out.startswith("line-")
    assert out.endswith("line-000199 " + "x" * 40)


def test_artifact_writer_and_next_path(tmp_path):
    (tmp_path / "MULTICHIP_r05.json").write_text("{}")
    (tmp_path / "MULTICHIP_r11.json").write_text("{}")
    path = tmc.next_artifact_path(str(tmp_path))
    assert path.endswith("MULTICHIP_r12.json")
    out = tmc.write_artifact({"n_devices": 8, "ok": True, "skipped": False},
                             tail="\n".join([NOISE] * 50 + [SIGNAL]), path=path)
    data = json.loads(open(out).read())
    assert data["ok"] is True and SIGNAL in data["tail"] and "cpu_aot_loader" not in data["tail"]
    assert len(data["tail"]) <= tmc.TAIL_CAP
    # the default slot lies under the build directory, never the repository
    # root's series of the JAX package's runs
    assert "/build/nomad_tpu_torch/multichip/" in tmc.next_artifact_path()


def test_summary_line_carries_timings():
    report = {"n_devices": 8, "nodes": 1024, "allocs": 256, "ok": True, "skipped": False,
              "planners": {"runs": {"sharded_s": 0.5, "speedup": 1.9, "parity": 1.0,
                                    "recompiles": 0}}}
    from nomad_tpu.tpu import multichip as jmc

    line = tmc.summary_line(report)
    assert line == jmc.summary_line(report)
    assert line.startswith("MULTICHIP_SUMMARY ") and "runs=0.5s/x1.9/parity1.0/rc0" in line
