"""The port's paged node axis against the JAX package's, on the CPU.

The tile sweeps (``tile_count``/``tile_window``), ``TileCache`` and the
host-driven ``plan_batch_paged`` run their plain versions (device="cpu")
and must equal the JAX package's exactly: every tile's sweep outputs bit
for bit, placements, rounds and the cache's stats. The port's numpy
oracle ``plan_windowed_np`` and its flat windowed planner must agree with
both. Inputs are the JAX suite's seeded cases (tests/test_paging.py).
"""

import numpy as np
import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

import bench
from nomad_tpu.state import planes as state_planes
from nomad_tpu.tpu import kernel as jk
from nomad_tpu.tpu import paging as jpaging
from nomad_tpu.tpu import wavefront as jwf
from nomad_tpu_torch.tpu import kernel as tk
from nomad_tpu_torch.tpu import paging as tpaging
from nomad_tpu_torch.tpu import problems
from nomad_tpu_torch.tpu import wavefront as twf
from test_paging import _tile_builders, build_case

ARG_ORDER = ("capacity", "usable", "feasible", "perm", "demand", "group_count", "limit",
             "n_allocs", "used0", "collisions0", "n_real", "a_pad")


@pytest.fixture(autouse=True)
def _stanzas_reset():
    # the JAX stanza's tile_nodes also sets the committed planes' tile rows
    tile_rows = state_planes.TILE_ROWS
    for m in (jwf, twf, jpaging, tpaging):
        m.reset()
    yield
    for m in (jwf, twf, jpaging, tpaging):
        m.reset()
    state_planes.TILE_ROWS = tile_rows


def _args(case):
    return [case[k] for k in ARG_ORDER]


def _tiny_budget(monkeypatch):
    """A budget below two tiles in both packages: the cache floors it at two
    tiles and evicts by LRU on every sweep."""
    for m in (jpaging, tpaging):
        monkeypatch.setattr(m, "budget_mb", lambda: 0)


#: name -> (seed, nodes, allocs, limit, expected tiles) at 64-row tiles
CASES = {
    "multi_tile_0": (0, 320, 160, 4, 5),
    "multi_tile_1": (1, 320, 160, 4, 5),
    "multi_tile_2": (2, 320, 160, 4, 5),
    "irregular_tail": (11, 797, 96, 6, 13),
    "single_tile": (5, 48, 24, 3, 1),
    "zero_feasible": (3, 200, 50, 4, 4),
    "tiny_budget": (7, 320, 160, 4, 5),
}


def _case(name, monkeypatch):
    seed, n, a, limit, tiles = CASES[name]
    case = build_case(seed, n=n, a=a, limit=limit)
    if name == "zero_feasible":
        case["feasible"][:] = False
    if name == "tiny_budget":
        _tiny_budget(monkeypatch)
    for m in (jpaging, tpaging):
        m.configure(enabled=True, tile_nodes=64)
    return case, tiles


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_matches_jax(name, monkeypatch):
    case, tiles = _case(name, monkeypatch)
    with jk.deterministic_scope():
        want, want_rounds, want_stats = jpaging.plan_batch_paged(*_args(case))
    got, rounds, stats = tpaging.plan_batch_paged(*_args(case), device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert rounds == want_rounds
    assert stats == want_stats and stats["tiles"] == tiles
    if name == "tiny_budget":
        assert stats["budget_raised"] and stats["evictions"] > 0 and stats["reuploads"] > 0
        assert stats["resident_peak_bytes"] <= stats["limit_bytes"]
    if name == "zero_feasible":
        assert (got == -1).all() and rounds == 1
    else:
        assert (got >= 0).sum() == case["n_allocs"]

    # the host oracle and the flat windowed planner place the same
    oracle, oracle_rounds = tpaging.plan_windowed_np(*_args(case))
    np.testing.assert_array_equal(oracle, want)
    assert oracle_rounds == rounds
    wargs = dict(capacity=case["capacity"], usable=case["usable"], feasible=case["feasible"],
                 perm=case["perm"], demand=case["demand"],
                 group_count=np.int32(case["group_count"]), limit=np.int32(case["limit"]),
                 n_allocs=np.int32(case["n_allocs"]))
    used0, coll0 = tk.from_numpy((case["used0"], case["collisions0"]), "cpu")
    flat, flat_rounds = tk.plan_batch_windowed(tk.from_numpy(wargs, "cpu"), used0, coll0,
                                               case["n_real"], case["a_pad"])
    np.testing.assert_array_equal(flat.numpy(), want)
    assert flat_rounds == rounds


def _recorded_sweeps(case, monkeypatch):
    """JAX's paged run of ``case``, with every tile sweep it dispatches
    recorded as (name, host args, host outputs)."""
    calls = []
    orig = jk._dispatch

    def record(name, jitfn, call_args, key, *rest, **kw):
        out = orig(name, jitfn, call_args, key, *rest, **kw)
        if name == "paged":
            # copies: on the CPU a JAX array may alias the host plane that
            # the pager updates after the round
            calls.append((jitfn, [np.array(a) for a in call_args],
                          [np.array(o) for o in out[0]]))
        return out

    monkeypatch.setattr(jk, "_dispatch", record)
    with jk.deterministic_scope():
        jpaging.plan_batch_paged(*_args(case))
    monkeypatch.undo()
    return calls


def _row_scores(args, fused: bool) -> np.ndarray:
    """Sweep 2's score per row in numpy float32, op for op as the source
    reads (``fused=False``: the port's float contract, no contraction), or
    with each step of ``_pow10``'s Horner chain as one fused multiply-add
    (``fused=True``: XLA:CPU contracts the chain inside this compiled
    program). A float32 product is exact in float64, so a fused step is the
    float64 sum rounded once to float32."""
    cap, usable, feas, used, coll, nodes, demand, group_count = args[:8]
    f32 = np.float32

    def pow10(x):
        x = np.clip(x, f32(-45.2), f32(45.2))
        c = f32(4097.0) * x
        x_hi = c - (c - x)
        x_lo = x - x_hi
        y_hi = x_hi * f32(tk._LOG2_10_HI)
        y_lo = x_hi * f32(tk._LOG2_10_LO) + x_lo * f32(tk._LOG2_10)
        n = np.round(y_hi + y_lo)
        f = (y_hi - n) + y_lo
        p = np.full_like(f, tk._EXP2_POLY[0])
        for coef in tk._EXP2_POLY[1:]:
            if fused:
                p = (p.astype(np.float64) * f.astype(np.float64) + coef).astype(f32)
            else:
                p = p * f + f32(coef)
        n_i = n.astype(np.int32)
        n1 = np.clip(n_i, -126, 127)
        n2 = np.clip(n_i - n1, -126, 127)
        return p * ((n1 + 127) << 23).view(f32) * ((n2 + 127) << 23).view(f32)

    util = used + demand[None, :]
    free_cpu = f32(1.0) - util[:, 0].astype(f32) / usable[:, 0]
    free_mem = f32(1.0) - util[:, 1].astype(f32) / usable[:, 1]
    binpack = np.clip(f32(20.0) - (pow10(free_cpu) + pow10(free_mem)), f32(0.0), f32(18.0))
    binpack = binpack * f32(tk._INV18)  # XLA's rewrite of the division by 18
    present = coll > 0
    anti = np.where(present, -(coll.astype(f32) + f32(1.0)) / f32(group_count), f32(0.0))
    return ((binpack + anti.astype(f32)) / (f32(1.0) + present.astype(f32))).astype(f32)


@pytest.mark.parametrize("name", ["multi_tile_0", "irregular_tail", "tiny_budget"])
def test_tile_sweeps_match_jax_on_every_tile(name, monkeypatch):
    """Both sweeps on every tile JAX's paged run dispatches: the counts, the
    straddle bases, the per-window ranks and nodes, the watermark and the
    fill values of segments no row reaches are identical. A window's score
    is the winning row's score: the port's is that row's score without
    contraction, JAX's CPU program's the same with ``_pow10``'s Horner
    chain fused (``_row_scores``); both are checked bit for bit."""
    case, tiles = _case(name, monkeypatch)
    calls = _recorded_sweeps(case, monkeypatch)
    counts = [c for c in calls if c[0] is jpaging._tile_count_jit]
    windows = [c for c in calls if c[0] is jpaging._tile_window_jit]
    assert len(counts) >= tiles and len(windows) >= tiles
    for _, a, want in counts:
        cap, feas, used, demand = (torch.from_numpy(x) for x in a[:4])
        got = tpaging.tile_count(cap, feas, used, demand, *(int(x) for x in a[4:]))
        np.testing.assert_array_equal(got.numpy(), np.array([int(w) for w in want], np.int32))
    for _, a, want in windows:
        got = tpaging.tile_window(*(torch.from_numpy(x) for x in a[:7]), *(int(x) for x in a[7:]))
        got = [g.numpy() for g in got]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
        for k in (0, 2, 3, 4):  # bases, ranks, nodes, watermark
            np.testing.assert_array_equal(got[k], want[k])
        nodes = want[3]
        won = nodes >= 0
        row_of = {int(n): i for i, n in enumerate(a[5])}
        rows = np.array([row_of[int(n)] for n in nodes[won]], dtype=np.int64)
        np.testing.assert_array_equal(got[1][~won].view(np.int32), want[1][~won].view(np.int32))
        np.testing.assert_array_equal(got[1][won].view(np.int32),
                                      _row_scores(a, fused=False)[rows].view(np.int32))
        np.testing.assert_array_equal(want[1][won].view(np.int32),
                                      _row_scores(a, fused=True)[rows].view(np.int32))


def test_tile_cache_matches_jax():
    bs, bd = _tile_builders()
    tile_bytes = sum(np.asarray(x).nbytes for x in (*bs(0), *bd(0)))
    sequence = [("ensure", 0), ("ensure", 1), ("ensure", 2), ("ensure", 0),
                ("dirty", [0, 2]), ("ensure", 0), ("ensure", 2), ("ensure", 1),
                ("ensure", 1), ("dirty", [1]), ("ensure", 1), ("ensure", 3), ("ensure", 0)]
    for budget in (1, 2 * tile_bytes, 3 * tile_bytes, 1 << 20):
        want = jpaging.TileCache(budget, bs, bd)
        got = tpaging.TileCache(budget, bs, bd, device="cpu")
        for op, arg in sequence:
            for cache in (want, got):
                if op == "dirty":
                    cache.mark_dirty(arg)
                else:
                    ent = cache.ensure(arg)
            assert got.stats() == want.stats()
            if op == "ensure":  # the tile's arrays, as uploaded
                for g, w in zip((*ent["static"], *ent["dyn"]), (*bs(arg), *bd(arg))):
                    np.testing.assert_array_equal(g.numpy(), w)
        assert sorted(got._resident) == sorted(want._resident)


@pytest.mark.parametrize("seed,n,a,limit", [(0, 96, 200, 3), (4, 257, 64, 1), (6, 130, 40, 0)])
def test_plan_windowed_np_matches_jax(seed, n, a, limit):
    case = build_case(seed, n=n, a=a, limit=limit)
    want, want_rounds = jpaging.plan_windowed_np(*_args(case))
    got, rounds = tpaging.plan_windowed_np(*_args(case))
    np.testing.assert_array_equal(got, want)
    assert rounds == want_rounds


def test_paged_case_matches_bench():
    for args in ((3, 500, 80), (7, 8192, 1024, 4), (1, 130, 256, 8, 5)):
        want = bench._paged_case(*args)
        got = problems.paged_case(*args)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
            assert np.asarray(g).dtype == np.asarray(w).dtype


def test_stanza_resolves_like_jax(monkeypatch):
    def knobs(m):
        return (m.enabled(), m.budget_mb(), m.tile_rows(), m.plane_bytes(1000, 4),
                m.should_page(10**6, 4), m.should_page(1024))

    assert knobs(tpaging) == knobs(jpaging) == (False, 256, 65536, 45000, False, False)
    assert (tpaging.DEFAULT_BUDGET_MB, tpaging.DEFAULT_TILE_NODES, tpaging.MIN_TILE_NODES) == (
        jpaging.DEFAULT_BUDGET_MB, jpaging.DEFAULT_TILE_NODES, jpaging.MIN_TILE_NODES)
    monkeypatch.setenv("NOMAD_TPU_PAGING", "1")
    monkeypatch.setenv("NOMAD_TPU_PAGING_BUDGET_MB", "1")
    monkeypatch.setenv("NOMAD_TPU_PAGING_TILE_NODES", "100")
    assert knobs(tpaging) == knobs(jpaging) == (True, 1, 128, 45000, True, False)
    for m in (jpaging, tpaging):
        m.configure(enabled=False, device_node_budget_mb=0, tile_nodes=1)
    assert knobs(tpaging) == knobs(jpaging) == (False, 1, 64, 45000, False, False)
    for m in (jpaging, tpaging):
        m.reset()
    assert knobs(tpaging) == knobs(jpaging) == (True, 1, 128, 45000, True, False)
