"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and is marked ``gpu``; without one it
skips. The file imports neither JAX nor the JAX package, so on the card it
runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Placements, final state and round counts must be identical: the planners
break ties by exact float equality, so no tolerance applies.
"""

import threading

import numpy as np
import pytest
from torch_for_tests import multi_eval_problem, runcap_problem, torch

from nomad_tpu_torch.tpu import kernel as tk
from nomad_tpu_torch.tpu import paging, planner, problems, wavefront


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _stanzas_reset():
    for m in (wavefront, paging):
        m.reset()
    yield
    for m in (wavefront, paging):
        m.reset()


def _same(got, want):
    got, want = got.cpu(), want.cpu()
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


def _with_devices(args, init):
    """The same problem with a 5th resource column (free device instances)."""
    n = args["capacity"].shape[0]
    args = dict(args, capacity=np.concatenate([args["capacity"], np.full((n, 1), 3, np.int32)], 1),
                demands=np.concatenate([args["demands"], np.ones((len(args["demands"]), 1), np.int32)], 1))
    return args, dict(init, used=np.concatenate([init["used"], np.zeros((n, 1), np.int32)], 1))


EXACT_CASES = {
    "spread": lambda: problems.exact_problem(problems.build_cluster(96, 128, seed=1)),
    "no_spread": lambda: problems.exact_problem(problems.build_cluster(96, 128, seed=1), spread=False),
    "groups8": lambda: problems.wavefront_problem(problems.build_cluster(96, 128, seed=2), n_groups=8),
    "padded": lambda: problems.exact_problem(problems.pad_cluster(problems.build_cluster(90, 128, seed=3), 96)),
    "multi_eval": multi_eval_problem,
    "devices": lambda: _with_devices(*problems.exact_problem(problems.build_cluster(64, 250, seed=4))),
    "wide": lambda: problems.wavefront_problem(problems.build_cluster(3000, 700, seed=5), n_groups=3),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(EXACT_CASES))
def test_exact_scan_kernel_matches_plain(case, cuda_device):
    args, init = EXACT_CASES[case]()
    a, s = tk.from_numpy(args, cuda_device), tk.from_numpy(init, cuda_device)
    n_real = int(args["ring"].max())
    before = tk.LAUNCHES["exact_scan"]
    got_state, got = tk.plan_batch(a, s, n_real)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["exact_scan"] == before + 1
    want_state, want = tk.plan_batch_ref(a, s, n_real)
    _same(got, want)
    for g, w in zip(got_state, want_state):
        _same(g, w)


def _runs_case(affinity=True, spread=True, n=96, a=700, seed=4):
    return problems.runs_problem(problems.build_cluster(n, a, seed=seed), affinity=affinity, spread=spread)


def _even_case():
    args, init = problems.runs_problem(problems.build_cluster(96, 300, n_values=3, seed=5),
                                       affinity=False, spread=True)
    return dict(args, spread_even=np.bool_(True)), init


RUNS_CASES = {
    "aff_spread": lambda: _runs_case(),
    "spread": lambda: _runs_case(affinity=False),
    "aff": lambda: _runs_case(spread=False),
    "plain": lambda: _runs_case(affinity=False, spread=False),
    "even": _even_case,
    "runcap": lambda: runcap_problem(problems.build_cluster, problems.runs_problem),
    "wide": lambda: _runs_case(n=3000, a=9000, seed=6),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(RUNS_CASES))
def test_runs_kernel_matches_plain(case, cuda_device):
    args, init = RUNS_CASES[case]()
    a, i = tk.from_numpy(args, cuda_device), tk.from_numpy(init, cuda_device)
    a_pad = problems.bucket(int(args["n_allocs"]))
    even = bool(args["spread_even"])
    got, got_rounds = tk.plan_batch_runs(a, i, a_pad, even)
    torch.cuda.synchronize()
    want, want_rounds = tk.plan_batch_runs_ref(a, i, a_pad, even)
    _same(got, want)
    assert int(got_rounds) == want_rounds


@pytest.mark.gpu
@pytest.mark.parametrize("n,a,limit", [(96, 127, 2), (96, 127, 10), (3000, 5000, 10)])
def test_windowed_kernel_matches_plain(n, a, limit, cuda_device):
    c = problems.build_cluster(n, a, seed=8)
    args, used0, coll0 = problems.window_problem(c, limit=limit)
    wa = tk.from_numpy(args, cuda_device)
    u, cl = tk.from_numpy((used0, coll0), cuda_device)
    a_pad = problems.bucket(a)
    got, got_rounds = tk.plan_batch_windowed(wa, u, cl, n, a_pad)
    torch.cuda.synchronize()
    want, want_rounds = tk.plan_batch_windowed_ref(wa, u, cl, n, a_pad)
    _same(got, want)
    assert int(got_rounds) == want_rounds


@pytest.mark.gpu
@pytest.mark.parametrize("spread,limit", [(True, None), (False, 10), (True, 10)])
def test_plan_eval_on_card_matches_cpu(spread, limit, cuda_device):
    c = problems.build_cluster(2000, 6000, seed=2)
    planes = problems.eval_planes(*problems.exact_problem(c, spread=spread))
    if limit is not None:
        planes["limits"][:] = limit
    want, want_stats = planner.plan_eval(planes, device="cpu")
    got, stats = planner.plan_eval(planes, device=cuda_device)
    assert stats["mode"] == want_stats["mode"]
    assert stats["launches"] == 1 and want_stats["launches"] == 0
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the wavefront planner and the paged planner's tile sweeps
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("window", [8, 32, 200])
@pytest.mark.parametrize("top_m", [1, 3])
@pytest.mark.parametrize("case", sorted(EXACT_CASES))
def test_wavefront_kernel_matches_plain(case, top_m, window, cuda_device):
    """W = 200 is more lanes than blocks the card holds at once, so blocks
    loop over lanes; ``multi_eval`` has bounded limits, so lanes move their
    eval's cursor and block later lanes of it."""
    args, init = EXACT_CASES[case]()
    wavefront.configure(max_round=window, contention_top_m=top_m)
    a, s = tk.from_numpy(args, cuda_device), tk.from_numpy(init, cuda_device)
    n_real = int(args["ring"].max())
    before = tk.LAUNCHES["wavefront"]
    got_state, got, rounds = wavefront.plan_batch_wavefront(a, s, n_real)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["wavefront"] == before + 1
    W = wavefront.window_for(len(args["groups"]))
    want_state, want, want_rounds = wavefront.plan_batch_wavefront_ref(a, s, n_real, W, top_m, 1)
    _same(got, want)
    for g, w in zip(got_state, want_state):
        _same(g, w)
    assert int(rounds) == want_rounds
    # and the sequential scan's placements and state
    scan_state, scan = tk.plan_batch(a, s, n_real)
    _same(got, scan)
    for g, w in zip(got_state, scan_state):
        _same(g, w)


def _two_tile_budget(monkeypatch):
    """A budget below two tiles: the cache floors it at two tiles and
    evicts by LRU on every sweep."""
    monkeypatch.setattr(paging, "budget_mb", lambda: 0)


def _recorded_tile_calls(case, tile_nodes):
    """The paged planner on the CPU, with every sweep call's arguments and
    outputs recorded."""
    calls = []

    def recorder(fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            saved = [x.clone() if isinstance(x, torch.Tensor) else x for x in args]
            calls.append((fn, saved, [o.clone() for o in (out if isinstance(out, tuple) else (out,))]))
            return out
        return wrapper

    paging.configure(tile_nodes=tile_nodes)
    count, window = paging.tile_count, paging.tile_window
    paging.tile_count, paging.tile_window = recorder(count), recorder(window)
    try:
        result = paging.plan_batch_paged(*case, device="cpu")
    finally:
        paging.tile_count, paging.tile_window = count, window
    return result, calls


@pytest.mark.gpu
@pytest.mark.parametrize("n,a,limit", [(797, 96, 6), (8192, 1024, 4), (5000, 3000, 1)])
def test_tile_sweep_kernels_match_plain(n, a, limit, cuda_device, monkeypatch):
    _two_tile_budget(monkeypatch)
    case = problems.paged_case(3, n, a, limit=limit)
    _, calls = _recorded_tile_calls(case, 1024)
    assert calls
    for fn, args, want in calls:
        on_card = [x.to(cuda_device) if isinstance(x, torch.Tensor) else x for x in args]
        before = tk.LAUNCHES[fn.__name__]
        got = fn(*on_card)
        torch.cuda.synchronize()
        assert tk.LAUNCHES[fn.__name__] == before + 1
        for g, w in zip(got if isinstance(got, tuple) else (got,), want):
            _same(g.reshape(w.shape), w)


@pytest.mark.gpu
@pytest.mark.parametrize("n,a,limit,tile_nodes", [(797, 96, 6, 64), (8192, 1024, 4, 1024),
                                                  (20000, 9000, 2, 4096)])
def test_paged_on_card_matches_flat_windowed(n, a, limit, tile_nodes, cuda_device, monkeypatch):
    """The paged planner on the card, with a budget of two tiles (LRU
    eviction every sweep), against the flat windowed kernel, the paged run
    on the CPU and the numpy oracle."""
    _two_tile_budget(monkeypatch)
    case = problems.paged_case(5, n, a, limit=limit)
    paging.configure(tile_nodes=tile_nodes)
    got, rounds, stats = paging.plan_batch_paged(*case, device=cuda_device)
    assert stats["budget_raised"] and stats["resident_peak_bytes"] <= stats["limit_bytes"]
    want, want_rounds, want_stats = paging.plan_batch_paged(*case, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert rounds == want_rounds and stats == want_stats
    capacity, usable, feasible, perm, demand, gc, limit, n_allocs, used0, coll0, n_real, a_pad = case
    wargs = tk.from_numpy(dict(capacity=capacity, usable=usable, feasible=feasible, perm=perm,
                               demand=demand, group_count=np.int32(gc), limit=np.int32(limit),
                               n_allocs=np.int32(n_allocs)), cuda_device)
    flat, flat_rounds = tk.plan_batch_windowed(wargs, *tk.from_numpy((used0, coll0), cuda_device),
                                               n_real, a_pad)
    np.testing.assert_array_equal(got, flat.cpu().numpy())
    assert rounds == int(flat_rounds)
    oracle, oracle_rounds = paging.plan_windowed_np(*case)
    np.testing.assert_array_equal(got, oracle)
    assert rounds == oracle_rounds


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["wavefront", "paged"])
def test_plan_eval_routes_on_card_match_cpu(route, cuda_device):
    if route == "wavefront":
        wavefront.configure(enabled=True)
        c = problems.build_cluster(2000, 3000, seed=4)
        planes = problems.eval_planes(*problems.wavefront_problem(c, n_groups=8))
    else:
        # 25,600 rows of 45 bytes exceed the least budget, 1 MB
        paging.configure(enabled=True, device_node_budget_mb=1, tile_nodes=4096)
        c = problems.build_cluster(25_000, 3000, seed=4)
        planes = problems.eval_planes(*problems.exact_problem(c, spread=False))
        planes["limits"][:] = 10
    want, want_stats = planner.plan_eval(planes, device="cpu")
    got, stats = planner.plan_eval(planes, device=cuda_device)
    assert stats["mode"] == want_stats["mode"] == route
    assert stats["rounds"] == want_stats["rounds"] and stats["launches"] > 0
    np.testing.assert_array_equal(got, want)


def _random_exact(seed):
    """A multi-group exact scan with random limits, signed affinities and
    small group counts, so nonpositive scores, deferral and replay occur."""
    rng = np.random.default_rng(seed)
    n, a = int(rng.integers(200, 1500)), int(rng.integers(100, 600))
    G = int(rng.integers(1, 5))
    args, init = problems.wavefront_problem(
        problems.build_cluster(n, a, n_values=int(rng.integers(1, 6)), seed=seed),
        n_groups=G, spread=bool(rng.random() < 0.7))
    aff = np.where(rng.random((G, n)) < 0.3, rng.uniform(-1, 1, (G, n)), 0).astype(np.float32)
    args.update(affinity=aff, affinity_present=aff != 0,
                group_count=rng.integers(1, 4, G).astype(np.int32),
                spread_even=rng.random(G) < 0.5,
                limits=rng.integers(1, n + 1, a).astype(np.int32))
    return args, init


def _random_runs(seed):
    rng = np.random.default_rng(seed)
    n, a = int(rng.integers(200, 1500)), int(rng.integers(300, 3000))
    args, init = problems.runs_problem(
        problems.build_cluster(n, a, n_values=int(rng.integers(1, 6)), seed=seed),
        affinity=bool(rng.random() < 0.5), spread=bool(rng.random() < 0.7))
    return dict(args, group_count=np.int32(rng.integers(1, a + 1)),
                spread_even=np.bool_(rng.random() < 0.3)), init


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(6))
def test_random_problems_kernels_match_plain(seed, cuda_device):
    args, init = _random_exact(100 + seed)
    a, s = tk.from_numpy(args, cuda_device), tk.from_numpy(init, cuda_device)
    got_state, got = tk.plan_batch(a, s, int(args["ring"][0]))
    want_state, want = tk.plan_batch_ref(a, s, int(args["ring"][0]))
    _same(got, want)
    for g, w in zip(got_state, want_state):
        _same(g, w)
    args, init = _random_runs(200 + seed)
    a, i = tk.from_numpy(args, cuda_device), tk.from_numpy(init, cuda_device)
    a_pad = problems.bucket(int(args["n_allocs"]))
    even = bool(args["spread_even"])
    got, got_rounds = tk.plan_batch_runs(a, i, a_pad, even)
    want, want_rounds = tk.plan_batch_runs_ref(a, i, a_pad, even)
    _same(got, want)
    assert int(got_rounds) == want_rounds


# ---------------------------------------------------------------------------
# the server path: usage bases, dirty-row scatter, dense verify, drain batch
# ---------------------------------------------------------------------------

def _lanes(kind, rng, N, R, C=4):
    """(rows, values) of R lanes over N rows: ``mid`` random with
    duplicates, ``one`` a single lane, ``dups`` every lane on three rows,
    ``invalid`` every row outside [0, N)."""
    if kind == "one":
        R = 1
    rows = rng.integers(0, N, R)
    if kind == "dups":
        rows = rng.choice([0, 5, N - 1], R)
    elif kind == "invalid":
        rows = np.where(rng.random(R) < 0.5, -1 - rng.integers(0, 3, R), N + rng.integers(0, 3, R))
    vals = rng.integers(-300, 300, (R, C))
    return rows.astype(np.int32), vals.astype(np.int32)


SERVER_CASES = ["mid", "one", "dups", "invalid"]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", SERVER_CASES)
def test_used_bases_kernel_matches_plain(kind, cuda_device):
    from nomad_tpu_torch.tpu import drain

    rng = np.random.default_rng(1)
    E, N, n_real, A = 16, 4096, 4000, 2048
    lanes, demands = _lanes(kind, rng, N, A)
    placements = lanes if kind != "invalid" else np.full(len(lanes), -1, np.int32)
    if kind == "mid":
        placements[::9] = -1
    eval_of = rng.integers(0, E, len(placements)).astype(np.int32)
    used0 = rng.integers(0, 10**5, (N, 4)).astype(np.int32)
    used0[n_real:] = 2**30
    t = [torch.from_numpy(a).to(cuda_device) for a in (used0, placements, np.abs(demands), eval_of)]
    before = tk.LAUNCHES["used_bases"]
    got = drain.used_bases(*t, E, n_real)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["used_bases"] == before + 1
    _same(got, drain.used_bases_ref(*t, E, n_real))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", SERVER_CASES)
def test_scatter_rows_kernel_matches_plain(kind, cuda_device):
    from nomad_tpu_torch.tpu import mirror

    rng = np.random.default_rng(2)
    N = 10_240
    rows, vals = _lanes(kind, rng, N, 3000)
    used = torch.from_numpy(rng.integers(0, 2**30, (N, 4)).astype(np.int32)).to(cuda_device)
    kept = used.clone()
    r, v = torch.from_numpy(rows).to(cuda_device), torch.from_numpy(vals).to(cuda_device)
    got = mirror.scatter_rows(used, r, v)
    torch.cuda.synchronize()
    _same(got, mirror.scatter_rows_ref(used, r, v))
    _same(used, kept)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", SERVER_CASES)
def test_verify_rows_kernel_matches_plain(kind, cuda_device):
    rng = np.random.default_rng(3)
    N = 10_240
    rows, deltas = _lanes(kind, rng, N, 4096)
    capacity = rng.integers(1000, 9000, (N, 4)).astype(np.int32)
    used = (capacity - rng.integers(0, 600, (N, 4))).astype(np.int32)
    t = [torch.from_numpy(a).to(cuda_device) for a in (capacity, used, rows, deltas)]
    kept = t[1].clone()
    got = tk.verify_rows(*t)
    torch.cuda.synchronize()
    want = tk.verify_rows_ref(*t)
    _same(got, want)
    _same(t[1], kept)
    if kind == "invalid":
        assert not bool(want.any())


@pytest.mark.gpu
@pytest.mark.parametrize("planner_on", ["exact", "wavefront"])
@pytest.mark.parametrize("shape,with_state", [("drain-tenant", True), ("drain-bench", False)])
def test_drain_batch_on_card_matches_cpu(shape, with_state, planner_on, cuda_device):
    from nomad_tpu_torch.tpu import drain, mirror

    wavefront.configure(enabled=planner_on == "wavefront")
    c = problems.build_cluster(3000, 1, seed=9)
    shared, preps = problems.drain_problem(c, 12, shape, seed=9)
    out = {}
    for dev in ("cpu", cuda_device):
        ds = None
        if with_state:
            ds = mirror.DeviceState(0, 3072, shared["capacity"], shared["usable"],
                                    shared["used0"], device=dev)
        collector = drain.KernelBatchCollector(
            drain.SharedCluster(shared["capacity"], shared["usable"], shared["used0"], ds),
            expected=len(preps), pad_evals=16, device=dev)
        got = {}

        def one(d):
            placements, base = collector.submit(drain.DrainPrep.from_dict(d))
            got[d["eval_id"]] = (placements.cpu().numpy(), base.cpu().numpy())

        threads = [threading.Thread(target=one, args=(d,)) for d in preps]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        out[str(dev)] = got
        assert drain.LAST_DRAIN_STATS["planner"] == planner_on
    cpu, card = out["cpu"], out[str(cuda_device)]
    assert sorted(cpu) == sorted(card) and len(card) == len(preps)
    for eval_id, (placements, base) in cpu.items():
        np.testing.assert_array_equal(card[eval_id][0], placements)
        np.testing.assert_array_equal(card[eval_id][1], base)
