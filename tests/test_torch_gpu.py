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
from nomad_tpu_torch.tpu import multichip, paging, planner, problems, shard, wavefront


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


def _drain_scan(limit, n=3000, shape="drain-bench", seed=31):
    """(args, init) of a fused drain batch's exact scan over ``n`` nodes
    (padded to its bucket), every lane's limit set to ``limit`` when given:
    several evals with rings over 1-4 datacenters, rings shorter than N,
    invalid padding lanes."""
    from nomad_tpu_torch.tpu import drain

    c = problems.build_cluster(n, 1, seed=seed)
    shared, preps = problems.drain_problem(c, 12, shape, seed=seed)
    order = [drain.DrainPrep.from_dict(d) for d in preps]
    shape_ = drain.batch_shape(order, n, 16)
    args, state, _ = drain.assemble(order, n, shape_)
    N, k = shape_[3], shape_[3] - n
    if limit is not None:
        args["limits"] = np.full_like(args["limits"], limit)
    cap = np.concatenate([shared["capacity"], np.zeros((k, 4), np.int32)])
    usable = np.concatenate([shared["usable"], np.ones((k, 2), np.float32)])
    used = np.concatenate([shared["used0"], np.full((k, 4), 2**30, np.int32)])
    return dict(capacity=cap, usable=usable, **args), dict(used=used, **state)


def _nonpositive_heavy(n=3000, a=600, seed=32):
    """Scores at or below zero on most nodes (a group count of 1 and a prior
    alloc of the group on 90% of the nodes), random limits: every step
    defers three options, and steps whose ring runs out replay them."""
    rng = np.random.default_rng(seed)
    args, init = problems.exact_problem(problems.build_cluster(n, a, seed=seed), spread=False)
    args.update(group_count=np.ones(1, np.int32),
                limits=rng.integers(1, n + 1, a).astype(np.int32))
    init["collisions"] = (rng.random((1, n)) < 0.9).astype(np.int32)
    return args, init


def _few_feasible(n=3000, a=40, seed=33):
    """Five feasible nodes, all nonpositive, limit 4: two are returned, and
    the ring runs out, so two of the three deferred ones are replayed."""
    args, init = _nonpositive_heavy(n, a, seed)
    feasible = np.zeros((1, n), bool)
    feasible[0, args["perm"][0, [7, 500, 1499, 2000, 2999]]] = True
    init["collisions"][:] = 1
    return dict(args, feasible=feasible, limits=np.full(a, 4, np.int32)), init


def _many_chunks(n=40_000, a=300, seed=34):
    """A ring longer than two of the cluster's chunks: full-ring limits walk
    it all, limit-14 lanes stop within the first chunk."""
    args, init = problems.exact_problem(problems.build_cluster(n, a, seed=seed))
    args["limits"] = np.where(np.arange(a) % 2 == 0, n, 14).astype(np.int32)
    return args, init


def _invalid_lanes(seed=35):
    """Invalid lanes scattered through a multi-group batch."""
    rng = np.random.default_rng(seed)
    args, init = problems.wavefront_problem(problems.build_cluster(3000, 500, seed=seed),
                                            n_groups=4)
    args.update(valid=rng.random(500) < 0.7,
                limits=np.where(rng.random(500) < 0.5, 14, 3000).astype(np.int32))
    return args, init


#: the windowed walk's cases: limits that stop within a chunk, replay after
#: an exhausted ring, rings of several chunks or of no whole chunk
SCAN_WALK_CASES = {
    "drain_limit2": lambda: _drain_scan(2),
    "drain_limit14": lambda: _drain_scan(14),
    "drain_tenant": lambda: _drain_scan(None, shape="drain-tenant"),
    "nonpositive_heavy": _nonpositive_heavy,
    "few_feasible_replay": _few_feasible,
    "ring_40000": _many_chunks,
    "ring_3000": lambda: problems.exact_problem(problems.build_cluster(3000, 400, seed=36)),
    "ring_10000_padded": lambda: problems.exact_problem(
        problems.pad_cluster(problems.build_cluster(10_000, 200, seed=37), 10_240)),
    "invalid_lanes": _invalid_lanes,
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SCAN_WALK_CASES))
def test_exact_scan_walk_matches_plain(case, cuda_device):
    args, init = SCAN_WALK_CASES[case]()
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
    assert (want.cpu() >= 0).any()


def _roomy(n, a, limit=None, seed=5):
    """One group of ``a`` identical allocs over ``n`` feasible nodes with
    capacity to spare, no spread; every lane's limit ``limit`` if given."""
    c = problems.build_cluster(n, a, seed=seed)
    c["feasible"][:] = True
    c["capacity"][:] = [10**6, 10**7, 10**7, 10**6]
    c["usable"][:] = [10**6, 10**7]
    args, init = problems.exact_problem(c, spread=False)
    if limit is not None:
        args["limits"] = np.full_like(args["limits"], limit)
    return args, init


@pytest.mark.gpu
@pytest.mark.parametrize("n", [3_000, 40_000])
def test_exact_scan_counts_its_walk(n, cuda_device):
    """The kernel counts the ring positions it walks: a full-ring limit
    walks the whole ring every step; with limit 1 every step's window fills
    at its first position, so a step walks no more than its first chunk
    (at most the cluster's 16 x 1,024 positions), and adding to the count
    accumulates across calls."""
    a = 200
    for limit, lo, hi in [(None, a * n, a * n), (1, a, a * min(n, 16 * 1024))]:
        args, init = _roomy(n, a, limit)
        ga, gs = tk.from_numpy(args, cuda_device), tk.from_numpy(init, cuda_device)
        walked = torch.zeros(1, dtype=torch.int64, device=cuda_device)
        got_state, got = tk.plan_batch(ga, gs, n, walked=walked)
        first = int(walked.item())
        assert lo <= first <= hi
        tk.plan_batch(ga, gs, n, walked=walked)
        assert int(walked.item()) == 2 * first
        want_state, want = tk.plan_batch_ref(ga, gs, n)
        _same(got, want)
        for g, w in zip(got_state, want_state):
            _same(g, w)


def _many_classes(V, n=20_000, a=96, seed=39):
    """Spread over ``V`` classes (most nodes a class of their own)."""
    args, init = problems.exact_problem(problems.build_cluster(n, a, n_values=V, seed=seed))
    rng = np.random.default_rng(seed)
    init["spread_counts"] = rng.integers(0, 3, init["spread_counts"].shape).astype(np.int32)
    init["spread_present"] = init["spread_counts"] > 0
    return args, init


@pytest.mark.gpu
@pytest.mark.parametrize("V", [16_384, tk.SCAN_MAX_CLASSES])
def test_exact_scan_many_spread_classes(V, cuda_device):
    """Spread boosts for more classes than the default 48 KB of a block's
    shared memory holds."""
    args, init = _many_classes(V)
    a, s = tk.from_numpy(args, cuda_device), tk.from_numpy(init, cuda_device)
    got_state, got = tk.plan_batch(a, s, 20_000)
    want_state, want = tk.plan_batch_ref(a, s, 20_000)
    _same(got, want)
    for g, w in zip(got_state, want_state):
        _same(g, w)
    assert (want.cpu() >= 0).any()


@pytest.mark.gpu
def test_exact_scan_plans_classes_past_shared_memory(cuda_device):
    """Past the classes whose boosts fit shared memory the kernel no longer
    refuses: it takes each position's boost from the classes' count range,
    and places as the plain version does."""
    args, init = _many_classes(tk.SCAN_MAX_CLASSES + 1, n=2_000, a=4)
    a, s = tk.from_numpy(args, cuda_device), tk.from_numpy(init, cuda_device)
    got_state, got = tk.plan_batch(a, s, 2_000)
    want_state, want = tk.plan_batch_ref(a, s, 2_000)
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


def _small_nodes(n, a, seed):
    """Nodes that hold 2-3 allocs each: the ring exhausts."""
    c = problems.build_cluster(n, a, seed=seed)
    c["capacity"][:, 0] = np.where(np.arange(n) % 2, 400, 300)
    c["usable"][:, 0] = c["capacity"][:, 0] - c["reserved"][:, 0]
    return c


def _wide_rows(c, cols):
    """The cluster with ``cols`` resource columns (roomy extra columns)."""
    n = c["capacity"].shape[0]
    extra = cols - c["capacity"].shape[1]
    c = dict(c, capacity=np.concatenate([c["capacity"], np.full((n, extra), 50, np.int32)], 1),
             reserved=np.concatenate([c["reserved"], np.zeros((n, extra), np.int32)], 1))
    return dict(c, demand=np.concatenate([c["demand"], np.ones(extra, np.int32)]))


#: the cluster kernel's edge shapes (tests/test_torch_windowed_walk.py
#: models them against JAX): (cluster, n_real, allocs padded, limit).
#: With 16 blocks of 6 positions, L = 10 spans three blocks; the cursor
#: lands inside blocks; L = 200 exceeds a round's feasible count; the
#: small nodes exhaust the ring; 5 columns stay in registers, 7 take the
#: rows from global records; 20,000 positions hold 2 a thread and 40,000
#: (2,500 a block) take the global records and window keys.
WINDOWED_EDGE_CASES = {
    "l2": (lambda: problems.build_cluster(96, 127, seed=8), 96, 128, 2),
    "l10_spans_3": (lambda: problems.build_cluster(96, 127, seed=8), 96, 128, 10),
    "l1": (lambda: problems.build_cluster(96, 127, seed=9), 96, 128, 1),
    "l0": (lambda: problems.build_cluster(96, 127, seed=9), 96, 128, 0),
    "short_l200": (lambda: problems.build_cluster(96, 40, seed=10), 96, 64, 200),
    "exhaust_l3": (lambda: _small_nodes(96, 400, seed=11), 96, 512, 3),
    "padded_l4": (lambda: problems.pad_cluster(problems.build_cluster(90, 200, seed=12), 96),
                  90, 256, 4),
    "ring_97_l7": (lambda: problems.build_cluster(97, 300, seed=13), 97, 512, 7),
    "c5": (lambda: _wide_rows(problems.build_cluster(3000, 5000, seed=14), 5), 3000, 8192, 10),
    "c7": (lambda: _wide_rows(problems.build_cluster(3000, 5000, seed=14), 7), 3000, 8192, 10),
    "two_a_thread": (lambda: problems.build_cluster(20_000, 30_000, seed=15), 20_000, 32768, 3),
    "past_registers": (lambda: problems.build_cluster(40_000, 60_000, seed=16), 40_000, 65536,
                       3),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(WINDOWED_EDGE_CASES))
def test_windowed_cluster_edge_shapes(case, cuda_device):
    build, n_real, a_pad, limit = WINDOWED_EDGE_CASES[case]
    args, used0, coll0 = problems.window_problem(build(), limit=limit)
    wa = tk.from_numpy(args, cuda_device)
    u, cl = tk.from_numpy((used0, coll0), cuda_device)
    before = tk.LAUNCHES["windowed"]
    got, got_rounds = tk.plan_batch_windowed(wa, u, cl, n_real, a_pad)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["windowed"] == before + 1
    want, want_rounds = tk.plan_batch_windowed_ref(wa, u, cl, n_real, a_pad)
    _same(got, want)
    assert int(got_rounds) == want_rounds
    _same(u, tk.from_numpy(used0, cuda_device))  # the kernel writes no input
    if case == "exhaust_l3":
        assert (want.cpu() < 0).any()  # the ring ran out before the allocs


def _count_tile(T, C, seed, aligned=True):
    """One tile of sweep 1's inputs on the card: T rows of C columns;
    ``aligned=False`` starts the row planes 4 bytes past a 16-byte
    boundary."""
    rng = np.random.default_rng(seed)
    cap = rng.integers(8, 64, size=(T, C)).astype(np.int32)
    used = (cap * rng.uniform(0.5, 1.1, size=(T, C))).astype(np.int32)
    feas = rng.random(T) < 0.9
    demand = rng.integers(1, 4, size=C).astype(np.int32)

    def put(x):
        t = torch.from_numpy(x)
        if aligned:
            return t.to(cuda)
        flat = torch.empty(x.size + 1, dtype=t.dtype, device=cuda)
        flat[1:] = t.reshape(-1).to(cuda)
        return flat[1:].view(x.shape)

    cuda = torch.device("cuda")
    return put(cap), torch.from_numpy(feas).to(cuda), put(used), torch.from_numpy(demand).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("T,C,aligned", [(1000, 4, True), (1000, 4, False), (1000, 3, True),
                                         (1000, 5, True), (70_000, 4, True), (3, 4, True)])
def test_tile_count_one_launch(T, C, aligned, cuda_device):
    """Sweep 1 into an ``out`` full of garbage, on a tile whose ring ends
    inside it (t0 + T > n_real) with the cursor inside it, twice in a row
    (the ticket word is cleared by the launch's last block): one launch a
    call and the plain version's counts."""
    cap, feas, used, demand = _count_tile(T, C, seed=T + C, aligned=aligned)
    t0, n_real, offset = 5_000, 5_000 + T - T // 3, 5_000 + T // 2
    want = paging.tile_count_ref(cap, feas, used, demand, t0, offset, n_real)
    assert int(want[1]) > 0 or T < 10
    for _ in range(2):
        out = torch.full((2,), -123_456, dtype=torch.int32, device=cuda_device)
        before = tk.LAUNCHES["tile_count"]
        got = paging.tile_count(cap, feas, used, demand, t0, offset, n_real, out=out)
        torch.cuda.synchronize()
        assert tk.LAUNCHES["tile_count"] == before + 1 and got is out
        _same(got, want)
    with pytest.raises(ValueError):
        paging.tile_count(cap, feas, used, demand, t0, offset, n_real,
                          out=torch.empty(3, dtype=torch.int32, device=cuda_device))


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


def _tile_round(T, offset, w_use_div, c=4, dead_tile=None, n=4_700, limit=5, seed=38):
    """Every tile of one round of the paged planner over an ``n``-row ring
    in ``T``-row tiles, as tile_window's arguments: the counts, flat bases,
    x0, total and w_use of a round with the cursor at ``offset``; w_use is
    the round's windows divided by ``w_use_div``; tile ``dead_tile`` has no
    feasible row."""
    capacity, usable, feasible, perm, demand, gc, _, _, used0, coll0, _, _ = problems.paged_case(
        seed, n, 100, limit=limit, c=c)
    n_tiles = -(-n // T)
    rows = n_tiles * T
    ring = np.arange(rows)
    real = ring < n

    def gathered(plane, fill):
        out = np.full((rows, *plane.shape[1:]), fill, plane.dtype)
        out[real] = plane[perm]
        return out

    cap_r, usable_r = gathered(capacity, 0), gathered(usable, 1.0)
    feas_r, used_r, coll_r = gathered(feasible, False), gathered(used0, 2**30), gathered(coll0, 0)
    nodes_r = np.where(real, np.concatenate([perm, np.zeros(rows - n, np.int32)]), 0)
    if dead_tile is not None:
        feas_r[dead_tile * T:(dead_tile + 1) * T] = False
    tiles = []
    for t in range(n_tiles):
        sl = slice(t * T, (t + 1) * T)
        tiles.append(tuple(torch.from_numpy(np.ascontiguousarray(x[sl])) for x in
                           (cap_r, usable_r, feas_r, used_r, coll_r, nodes_r.astype(np.int32))))
    dem = torch.from_numpy(demand)
    counts = np.array([paging.tile_count_ref(cp, f, u, dem, t * T, offset, n).numpy()
                       for t, (cp, _, f, u, _, _) in enumerate(tiles)], np.int64)
    total, x0 = int(counts[:, 0].sum()), int(counts[:, 1].sum())
    flat_base = np.concatenate([[0], np.cumsum(counts[:, 0])[:-1]])
    w_use = max(total // max(limit, 1) // w_use_div, 1)
    return [(*tiles[t], dem, int(gc), limit, t * T, offset, n, int(flat_base[t]), x0, total,
             w_use) for t in range(n_tiles)]


#: cursor (0: no row wrapped; 3,100: tiles 0-2 all wrapped, tile 3
#: straddles; the ring's end: every row wrapped), w_use (every window, or a
#: third of them: the last window ends inside a tile), columns, dead tile
TILE_EDGE_CASES = {
    "none_wrapped": (0, 1, 4, None),
    "straddle_all_windows": (3_100, 1, 4, 2),
    "straddle_third_windows": (3_100, 3, 4, 1),
    "all_wrapped": (4_699, 1, 4, None),
    "five_columns": (2_500, 2, 5, 4),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(TILE_EDGE_CASES))
def test_tile_window_kernel_edge_tiles(case, cuda_device):
    """The window sweep on every tile of a round of 1,000-row tiles (not a
    multiple of the kernel's 1,024-row blocks), against its plain version."""
    offset, w_use_div, c, dead = TILE_EDGE_CASES[case]
    for args in _tile_round(1_000, offset, w_use_div, c=c, dead_tile=dead):
        on_card = [x.to(cuda_device) if isinstance(x, torch.Tensor) else x for x in args]
        before = tk.LAUNCHES["tile_window"]
        got = paging.tile_window(*on_card)
        torch.cuda.synchronize()
        assert tk.LAUNCHES["tile_window"] == before + 1
        want = paging.tile_window_ref(*args)
        for g, w in zip(got, want):
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


# ---------------------------------------------------------------------------
# the wavefront as a cluster per lane that stops at its window, and the
# dirty-row scatter as one launch
# ---------------------------------------------------------------------------

#: (window, candidates per lane): one lane, a few, the default, and more
#: lanes than clusters of one block fit on the card (they take turns)
WAVE_SHAPES = [(1, 1), (8, 1), (32, 1), (32, 3), (200, 1), (200, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("window,top_m", WAVE_SHAPES)
@pytest.mark.parametrize("case", sorted(SCAN_WALK_CASES))
def test_wavefront_walk_matches_plain(case, window, top_m, cuda_device):
    """Small and full-ring limits, rings shorter than a chunk and of several
    chunks, replays, invalid lanes: placements, final state and rounds of
    the plain version, and the sequential scan's placements and state."""
    args, init = SCAN_WALK_CASES[case]()
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
    scan_state, scan = tk.plan_batch(a, s, n_real)
    _same(got, scan)
    for g, w in zip(got_state, scan_state):
        _same(g, w)


def _positions_needed(a, s, n_real):
    """The ring positions the placements need, over the valid lanes: each
    lane's consumed prefix (the plain scan lane by lane on the CPU), or its
    whole ring where the window does not fill."""
    args = tk.BatchArgs(*(t.cpu() for t in a))
    state = tk.BatchState(*(t.cpu() for t in s))
    needed = 0
    for i in np.flatnonzero(args.valid.numpy()):
        e = int(args.group_eval[args.groups[i]])
        ring, off = int(args.ring[e]), int(state.offset[e])
        one = args._replace(demands=args.demands[i:i + 1], groups=args.groups[i:i + 1],
                            limits=args.limits[i:i + 1], valid=args.valid[i:i + 1])
        state, _ = tk.plan_batch_ref(one, state, n_real)
        needed += (int(state.offset[e]) - off) % max(ring, 1) or ring
    return needed


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["drain_limit14", "drain_tenant", "ring_40000", "invalid_lanes"])
def test_wavefront_counts_its_walk(case, cuda_device):
    """The kernel counts the ring positions its committed lanes walked: at
    least what the placements need, no more than whole rings, and a limit
    of 14 stops short of them; the count adds up across calls."""
    args, init = SCAN_WALK_CASES[case]()
    a, s = tk.from_numpy(args, cuda_device), tk.from_numpy(init, cuda_device)
    n_real = int(args["ring"].max())
    walked = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    got_state, got, _ = wavefront.plan_batch_wavefront(a, s, n_real, walked=walked)
    first = int(walked.item())
    valid = args["valid"]
    whole = int(args["ring"][args["group_eval"][args["groups"]]][valid].sum())
    assert _positions_needed(a, s, n_real) <= first <= whole
    if case == "drain_limit14":
        assert first < whole
    wavefront.plan_batch_wavefront(a, s, n_real, walked=walked)
    assert int(walked.item()) == 2 * first
    scan_state, scan = tk.plan_batch(a, s, n_real)
    _same(got, scan)
    for g, w in zip(got_state, scan_state):
        _same(g, w)


@pytest.mark.gpu
def test_wavefront_plans_past_its_budgets(cuda_device):
    """Spread classes and candidates past the shared-memory and register
    budgets take the kernel's other paths and place as the plain version;
    what no path takes still raises: a walk counter of the wrong shape, and
    more resource columns than a lane keeps in registers."""
    args, init = problems.wavefront_problem(problems.build_cluster(200, 64, seed=3), n_groups=4)
    a, s = tk.from_numpy(args, cuda_device), tk.from_numpy(init, cuda_device)
    wavefront.configure(contention_top_m=wavefront.WAVE_MAX_TOP_M + 1)
    got_state, got, rounds = wavefront.plan_batch_wavefront(a, s, 200)
    want_state, want, want_rounds = wavefront.plan_batch_wavefront_ref(
        a, s, 200, wavefront.window_for(64), wavefront.WAVE_MAX_TOP_M + 1, 1)
    _same(got, want)
    assert int(rounds) == want_rounds
    wavefront.reset()
    with pytest.raises(ValueError, match="walked"):
        wavefront.plan_batch_wavefront(a, s, 200, walked=torch.zeros(2, dtype=torch.int64,
                                                                     device=cuda_device))
    wide = _with_devices(args, init)
    wide = (dict(wide[0], capacity=np.repeat(wide[0]["capacity"], 2, axis=1)[:, :7],
                 demands=np.repeat(wide[0]["demands"], 2, axis=1)[:, :7]),
            dict(wide[1], used=np.repeat(wide[1]["used"], 2, axis=1)[:, :7]))
    a, s = tk.from_numpy(wide[0], cuda_device), tk.from_numpy(wide[1], cuda_device)
    with pytest.raises(ValueError, match="resource columns"):
        wavefront.plan_batch_wavefront(a, s, 200)


@pytest.mark.gpu
def test_wavefront_cluster_shape(cuda_device):
    """Q is the largest power of two at which W clusters fit; a window
    wider than the card's clusters of one block takes them in turn."""
    shapes = {w: wavefront.cluster_shape(w, 4, 1, cuda_device) for w in (1, 8, 32, 200, 4096)}
    for w, (q, clusters, _) in shapes.items():
        assert q in (1, 2, 4, 8, 16) and 1 <= clusters <= w
        assert clusters == w or q == 1
    assert shapes[1][0] >= shapes[8][0] >= shapes[32][0] >= shapes[200][0]
    assert shapes[4096][1] < 4096


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 64, 512, 4096])
def test_scatter_rows_one_launch_per_bucket(rows, cuda_device):
    """Every row bucket of DeviceState, duplicate rows with differing
    values, rows outside [0, N), N not a multiple of a block's rows: the
    plain version's plane, from one launch."""
    from nomad_tpu_torch.tpu import mirror

    rng = np.random.default_rng(rows)
    N = 10_000
    r = rng.integers(0, N, rows).astype(np.int32)
    r[: rows // 4] = r[rows // 4: rows // 2]  # duplicates, with their own values
    r[-1], r[-2] = -1, N
    vals = rng.integers(0, 2**30, (rows, 4)).astype(np.int32)
    used = torch.from_numpy(rng.integers(0, 2**30, (N, 4)).astype(np.int32)).to(cuda_device)
    t = [torch.from_numpy(x).to(cuda_device) for x in (r, vals)]
    before = tk.LAUNCHES["scatter_rows"]
    got = mirror.scatter_rows(used, *t)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["scatter_rows"] == before + 1
    _same(got, mirror.scatter_rows_ref(used, *t))


# ---------------------------------------------------------------------------
# C1: what the reference plans past the kernels' shared-memory and register
# budgets, and the run planner as one thread block cluster
# ---------------------------------------------------------------------------

def _classes_past_shared(V=tk.SCAN_MAX_CLASSES + 1, n=300, a=64, seed=41):
    """Four groups spread over ``V`` classes (the plane's width), with
    counts already on a random third of them."""
    args, init = problems.wavefront_problem(problems.build_cluster(n, a, n_values=V, seed=seed),
                                            n_groups=4)
    rng = np.random.default_rng(seed)
    init["spread_counts"] = (rng.integers(0, 3, init["spread_counts"].shape)
                             * (rng.random(init["spread_counts"].shape) < 0.3)).astype(np.int32)
    init["spread_present"] = init["spread_counts"] > 0
    return args, init


@pytest.mark.gpu
@pytest.mark.parametrize("planner_on", ["exact", "wavefront"])
def test_scan_and_wavefront_past_shared_classes(planner_on, cuda_device):
    """V = 49,153: one class more than every block's shared memory holds
    boosts for; placements and state of the plain version."""
    args, init = _classes_past_shared()
    a, s = tk.from_numpy(args, cuda_device), tk.from_numpy(init, cuda_device)
    n_real = int(args["ring"].max())
    if planner_on == "exact":
        got_state, got = tk.plan_batch(a, s, n_real)
        want_state, want = tk.plan_batch_ref(a, s, n_real)
    else:
        got_state, got, rounds = wavefront.plan_batch_wavefront(a, s, n_real)
        want_state, want, want_rounds = wavefront.plan_batch_wavefront_ref(
            a, s, n_real, wavefront.window_for(len(args["groups"])), 1, 1)
        assert int(rounds) == want_rounds
    _same(got, want)
    for g, w in zip(got_state, want_state):
        _same(g, w)
    assert (want.cpu() >= 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("window", [8, 32])
@pytest.mark.parametrize("top_m", [5, 16])
@pytest.mark.parametrize("case", ["drain_limit14", "few_feasible_replay", "invalid_lanes",
                                  "nonpositive_heavy", "ring_3000"])
def test_wavefront_more_candidates_than_registers(case, top_m, window, cuda_device):
    """M = 5 and 16: each thread's best M - 1 keys in a list in global
    memory; placements, state and rounds of the plain version."""
    args, init = SCAN_WALK_CASES[case]()
    wavefront.configure(max_round=window, contention_top_m=top_m)
    a, s = tk.from_numpy(args, cuda_device), tk.from_numpy(init, cuda_device)
    n_real = int(args["ring"].max())
    got_state, got, rounds = wavefront.plan_batch_wavefront(a, s, n_real)
    W = wavefront.window_for(len(args["groups"]))
    want_state, want, want_rounds = wavefront.plan_batch_wavefront_ref(a, s, n_real, W, top_m, 1)
    _same(got, want)
    for g, w in zip(got_state, want_state):
        _same(g, w)
    assert int(rounds) == want_rounds


@pytest.mark.gpu
def test_wavefront_window_past_shared_records(cuda_device):
    """W = 5,462 at M = 1: 5,462 x 9 record ints, past a block's shared
    memory, so each block keeps its copy of the window's records in global
    memory; 64 groups on disjoint slices commit up to 64 lanes a round."""
    W = 5_462
    args, init = problems.wavefront_problem(problems.build_cluster(2_048, W, seed=42),
                                            n_groups=64, overlap=0)
    wavefront.configure(max_round=W, contention_top_m=1)
    a, s = tk.from_numpy(args, cuda_device), tk.from_numpy(init, cuda_device)
    assert wavefront.window_for(W) == W
    got_state, got, rounds = wavefront.plan_batch_wavefront(a, s, 2_048)
    want_state, want, want_rounds = wavefront.plan_batch_wavefront_ref(a, s, 2_048, W, 1, 1)
    _same(got, want)
    for g, w in zip(got_state, want_state):
        _same(g, w)
    assert int(rounds) == want_rounds < W


def _uniform_runs(n, a, seed=43):
    """One group spread over 4 values on ``n`` identical roomy nodes: the
    first round's sweep accepts a lane on most of them."""
    c = problems.build_cluster(n, a, seed=seed)
    c["feasible"][:] = True
    c["capacity"][:] = [16000, 32768, 100 * 1024, 1000]
    c["usable"][:] = [15900, 32512]
    return problems.runs_problem(c, affinity=False, spread=True)


#: the cluster's cases: a ring that 16 does not divide, a sweep of more
#: than one block's 640 positions, more classes than shared memory holds
#: (class arrays and tie counts in global memory), more than 1,024 positions
#: a block (round records in global memory)
RUNS_CLUSTER_CASES = {
    "ring_3001": lambda: _runs_case(n=3001, a=6000, seed=44),
    "sweep_past_640": lambda: _uniform_runs(12_000, 30_000),
    "classes_49153": lambda: problems.runs_problem(
        problems.build_cluster(300, 1000, n_values=tk.SCAN_MAX_CLASSES + 1, seed=45),
        affinity=False),
    "ring_20000": lambda: _runs_case(n=20_000, a=6000, seed=46),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(RUNS_CLUSTER_CASES))
def test_runs_cluster_matches_plain(case, cuda_device):
    args, init = RUNS_CLUSTER_CASES[case]()
    a, i = tk.from_numpy(args, cuda_device), tk.from_numpy(init, cuda_device)
    a_pad = problems.bucket(int(args["n_allocs"]))
    before = tk.LAUNCHES["runs"]
    got, got_rounds = tk.plan_batch_runs(a, i, a_pad)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["runs"] == before + 1
    want, want_rounds = tk.plan_batch_runs_ref(a, i, a_pad)
    _same(got, want)
    assert int(got_rounds) == want_rounds
    if case == "sweep_past_640":
        # rounds follow one trajectory whatever the alloc count, but for
        # the last one's cut: 100 allocs take as many rounds as 2,000, so
        # one round placed more than 1,900 lanes, more than a fill run's
        # RUNCAP: a sweep of more than a block's 640 positions
        rounds = [tk.plan_batch_runs_ref(
            a._replace(n_allocs=torch.tensor(k, dtype=torch.int32, device=cuda_device)), i,
            problems.bucket(k))[1] for k in (100, 2000)]
        assert rounds[0] == rounds[1]


# ---------------------------------------------------------------------------
# the score primitives alone (csrc/primitives.cu)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("V", [4, tk.SCAN_MAX_CLASSES + 1])
def test_primitives_match_plain(V, cuda_device):
    """Each primitive over a 10,000-node plane, one launch each: the plain
    version's bits."""
    args, init = _classes_past_shared(V=V, n=10_000, a=64)
    a, s = tk.from_numpy(args, cuda_device), tk.from_numpy(init, cuda_device)
    rng = np.random.default_rng(V)
    before = {k: tk.LAUNCHES[k] for k in ("binpack", "class_boosts", "scores", "rot_incl")}
    fc, fm = (torch.from_numpy(rng.uniform(-1.5, 1.0, 10_000).astype(np.float32)).to(cuda_device)
              for _ in range(2))
    _same(tk.binpack(fc, fm), tk._binpack(fc, fm))
    for g in range(2):
        boost_args = (s.spread_counts[g], s.spread_present[g], a.spread_desired[g],
                      a.spread_implicit[g], a.spread_weight_frac[g], a.spread_even[g],
                      a.spread_active[g])
        _same(tk.class_boosts(*boost_args), tk._class_boosts(*boost_args))
        _same(tk.scores(a, s, g, a.demands[g]), tk._scores(a, s, g, a.demands[g]))
    x = torch.from_numpy(rng.random(10_000) < 0.3).to(cuda_device)
    for offset in (0, 4_321):
        positions = torch.arange(10_000, dtype=torch.int32, device=cuda_device)
        _same(tk.rot_incl(x, offset),
              tk._rot_incl(x, offset, x.to(torch.int32).sum(dtype=torch.int32), positions))
    torch.cuda.synchronize()
    assert {k: tk.LAUNCHES[k] - n for k, n in before.items()} == dict(
        binpack=1, class_boosts=2, scores=2, rot_incl=2)


# ---------------------------------------------------------------------------
# the usage bases as one launch that writes each base once, and the dense
# verify as one launch with its row sums in shared memory
# ---------------------------------------------------------------------------

def _bases_lanes(E, C=4, A=2048, N=4096, n_real=4000, kind="mid", seed=0):
    """(used0, placements, demands, eval_of, n_real) as numpy: ``mid`` random
    lanes with unplaced ones and lanes on pad nodes, ``one_node`` every lane
    on one node, ``unplaced`` no lane placed, ``out_of_order`` evals in
    descending order with some outside [0, E)."""
    rng = np.random.default_rng(seed)
    used0 = rng.integers(0, 10**5, (N, C)).astype(np.int32)
    used0[n_real:] = 2**30
    placements = rng.integers(0, N, A).astype(np.int32)
    placements[::7] = -1
    eval_of = np.sort(rng.integers(0, E, A)).astype(np.int32)
    if kind == "one_node":
        placements[:] = 7
    elif kind == "unplaced":
        placements[:] = -1
    elif kind == "out_of_order":
        eval_of = eval_of[::-1].copy()
        eval_of[::5] = rng.choice([-1, E, E + 3, -(2**31)], len(eval_of[::5]))
    demands = rng.integers(0, 900, (A, C)).astype(np.int32)
    return used0, placements, demands, eval_of, n_real


#: (E, C, A, N, kind): E 1, the drain batches' 32, the evals around the
#: shared-memory budget at a block's first width (82 fit 124 ints, 83 take
#: half), an E past it at the narrowest slice (4,000: two chunks of
#: evals); C 1, 2, 5 (a node's columns straddle two blocks) and 6; A 0;
#: the edge lanes
BASES_CASES = [
    (1, 4, 2048, 4096, "mid"), (32, 4, 4096, 10_240, "mid"), (82, 4, 512, 4096, "mid"),
    (83, 4, 512, 4096, "mid"), (4_000, 4, 300, 64, "mid"), (32, 1, 1024, 4096, "mid"),
    (32, 2, 1024, 4096, "mid"), (32, 5, 1024, 4096, "mid"), (32, 6, 1024, 4096, "mid"),
    (32, 4, 0, 4096, "mid"), (32, 4, 2048, 4096, "one_node"), (32, 4, 2048, 4096, "unplaced"),
    (32, 4, 2048, 4096, "out_of_order"), (16, 5, 777, 4097, "mid"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("E,C,A,N,kind", BASES_CASES)
def test_used_bases_one_launch(E, C, A, N, kind, cuda_device):
    """The plain version's bases bit for bit, from one launch."""
    from nomad_tpu_torch.tpu import drain

    used0, placements, demands, eval_of, n_real = _bases_lanes(
        E, C, A, N, N - 96 if N > 96 else N, kind)
    t = [torch.from_numpy(a).to(cuda_device) for a in (used0, placements, demands, eval_of)]
    want = drain.used_bases_ref(*t, E, n_real)
    before = tk.LAUNCHES["used_bases"]
    got = drain.used_bases(*t, E, n_real)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["used_bases"] == before + 1
    _same(got, want)


@pytest.mark.gpu
def test_used_bases_unaligned_planes(cuda_device):
    """Planes and lanes that start off a 16-byte boundary (the lanes take
    the kernel's 4-byte loads) give the same bases."""
    from nomad_tpu_torch.tpu import drain

    E, C, A, N = 8, 4, 1001, 2048
    used0, placements, demands, eval_of, n_real = _bases_lanes(E, C, A, N, 2000)
    flat = torch.from_numpy(np.concatenate([[0], used0.ravel()]).astype(np.int32)).to(cuda_device)
    lanes = torch.from_numpy(np.concatenate([[0], placements]).astype(np.int32)).to(cuda_device)
    u, p = flat[1:].view(N, C), lanes[1:]
    d, e = (torch.from_numpy(a).to(cuda_device) for a in (demands, eval_of))
    assert u.data_ptr() % 16 and p.data_ptr() % 16
    got = drain.used_bases(u, p, d, e, E, n_real)
    torch.cuda.synchronize()
    _same(got, drain.used_bases_ref(u, p, d, e, E, n_real))


def _verify_lanes_case(R, N=10_240, C=4, kind="mid", seed=0):
    """(capacity, used, rows, deltas) as numpy, R lanes: ``mid`` a
    quarter real rows with duplicates and the rest pad lanes (row 0, a
    delta of 0), ``one_row`` every lane on one row with deltas that sum to
    its room, ``outside`` rows outside [0, N) among the real ones."""
    rng = np.random.default_rng(seed + R)
    capacity = rng.integers(1000, 9000, (N, C)).astype(np.int32)
    used = (capacity - rng.integers(0, 700, (N, C))).astype(np.int32)
    k = max(1, R // 4)
    rows = np.zeros(R, np.int32)
    rows[:k] = rng.integers(0, N, k)
    if k > 4:
        rows[1:4] = rows[0]
    deltas = np.zeros((R, C), np.int32)
    deltas[:k] = rng.integers(-300, 300, (k, C))
    if kind == "one_row":  # the deltas sum to the row's room exactly: every lane fits
        rows[:] = one = min(5, N - 1)
        deltas = rng.integers(-3, 4, (R, C)).astype(np.int32)
        deltas[-1] = capacity[one] - used[one] - deltas[:-1].sum(axis=0)
    elif kind == "outside":
        rows[: k: 3] = rng.choice([-1, N, N + 7, -(2**31)], len(rows[: k: 3]))
    return capacity, used, rows, deltas


#: (R, N, C, kind): R 1, 512 and 4,096 (a thread's lanes in registers)
#: and 8,192, 65,536 and 69,632 (read again) over N 10,240 (8 blocks),
#: 100,000 (the rows' sums past one block's shared memory), 1,000,000 and
#: 5 (fewer rows than blocks); C 5 and 1
VERIFY_CASES = [
    (1, 10_240, 4, "mid"), (512, 10_240, 4, "mid"), (4096, 10_240, 4, "mid"),
    (8192, 10_240, 4, "mid"), (65_536, 100_000, 4, "mid"), (69_632, 100_000, 4, "mid"),
    (4096, 1_000_000, 4, "mid"), (512, 5, 4, "one_row"), (4096, 10_240, 4, "one_row"),
    (4096, 100_000, 4, "one_row"), (4096, 10_240, 4, "outside"), (8192, 10_240, 4, "outside"),
    (69_632, 100_000, 4, "outside"), (4096, 10_240, 5, "mid"), (4096, 100_000, 5, "mid"),
    (512, 10_240, 1, "mid"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("R,N,C,kind", VERIFY_CASES)
def test_verify_rows_one_launch(R, N, C, kind, cuda_device):
    """The plain version's verdicts, from one launch whose blocks own every
    row, twice in a row with the lanes reversed."""
    shape = tk.verify_shape(N, C)
    limit = torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin
    assert shape["blocks"] >= min(8, N) and shape["blocks"] * shape["rows"] >= N
    assert shape["rows"] * C * 4 <= limit
    t = [torch.from_numpy(a).to(cuda_device) for a in _verify_lanes_case(R, N, C, kind)]
    kept = t[1].clone()
    want = tk.verify_rows_ref(*t)
    before = tk.LAUNCHES["verify_rows"]
    got = tk.verify_rows(*t)
    again = tk.verify_rows(t[0], t[1], t[2].flip(0).contiguous(), t[3].flip(0).contiguous())
    torch.cuda.synchronize()
    assert tk.LAUNCHES["verify_rows"] == before + 2
    _same(got, want)
    _same(again, want.flip(0))
    _same(t[1], kept)
    if kind == "outside":
        assert not bool(want[t[2] < 0].any()) and not bool(want[t[2] >= N].any())
    assert bool(want.any())


@pytest.mark.gpu
def test_verify_rows_unaligned_lanes(cuda_device):
    """Deltas that start off a 16-byte boundary take the general path."""
    capacity, used, rows, deltas = _verify_lanes_case(4096)
    flat = torch.from_numpy(np.concatenate([[0], deltas.ravel()]).astype(np.int32)).to(cuda_device)
    d = flat[1:].view(4096, 4)
    c, u, r = (torch.from_numpy(a).to(cuda_device) for a in (capacity, used, rows))
    assert d.data_ptr() % 16
    got = tk.verify_rows(c, u, r, d)
    torch.cuda.synchronize()
    _same(got, tk.verify_rows_ref(c, u, r, d))


@pytest.mark.gpu
def test_dense_verify_on_device_state(cuda_device):
    """``dense_verify`` on a DeviceState's planes on the card against the
    same call on the CPU's, before and after a refresh."""
    from nomad_tpu_torch.core import plan_apply
    from nomad_tpu_torch.tpu import mirror

    rng = np.random.default_rng(5)
    n = 3000
    capacity = rng.integers(1000, 9000, (n, 4))
    used = capacity - rng.integers(0, 700, (n, 4))
    rows = rng.choice(n, 600, replace=False)
    deltas = list(rng.integers(-300, 400, (600, 4)))
    used_host = np.full((3072, 4), 2**30, np.int64)
    used_host[:n] = used + rng.integers(0, 300, (n, 4))
    dirty = rng.choice(n, 900, replace=False)
    out = {}
    for dev in ("cpu", cuda_device):
        ds = mirror.DeviceState(0, 3072, capacity, np.ones((n, 2)), used, device=dev)
        first = plan_apply.dense_verify(ds.arrays(), rows, deltas)
        ds.pending.update(int(r) for r in dirty)
        ds.refresh(used_host)
        out[str(dev)] = (first, plan_apply.dense_verify(ds.arrays(), rows, deltas))
    cpu, card = out["cpu"], out[str(cuda_device)]
    for want, got in zip(cpu, card):
        np.testing.assert_array_equal(got, want)
        assert want.any() and not want.all()
    assert not np.array_equal(cpu[0], cpu[1])


# ---------------------------------------------------------------------------
# the scheduler front: the port's tpu-batch on the card against the CPU
# ---------------------------------------------------------------------------

def _sched_cluster(n, dcs, devices=False):
    import random

    from nomad_tpu_torch import mock

    rng = random.Random(99)
    nodes = []
    for i in range(n):
        node = mock.tpu_node() if devices and i % 4 == 0 else mock.node()
        node.node_resources.cpu.cpu_shares = rng.choice([2000, 4000, 8000])
        node.node_resources.memory.memory_mb = rng.choice([4096, 8192, 16384])
        node.datacenter = f"dc{i % dcs + 1}"
        nodes.append(node)
    return [nd.to_dict() for nd in nodes]


def _sched_job(count, dcs, spread=False, groups=1, device=False):
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs.model import RequestedDevice, Spread, SpreadTarget, TaskGroup

    job = mock.job()
    job.datacenters = [f"dc{i + 1}" for i in range(dcs)]
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.networks = []
    if device:
        tg.tasks[0].resources.devices = [RequestedDevice(name="tpu", count=1)]
    if spread:
        job.spreads = [Spread(attribute="${node.datacenter}", weight=100, spread_target=[
            SpreadTarget(value=d, percent=100 // dcs) for d in job.datacenters])]
    for g in range(1, groups):
        other = TaskGroup.from_dict(tg.to_dict())
        other.name = f"web{g}"
        other.tasks[0].resources.cpu += 50 * g
        job.task_groups.append(other)
    return job


#: shape -> (nodes, dcs, job kwargs, stanza, the mode the scheduler must count)
SCHED_SHAPES = {
    "runs": (300, 4, dict(count=1200, spread=True), None, "runs"),
    "windowed": (300, 4, dict(count=1200), None, "windowed"),
    "exact-scan": (300, 4, dict(count=40, groups=4), None, "exact-scan"),
    "wavefront": (300, 4, dict(count=40, groups=4), "wavefront", "wavefront"),
    "paged": (3000, 4, dict(count=2000), "paged", "paged"),
    "device": (300, 1, dict(count=30, groups=2, device=True), None, "exact-scan"),
}


def _sched_place(dev, node_docs, job, stanza, monkeypatch):
    from nomad_tpu_torch.scheduler import Harness
    from nomad_tpu_torch.state.carry import carry_state
    from nomad_tpu_torch.structs.model import Evaluation
    from nomad_tpu_torch.tpu import batch_sched

    ev = Evaluation(id="eval-1", namespace=job.namespace, priority=job.priority, type="service",
                    triggered_by="job-register", job_id=job.id, status="pending")
    h = Harness(state=carry_state([(1, "nodes", node_docs), (2, "job", job.to_dict()),
                                   (3, "evals", [ev.to_dict()])]), seed=5, device=dev)
    for _ in range(3):
        h.next_index()
    if stanza == "wavefront":
        wavefront.configure(enabled=True, max_round=32, contention_top_m=1)
    elif stanza == "paged":  # a budget below the planes
        paging.configure(enabled=True, tile_nodes=1024)
        monkeypatch.setattr(paging, "budget_mb", lambda: 0)
    before = batch_sched.counters_snapshot()["modes"]
    sched = h.process("tpu-batch", ev)
    after = batch_sched.counters_snapshot()["modes"]
    modes = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    placements = {a.name: a.node_id for a in h.state.allocs_by_job(job.namespace, job.id)}
    failed = {k: {f: x for f, x in m.to_dict().items() if f != "allocation_time"}
              for k, m in sched.failed_tg_allocs.items()}
    return placements, failed, modes, dict(batch_sched.LAST_KERNEL_STATS)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(SCHED_SHAPES))
def test_tpu_batch_on_the_card_places_as_on_the_cpu(shape, cuda_device, monkeypatch):
    """A real eval through the port's Harness on the card: the same
    placements, failure metrics and mode as through the plain versions,
    and the planner's kernels launched."""
    n, dcs, kw, stanza, mode = SCHED_SHAPES[shape]
    node_docs, job = _sched_cluster(n, dcs, devices=kw.get("device", False)), _sched_job(dcs=dcs, **kw)
    tk.reset_launches()
    got = _sched_place(cuda_device, node_docs, job, stanza, monkeypatch)
    launches = sum(tk.LAUNCHES.values())
    wavefront.reset()
    paging.reset()
    want = _sched_place("cpu", node_docs, job, stanza, monkeypatch)
    assert got[2] == want[2] == {mode: 1}
    assert got[0] == want[0] and got[0]
    assert got[1] == want[1]
    assert got[3]["launches"] == launches >= 1
    # one timing of the planner: its launches by events lie inside its
    # launch-to-sync span, which lies inside the dispatch
    assert 0 < got[3]["device_s"] <= got[3]["kernel_s"] <= got[3]["dispatch_s"]
    assert want[3]["device_s"] is None


# ---------------------------------------------------------------------------
# the server: evals through a running Server on the card against the CPU
# ---------------------------------------------------------------------------

def _port_server(dev, extra):
    from nomad_tpu_torch.core.server import Server
    from nomad_tpu_torch.raft import InmemTransport, RaftConfig

    cfg = {"seed": 42, "heartbeat_ttl": 600.0, **extra, "raft": {
        "node_id": "s0", "address": "raft0", "voters": {"s0": "raft0"},
        "transport": InmemTransport(),
        "config": RaftConfig(heartbeat_interval=0.02, election_timeout_min=0.05,
                             election_timeout_max=0.10)}}
    return Server(cfg, device=dev)


def _checked_verify(monkeypatch, mismatches):
    """Wrap the applier's device verify: each plan it answers is also
    answered by the host oracle on the same stacked snapshot, and every
    difference of the committed sets is recorded."""
    from nomad_tpu_torch.core import plan_apply

    real = plan_apply.Planner._evaluate_plan_device

    def sets(r):
        return ({k: sorted(a.id for a in v) for k, v in r.node_allocation.items()},
                {k: sorted(a.id for a in v) for k, v in r.node_update.items()},
                bool(r.refresh_index))

    def checked(self, dev_ctx, base_snap, plan, overlay_deltas, epoch, stacked_fn):
        got = real(self, dev_ctx, base_snap, plan, overlay_deltas, epoch, stacked_fn)
        if got is not None:
            checked.count += 1
            want = plan_apply.evaluate_plan(stacked_fn(), plan)
            if sets(got) != sets(want):
                mismatches.append(plan.eval_id)
        return got

    checked.count = 0
    monkeypatch.setattr(plan_apply.Planner, "_evaluate_plan_device", checked)
    return checked


def _server_run(dev, node_docs, jobs, extra, workers=1, later=()):
    """Register ``node_docs`` and ``jobs`` with no worker running, start
    ``workers`` workers, wait (60 s at most) for every eval, then register
    the ``later`` jobs one by one, each waited for; returns the sorted
    (job id, alloc name, node id) of every alloc (a system job's allocs
    share one name) and the server's mirror stats."""
    import time

    from nomad_tpu_torch.structs.model import Job, Node

    server = _port_server(dev, extra)

    def wait(ids):
        deadline = time.monotonic() + 60.0
        while True:
            evs = [server.state.eval_by_id(e) for e in ids]
            if all(e is not None and e.status == "complete" for e in evs):
                return
            assert time.monotonic() < deadline, [e and e.status for e in evs]
            time.sleep(0.02)

    try:
        server.start(num_workers=0, wait_for_leader=5.0)
        for d in node_docs:
            server.node_register(Node.from_dict(d))
        ids = [server.job_register(Job.from_dict(j.to_dict())) for j in jobs]
        server.start_workers(workers)
        wait(ids)
        for j in later:
            wait([server.job_register(Job.from_dict(j.to_dict()))])
        placed = sorted((j.id, a.name, a.node_id)
                        for j in (*jobs, *later) for a in server.state.allocs_by_job(j.namespace, j.id))
        return placed, server.columnar_mirror.stats()
    finally:
        server.stop()


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["exact", "wavefront"])
def test_server_drain_on_the_card_places_as_on_the_cpu(route, cuda_device, monkeypatch):
    """Eight jobs drained in one fused batch by a server on the card: the
    same placements as the same server on the CPU, every plan's device
    verify equal to the host oracle's, and the drain's kernels (scan or
    wavefront, usage bases), the verify and the dirty-row scatter launched."""
    from nomad_tpu_torch.tpu import drain

    node_docs = _sched_cluster(400, 4)
    jobs = [_sched_job(count=40 + 10 * i, dcs=4) for i in range(8)]
    extra = {"default_scheduler": "tpu-batch", "batch_drain": 8, "plan_apply_batch": 8,
             "plan_pipeline": {"device_verify_min": 1}}
    if route == "wavefront":
        extra["wavefront"] = {"enabled": True, "max_round": 32, "contention_top_m": 1}
    mismatches = []
    checked = _checked_verify(monkeypatch, mismatches)
    tk.reset_launches()
    before = dict(drain.DRAIN_COUNTERS)
    # a ninth job after the batch: its solo eval's verify reads planes
    # that the batch's commits dirtied, so the mirror scatters their rows
    later = [_sched_job(count=200, dcs=4)]
    got, stats = _server_run(cuda_device, node_docs, jobs, extra, later=later)
    launches = dict(tk.LAUNCHES)
    assert drain.DRAIN_COUNTERS["batches"] == before["batches"] + 1
    assert drain.LAST_DRAIN_STATS["device_state"] and drain.LAST_DRAIN_STATS["planner"] == route
    wavefront.reset()
    want, _ = _server_run("cpu", node_docs, jobs, extra, later=later)
    assert got == want and len(got) == sum(40 + 10 * i for i in range(8)) + 200
    # plans verified after a commit moved the planes past their snapshot
    # take the host (counted stale); the rest ride the device
    assert not mismatches and checked.count >= 2
    planner_kernel = "wavefront" if route == "wavefront" else "exact_scan"
    assert launches[planner_kernel] >= 1 and launches["used_bases"] >= 1
    assert launches["verify_rows"] >= 1
    assert launches["scatter_rows"] >= 1 and stats["refreshes"] >= 1


@pytest.mark.gpu
def test_server_solo_and_system_evals_on_the_card_place_as_on_the_cpu(cuda_device, monkeypatch):
    """A plain worker's solo tpu-batch evals (windowed and runs) and a
    tpu-system eval on the card: the same placements as on the CPU, the
    verify equal to the host oracle's."""
    from nomad_tpu_torch import mock

    node_docs = _sched_cluster(400, 4)
    sys_job = mock.system_job()
    sys_job.datacenters = ["dc1", "dc2", "dc3", "dc4"]
    sys_job.task_groups[0].tasks[0].resources.networks = []
    jobs = [_sched_job(count=600, dcs=4), _sched_job(count=600, dcs=4, spread=True), sys_job]
    extra = {"default_scheduler": "tpu-batch", "plan_pipeline": {"device_verify_min": 1}}
    mismatches = []
    checked = _checked_verify(monkeypatch, mismatches)
    tk.reset_launches()
    got, _ = _server_run(cuda_device, node_docs, jobs, extra)
    launches = dict(tk.LAUNCHES)
    want, _ = _server_run("cpu", node_docs, jobs, extra)
    assert got == want and len(got) == 1200 + 400
    assert not mismatches and checked.count >= 2
    assert launches["windowed"] >= 1 and launches["runs"] >= 1 and launches["verify_rows"] >= 1


# ---------------------------------------------------------------------------
# warm-up and the device ledger
# ---------------------------------------------------------------------------

def _ladder_keys(shapes) -> list:
    """The (planner, shape) ledger keys ``warmup.prewarm`` launches for
    ``shapes`` with no stanza on."""
    keys = []
    for n_pad, a_pad in shapes:
        keys += [("runs", f"N{n_pad}A{a_pad}"), ("windowed", f"N{n_pad}A{a_pad}"),
                 ("exact", f"E1G1A{a_pad}N{n_pad}")]
    return keys


@pytest.mark.gpu
def test_prewarm_on_the_card_covers_the_ladder(cuda_device):
    from nomad_tpu_torch.debug import devprof
    from nomad_tpu_torch.tpu import warmup

    assert warmup.prewarm(device=cuda_device) == 3 * len(warmup.DEFAULT_SHAPES)
    assert not [k for k in _ladder_keys(warmup.DEFAULT_SHAPES)
                if (*k, "cuda") not in devprof._LAUNCHED]
    # the drain ladder: the fused scan, the bases and two verify buckets
    assert warmup.prewarm_drain(10000, 8, device=cuda_device) == 4
    for key in (("exact", "E8G8A32N10240"), ("verify_rows", "N10240R8"),
                ("verify_rows", "N10240R64")):
        assert (*key, "cuda") in devprof._LAUNCHED, key
    # the library was loaded once, before any launch
    libs = [e for e in devprof.snapshot()["compile_ledger"] if e["planner"] == "library"]
    assert len(libs) <= 1


@pytest.mark.gpu
def test_plan_eval_at_a_ladder_shape_adds_no_planner(cuda_device):
    from nomad_tpu_torch.debug import devprof
    from nomad_tpu_torch.tpu import warmup

    shapes = (warmup.bucket_shape(1000, 1000),)
    assert warmup.prewarm(shapes, device=cuda_device) == 3
    size = devprof.compile_cache_size()
    c = problems.build_cluster(1000, 1000)
    for spread in (True, False):  # the run planner, then the exact scan
        planes = problems.eval_planes(*problems.exact_problem(c, spread=spread))
        placements, stats = planner.plan_eval(planes, device=cuda_device)
        assert stats["mode"] in ("runs", "exact-scan") and (placements >= 0).any()
        assert devprof.compile_cache_size() == size, stats["mode"]


@pytest.mark.gpu
def test_count_rounds_does_not_wait_for_a_running_kernel(cuda_device):
    import time

    from nomad_tpu_torch.debug import devprof

    prior = devprof.enable(True)
    try:
        devprof.reset()
        rounds = torch.full((), 7, dtype=torch.int32, device=cuda_device)
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000_000)  # about a second of the card's cycles
        t0 = time.perf_counter()
        devprof.count_rounds("runs", rounds, 21, False)
        totals = devprof.totals()
        waited = time.perf_counter() - t0
        assert waited < 0.2, waited
        assert totals["pending_rounds"] == 1 and totals["rounds"] == 0
        torch.cuda.synchronize()
        totals = devprof.totals()
        assert totals["pending_rounds"] == 0 and totals["rounds"] == 7
        assert totals["placements"] == 21
    finally:
        devprof.reset()
        devprof.enable(prior)


@pytest.mark.gpu
def test_smoke_storm_on_the_card_through_the_drain(cuda_device):
    """The small smoke storm of tests/test_torch_loadgen.py (16 nodes, 4 s
    of churn, seed 7) against a server on the card with the ``tpu-batch``
    scheduler and a drain of 8, its schedule compressed fourfold so that
    evals queue up and fuse: it ends clean and quiesced, and the drain's
    scan launched. The smoke's jobs (1-4 allocs) never reach the dense
    verify, and its drain batches take the mirror's device planes only when
    no write lands between their snapshot and their launch, which the storm
    seldom leaves; so on the quiesced cluster two batch jobs of 300 allocs
    are registered one after the other: the first plan's verify uploads
    the device planes, the second's scatters the first's rows into them."""
    import time

    from nomad_tpu_torch.loadgen.grammar import build_job
    from nomad_tpu_torch.loadgen.runner import run_scenario
    from nomad_tpu_torch.loadgen.scenarios import smoke
    from nomad_tpu_torch.testing.invariants import check_cluster_invariants

    scenario = smoke(nodes=16, churn_s=4)
    scenario.server_config.update(default_scheduler="tpu-batch", batch_drain=8)
    before = dict(tk.LAUNCHES)
    threads0 = set(threading.enumerate())
    seen = {}

    def inspect(server, report):
        seen.update(storm={k: tk.LAUNCHES[k] - before[k] for k in tk.LAUNCHES},
                    device=server.device.type)
        for slot in (900, 901):
            job = build_job({"slot": slot, "category": "bat", "type": "batch", "count": 300,
                             "cpu": 50, "memory_mb": 32})
            eid = server.job_register(job)
            deadline = time.monotonic() + 60.0
            while server.state.eval_by_id(eid).status != "complete":
                assert time.monotonic() < deadline, server.state.eval_by_id(eid).status
                time.sleep(0.02)
        seen["full"] = check_cluster_invariants(server.state)

    report = run_scenario(scenario, seed=7, driver_workers=6, time_scale=0.25,
                          device=cuda_device, inspect=inspect)
    launched = {k: tk.LAUNCHES[k] - before[k] for k in tk.LAUNCHES}
    assert seen["full"] == [] and seen["device"] == "cuda"
    assert report["quiesced"]
    assert report["invariants"]["violations"] == 0, report["invariants"]["violation_log"]
    assert report["driver"]["failed"] == 0, report["driver"]["errors"]
    assert seen["storm"]["exact_scan"] >= 1, seen["storm"]
    assert launched["verify_rows"] >= 2 and launched["scatter_rows"] >= 1, launched
    deadline = time.monotonic() + 10.0
    while True:
        left = [t for t in threading.enumerate() if t not in threads0 and t.is_alive()
                and t.name != "eval-broker-timers"]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, [t.name for t in left]


# ---------------------------------------------------------------------------
# gossip, ACL and federation: two regions, forwarding, a restart
# ---------------------------------------------------------------------------

#: the soak scenario's device settings, as chip_smoke.py phase 10 gives them
FED_SETTINGS = {"default_scheduler": "tpu-batch", "batch_drain": 8, "plan_apply_batch": 8}


def _threads_left(threads0, limit_s=10.0) -> list:
    import time

    deadline = time.monotonic() + limit_s
    while True:
        left = [t for t in threading.enumerate() if t not in threads0 and t.is_alive()
                and t.name != "eval-broker-timers"]
        if not left or time.monotonic() > deadline:
            return [t.name for t in left]
        time.sleep(0.05)


def _two_regions_forwarded(dev, node_docs, job_docs) -> tuple:
    """Two regions of one server each on ``dev``, ACL on (east
    authoritative), the soak's device settings: the jobs enter west's HTTP
    with ``?region=east`` and the management token, and east's one drain
    worker, started once both evals wait, plans them; returns the
    placements, the launches and west's replicated tokens."""
    import os
    import time

    from nomad_tpu_torch.api.client import ApiClient
    from nomad_tpu_torch.loadgen import federation
    from nomad_tpu_torch.structs.model import Node

    cfg = federation.FederationConfig(regions=2, servers_per_region=1, n_workers=0,
                                      server_settings=dict(FED_SETTINGS))
    cluster = federation.FederatedCluster(cfg, seed=42, device=dev)
    try:
        cluster.start()
        cluster.wait_ready()
        east, west = (cluster.leader_of(r) for r in ("east", "west"))
        server = east.agent.server
        for d in node_docs:
            server.node_register(Node.from_dict(d))
        api = ApiClient(address=west.http.address, token=cluster.mgmt_token)
        eval_ids = [api.put("/v1/jobs", body={"Job": d}, region="east")[0]["EvalID"]
                    for d in job_docs]
        before = dict(tk.LAUNCHES)
        server.start_workers(1)
        deadline = time.monotonic() + 60.0
        while not all(server.state.eval_by_id(e).status == "complete" for e in eval_ids):
            assert time.monotonic() < deadline, [server.state.eval_by_id(e).status
                                                 for e in eval_ids]
            time.sleep(0.02)
        launches = {k: tk.LAUNCHES[k] - before[k] for k in tk.LAUNCHES}
        placed = sorted((d["id"], a.name, a.node_id) for d in job_docs
                        for a in server.state.allocs_by_job("default", d["id"]))
        tokens = sorted(t.name for t in west.agent.server.state.acl_tokens())
        assert os.path.isdir(cluster._tmpdir)
        return placed, launches, tokens, list(west.agent.server.state.jobs())
    finally:
        cluster.stop()


@pytest.mark.gpu
def test_two_regions_with_acl_place_a_forwarded_job_on_the_card(cuda_device):
    """A job forwarded from west to east, each region one server on the
    card with ACL on: east plans it through the fused drain's kernels,
    west holds no copy of it, the bootstrap token replicated, the
    placements equal the same run's through the plain versions, and every
    thread of both regions stops."""
    from nomad_tpu_torch import mock

    node_docs = _sched_cluster(64, 2)
    jobs = []
    for i, count in enumerate((24, 30)):
        job = mock.job()
        job.datacenters = ["dc1", "dc2"]
        job.task_groups[0].count = count
        job.task_groups[0].tasks[0].resources.networks = []
        job.task_groups[0].tasks[0].resources.cpu = (250, 500)[i]
        jobs.append(job.to_dict())
    threads0 = set(threading.enumerate())
    got, launches, tokens, west_jobs = _two_regions_forwarded(cuda_device, node_docs, jobs)
    assert _threads_left(threads0) == []
    want, _, _, _ = _two_regions_forwarded("cpu", node_docs, jobs)
    assert _threads_left(threads0) == []
    assert len(got) == 54 and got == want
    assert launches["exact_scan"] >= 1 and launches["used_bases"] >= 1, launches
    assert tokens == ["Bootstrap Token"] and west_jobs == []


@pytest.mark.gpu
def test_a_restarted_server_rebuilds_device_planes_equal_to_a_cold_build(cuda_device, tmp_path):
    """A server on the card with a data dir plans two fused drain batches,
    stops, and comes back as a new ``Server`` from its data dir on the same
    port: once its state has caught up, its device planes equal those it
    had before the stop and planes built cold from its tables."""
    import time

    import chip_smoke
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.agent import ServerAgent
    from nomad_tpu_torch.structs.model import Node

    node_docs = _sched_cluster(200, 2)
    threads0 = set(threading.enumerate())
    cfg = {"seed": 42, "heartbeat_ttl": 3600.0, **FED_SETTINGS}

    def boot(port=0):
        agent = ServerAgent("s0", port=port, data_dir=str(tmp_path / "s0"), config=dict(cfg),
                            device=cuda_device)
        agent.start(num_workers=0, wait_for_leader=10.0)
        return agent

    agent = boot()
    try:
        server = agent.server
        for d in node_docs:
            server.node_register(Node.from_dict(d))
        ids = []
        for count in (40, 60, 20):
            job = mock.job()
            job.datacenters = ["dc1", "dc2"]
            job.task_groups[0].count = count
            job.task_groups[0].tasks[0].resources.networks = []
            ids.append(server.job_register(job))
        tk.reset_launches()
        server.start_workers(1)
        deadline = time.monotonic() + 60.0
        while not all(server.state.eval_by_id(e).status == "complete" for e in ids):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert tk.LAUNCHES["exact_scan"] >= 1
        before = chip_smoke.planes_vs_cold_build(server)
        snap = server.state.snapshot()
        planes = [t.cpu() for t in server.columnar_mirror.device_state(before["rows"], snap._gen)]
        index, port = server.raft.last_applied, int(agent.address.rsplit(":", 1)[1])
    finally:
        agent.stop()
    agent = boot(port)
    try:
        server = agent.server
        deadline = time.monotonic() + 30.0
        while server.raft.last_applied < index:
            assert time.monotonic() < deadline, (server.raft.last_applied, index)
            time.sleep(0.02)
        after = chip_smoke.planes_vs_cold_build(server)
        snap = server.state.snapshot()
        again = server.columnar_mirror.device_state(after["rows"], snap._gen)
        assert before["max_abs_err"] == after["max_abs_err"] == 0, (before, after)
        assert after["nodes"] == 200 and after["rows"] == before["rows"]
        for got, want in zip(again, planes):
            _same(got, want.to(cuda_device))
        assert server.columnar_mirror.device.type == cuda_device.type
    finally:
        agent.stop()
    assert _threads_left(threads0) == []


@pytest.mark.gpu
def test_the_card_plugin_fingerprints_the_card(cuda_device):
    """The client's default device plugin finds this machine's card: one
    nvidia/gpu group named as torch names the card, its instance ids the
    cards' UUIDs, a driver version, and the node's count attribute."""
    import shutil
    import subprocess

    from nomad_tpu_torch.client.devices import DeviceManager, NvidiaDevicePlugin
    from nomad_tpu_torch.structs.model import Node, NodeResources

    manager = DeviceManager()
    assert [type(p) for p in manager.plugins] == [NvidiaDevicePlugin]
    node = Node(node_resources=NodeResources())
    assert manager.fingerprint_node(node) >= 1
    (group,) = [g for g in node.node_resources.devices if g.name == torch.cuda.get_device_name(0)]
    assert (group.vendor, group.type) == ("nvidia", "gpu")
    listed = subprocess.run([shutil.which("nvidia-smi"), "-L"], capture_output=True, text=True,
                            check=True).stdout
    ids = [d.id for d in group.instances]
    assert ids and all(i.startswith("GPU-") and i in listed for i in ids)
    assert group.attributes["driver_version"].string_val not in ("", "unknown")
    total = sum(len(g.instances) for g in node.node_resources.devices)
    assert node.attributes["device.nvidia.gpu.count"] == str(total) == str(torch.cuda.device_count())
    assert manager.reserve_env(
        [type("A", (), dict(vendor="nvidia", type="gpu", name=group.name, device_ids=ids[:1]))]
    ) == {"CUDA_VISIBLE_DEVICES": ids[0]}


@pytest.mark.gpu
def test_a_device_job_is_handed_the_card(cuda_device):
    """A raw_exec job asking for ``nvidia/gpu`` on a client on the card: its
    task's CUDA_VISIBLE_DEVICES holds the reserved card's UUID, nvidia-smi
    -L in the task names the card, and a torch child process under that env
    sees one card of that name."""
    import os
    import shutil
    import sys
    import tempfile
    import time

    from nomad_tpu_torch.client import Client
    from nomad_tpu_torch.core.server import Server
    from nomad_tpu_torch.jobspec import parse_job

    smi = shutil.which("nvidia-smi")
    probe = ("import torch; print(torch.cuda.device_count(), torch.cuda.get_device_name(0))")
    hcl = f'''job "gpu" {{
  datacenters = ["dc1"]
  type = "batch"
  group "gpu" {{
    task "smi" {{
      driver = "raw_exec"
      config {{
        command = "/bin/sh"
        args = ["-c", "echo $CUDA_VISIBLE_DEVICES; {smi} -L; {sys.executable} -c '{probe}'"]
      }}
      resources {{
        cpu = 20
        memory = 64
        device "nvidia/gpu" {{
          count = 1
        }}
      }}
    }}
  }}
}}
'''
    before = set(threading.enumerate())
    server = Server({"seed": 1, "heartbeat_ttl": 60.0}, device=cuda_device)
    data_dir = tempfile.mkdtemp(prefix="gpu_client_")
    client = Client(server, data_dir=data_dir)
    try:
        server.start(num_workers=1)
        client.start()
        server.job_register(parse_job(hcl))
        deadline = time.monotonic() + 120
        while True:
            allocs = server.state.allocs_by_job("default", "gpu")
            if allocs and allocs[0].client_status in ("complete", "failed"):
                break
            assert time.monotonic() < deadline, [a.client_status for a in allocs]
            time.sleep(0.1)
        (alloc,) = allocs
        assert alloc.client_status == "complete"
        (reserved,) = alloc.allocated_resources.tasks["smi"].devices
        (card_id,) = reserved.device_ids
        with open(os.path.join(data_dir, "allocs", alloc.id, "smi", "logs", "smi.stdout.0")) as f:
            lines = f.read().splitlines()
        assert lines[0] == card_id
        assert card_id in lines[1] and torch.cuda.get_device_name(0) in lines[1]
        assert lines[-1] == f"1 {torch.cuda.get_device_name(0)}"
    finally:
        client.stop()
        server.stop()
    deadline = time.monotonic() + 10
    while [t for t in set(threading.enumerate()) - before
           if t.is_alive() and t.name != "eval-broker-timers"] and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not [t.name for t in set(threading.enumerate()) - before
                if t.is_alive() and t.name != "eval-broker-timers"]


# ---------------------------------------------------------------------------
# the sharded kernels (csrc/mesh.cu): K5s, K6s and K7s over a node axis
# split into S shards on the card, against their sharded plain versions on
# the CPU and the unsharded kernels on the card
# ---------------------------------------------------------------------------

MESH_SHARDS = (2, 4, 8)


def _extra_column(capacity, used, demand):
    """The same planes with a 5th resource column (free device instances)."""
    n = capacity.shape[0]
    return (np.concatenate([capacity, np.full((n, 1), 3, np.int32)], 1),
            np.concatenate([used, np.zeros((n, 1), np.int32)], 1),
            np.concatenate([demand, np.ones(demand.shape[:-1] + (1,), np.int32)], -1))


def _mesh_cluster(n, a, seed, s, n_values=4):
    c = problems.build_cluster(n, a, n_values=n_values, seed=seed)
    n_pad = shard.node_bucket(n, shard.Mesh(s, "cpu"))
    return problems.pad_cluster(c, n_pad) if n_pad != n else c


def _mesh_exact(case, s):
    n, a, seed, cols = {"1k": (1024, 96, 0, 4), "uneven": (2059, 96, 13, 4),
                        "devices": (1024, 200, 4, 5)}[case]
    args, init = problems.exact_problem(_mesh_cluster(n, a, seed, s))
    if cols == 5:
        cap, used, dem = _extra_column(args["capacity"], init["used"], args["demands"])
        args, init = dict(args, capacity=cap, demands=dem), dict(init, used=used)
    return tk.BatchArgs(**args), tk.BatchState(**init), n


def _mesh_runs(case, s):
    n, a, seed, cols, values = {"1k": (1024, 512, 3, 4, 4), "uneven": (2059, 384, 11, 4, 4),
                                "devices": (1024, 300, 6, 5, 4),
                                "values_40": (1024, 512, 3, 4, 40),
                                "values_300": (2059, 384, 11, 4, 300)}[case]
    args, init = problems.runs_problem(_mesh_cluster(n, a, seed, s, values))
    init = tuple(init)
    if cols == 5:
        cap, used, dem = _extra_column(args["capacity"], init[0], args["demand"])
        args, init = dict(args, capacity=cap, demand=dem), (used, *init[1:])
    return tk.RunArgs(**args), init, a


def _mesh_windowed(case, s):
    n, a, seed, cols = {"1k": (1024, 512, 5, 4), "uneven": (2059, 300, 7, 4),
                        "devices": (1024, 300, 8, 5)}[case]
    args, used0, coll0 = problems.window_problem(_mesh_cluster(n, a, seed, s), limit=10)
    if cols == 5:
        cap, used0, dem = _extra_column(args["capacity"], used0, args["demand"])
        args = dict(args, capacity=cap, demand=dem)
    return tk.WindowArgs(**args), used0, coll0, n, a


MESH_CASES = ("1k", "uneven", "devices")


@pytest.mark.gpu
@pytest.mark.parametrize("s", MESH_SHARDS)
@pytest.mark.parametrize("case", MESH_CASES)
def test_mesh_exact_kernel_matches_plain(case, s, cuda_device):
    args, init, n_real = _mesh_exact(case, s)
    aspec, sspec = shard.batch_specs()
    card, cpu = shard.Mesh(s, cuda_device), shard.Mesh(s, "cpu")
    before = tk.LAUNCHES["mesh_exact"]
    state, got = tk.plan_batch(shard.put(args, aspec, card), shard.put(init, sspec, card), n_real)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["mesh_exact"] == before + 1
    want_state, want = tk.plan_batch(shard.put(args, aspec, cpu), shard.put(init, sspec, cpu),
                                     n_real)
    _same(got, want)
    for g, w in zip(shard.gather(state), shard.gather(want_state)):
        _same(g, w)
    _, flat = tk.plan_batch(tk.from_numpy(args, cuda_device), tk.from_numpy(init, cuda_device),
                            n_real)
    _same(got, flat)


@pytest.mark.gpu
@pytest.mark.parametrize("s", MESH_SHARDS)
@pytest.mark.parametrize("case", MESH_CASES + ("values_40", "values_300"))
def test_mesh_runs_kernel_matches_plain(case, s, cuda_device):
    args, init, a_pad = _mesh_runs(case, s)
    aspec, ispec = shard.run_specs()
    card, cpu = shard.Mesh(s, cuda_device), shard.Mesh(s, "cpu")
    before = tk.LAUNCHES["mesh_runs"]
    got, rounds = tk.plan_batch_runs(shard.put(args, aspec, card), shard.put(init, ispec, card),
                                     a_pad)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["mesh_runs"] == before + 1
    want, want_rounds = tk.plan_batch_runs(shard.put(args, aspec, cpu),
                                           shard.put(init, ispec, cpu), a_pad)
    _same(got, want)
    assert int(rounds) == want_rounds
    flat, flat_rounds = tk.plan_batch_runs(tk.from_numpy(args, cuda_device),
                                           tk.from_numpy(init, cuda_device), a_pad)
    _same(got, flat)
    assert int(flat_rounds) == want_rounds


@pytest.mark.gpu
@pytest.mark.parametrize("s", MESH_SHARDS)
@pytest.mark.parametrize("case", MESH_CASES)
def test_mesh_windowed_kernel_matches_plain(case, s, cuda_device):
    args, used0, coll0, n_real, a_pad = _mesh_windowed(case, s)
    aspec, (uspec, cspec) = shard.window_specs()
    card, cpu = shard.Mesh(s, cuda_device), shard.Mesh(s, "cpu")
    before = tk.LAUNCHES["mesh_windowed"]
    got, rounds = tk.plan_batch_windowed(shard.put(args, aspec, card), shard.put(used0, uspec, card),
                                         shard.put(coll0, cspec, card), n_real, a_pad)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["mesh_windowed"] == before + 1
    want, want_rounds = tk.plan_batch_windowed(shard.put(args, aspec, cpu),
                                               shard.put(used0, uspec, cpu),
                                               shard.put(coll0, cspec, cpu), n_real, a_pad)
    _same(got, want)
    assert int(rounds) == want_rounds
    flat, flat_rounds = tk.plan_batch_windowed(tk.from_numpy(args, cuda_device),
                                               *tk.from_numpy((used0, coll0), cuda_device),
                                               n_real, a_pad)
    _same(got, flat)
    assert int(flat_rounds) == want_rounds


@pytest.mark.gpu
def test_mesh_refuses_what_its_kernels_do_not_take(cuda_device):
    """More shards than the kernels' pointer tables hold (or than the card
    co-schedules) are refused with KernelFault before any launch."""
    before = dict(tk.LAUNCHES)
    shape = tk.mesh_shape("mesh_exact", 8, 10_240)
    assert shape["blocks"] <= shape["max_blocks"] and shape["blocks_a_shard"] >= 1
    with pytest.raises(tk.KernelFault, match="shards"):
        tk.mesh_shape("mesh_exact", tk.MESH_MAX_SHARDS * 2, 10_240)
    args, init, n_real = _mesh_exact("1k", 32)
    aspec, sspec = shard.batch_specs()
    mesh = shard.Mesh(32, cuda_device)
    with pytest.raises(tk.KernelFault):
        tk.plan_batch(shard.put(args, aspec, mesh), shard.put(init, sspec, mesh), n_real)
    assert tk.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("s", MESH_SHARDS)
def test_mesh_dryrun_places_every_alloc(s, cuda_device):
    before = tk.LAUNCHES["mesh_exact"]
    report = multichip.dryrun_multichip(s, device=cuda_device)
    assert report["placed"] == 512 and report["mismatches"] == 0
    assert tk.LAUNCHES["mesh_exact"] == before + 1


@pytest.mark.gpu
def test_mesh_plan_eval_places_as_unsharded(cuda_device, monkeypatch):
    """``planner.plan_eval`` under a mesh on the card: the run planner's
    eval launches K6s once and places as the unsharded kernel."""
    monkeypatch.setattr(shard, "MIN_NODES", 1024)
    planes = problems.eval_planes(*problems.exact_problem(problems.build_cluster(1500, 300, seed=9)))
    flat, flat_stats = planner.plan_eval(planes, device=cuda_device)
    shard.configure(4, device="cuda")
    try:
        before = tk.LAUNCHES["mesh_runs"]
        got, stats = planner.plan_eval(planes, device=cuda_device)
    finally:
        shard.configure(enabled=False)
    assert stats["mode"] == flat_stats["mode"] == "runs"
    assert stats["shards"] == 4 and flat_stats["shards"] == 1
    assert tk.LAUNCHES["mesh_runs"] == before + 1
    np.testing.assert_array_equal(got, flat)


# ---------------------------------------------------------------------------
# the server path's sharded kernels (csrc/mesh_server.cu): K8s, K9s and
# K10s over a node axis split into S shards on the card, and K5s over a
# fused multi-eval batch, against their sharded plain versions and the
# unsharded kernels
# ---------------------------------------------------------------------------

#: lanes of the server kernels: ``mid`` random with duplicates and rows on
#: both sides of every shard boundary, ``dups`` every lane on three rows,
#: ``invalid`` every row outside [0, N)
MESH_SERVER_CASES = ("mid", "dups", "invalid")


def _mesh_lanes(kind, rng, N, s, R, C=4):
    rows, vals = _lanes(kind, rng, N, R, C)
    if kind == "mid":
        per = N // s
        edges = [r for k in range(1, s) for r in (k * per - 1, k * per)]
        rows[: len(edges)] = edges
    return rows, vals


def _mesh_planes(s, n_real=10_000, seed=3):
    """capacity, used of n_real nodes padded to the mesh's bucket, as the
    mirror pads them."""
    rng = np.random.default_rng(seed)
    N = shard.node_bucket(n_real, shard.Mesh(s, "cpu"))
    capacity = np.zeros((N, 4), np.int32)
    capacity[:n_real] = rng.integers(1000, 9000, (n_real, 4))
    used = np.full((N, 4), 2**30, np.int32)
    used[:n_real] = capacity[:n_real] - rng.integers(0, 600, (n_real, 4))
    return rng, N, capacity, used


def _rows_on(mesh, *planes):
    return shard.put(tuple(planes), (shard.ROWS,) * len(planes), mesh)


@pytest.mark.gpu
@pytest.mark.parametrize("s", MESH_SHARDS)
@pytest.mark.parametrize("kind", MESH_SERVER_CASES)
def test_mesh_verify_kernel_matches_plain(kind, s, cuda_device):
    rng, N, capacity, used = _mesh_planes(s)
    rows, deltas = _mesh_lanes(kind, rng, N, s, 4096)
    card = _rows_on(shard.Mesh(s, cuda_device), capacity, used)
    kept = [t.clone() for t in card[1].slabs]
    r, d = (torch.from_numpy(a).to(cuda_device) for a in (rows, deltas))
    before = tk.LAUNCHES["mesh_verify"]
    got = tk.verify_rows(*card, r, d)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["mesh_verify"] == before + 1
    _same(got, tk.verify_rows_sharded_ref(*card, r, d))
    flat = [torch.from_numpy(a).to(cuda_device) for a in (capacity, used)]
    _same(got, tk.verify_rows(*flat, r, d))
    assert all(torch.equal(a, b) for a, b in zip(kept, card[1].slabs))
    if kind == "invalid":
        assert not bool(got.any())


@pytest.mark.gpu
@pytest.mark.parametrize("s", MESH_SHARDS)
@pytest.mark.parametrize("kind", MESH_SERVER_CASES)
def test_mesh_bases_kernel_matches_plain(kind, s, cuda_device):
    from nomad_tpu_torch.tpu import drain

    rng, N, _, used0 = _mesh_planes(s, n_real=4000)
    E, n_real = 32, 4000
    lanes, demands = _mesh_lanes(kind, rng, N, s, 4096)
    placements = lanes if kind != "invalid" else np.full(len(lanes), -1, np.int32)
    if kind == "mid":
        placements[::9] = -1
    eval_of = rng.integers(-1, E + 1, len(placements)).astype(np.int32)
    (card,) = _rows_on(shard.Mesh(s, cuda_device), used0)
    t = [torch.from_numpy(a).to(cuda_device) for a in (placements, np.abs(demands), eval_of)]
    before = tk.LAUNCHES["mesh_bases"]
    got = drain.used_bases(card, *t, E, n_real)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["mesh_bases"] == before + 1
    assert got.split == shard.COLS and all(x.shape == (E, N // s, 4) for x in got.slabs)
    want = drain.used_bases_sharded_ref(card, *t, E, n_real)
    for g, w in zip(got.slabs, want.slabs):
        _same(g, w)
    _same(got.full(), drain.used_bases(torch.from_numpy(used0).to(cuda_device), *t, E, n_real))


@pytest.mark.gpu
@pytest.mark.parametrize("s", MESH_SHARDS)
@pytest.mark.parametrize("kind", MESH_SERVER_CASES)
def test_mesh_scatter_kernel_matches_plain(kind, s, cuda_device):
    from nomad_tpu_torch.tpu import mirror

    rng, N, _, used = _mesh_planes(s)
    rows, vals = _mesh_lanes(kind, rng, N, s, 3000)
    (card,) = _rows_on(shard.Mesh(s, cuda_device), used)
    kept = [x.clone() for x in card.slabs]
    r, v = (torch.from_numpy(a).to(cuda_device) for a in (rows, vals))
    before = tk.LAUNCHES["mesh_scatter"]
    got = mirror.scatter_rows(card, r, v)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["mesh_scatter"] == before + 1
    assert got.split == shard.ROWS and len(got.slabs) == s
    for g, w in zip(got.slabs, mirror.scatter_rows_sharded_ref(card, r, v).slabs):
        _same(g, w)
    _same(got.full(), mirror.scatter_rows(torch.from_numpy(used).to(cuda_device), r, v))
    assert all(torch.equal(a, b) for a, b in zip(kept, card.slabs))


def _fused_batch(mix, n_evals, s, n_real=3000, seed=9):
    """(BatchArgs, BatchState) of numpy planes of a fused drain batch
    (E = 32) over ``n_real`` nodes padded to the mesh's bucket."""
    from nomad_tpu_torch.tpu import drain

    shared, preps = problems.drain_problem(problems.build_cluster(n_real, 1, seed=seed), n_evals,
                                           mix, seed=seed)
    order = [drain.DrainPrep.from_dict(d) for d in preps]
    shape = drain.batch_shape(order, n_real, 32, shard.Mesh(s, "cpu"))
    args, state, _ = drain.assemble(order, n_real, shape)
    capacity, usable, used = drain.host_planes(
        drain.SharedCluster(shared["capacity"], shared["usable"], shared["used0"]), shape[3])
    return (tk.BatchArgs(capacity=capacity, usable=usable, **args),
            tk.BatchState(used=used, **state), n_real)


@pytest.mark.gpu
@pytest.mark.parametrize("s", MESH_SHARDS)
@pytest.mark.parametrize("mix,n_evals", [("drain-bench", 32), ("drain-tenant", 12)])
def test_mesh_exact_kernel_over_a_fused_batch(mix, n_evals, s, cuda_device):
    """K5s at E = 32: per-eval rings and cursors, ``perm`` [E, N] split by
    columns, groups over many evals, padded lanes."""
    args, init, n_real = _fused_batch(mix, n_evals, s)
    aspec, sspec = shard.batch_specs()
    card, cpu = shard.Mesh(s, cuda_device), shard.Mesh(s, "cpu")
    before = tk.LAUNCHES["mesh_exact"]
    state, got = tk.plan_batch(shard.put(args, aspec, card), shard.put(init, sspec, card), n_real)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["mesh_exact"] == before + 1
    cut = slice(0, 256)  # the plain version walks its lanes one by one
    cargs = args._replace(demands=args.demands[cut], groups=args.groups[cut],
                          limits=args.limits[cut], valid=args.valid[cut])
    want_state, want = tk.plan_batch(shard.put(cargs, aspec, cpu), shard.put(init, sspec, cpu),
                                     n_real)
    cut_state, cut_got = tk.plan_batch(shard.put(cargs, aspec, card),
                                       shard.put(init, sspec, card), n_real)
    _same(cut_got, want)
    for g, w in zip(shard.gather(cut_state), shard.gather(want_state)):
        _same(g, w)
    _same(got[cut], want)
    flat_state, flat = tk.plan_batch(tk.from_numpy(args, cuda_device),
                                     tk.from_numpy(init, cuda_device), n_real)
    _same(got, flat)
    for g, w in zip(shard.gather(state), flat_state):
        _same(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("s", (4, 8))
def test_mesh_drain_batch_on_card_matches_cpu(s, cuda_device, monkeypatch):
    """The collector under a mesh on a row-sharded DeviceState: the card
    (K5s, K9s, K10s for the refresh) against the CPU's sharded plain
    versions and the card's unsharded run."""
    from nomad_tpu_torch.tpu import batch_sched, drain, mirror

    monkeypatch.setattr(shard, "MIN_NODES", 1024)
    c = problems.build_cluster(3000, 1, seed=9)
    shared, preps = problems.drain_problem(c, 12, "drain-tenant", seed=9)
    out = {}
    for dev, sharded in (("cpu", True), (cuda_device, True), (cuda_device, False)):
        mesh = shard.configure(s, device=str(torch.device(dev).type)) if sharded else None
        try:
            n_pad = shard.node_bucket(3000, mesh)
            stale = np.zeros_like(shared["used0"])
            ds = mirror.DeviceState(0, n_pad, shared["capacity"], shared["usable"], stale,
                                    device=dev, mesh=mesh)
            ds.pending.update(int(r) for r in np.flatnonzero((shared["used0"] != stale).any(1)))
            ds.refresh(shared["used0"])
            collector = drain.KernelBatchCollector(
                drain.SharedCluster(shared["capacity"], shared["usable"], shared["used0"], ds),
                expected=len(preps), pad_evals=16, device=dev)
            got = {}

            def one(d):
                placements, base = collector.submit(drain.DrainPrep.from_dict(d))
                got[d["eval_id"]] = (batch_sched._to_host(placements),
                                     batch_sched._to_host(base))

            threads = [threading.Thread(target=one, args=(d,)) for d in preps]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            assert drain.LAST_DRAIN_STATS["shards"] == (s if sharded else 1)
            out[(str(dev), sharded)] = got
        finally:
            shard.configure(enabled=False)
    want = out[("cpu", True)]
    for key in ((str(cuda_device), True), (str(cuda_device), False)):
        assert sorted(out[key]) == sorted(want)
        for eval_id, (placements, base) in want.items():
            np.testing.assert_array_equal(out[key][eval_id][0], placements)
            np.testing.assert_array_equal(out[key][eval_id][1], base)


# ---------------------------------------------------------------------------
# the wavefront and paged routes under a mesh: K11s (csrc/mesh.cu) and K12s
# and K13s (csrc/paging.cu) against their sharded plain versions and the
# unsharded kernels
# ---------------------------------------------------------------------------

#: name -> (nodes, allocs, seed, W, M): an uneven axis (real rows end inside
#: a shard) at M 1 and 4, and a window narrower than the default at M 3
MESH_WAVE_CASES = {"uneven_m1": (2059, 256, 11, 32, 1), "uneven_m4": (2059, 256, 29, 32, 4),
                   "1k_w8_m3": (1024, 200, 3, 8, 3)}


def _mesh_wave_kernels(args, init, n_real, s, cuda_device):
    """K11s over ``s`` shards on the card against its sharded plain
    version, the unsharded K11 and the sequential K5 on the same inputs."""
    aspec, sspec = shard.wavefront_specs()
    card, cpu = shard.Mesh(s, cuda_device), shard.Mesh(s, "cpu")
    before = dict(tk.LAUNCHES)
    state, got, rounds = wavefront.plan_batch_wavefront(
        shard.put(args, aspec, card), shard.put(init, sspec, card), n_real, n_shards=s)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["mesh_wavefront"] == before["mesh_wavefront"] + 1
    assert {k: v - before[k] for k, v in tk.LAUNCHES.items() if v != before[k]} == {
        "mesh_wavefront": 1}
    want_state, want, want_rounds = wavefront.plan_batch_wavefront_sharded_ref(
        shard.put(args, aspec, cpu), shard.put(init, sspec, cpu), n_real,
        wavefront.window_for(args.demands.shape[0]), wavefront.contention_top_m())
    _same(got, want)
    assert int(rounds) == want_rounds
    for g, w in zip(shard.gather(state), shard.gather(want_state)):
        _same(g, w)
    ca, cs = tk.from_numpy(args, cuda_device), tk.from_numpy(init, cuda_device)
    _, flat, flat_rounds = wavefront.plan_batch_wavefront(ca, cs, n_real)
    _same(got, flat)
    assert int(flat_rounds) == want_rounds
    _, seq = tk.plan_batch(ca, cs, n_real)
    _same(got, seq)
    return want_rounds


@pytest.mark.gpu
@pytest.mark.parametrize("s", MESH_SHARDS)
@pytest.mark.parametrize("case", sorted(MESH_WAVE_CASES))
def test_mesh_wavefront_kernel_matches_plain(case, s, cuda_device):
    n, a, seed, window, top_m = MESH_WAVE_CASES[case]
    args, init = problems.wavefront_problem(_mesh_cluster(n, a, seed, s))
    wavefront.configure(max_round=window, contention_top_m=top_m)
    rounds = _mesh_wave_kernels(tk.BatchArgs(**args), tk.BatchState(**init), n, s, cuda_device)
    assert rounds < a


@pytest.mark.gpu
@pytest.mark.parametrize("s", MESH_SHARDS)
@pytest.mark.parametrize("mix,top_m", [("drain-bench", 1), ("drain-tenant", 4)])
def test_mesh_wavefront_over_a_fused_batch(mix, top_m, s, cuda_device):
    """K11s at E 32: a fused drain batch of several evals, each its own ring
    and cursor, with padded lanes."""
    from nomad_tpu_torch.tpu import drain

    n_real = 1000
    shared, preps = problems.drain_problem(problems.build_cluster(n_real, 1, seed=5), 12, mix,
                                           seed=5)
    order = [drain.DrainPrep.from_dict(d) for d in preps]
    shape = drain.batch_shape(order, n_real, 32, shard.Mesh(s, "cpu"))
    args_np, state_np, _ = drain.assemble(order, n_real, shape)
    planes = drain.host_planes(drain.SharedCluster(shared["capacity"], shared["usable"],
                                                   shared["used0"]), shape[3])
    args = tk.BatchArgs(capacity=planes[0], usable=planes[1], **args_np)
    init = tk.BatchState(used=planes[2], **state_np)
    assert args.perm.shape[0] == 32 and not args.valid.all()
    wavefront.configure(contention_top_m=top_m)
    _mesh_wave_kernels(args, init, n_real, s, cuda_device)


_TILE_SPLITS = (shard.ROWS, shard.ROWS, shard.LANE, shard.ROWS, shard.LANE, shard.LANE)


@pytest.mark.gpu
@pytest.mark.parametrize("s", MESH_SHARDS)
@pytest.mark.parametrize("case", sorted(TILE_EDGE_CASES))
def test_mesh_tile_sweeps_match_plain(case, s, cuda_device):
    """K12s and K13s on every tile of a round of 1,000-row tiles split into
    ``s`` slabs: one launch each a call, against their sharded plain
    versions and the unsharded kernels."""
    offset, w_use_div, c, dead = TILE_EDGE_CASES[case]
    for args in _tile_round(1_000, offset, w_use_div, c=c, dead_tile=dead):
        planes, dem, scalars = args[:6], args[6], args[7:]
        t0, off, n_real = scalars[2], scalars[3], scalars[4]
        card = [x.to(cuda_device) for x in planes]
        on_slabs = [shard.split(x, spec, s) for x, spec in zip(card, _TILE_SPLITS)]
        cpu_slabs = [shard.split(x, spec, s) for x, spec in zip(planes, _TILE_SPLITS)]
        demand = dem.to(cuda_device)
        before = dict(tk.LAUNCHES)
        got_c = paging.tile_count(on_slabs[0], on_slabs[2], on_slabs[3], demand, t0, off, n_real)
        got_w = paging.tile_window(*on_slabs, demand, *scalars)
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in tk.LAUNCHES.items() if v != before[k]} == {
            "mesh_tile_count": 1, "mesh_tile_window": 1}
        _same(got_c, paging.tile_count_sharded_ref(cpu_slabs[0], cpu_slabs[2], cpu_slabs[3], dem,
                                                   t0, off, n_real))
        _same(got_c, paging.tile_count(card[0], card[2], card[3], demand, t0, off, n_real))
        want_w = paging.tile_window_sharded_ref(*cpu_slabs, dem, *scalars)
        flat_w = paging.tile_window(*card, demand, *scalars)
        for g, w, f in zip(got_w, want_w, flat_w):
            _same(g.reshape(w.shape), w)
            _same(g, f)


@pytest.mark.gpu
@pytest.mark.parametrize("s", MESH_SHARDS)
@pytest.mark.parametrize("n,a,limit,tile_nodes", [(797, 96, 6, 64), (8192, 1024, 4, 1024)])
def test_mesh_paged_on_card_matches_unsharded(n, a, limit, tile_nodes, s, cuda_device,
                                              monkeypatch):
    """The paged planner over ``s`` slabs a tile on the card, under a budget
    of two tiles: only K12s and K13s launch, and placements, rounds and the
    tile cache's counts (bytes uploaded among them) equal the unsharded
    run's on the card and the sharded run's on the CPU."""
    _two_tile_budget(monkeypatch)
    case = problems.paged_case(5, n, a, limit=limit)
    paging.configure(tile_nodes=tile_nodes)
    flat, flat_rounds, flat_stats = paging.plan_batch_paged(*case, device=cuda_device)
    before = dict(tk.LAUNCHES)
    got, rounds, stats = paging.plan_batch_paged(*case, device=cuda_device,
                                                 mesh=shard.Mesh(s, cuda_device))
    launched = {k: v - before[k] for k, v in tk.LAUNCHES.items() if v != before[k]}
    assert set(launched) == {"mesh_tile_count", "mesh_tile_window"}
    np.testing.assert_array_equal(got, flat)
    assert rounds == flat_rounds and stats == flat_stats
    want, want_rounds, want_stats = paging.plan_batch_paged(*case, device="cpu",
                                                            mesh=shard.Mesh(s, "cpu"))
    np.testing.assert_array_equal(got, want)
    assert rounds == want_rounds and stats == want_stats


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["wavefront", "paged"])
def test_mesh_routes_on_card_place_as_unsharded(route, cuda_device, monkeypatch):
    """``planner.plan_eval`` under a mesh of 4 on the card: the wavefront
    and paged routes launch only their sharded kernels and place as the
    unsharded routes do."""
    monkeypatch.setattr(shard, "MIN_NODES", 1024)
    if route == "wavefront":
        wavefront.configure(enabled=True)
        planes = problems.eval_planes(*problems.wavefront_problem(
            problems.build_cluster(2000, 3000, seed=4), n_groups=8))
        kernels = {"mesh_wavefront"}
    else:
        paging.configure(enabled=True, device_node_budget_mb=1, tile_nodes=4096)
        planes = problems.eval_planes(*problems.exact_problem(
            problems.build_cluster(25_000, 3000, seed=4), spread=False))
        planes["limits"][:] = 10
        kernels = {"mesh_tile_count", "mesh_tile_window"}
    flat, flat_stats = planner.plan_eval(planes, device=cuda_device)
    shard.configure(4, device="cuda")
    try:
        before = dict(tk.LAUNCHES)
        got, stats = planner.plan_eval(planes, device=cuda_device)
    finally:
        shard.configure(enabled=False)
    assert {k for k, v in tk.LAUNCHES.items() if v != before[k]} == kernels
    assert stats["mode"] == flat_stats["mode"] == route
    assert stats["shards"] == 4 and stats["rounds"] == flat_stats["rounds"]
    np.testing.assert_array_equal(got, flat)
