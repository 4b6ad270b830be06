"""The port's planners against the JAX package, bit for bit, on the CPU.

Inputs are made with numpy from a seed and go through both the JAX
function (deterministic compile flavor, the only bit-exact reference) and
its counterpart in ``nomad_tpu_torch``: the score primitives, the exact
scan, the run planner and the windowed planner. tests/test_torch_gpu.py
holds the CUDA kernels against these plain versions on the card.
"""

import jax
import numpy as np
import pytest
from torch_for_tests import gil_handoff, multi_eval_problem, runcap_problem, torch  # noqa: F401

from nomad_tpu.tpu import exact_np as jexact_np
from nomad_tpu.tpu import kernel as jk
from nomad_tpu.tpu import multichip as mc
from nomad_tpu_torch.tpu import exact_np, problems
from nomad_tpu_torch.tpu import kernel as tk


def _det(name, jitfn, *call_args):
    """One JAX planner call through the deterministic (fusion-free) flavor."""
    with jk.deterministic_scope():
        out, _ = jk._dispatch(name, jitfn, call_args, name)
    return jax.tree_util.tree_map(np.asarray, out)


def _bits(x):
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bits_equal(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def cpu(obj):
    return tk.from_numpy(obj, "cpu")


# ---------------------------------------------------------------------------
# problems and the host oracle are the JAX package's, array for array
# ---------------------------------------------------------------------------


def test_problem_builders_match():
    c = mc.build_cluster(50, 40, seed=3)
    mine = problems.build_cluster(50, 40, seed=3)
    for k, v in c.items():
        np.testing.assert_array_equal(np.asarray(mine[k]), np.asarray(v))
    cp, mp = mc.pad_cluster(c, 64), problems.pad_cluster(mine, 64)
    pairs = [
        (mc.exact_problem(cp, spread=False), problems.exact_problem(mp, spread=False)),
        (mc.wavefront_problem(cp, n_groups=4), problems.wavefront_problem(mp, n_groups=4)),
        (mc.runs_problem(cp, affinity=True), problems.runs_problem(mp, affinity=True)),
        (mc.window_problem(cp, limit=3), problems.window_problem(mp, limit=3)),
    ]
    for want, got in pairs:
        for w, g in zip(want, got):
            w = w._asdict() if hasattr(w, "_asdict") else w
            if isinstance(w, dict):
                assert set(w) == set(g)
                for k in w:
                    np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))
            else:
                for wi, gi in zip(w, g) if isinstance(w, tuple) else [(w, g)]:
                    np.testing.assert_array_equal(gi, wi)
    for n in (1, 8, 9, 1000, 1024, 1025, 10000):
        from nomad_tpu.tpu.batch_sched import _bucket

        assert problems.bucket(n) == _bucket(n)


def test_exact_np_matches_reference_oracle():
    c = mc.build_cluster(40, 60, seed=5)
    args, init = mc.exact_problem(c)
    call = (
        args.capacity.astype(np.int64), args.usable.astype(np.float64), args.feasible,
        args.affinity.astype(np.float64), args.affinity_present,
        args.group_count.astype(np.int64), args.node_value.astype(np.int64),
        args.spread_desired.astype(np.float64), args.spread_implicit.astype(np.float64),
        args.spread_weight_frac.astype(np.float64), args.spread_even, args.spread_active,
        args.perm[0].astype(np.int64), args.demands.astype(np.int64),
        args.groups.astype(np.int64), args.limits.astype(np.int64),
        init.used.astype(np.int64), init.collisions.astype(np.int64),
        init.spread_counts.astype(np.int64), init.spread_present,
    )
    np.testing.assert_array_equal(exact_np.plan_exact_np(*call), jexact_np.plan_exact_np(*call))


# ---------------------------------------------------------------------------
# score primitives
# ---------------------------------------------------------------------------


def test_pow10_bit_equal():
    # XLA on the CPU flushes subnormal results to zero and torch does not:
    # below about -37.9 JAX returns 0 where torch returns a subnormal, so
    # the range stops at -37.5 (scores never get there: 20 - subnormal
    # rounds to 20). Both clip at +-45.2, where 10^x is 0 and inf in both.
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-37.5, 38.5, 60_000),
        rng.uniform(-2.0, 1.5, 20_000),
        np.array([-37.5, 38.5, 0.0, -0.0, 1.0, -1.0, 0.5, -0.5]),
        np.array([-45.2, 45.2, -60.0, 60.0, -45.3, 45.3]),
    ]).astype(np.float32)
    want = _det("pow10", jax.jit(jk._pow10), x)
    assert_bits_equal(tk._pow10(torch.from_numpy(x)), want)


def test_binpack_bit_equal():
    rng = np.random.default_rng(1)
    fc = rng.uniform(-1.5, 1.0, 50_000).astype(np.float32)
    fm = rng.uniform(-1.5, 1.0, 50_000).astype(np.float32)
    fc[:1000] = fc[0]  # exact ties
    fm[:1000] = fm[0]
    want = _det("binpack", jax.jit(jk._binpack), fc, fm)
    assert_bits_equal(tk._binpack(torch.from_numpy(fc), torch.from_numpy(fm)), want)


@pytest.mark.parametrize(
    "case",
    ["target", "even", "inactive", "nothing_present", "implicit", "even_all_equal"],
)
def test_class_boosts_bit_equal(case):
    rng = np.random.default_rng(2)
    V = 6
    counts = rng.integers(0, 9, V).astype(np.int32)
    present = rng.random(V) > 0.3
    desired = rng.uniform(0.5, 12.0, V).astype(np.float32)
    desired[1] = -1.0
    implicit, wf, even, active = np.float32(-1.0), np.float32(0.7), False, True
    if case == "even":
        even = True
    elif case == "inactive":
        active = False
    elif case == "nothing_present":
        present[:] = False
        even = True
    elif case == "implicit":
        implicit = np.float32(3.0)
    elif case == "even_all_equal":
        counts[:] = 4
        present[:] = True
        even = True
    flags = (implicit, wf, np.bool_(even), np.bool_(active))
    want = _det("class_boosts", jax.jit(jk._class_boosts), counts, present, desired, *flags)
    got = tk._class_boosts(*(torch.from_numpy(np.asarray(a)) for a in
                             (counts, present, desired) + flags))
    assert_bits_equal(got, want)


def _random_batch(seed=4, G=2, N=64, V=3):
    """BatchArgs/BatchState planes with pad rows, exact ties and every
    score plane firing somewhere."""
    rng = np.random.default_rng(seed)
    cap = rng.choice([2000, 4000, 8000], (N, 4)).astype(np.int32)
    cap[:8] = cap[8]  # a tier of identical nodes
    used = (cap * rng.uniform(0.0, 0.6, (N, 4))).astype(np.int32)
    used[:8] = used[8]
    usable = cap[:, :2].astype(np.float32)
    used[-4:] = 2**30  # pad rows
    usable[-4:] = 1.0
    args = dict(
        capacity=cap, usable=usable, feasible=rng.random((G, N)) > 0.2,
        affinity=rng.uniform(-1, 1, (G, N)).astype(np.float32),
        affinity_present=rng.random((G, N)) > 0.7,
        group_count=np.array([5, 40][:G], np.int32),
        group_eval=np.zeros(G, np.int32),
        node_value=rng.integers(-1, V, (G, N)).astype(np.int32),
        spread_desired=rng.uniform(1, 20, (G, V)).astype(np.float32),
        spread_implicit=np.full(G, -1.0, np.float32),
        spread_weight_frac=np.full(G, 0.5, np.float32),
        spread_even=np.array([False, True][:G]),
        spread_active=np.ones(G, bool),
        perm=rng.permutation(N).astype(np.int32)[None, :],
        ring=np.array([N - 4], np.int32),
        demands=np.tile(np.array([100, 256, 10, 1], np.int32), (4, 1)),
        groups=np.zeros(4, np.int32), limits=np.full(4, N, np.int32),
        valid=np.ones(4, bool),
    )
    state = dict(
        used=used, collisions=rng.integers(0, 3, (G, N)).astype(np.int32),
        spread_counts=rng.integers(0, 5, (G, V)).astype(np.int32),
        spread_present=rng.random((G, V)) > 0.3, offset=np.zeros(1, np.int32),
    )
    return args, state


@pytest.mark.parametrize("g", [0, 1])
def test_scores_bit_equal(g, monkeypatch):
    # Compiled as one program, jk._scores lets XLA:CPU contract the pow10
    # Horner chain into FMAs (its LLVM backend allows FMA fusion whatever
    # --xla_allow_excess_precision says), which the JAX package's float
    # contract rules out and the port does not do. So the reference runs
    # _scores op by op, where no contraction can span two ops, with
    # _binpack as its own deterministic program (the XLA constant-reciprocal
    # rule applies there; test_binpack_bit_equal pins it).
    args, state = _random_batch()
    jargs, jstate = jk.BatchArgs(**args), jk.BatchState(**state)
    demand = args["demands"][0]
    n = args["capacity"].shape[0]
    binpack = jax.jit(jk._binpack).lower(
        np.zeros(n, np.float32), np.zeros(n, np.float32)
    ).compile(compiler_options=jk.DET_COMPILER_OPTIONS)
    monkeypatch.setattr(jk, "_binpack", binpack)
    want = np.asarray(jk._scores(jargs, jstate, g, demand))  # eager: op by op
    got = tk._scores(cpu(args), cpu(state), g, torch.from_numpy(demand))
    assert_bits_equal(got, want)


def test_rot_incl_bit_equal():
    rng = np.random.default_rng(6)
    x = rng.random(200) > 0.5
    positions = np.arange(200, dtype=np.int32)
    fn = jax.jit(jk._rot_incl)
    for offset in (0, 1, 77, 199):
        want = _det("rot_incl", fn, x, np.int32(offset), np.int32(x.sum()), positions)
        got = tk._rot_incl(torch.from_numpy(x), offset, int(x.sum()), torch.from_numpy(positions))
        assert_bits_equal(got, want)


# ---------------------------------------------------------------------------
# K5: the exact sequential scan
# ---------------------------------------------------------------------------


def _exact_pair(args, init, n_real):
    jargs = args if hasattr(args, "_fields") else jk.BatchArgs(**args)
    jinit = init if hasattr(init, "_fields") else jk.BatchState(**init)
    want_state, want = _det("exact", jk._plan_batch_jit, jargs, jinit, n_real)
    got_state, got = tk.plan_batch(cpu(jargs), cpu(jinit), n_real)
    assert_bits_equal(got, want)
    for name in jk.BatchState._fields:
        assert_bits_equal(getattr(got_state, name), getattr(want_state, name))
    return np.asarray(want)


@pytest.mark.parametrize("spread", [True, False])
def test_exact_scan_matches(spread):
    c = mc.build_cluster(96, 128, seed=1)
    want = _exact_pair(*mc.exact_problem(c, spread=spread), 96)
    assert (want >= 0).sum() == 128


def test_exact_scan_wavefront_groups():
    c = mc.build_cluster(96, 128, seed=2)
    _exact_pair(*mc.wavefront_problem(c, n_groups=8), 96)


def test_exact_scan_padded_cluster():
    c = mc.pad_cluster(mc.build_cluster(90, 128, seed=3), 96)
    want = _exact_pair(*mc.exact_problem(c), 90)
    assert want.max() < 90


def test_exact_scan_multi_eval_ring():
    """Two evals with their own rings, ring sizes and cursors, deferral and
    replay, exhausted nodes and invalid lanes (``multi_eval_problem``)."""
    args, init = multi_eval_problem()
    want = _exact_pair(args, init, args["capacity"].shape[0])
    assert (want[:-3] < 0).any() and (want[:-3] >= 0).any()


# ---------------------------------------------------------------------------
# K6: the run planner
# ---------------------------------------------------------------------------

RUNS_A_PAD = 1024  # one compiled shape for every case below


def _runs_pair(args, init, even_mode=False):
    want, want_rounds = _det("runs", jk._plan_batch_runs_jit, args, init, RUNS_A_PAD, even_mode)
    got, got_rounds = tk.plan_batch_runs(cpu(args), cpu(init), RUNS_A_PAD, even_mode)
    assert_bits_equal(got, want)
    assert int(got_rounds) == int(want_rounds)
    return np.asarray(want), int(want_rounds)


@pytest.mark.parametrize("affinity,spread", [(True, True), (False, True), (True, False), (False, False)])
def test_runs_matches(affinity, spread):
    c = mc.build_cluster(96, 700, seed=4)
    want, rounds = _runs_pair(*mc.runs_problem(c, affinity=affinity, spread=spread))
    assert (want >= 0).sum() == 700
    assert rounds < 700  # runs resolved more than one placement per round


def test_runs_even_mode():
    c = mc.build_cluster(96, 300, n_values=3, seed=5)
    args, init = mc.runs_problem(c, affinity=False, spread=True)
    args = args._replace(spread_even=np.bool_(True))
    _runs_pair(args, init, even_mode=True)


def test_runs_fill_run_past_runcap():
    """One roomy node with affinity wins every placement: its fill run is
    cut at RUNCAP and resumed by the next round."""
    args, init = runcap_problem(mc.build_cluster, mc.runs_problem)
    want, rounds = _runs_pair(jk.RunArgs(**args), init)
    assert (want[:1000] == 0).sum() > tk.RUNCAP  # node 0 is the roomy one
    assert rounds >= 2


# ---------------------------------------------------------------------------
# K7: the windowed planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("limit", [2, 10])
def test_windowed_matches(limit):
    c = mc.build_cluster(96, 127, seed=8)  # 127 allocs: not a multiple of L
    args, used0, coll0 = mc.window_problem(c, limit=limit)
    want, want_rounds = _det("windowed", jk._plan_batch_windowed_jit, args, used0, coll0, 96, 128)
    got, got_rounds = tk.plan_batch_windowed(cpu(args), *cpu((used0, coll0)), 96, 128)
    assert_bits_equal(got, want)
    assert int(got_rounds) == int(want_rounds) > 1
    assert (np.asarray(want)[:127] >= 0).all()


# ---------------------------------------------------------------------------
# what a kernel wrapper checks before it passes pointers
# ---------------------------------------------------------------------------


def test_kernel_input_checks():
    dev = torch.device("cpu")
    args, init = problems.wavefront_problem(problems.build_cluster(40, 30, seed=1), n_groups=3)
    named = {**cpu(args)._asdict(), **cpu(init)._asdict()}
    dims = tk._check_cuda(named, tk._EXACT_SHAPES, dev)
    assert dims == dict(N=40, C=4, G=3, V=4, E=1, A=30)
    with pytest.raises(ValueError, match="usable"):
        tk._check_cuda({**named, "usable": named["usable"][:7]}, tk._EXACT_SHAPES, dev)
    with pytest.raises(ValueError, match="spread_desired"):
        tk._check_cuda({**named, "spread_desired": named["spread_desired"][:, :2]},
                       tk._EXACT_SHAPES, dev)
    with pytest.raises(TypeError, match="int64"):
        tk._check_cuda({**named, "groups": named["groups"].long()}, tk._EXACT_SHAPES, dev)
    with pytest.raises(ValueError, match="contiguous"):
        tk._check_cuda({**named, "capacity": named["capacity"].t().contiguous().t()},
                       tk._EXACT_SHAPES, dev)
    with pytest.raises(ValueError, match="expected meta"):
        tk._check_cuda(named, tk._EXACT_SHAPES, torch.device("meta"))
    tk._check_index(named["groups"], 3, "groups")
    with pytest.raises(ValueError, match="groups"):
        tk._check_index(named["groups"], 2, "groups")
