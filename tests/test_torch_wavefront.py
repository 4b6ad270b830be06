"""The port's wavefront planner against the JAX package's, on the CPU.

Inputs are numpy from a seed (the multichip builders). The JAX side runs
under ``deterministic_scope()``, the bit-exact flavor; the port runs its
plain version (CPU tensors). Placements, final state and round counts must
be identical, and both must equal the sequential exact scan.
tests/test_torch_gpu.py holds the CUDA kernel against the plain version.
"""

import jax
import numpy as np
import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

from nomad_tpu.tpu import kernel as jk
from nomad_tpu.tpu import multichip as mc
from nomad_tpu.tpu import paging as jpaging
from nomad_tpu.tpu import wavefront as jwf
from nomad_tpu_torch.tpu import kernel as tk
from nomad_tpu_torch.tpu import paging as tpaging
from nomad_tpu_torch.tpu import problems
from nomad_tpu_torch.tpu import wavefront as twf


@pytest.fixture(autouse=True)
def _stanzas_reset():
    for m in (jwf, twf, jpaging, tpaging):
        m.reset()
    yield
    for m in (jwf, twf, jpaging, tpaging):
        m.reset()


def cpu(obj):
    return tk.from_numpy(obj, "cpu")


def _jax_wavefront(args, init, n_real):
    """JAX's public wavefront dispatch, deterministic flavor, as numpy."""
    jargs = jk.BatchArgs(*[np.asarray(args[f]) for f in jk.BatchArgs._fields])
    jinit = jk.BatchState(*[np.asarray(init[f]) for f in jk.BatchState._fields])
    with jk.deterministic_scope():
        out = jwf.plan_batch_wavefront(jargs, jinit, n_real)
    state, placements, rounds = jax.tree_util.tree_map(np.asarray, out)
    return state, placements, int(rounds)


def _as_dicts(args, init):
    args = args._asdict() if hasattr(args, "_asdict") else args
    init = init._asdict() if hasattr(init, "_asdict") else init
    return dict(args), dict(init)


def _assert_same(port, want_state, want_placements, want_rounds=None):
    state, placements, rounds = port
    np.testing.assert_array_equal(placements.numpy(), want_placements)
    for name, got, want in zip(tk.BatchState._fields, state, want_state):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"state.{name}")
    if want_rounds is not None:
        assert rounds == want_rounds


@pytest.mark.parametrize("window", [8, 32])
@pytest.mark.parametrize("top_m", [1, 3])
@pytest.mark.parametrize("seed", [0, 3, 7])
def test_wavefront_matches_jax(seed, top_m, window):
    n_nodes, n_allocs = 1024, 256
    args, init = _as_dicts(*mc.wavefront_problem(mc.build_cluster(n_nodes, n_allocs, seed=seed)))
    for m in (jwf, twf):
        m.configure(enabled=True, max_round=window, contention_top_m=top_m)
    want_state, want, want_rounds = _jax_wavefront(args, init, n_nodes)
    got = twf.plan_batch_wavefront(cpu(args), cpu(init), n_nodes)
    _assert_same(got, want_state, want, want_rounds)
    assert (want >= 0).sum() == n_allocs and want_rounds < n_allocs
    # and both are the sequential scan
    scan_state, scan = tk.plan_batch_ref(cpu(args), cpu(init), n_nodes)
    _assert_same((scan_state, scan, None), want_state, want)


# ---------------------------------------------------------------------------
# the JAX suite's properties, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_single_group_serializes(seed):
    """One group: every pair of lanes shares the feasible set, so each round
    commits one lane."""
    n_nodes, n_allocs = 512, 64
    args, init = problems.exact_problem(problems.build_cluster(n_nodes, n_allocs, seed=seed))
    scan_state, scan = tk.plan_batch_ref(cpu(args), cpu(init), n_nodes)
    got = twf.plan_batch_wavefront(cpu(args), cpu(init), n_nodes)
    _assert_same(got, scan_state, scan.numpy(), n_allocs)


def test_sole_shared_node_takes_two_rounds():
    """Two groups whose only feasible node is the same node, which holds one
    of the two allocs: the second lane waits a round and stays unplaced."""
    n_nodes, V = 64, 4
    c = problems.build_cluster(n_nodes, 2, seed=1)
    args, init = problems.wavefront_problem(c, n_groups=2, overlap=0)
    sole = np.zeros((2, n_nodes), dtype=bool)
    sole[:, 5] = True
    cap5 = c["capacity"][5] - c["reserved"][5]
    args.update(feasible=sole, demands=np.tile((cap5 * 0.6).astype(np.int32), (2, 1)),
                spread_active=np.zeros(2, dtype=bool),
                spread_desired=np.full((2, V), -1.0, dtype=np.float32))
    state, placements, rounds = twf.plan_batch_wavefront(cpu(args), cpu(init), n_nodes)
    assert placements.tolist() == [5, -1]
    assert rounds == 2
    _, want, want_rounds = _jax_wavefront(args, init, n_nodes)
    np.testing.assert_array_equal(placements.numpy(), want)
    assert rounds == want_rounds


def test_disjoint_groups_commit_in_one_round():
    n_nodes, n_allocs = 512, 16
    args, init = problems.wavefront_problem(problems.build_cluster(n_nodes, n_allocs, seed=2),
                                            n_groups=16, overlap=0)
    scan_state, scan = tk.plan_batch_ref(cpu(args), cpu(init), n_nodes)
    got = twf.plan_batch_wavefront(cpu(args), cpu(init), n_nodes)
    _assert_same(got, scan_state, scan.numpy(), 1)


def _tied_problem():
    """Identical nodes with no usage, so every feasible node of a group ties
    on score: the top-M candidates are the lowest ring positions, and with
    M = 3 they reach into the next group's share of the ring."""
    n_nodes, n_allocs, G = 64, 24, 4
    c = problems.build_cluster(n_nodes, n_allocs, seed=9)
    c["capacity"][:] = c["capacity"][0]
    c["usable"][:] = c["usable"][0]
    c["reserved"][:] = 0
    c["feasible"][:] = True
    args, init = problems.wavefront_problem(c, n_groups=G, spread=False, overlap=2)
    return args, init, n_nodes


def test_tie_ordered_top_m():
    args, init, n_nodes = _tied_problem()
    rounds = {}
    for top_m in (1, 3):
        for m in (jwf, twf):
            m.configure(max_round=8, contention_top_m=top_m)
        want_state, want, want_rounds = _jax_wavefront(args, init, n_nodes)
        got = twf.plan_batch_wavefront(cpu(args), cpu(init), n_nodes)
        _assert_same(got, want_state, want, want_rounds)
        rounds[top_m] = want_rounds
    assert rounds[3] > rounds[1]

    # one lane's candidates directly: the winner, then the top-2 by score
    # with ties to the lower ring position
    jargs = jk.BatchArgs(*[np.asarray(args[f]) for f in jk.BatchArgs._fields])
    jinit = jk.BatchState(*[np.asarray(init[f]) for f in jk.BatchState._fields])
    a, s = cpu(args), cpu(init)
    for lane in range(4):
        g, limit = int(args["groups"][lane]), int(args["limits"][lane])
        want = jwf._select(jargs, jinit, 1, 3, jargs.demands[lane], g, limit, True)
        got = twf._select(a, s, 1, 3, a.demands[lane], g, limit, True)
        assert got[0] == int(want[0]) and got[4] == np.asarray(want[4]).tolist()
        assert got[1:4] == (bool(want[1]), bool(want[2]), int(want[3]))


# ---------------------------------------------------------------------------
# tournaments at S = 4
# ---------------------------------------------------------------------------


def test_tournaments_match_jax_at_four_shards():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2, 64).astype(bool)
    xi = rng.integers(-50, 50, 64).astype(np.int32)
    xf = rng.normal(size=64).astype(np.float32)
    positions = np.arange(64, dtype=np.int32)
    for s in (1, 4):
        assert int(twf._tsum(torch.from_numpy(xi), s)) == int(jwf._tsum(xi, s))
        assert float(twf._tmax(torch.from_numpy(xf), s)) == float(jwf._tmax(xf, s))
        assert int(twf._tmin(torch.from_numpy(xi), s)) == int(jwf._tmin(xi, s))
        np.testing.assert_array_equal(twf._tcumsum(torch.from_numpy(xi), s).numpy(),
                                      np.asarray(jwf._tcumsum(xi, s)))
        for offset in (0, 17, 63):
            total = int(x.sum())
            got = twf._rot_incl_t(torch.from_numpy(x), offset, total, torch.from_numpy(positions), s)
            want = jwf._rot_incl_t(x, offset, total, positions, s)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # the whole drive, its reductions staged over four shards
    n_nodes = 512
    args, init = _as_dicts(*mc.wavefront_problem(mc.build_cluster(n_nodes, 128, seed=4)))
    jargs = jk.BatchArgs(*[np.asarray(args[f]) for f in jk.BatchArgs._fields])
    jinit = jk.BatchState(*[np.asarray(init[f]) for f in jk.BatchState._fields])
    with jk.deterministic_scope():
        out, _ = jk._dispatch("wavefront", jwf._plan_batch_wavefront_jit,
                              (jargs, jinit, n_nodes, 16, 2, 4), "S4")
    want_state, want, want_rounds = jax.tree_util.tree_map(np.asarray, out)
    got = twf.plan_batch_wavefront_ref(cpu(args), cpu(init), n_nodes, 16, 2, 4)
    _assert_same(got, want_state, want, int(want_rounds))


# ---------------------------------------------------------------------------
# the config stanza
# ---------------------------------------------------------------------------


def test_stanza_resolves_like_jax(monkeypatch):
    def knobs(m):
        return (m.enabled(), m.max_round(), m.contention_top_m(), m.window_for(4),
                m.window_for(512), m.shards_for(3072, 8), m.shards_for(3070, 8))

    assert knobs(twf) == knobs(jwf) == (False, twf.DEFAULT_MAX_ROUND, twf.DEFAULT_TOP_M,
                                        4, 32, 8, 1)
    monkeypatch.setenv("NOMAD_TPU_WAVEFRONT", "1")
    monkeypatch.setenv("NOMAD_TPU_WAVEFRONT_MAX_ROUND", "16")
    monkeypatch.setenv("NOMAD_TPU_WAVEFRONT_TOP_M", "0")
    assert knobs(twf) == knobs(jwf) == (True, 16, 1, 4, 16, 8, 1)
    for m in (jwf, twf):
        m.configure(enabled=False, max_round=8, contention_top_m=2)
    assert knobs(twf) == knobs(jwf) == (False, 8, 2, 4, 8, 8, 1)
    for m in (jwf, twf):
        m.reset()
    assert knobs(twf) == knobs(jwf) == (True, 16, 1, 4, 16, 8, 1)
