"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and is marked ``gpu``; without one it
skips. The file imports neither JAX nor the JAX package, so on the card it
runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Placements, final state and round counts must be identical: the planners
break ties by exact float equality, so no tolerance applies.
"""

import numpy as np
import pytest
from torch_for_tests import multi_eval_problem, runcap_problem, torch

from nomad_tpu_torch.tpu import kernel as tk
from nomad_tpu_torch.tpu import planner, problems


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


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
