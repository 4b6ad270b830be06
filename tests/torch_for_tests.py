"""``torch`` and numpy problem builders shared by the port's tests.

The tier-1 lockdep witness (tests/conftest.py) replaces ``threading.Lock``
with a wrapper that has no ``_at_fork_reinit``. Importing torch imports
``concurrent.futures.thread``, whose module-level lock needs that method,
so torch is imported with the real lock factory and the witness is put
back right after. Where the witness was never loaded (the GPU tests run
with ``--noconftest`` on a machine without JAX), torch imports plainly.

The builders return dicts keyed by the planner args' field names, made
with numpy only, so the CPU tests hand them to the JAX package and the
GPU tests to the port alone.
"""

import sys

import numpy as np

_lockdep = sys.modules.get("nomad_tpu.testing.lockdep")
_witness_on = _lockdep is not None and _lockdep.installed()
if _witness_on:
    _lockdep.uninstall()
try:
    import torch  # noqa: F401
    import concurrent.futures.thread  # noqa: F401
finally:
    if _witness_on:
        _lockdep.install()


def multi_eval_problem():
    """(args, init) of an exact scan over two evals with their own shuffled
    rings, ring sizes and cursors. A tiny group count makes anti-affinity
    drive scores nonpositive, so the deferral and replay paths run; small
    capacities exhaust nodes; the last three lanes are invalid."""
    rng = np.random.default_rng(7)
    N, A = 48, 40
    cap = np.stack([rng.choice([300, 500], N), rng.choice([512, 1024], N),
                    np.full(N, 10_000), np.full(N, 100)], axis=1).astype(np.int32)
    perm = np.stack([rng.permutation(N), rng.permutation(N)]).astype(np.int32)
    ring = np.array([N - 6, N - 20], np.int32)
    # each eval's ring holds its first ring[e] perm entries
    feasible = np.zeros((2, N), bool)
    feasible[0, perm[0, : ring[0]]] = rng.random(ring[0]) > 0.15
    feasible[1, perm[1, :3]] = True  # group 1 exhausts its three nodes
    groups = (np.arange(A) % 2).astype(np.int32)
    args = dict(
        capacity=cap, usable=cap[:, :2].astype(np.float32), feasible=feasible,
        affinity=np.zeros((2, N), np.float32), affinity_present=np.zeros((2, N), bool),
        group_count=np.array([2, 3], np.int32), group_eval=np.array([0, 1], np.int32),
        node_value=np.tile((np.arange(N) % 3).astype(np.int32), (2, 1)),
        spread_desired=np.full((2, 3), -1.0, np.float32),
        spread_implicit=np.full(2, -1.0, np.float32),
        spread_weight_frac=np.zeros(2, np.float32), spread_even=np.zeros(2, bool),
        spread_active=np.zeros(2, bool), perm=perm, ring=ring,
        demands=np.tile(np.array([100, 128, 10, 5], np.int32), (A, 1)),
        groups=groups, limits=np.where(groups == 0, 2, 4).astype(np.int32),
        valid=np.arange(A) < A - 3,
    )
    init = dict(
        used=np.zeros((N, 4), np.int32), collisions=np.zeros((2, N), np.int32),
        spread_counts=np.zeros((2, 3), np.int32), spread_present=np.zeros((2, 3), bool),
        offset=np.zeros(2, np.int32),
    )
    return args, init


def runcap_problem(build_cluster, runs_problem):
    """(args dict, init) of a run planner eval in which one roomy node with
    affinity wins every placement, so its fill run is cut at RUNCAP (512)
    and resumed by the next round. Takes either package's builders."""
    c = build_cluster(96, 1000, seed=6)
    c["feasible"][0] = True
    c["capacity"][0] = [10**6, 10**7, 10**7, 10**6]
    c["usable"][0] = [10**6, 10**7]
    args, init = runs_problem(c, affinity=True, spread=False)
    args = dict(args._asdict() if hasattr(args, "_asdict") else args)
    aff = np.zeros(96, np.float32)
    aff[0] = 0.9
    perm = c["perm"]
    args.update(group_count=np.int32(10**6), affinity=aff[perm],
                affinity_present=(aff > 0)[perm])
    return args, init
