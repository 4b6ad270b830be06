"""Seeded synthetic clusters and per-planner problems, as numpy.

The port's own copy of the builders in ``nomad_tpu/tpu/multichip.py``
(``build_cluster`` … ``window_problem``) and of ``batch_sched._bucket``:
the same arrays from the same seed, returned as plain dicts keyed by the
planner args' field names (``kernel.from_numpy`` turns them into tensors).
``eval_planes`` turns an exact-scan problem into the columnar planes that
``planner.plan_eval`` takes.
"""

from __future__ import annotations

import numpy as np


def bucket(n: int) -> int:
    """Round up to limit distinct shapes: powers of two up to 1024, then
    multiples of 1024 (the JAX scheduler's padding ladder)."""
    size = 8
    while size < n and size < 1024:
        size *= 2
    if n <= size:
        return size
    return ((n + 1023) // 1024) * 1024


def build_cluster(n_nodes: int, n_allocs: int, n_values: int = 4, seed: int = 0):
    """Heterogeneous capacities, ~10% infeasible nodes, spread classes."""
    rng = np.random.default_rng(seed)
    capacity = np.stack(
        [
            rng.choice([4000, 8000, 16000, 32000], n_nodes),
            rng.choice([8192, 16384, 32768], n_nodes),
            np.full(n_nodes, 100 * 1024),
            np.full(n_nodes, 1000),
        ],
        axis=1,
    ).astype(np.int32)
    reserved = np.tile(np.array([100, 256, 4096, 0], dtype=np.int32), (n_nodes, 1))
    usable = (capacity[:, :2] - reserved[:, :2]).astype(np.float32)
    feasible = rng.random(n_nodes) > 0.1
    node_value = (np.arange(n_nodes) % n_values).astype(np.int32)
    perm = rng.permutation(n_nodes).astype(np.int32)
    demand = np.array([100, 128, 10, 5], dtype=np.int32)
    return dict(
        capacity=capacity,
        reserved=reserved,
        usable=usable,
        feasible=feasible,
        node_value=node_value,
        perm=perm,
        demand=demand,
        n_allocs=n_allocs,
        n_values=n_values,
    )


def pad_cluster(c: dict, n_pad: int) -> dict:
    """Pad the node axis to ``n_pad`` rows: pad rows are infeasible, carry
    zero capacity and a poisoned ``reserved`` (2**30), and extend the ring's
    tail ids; ``n_real`` records the true node count."""
    n = c["capacity"].shape[0]
    if n_pad < n:
        raise ValueError(f"n_pad {n_pad} < real node count {n}")
    out = dict(c)
    out["n_real"] = n
    if n_pad == n:
        return out
    k = n_pad - n
    out["capacity"] = np.concatenate(
        [c["capacity"], np.zeros((k, c["capacity"].shape[1]), np.int32)]
    )
    out["reserved"] = np.concatenate(
        [c["reserved"], np.full((k, c["reserved"].shape[1]), 2**30, np.int32)]
    )
    out["usable"] = np.concatenate([c["usable"], np.ones((k, 2), np.float32)])
    out["feasible"] = np.concatenate([c["feasible"], np.zeros(k, bool)])
    out["node_value"] = np.concatenate([c["node_value"], np.full(k, -1, np.int32)])
    out["perm"] = np.concatenate([c["perm"], np.arange(n, n_pad, dtype=np.int32)])
    return out


def exact_problem(c, spread: bool = True):
    """(args, state) dicts for the exact sequential-scan planner."""
    n_nodes = c["capacity"].shape[0]
    n_real = c.get("n_real", n_nodes)
    n_allocs = c["n_allocs"]
    V = c["n_values"]
    args = dict(
        capacity=c["capacity"],
        usable=c["usable"],
        feasible=c["feasible"][None, :],
        affinity=np.zeros((1, n_nodes), dtype=np.float32),
        affinity_present=np.zeros((1, n_nodes), dtype=bool),
        group_count=np.full(1, n_allocs, dtype=np.int32),
        group_eval=np.zeros(1, dtype=np.int32),
        node_value=c["node_value"][None, :],
        spread_desired=np.full(
            (1, V), float(n_allocs) / V if spread else -1.0, dtype=np.float32
        ),
        spread_implicit=np.full(1, -1.0, dtype=np.float32),
        spread_weight_frac=np.ones(1, dtype=np.float32),
        spread_even=np.zeros(1, dtype=bool),
        spread_active=np.full(1, spread, dtype=bool),
        perm=c["perm"][None, :],
        ring=np.array([n_real], dtype=np.int32),
        demands=np.tile(c["demand"], (n_allocs, 1)),
        groups=np.zeros(n_allocs, dtype=np.int32),
        limits=np.full(n_allocs, n_nodes, dtype=np.int32),
        valid=np.ones(n_allocs, dtype=bool),
    )
    init = dict(
        used=c["reserved"].copy(),
        collisions=np.zeros((1, n_nodes), dtype=np.int32),
        spread_counts=np.zeros((1, V), dtype=np.int32),
        spread_present=np.zeros((1, V), dtype=bool),
        offset=np.zeros(1, dtype=np.int32),
    )
    return args, init


def wavefront_problem(c, n_groups: int = 32, spread: bool = True, overlap: int = 16):
    """(args, state) dicts for a multi-tenant batch of ``n_groups`` groups in
    interleaved submission order, each feasible on a mostly-disjoint slice of
    the cluster (every ``overlap``-th node is shared with the next group),
    with full-ring limits, per-group demand tiers and spread."""
    n_nodes = c["capacity"].shape[0]
    n_real = c.get("n_real", n_nodes)
    n_allocs = c["n_allocs"]
    V = c["n_values"]
    G = int(n_groups)
    ids = np.arange(n_nodes)
    gid = np.arange(G)
    slice_of = (ids // 8) % G
    base = slice_of[None, :] == gid[:, None]
    if overlap:
        shared = ids % max(int(overlap), 1) == 0
        base = base | (
            shared[None, :] & (((slice_of + 1) % G)[None, :] == gid[:, None])
        )
    feasible = base & c["feasible"][None, :]
    groups = (np.arange(n_allocs) % G).astype(np.int32)
    group_count = np.bincount(groups, minlength=G).astype(np.int32)
    scale = (1 + groups % 3).astype(np.int32)
    demands = c["demand"][None, :] * scale[:, None]
    args = dict(
        capacity=c["capacity"],
        usable=c["usable"],
        feasible=feasible,
        affinity=np.zeros((G, n_nodes), dtype=np.float32),
        affinity_present=np.zeros((G, n_nodes), dtype=bool),
        group_count=np.maximum(group_count, 1),
        group_eval=np.zeros(G, dtype=np.int32),
        node_value=np.tile(c["node_value"], (G, 1)),
        spread_desired=np.tile(
            np.full(
                (1, V),
                float(max(int(group_count.max()), 1)) / V if spread else -1.0,
                dtype=np.float32,
            ),
            (G, 1),
        ),
        spread_implicit=np.full(G, -1.0, dtype=np.float32),
        spread_weight_frac=np.ones(G, dtype=np.float32),
        spread_even=np.zeros(G, dtype=bool),
        spread_active=np.full(G, spread, dtype=bool),
        perm=c["perm"][None, :],
        ring=np.array([n_real], dtype=np.int32),
        demands=demands.astype(np.int32),
        groups=groups,
        limits=np.full(n_allocs, n_nodes, dtype=np.int32),
        valid=np.ones(n_allocs, dtype=bool),
    )
    init = dict(
        used=c["reserved"].copy(),
        collisions=np.zeros((G, n_nodes), dtype=np.int32),
        spread_counts=np.zeros((G, V), dtype=np.int32),
        spread_present=np.zeros((G, V), dtype=bool),
        offset=np.zeros(1, dtype=np.int32),
    )
    return args, init


def runs_problem(c, affinity: bool = True, spread: bool = True):
    """(args dict, init tuple) for the run-based full-ring planner, in
    rotation order."""
    n_nodes = c["capacity"].shape[0]
    V = c["n_values"]
    perm = c["perm"]
    aff = (
        np.where(np.arange(n_nodes) % 5 == 0, 0.5, 0.0).astype(np.float32)
        if affinity
        else np.zeros(n_nodes, dtype=np.float32)
    )
    args = dict(
        capacity=c["capacity"][perm],
        usable=c["usable"][perm],
        feasible=c["feasible"][perm],
        affinity=aff[perm],
        affinity_present=(aff > 0)[perm],
        group_count=np.int32(c["n_allocs"]),
        node_value=c["node_value"][perm],
        spread_desired=np.full(
            V, float(c["n_allocs"]) / V if spread else -1.0, dtype=np.float32
        ),
        spread_implicit=np.float32(-1.0),
        spread_weight_frac=np.float32(1.0),
        spread_even=np.bool_(False),
        spread_active=np.bool_(spread),
        perm=perm,
        demand=c["demand"],
        n_allocs=np.int32(c["n_allocs"]),
    )
    init = (
        c["reserved"][perm].copy(),
        np.zeros(n_nodes, dtype=np.int32),
        np.zeros(V, dtype=np.int32),
        np.zeros(V, dtype=bool),
    )
    return args, init


def window_problem(c, limit: int = 10):
    """(args dict, used0, collisions0) for the windowed planner."""
    n_nodes = c["capacity"].shape[0]
    args = dict(
        capacity=c["capacity"],
        usable=c["usable"],
        feasible=c["feasible"],
        perm=c["perm"],
        demand=c["demand"],
        group_count=np.int32(c["n_allocs"]),
        limit=np.int32(limit),
        n_allocs=np.int32(c["n_allocs"]),
    )
    return args, c["reserved"].copy(), np.zeros(n_nodes, dtype=np.int32)


def eval_planes(args: dict, init: dict, n_real: int | None = None) -> dict:
    """The columnar planes of one eval (``planner.plan_eval``'s input) from
    an exact-scan problem: the args' fields, the initial state as
    ``used0``/``collisions0``/``counts0``/``present0``, and the real node
    and alloc counts."""
    planes = {k: np.asarray(v) for k, v in args.items()}
    planes.update(
        used0=np.asarray(init["used"]),
        collisions0=np.asarray(init["collisions"]),
        counts0=np.asarray(init["spread_counts"]),
        present0=np.asarray(init["spread_present"]),
        n_real=int(args["ring"][0]) if n_real is None else int(n_real),
        a_real=int(np.asarray(args["valid"]).sum()),
    )
    return planes
