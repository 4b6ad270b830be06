"""Seeded synthetic clusters and per-planner problems, as numpy.

The port's own copy of the builders in ``nomad_tpu/tpu/multichip.py``
(``build_cluster`` … ``window_problem``) and of ``batch_sched._bucket``:
the same arrays from the same seed, returned as plain dicts keyed by the
planner args' field names (``kernel.from_numpy`` turns them into tensors).
``eval_planes`` turns an exact-scan problem into the columnar planes that
``planner.plan_eval`` takes; ``drain_problem`` makes a batch of evals for
the drain collector (``drain.KernelBatchCollector``); ``paged_case`` makes
the paged planner's arguments at up to a million nodes, and
``paged_eval_planes`` the same eval as ``plan_eval``'s planes.
"""

from __future__ import annotations

import math

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


def paged_case(seed: int, n: int, a: int, limit: int = 8, c: int = 4) -> tuple:
    """The paged planner's arguments for an ``n``-node, ``a``-alloc windowed
    eval (the JAX package's ``bench._paged_case``): random planes at node
    counts no mock cluster reaches, in the shapes the scheduler builds.
    Returns (capacity, usable, feasible, perm, demand, group_count, limit,
    n_allocs, used0, collisions0, n_real, a_pad)."""
    rng = np.random.default_rng(seed)
    capacity = rng.integers(8, 64, size=(n, c)).astype(np.int32)
    usable = np.maximum(capacity[:, :2].astype(np.float32), 1.0)
    feasible = rng.random(n) < 0.9
    demand = rng.integers(1, 4, size=c).astype(np.int32)
    used0 = rng.integers(0, 4, size=(n, c)).astype(np.int32)
    collisions0 = rng.integers(0, 2, size=n).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    return (capacity, usable, feasible, perm, demand, 1, int(limit),
            int(a), used0, collisions0, int(n), int(a))


def paged_eval_planes(case: tuple) -> dict:
    """The columnar planes of a ``paged_case`` eval (``planner.plan_eval``'s
    input): one group with no affinity or spread and the case's limit, so
    that ``plan_eval`` routes it to the windowed planner, or to the paged
    one when its planes exceed the paging budget."""
    capacity, usable, feasible, perm, demand, group_count, limit, n_allocs, used0, collisions0, \
        n_real, _ = case
    n = capacity.shape[0]
    return dict(
        capacity=capacity, usable=usable, feasible=feasible[None],
        affinity=np.zeros((1, n), np.float32), affinity_present=np.zeros((1, n), bool),
        group_count=np.array([group_count], np.int32), group_eval=np.zeros(1, np.int32),
        node_value=np.full((1, n), -1, np.int32), spread_desired=np.full((1, 1), -1.0, np.float32),
        spread_implicit=np.full(1, -1.0, np.float32), spread_weight_frac=np.zeros(1, np.float32),
        spread_even=np.zeros(1, bool), spread_active=np.zeros(1, bool), perm=perm[None],
        ring=np.array([n_real], np.int32), demands=np.tile(demand, (n_allocs, 1)),
        groups=np.zeros(n_allocs, np.int32), limits=np.full(n_allocs, limit, np.int32),
        valid=np.ones(n_allocs, bool), used0=used0, collisions0=collisions0[None],
        counts0=np.zeros((1, 1), np.int32), present0=np.zeros((1, 1), bool),
        n_real=int(n_real), a_real=int(n_allocs),
    )


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


def compute_limit(num_nodes: int, batch: bool, has_affinity_or_spread: bool) -> int:
    """Candidate-scan bound (the JAX package's ``columnar.compute_limit``,
    ref stack.go:74-87)."""
    if has_affinity_or_spread:
        return 2**31 - 1
    limit = 2
    if not batch and num_nodes > 0:
        limit = max(limit, int(math.ceil(math.log2(num_nodes))))
    return limit


#: the job mix of each synthetic drain batch: groups per eval, allocs per
#: group and datacenters per eval as (low, high), the share of groups with
#: a datacenter spread or a node affinity, and the per-alloc cpu (MHz) and
#: memory (MB) choices
DRAIN_SHAPES = {
    # bench.py bench_drain's jobs: one group of 1-4 allocs over all 4 DCs
    "drain-bench": dict(groups=(1, 1), allocs=(1, 4), dcs=(4, 4), spread_share=0.0,
                        affinity_share=0.0, cpu=(100, 250), mem=(64, 128)),
    # a synthetic stress shape of the multi-eval scan, not a traffic mix
    # the system serves: two groups of 64 allocs (4,096 lanes at 32
    # evals), rings over 1-4 DCs, spread on half the groups
    "drain-tenant": dict(groups=(2, 2), allocs=(64, 64), dcs=(1, 4), spread_share=0.5,
                         affinity_share=0.25, cpu=(100, 250, 500), mem=(64, 128, 256)),
}
N_DCS = 4


def drain_problem(c, n_evals: int, shape: str = "drain-bench", seed: int = 0):
    """(shared, preps): a seeded drain batch of ``n_evals`` evals over the
    nodes of ``c`` (``build_cluster``'s, unpadded), node i in datacenter
    ``dc{i % 4 + 1}``. ``shared`` holds the node planes ``capacity``,
    ``usable`` and ``used0`` (the reserved usage plus existing allocs on
    about a third of the nodes) and ``n_real``. Each prep is a dict of
    ``drain.DrainPrep``'s fields, with ``planes_list`` a list of dicts of
    ``GroupPlanes``' fields: the eval's ring is a shuffle of the nodes in
    its datacenters, each group has its feasible, affinity and spread
    planes, demand and limit."""
    mix = DRAIN_SHAPES[shape]
    rng = np.random.default_rng(seed)
    n = c["capacity"].shape[0]
    dc_of = (np.arange(n) % N_DCS).astype(np.int32)
    used0 = c["reserved"].astype(np.int32).copy()
    busy = rng.random(n) < 0.3
    used0[busy, 0] += rng.choice([250, 500, 1000], int(busy.sum())).astype(np.int32)
    used0[busy, 1] += rng.choice([256, 512, 1024], int(busy.sum())).astype(np.int32)
    shared = dict(capacity=c["capacity"], usable=c["usable"], used0=used0, n_real=n)

    preps = []
    for i in range(n_evals):
        k = int(rng.integers(mix["dcs"][0], mix["dcs"][1] + 1))
        dcs = np.sort(rng.choice(N_DCS, k, replace=False))
        elig = np.flatnonzero(np.isin(dc_of, dcs)).astype(np.int32)
        n_groups = int(rng.integers(mix["groups"][0], mix["groups"][1] + 1))
        planes_list, demand, limit, counts = [], [], [], []
        collisions0 = np.zeros((n_groups, n), dtype=np.int32)
        for g in range(n_groups):
            count = int(rng.integers(mix["allocs"][0], mix["allocs"][1] + 1))
            feasible = c["feasible"] & (rng.random(n) > 0.05)
            planes = dict(name=f"g{g}", feasible=feasible,
                          affinity=np.zeros(n, np.float32),
                          affinity_present=np.zeros(n, bool), count=count)
            if rng.random() < mix["affinity_share"]:
                aff = np.where(rng.random(n) < 0.2, 0.5, 0.0).astype(np.float32)
                planes.update(affinity=aff, affinity_present=aff > 0)
            if rng.random() < mix["spread_share"]:
                planes.update(node_value=dc_of.copy(), weight_frac=1.0,
                              values=[f"dc{d + 1}" for d in range(N_DCS)],
                              counts0=np.zeros(N_DCS, np.int32),
                              present0=np.zeros(N_DCS, bool))
                desired = np.full(N_DCS, -1.0, np.float32)
                if rng.random() < 0.5:
                    planes["even"] = True
                else:
                    desired[dcs] = (100 // k) / 100.0 * count
                    total = float(desired[dcs].sum())
                    if 0 < total < count:
                        planes["implicit"] = float(count) - total
                planes["desired"] = desired
            if rng.random() < 0.25:  # same-job allocs already on a few nodes
                collisions0[g] = (rng.random(n) < 0.02).astype(np.int32)
            spread_or_aff = "node_value" in planes or bool(planes["affinity_present"].any())
            planes_list.append(planes)
            demand.append([int(rng.choice(mix["cpu"])), int(rng.choice(mix["mem"])), 150, 0])
            limit.append(min(compute_limit(len(elig), False, spread_or_aff), len(elig)))
            counts.append(count)
        gid_real = rng.permutation(np.repeat(np.arange(n_groups), counts)).astype(np.int32)
        preps.append(dict(
            eval_id=f"eval-{i:03d}",
            priority=int(rng.choice([30, 50, 70])),
            create_index=100 + i,
            planes_list=planes_list,
            g_index={p["name"]: g for g, p in enumerate(planes_list)},
            g_demand=np.array(demand, dtype=np.int32),
            g_limit=np.array(limit, dtype=np.int32),
            gid_real=gid_real,
            perm_eligible=rng.permutation(elig).astype(np.int32),
            collisions0=collisions0,
            by_dc={f"dc{d + 1}": int((dc_of[elig] == d).sum()) for d in dcs},
        ))
    return shared, preps
