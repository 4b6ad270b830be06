"""Host-side numpy exact stepper: the float64 vectorized oracle.

The port's own copy of ``nomad_tpu/tpu/exact_np.py``. One numpy pass per
placement with the scalar iterator chain's semantics (stack.go:104-162,
select.go:35-67, rank.go:146-521, spread.go:110-227): rotating candidate
cursor, limit window with the 3-deep nonpositive deferral,
binpack/anti-affinity/affinity/spread planes averaged over fired planes,
first-strict-max tie-break in visit order. It runs in float64, not the
kernels' float32, so it measures how far a planner strays from the
reference semantics instead of sharing its rounding.
"""

from __future__ import annotations

import numpy as np

MAX_SKIP = 3  # ref stack.go:17
NEG_INF = -1e300


def _rot_incl(x: np.ndarray, offset: int, positions: np.ndarray) -> np.ndarray:
    """Inclusive count of ``x`` along rotation order up to each position
    (the ring starts at ``offset``); numpy twin of kernel._rot_incl."""
    xc = np.cumsum(x.astype(np.int64))
    xex = xc - x.astype(np.int64)
    total = int(xc[-1]) if len(xc) else 0
    x_off = int(xex[offset])
    return np.where(positions >= offset, xc - x_off, total - x_off + xc)


def _class_boosts_np(
    counts, present, desired, implicit, weight_frac, even_flag, active_flag
):
    """float64 twin of kernel._class_boosts (spread.go:110-227)."""
    used_count = counts.astype(np.float64) + 1.0
    desired_eff = np.where(desired >= 0.0, desired, implicit)
    with np.errstate(divide="ignore", invalid="ignore"):
        target = np.where(
            desired_eff >= 0.0,
            (desired_eff - used_count) / np.maximum(desired_eff, 1e-9) * weight_frac,
            -1.0,
        )

    counts_f = counts.astype(np.float64)
    big = float(2**30)
    any_present = bool(present.any())
    min_count = (
        float(np.min(np.where(present, counts_f, big))) if any_present else 0.0
    )
    max_count = (
        float(np.max(np.where(present, counts_f, -big))) if any_present else 0.0
    )
    delta_boost = np.where(
        min_count == 0.0,
        -1.0,
        (min_count - counts_f) / max(min_count, 1e-9),
    )
    even = np.where(
        counts_f != min_count,
        delta_boost,
        (
            -1.0
            if min_count == max_count
            else (
                1.0
                if min_count == 0.0
                else (max_count - min_count) / max(min_count, 1e-9)
            )
        ),
    )
    if not any_present:
        even = np.zeros_like(counts_f)

    per_class = even if even_flag else target
    boosts = np.concatenate([per_class, np.array([-1.0])])
    return boosts if active_flag else np.zeros_like(boosts)


def plan_exact_np(
    capacity: np.ndarray,  # i64[N,R]
    usable: np.ndarray,  # f64[N,2]
    feasible: np.ndarray,  # bool[G,N]
    affinity: np.ndarray,  # f64[G,N]
    affinity_present: np.ndarray,  # bool[G,N]
    group_count: np.ndarray,  # i64[G]
    node_value: np.ndarray,  # i64[G,N] (-1 = missing)
    spread_desired: np.ndarray,  # f64[G,V] (-1 = absent)
    spread_implicit: np.ndarray,  # f64[G] (-1 = none)
    spread_weight_frac: np.ndarray,  # f64[G]
    spread_even: np.ndarray,  # bool[G]
    spread_active: np.ndarray,  # bool[G]
    perm: np.ndarray,  # i64[N] node id at ring position p
    demands: np.ndarray,  # i64[A,R]
    groups: np.ndarray,  # i64[A]
    limits: np.ndarray,  # i64[A]
    used0: np.ndarray,  # i64[N,R]
    collisions0: np.ndarray,  # i64[G,N]
    counts0: np.ndarray,  # i64[G,V]
    present0: np.ndarray,  # bool[G,V]
) -> np.ndarray:
    """Run the placement sequence; returns node index per alloc (-1 = none)."""
    n = capacity.shape[0]
    A = demands.shape[0]
    V = counts0.shape[1]
    positions = np.arange(n)
    placements = np.full(A, -1, dtype=np.int64)

    used = used0.astype(np.int64).copy()
    collisions = collisions0.astype(np.int64).copy()
    counts = counts0.astype(np.int64).copy()
    present = present0.astype(bool).copy()
    offset = 0

    cap_perm = capacity[perm]
    usable_perm = usable[perm].astype(np.float64)
    feas_perm = feasible[:, perm]
    aff_perm = affinity[:, perm].astype(np.float64)
    aff_present_perm = affinity_present[:, perm]
    nv_perm = node_value[:, perm]

    for i in range(A):
        g = int(groups[i])
        demand = demands[i]
        limit = int(limits[i])

        used_p = used[perm]
        fit_p = feas_perm[g] & np.all(used_p + demand[None, :] <= cap_perm, axis=1)

        # scores (in ring coordinates throughout)
        util = (used_p + demand[None, :])[:, :2].astype(np.float64)
        free = 1.0 - util / usable_perm
        total = np.power(10.0, free[:, 0]) + np.power(10.0, free[:, 1])
        binpack = np.clip(20.0 - total, 0.0, 18.0) / 18.0

        coll = collisions[g][perm]
        anti_present = coll > 0
        anti = np.where(
            anti_present,
            -(coll.astype(np.float64) + 1.0) / float(group_count[g]),
            0.0,
        )

        boosts = _class_boosts_np(
            counts[g],
            present[g],
            spread_desired[g].astype(np.float64),
            float(spread_implicit[g]),
            float(spread_weight_frac[g]),
            bool(spread_even[g]),
            bool(spread_active[g]),
        )
        v = nv_perm[g]
        cls = np.where(v >= 0, v, V)
        spread_score = boosts[cls]
        spread_fired = bool(spread_active[g]) & (spread_score != 0.0)
        spread_score = np.where(spread_fired, spread_score, 0.0)

        num = (
            1.0
            + anti_present.astype(np.float64)
            + aff_present_perm[g].astype(np.float64)
            + spread_fired.astype(np.float64)
        )
        score_p = (
            binpack
            + np.where(anti_present, anti, 0.0)
            + np.where(aff_present_perm[g], aff_perm[g], 0.0)
            + spread_score
        ) / num

        # limit-iterator deferral (select.go:35-67)
        nonpos = fit_p & (score_p <= 0.0)
        nonpos_incl = _rot_incl(nonpos, offset, positions)
        skipped = nonpos & (nonpos_incl <= MAX_SKIP)

        kept = fit_p & ~skipped
        ret_incl = _rot_incl(kept, offset, positions)
        returned = kept & (ret_incl <= limit)
        n_returned = int(returned.sum())

        need = max(limit - n_returned, 0)
        skip_incl = _rot_incl(skipped, offset, positions)
        replay = skipped & (skip_incl <= need)
        candidates = returned | replay

        rot_rank = np.where(positions >= offset, positions - offset, n - offset + positions)

        if candidates.any():
            max_score = np.max(np.where(candidates, score_p, NEG_INF))
            tie = candidates & (score_p == max_score)
            visit_order = rot_rank + np.where(replay, n, 0)
            best_p = int(np.argmin(np.where(tie, visit_order, 2**62)))
            best_node = int(perm[best_p])

            placements[i] = best_node
            used[best_node] += demand
            collisions[g, best_node] += 1
            bv = int(node_value[g, best_node])
            if bool(spread_active[g]) and bv >= 0:
                counts[g, bv] += 1
                present[g, bv] = True

        # StaticIterator.seen accounting
        last_ret_rank = int(np.max(np.where(returned, rot_rank, -1)))
        consumed = last_ret_rank + 1 if n_returned >= limit else n
        offset = (offset + consumed) % max(n, 1)

    return placements
