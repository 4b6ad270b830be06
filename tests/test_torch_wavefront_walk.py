"""The host-checkable rules of the wavefront's and the dirty-row scatter's
kernels, against the JAX package and the port's plain versions, on the CPU.

The wavefront kernel (``csrc/wavefront.cu``) selects each lane of a round's
window with the exact scan's walk: from the eval's cursor in chunks, stopping
after the chunk in which the limit window fills, replaying deferred options
only when the ring runs out, and taking its top-M candidates from the
positions it walked. Then every block finds the committed prefix by the
W x W conflict test, and the committed lanes' winners are folded into the
state. ``wavefront_rounds`` below is a numpy model of that round (scores
from the port's plain ``_scores``); it must give JAX's
``_plan_batch_wavefront_jit`` placements, final state and round count
exactly, for limits that stop inside the first chunk, full-ring limits, a
multi-eval batch with rings shorter than N, a case that defers and
replays, windows of 1, 8 and 32 lanes and 1 or 3 candidates a lane.

The scatter kernel (``csrc/scatter.cu``) gives each block a range of output
rows: the block reads every lane, keeps the lowest lane of each of its rows
and writes each row once. ``block_owned_scatter`` models it; it must equal
the plain ``scatter_rows_ref``.
"""

import functools

import numpy as np
import pytest
from test_torch_scan_walk import WALK_CASES
from torch_for_tests import gil_handoff, torch  # noqa: F401

from nomad_tpu.tpu import kernel as jk
from nomad_tpu.tpu import wavefront as jwf
from nomad_tpu_torch.tpu import kernel as tk
from nomad_tpu_torch.tpu import mirror

MAX_SKIP = 3


def _select(a, args, state, cache, lane, chunk, first):
    """One lane's as-if selection by the chunked walk: (winner or -1,
    placed, advances, consumed, the candidates as (score, rotated rank or
    replay visit, node, ring position), positions walked)."""
    g = int(args["groups"][lane])
    e = int(args["group_eval"][g])
    ring, limit = int(args["ring"][e]), int(args["limits"][lane])
    N = args["capacity"].shape[0]
    dem = args["demands"][lane]
    off = int(state["offset"][e])
    key = (g, tuple(dem))
    if key not in cache:  # the round's state is fixed: one score plane a group and demand
        st = tk.from_numpy(state, "cpu")
        cache[key] = (tk._scores(a, st, g, torch.from_numpy(dem)).numpy(),
                      args["feasible"][g] & (state["used"] + dem[None, :]
                                             <= args["capacity"]).all(axis=1))
    score, fit_node = cache[key]
    run_fit = run_np = walked = 0
    full = False
    cands, deferred, last = [], [], -1
    bounds = [0, *range(first, ring, chunk), ring] if ring > first else [0, ring]
    for base, end in zip(bounds, bounds[1:]):
        r = np.arange(base, end)
        p = (off + r) % max(ring, 1)
        nodes = args["perm"][e][p]
        fit, sc = fit_node[nodes], score[nodes]
        nonpos = fit & (sc <= 0.0)
        fit_r = run_fit + np.cumsum(fit)
        np_r = run_np + np.cumsum(nonpos)
        skipped = nonpos & (np_r <= MAX_SKIP)
        returned = fit & ~skipped & (fit_r - np.minimum(np_r, MAX_SKIP) <= limit)
        deferred += [(sc[k], r[k], nodes[k], p[k]) for k in np.flatnonzero(skipped)]
        cands += [(sc[k], r[k], nodes[k], p[k]) for k in np.flatnonzero(returned)]
        if returned.any():
            last = int(r[returned].max())
        run_fit += int(fit.sum())
        run_np += int(nonpos.sum())
        walked += len(r)
        full = run_fit - min(run_np, MAX_SKIP) >= limit
        if full:
            break
    if not full:
        need = limit - (run_fit - min(run_np, MAX_SKIP))
        cands += [(s, rot + N, node, pos) for s, rot, node, pos in deferred[:max(need, 0)]]
    place = bool(cands)
    best = max(cands, key=lambda c: (c[0], -c[1]))[2] if place else -1
    consumed = last + 1 if full else ring
    advances = consumed % max(ring, 1) != 0
    return best, place, advances, consumed, cands, walked


def wavefront_rounds(args, init, window, top_m, chunk, first):
    """The kernel's rounds: every lane of the window selected against the
    round-start state (the lanes after the first blocked one cannot change
    the prefix, so the model stops there), the committed prefix, the fold.
    Returns (final state, placements, rounds, positions the committed lanes
    walked)."""
    a = tk.from_numpy(args, "cpu")
    state = {k: np.array(init[k]) for k in tk.BatchState._fields}
    A = len(args["groups"])
    valid = np.asarray(args["valid"])
    placements = np.full(A, -1, np.int32)
    stop = int(np.flatnonzero(valid).max()) + 1 if valid.any() else 0
    i = rounds = walked = 0
    while i < stop:
        cache, lanes = {}, []
        for k in range(window):
            lane = i + k
            g = int(args["groups"][min(lane, A - 1)])
            e = int(args["group_eval"][g])
            if any((adv and e_a == e) or any(n >= 0 and args["feasible"][g, n] for n in top)
                   for e_a, adv, top in ((x[1], x[3], x[5]) for x in lanes)):
                break  # lane k is blocked: the prefix ends before it
            if lane < A and valid[lane]:
                best, place, adv, consumed, cands, w = _select(a, args, state, cache, lane,
                                                               chunk, first)
                # slot 0 the winner, then the first M - 1 of the top-M
                # order: higher score, then the lower ring position
                ranked = sorted(cands, key=lambda c: (-c[0], c[3]))[: top_m - 1]
                top = [best] + [int(c[2]) for c in ranked] + [-1] * (top_m - 1 - len(ranked))
                top = top if place else [-1] * top_m
            else:
                best, place, adv, consumed, top, w = -1, False, False, 0, [-1] * top_m, 0
            lanes.append((lane, e, best, adv, consumed, top, place, w))
        start = state["offset"].copy()
        for lane, e, best, adv, consumed, _, place, w in lanes:
            if lane >= A:
                continue
            walked += w
            placements[lane] = best
            if place:
                g = int(args["groups"][lane])
                state["used"][best] += args["demands"][lane]
                state["collisions"][g, best] += 1
                v = int(args["node_value"][g, best])
                if args["spread_active"][g] and 0 <= v < state["spread_counts"].shape[1]:
                    state["spread_counts"][g, v] += 1
                    state["spread_present"][g, v] = True
            if adv:
                state["offset"][e] = (int(start[e]) + consumed) % max(int(args["ring"][e]), 1)
        i += len(lanes)
        rounds += 1
    return state, placements, rounds, walked


@functools.lru_cache(maxsize=None)
def _jax_wavefront(case, window, top_m):
    args, init = WALK_CASES[case]()
    jargs, jinit = jk.BatchArgs(**args), jk.BatchState(**init)
    n_real = int(np.max(args["ring"]))
    with jk.deterministic_scope():
        out, _ = jk._dispatch("wavefront", jwf._plan_batch_wavefront_jit,
                              (jargs, jinit, n_real, window, top_m, 1), f"walk{window}.{top_m}")
    state, placements, rounds = out
    return ({k: np.asarray(getattr(state, k)) for k in jk.BatchState._fields},
            np.asarray(placements), int(rounds))


#: (window, candidates a lane)
WAVE_SHAPES = [(1, 1), (8, 1), (8, 3), (32, 1), (32, 3)]


@pytest.mark.parametrize("first,chunk", [(64, 64), (16, 64), (100, 100)])
@pytest.mark.parametrize("window,top_m", WAVE_SHAPES)
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_wavefront_walk_matches_jax(case, window, top_m, first, chunk):
    args, init = WALK_CASES[case]()
    want_state, want, want_rounds = _jax_wavefront(case, window, top_m)
    got_state, got, rounds, walked = wavefront_rounds(args, init, window, top_m, chunk, first)
    np.testing.assert_array_equal(got, want)
    for name in jk.BatchState._fields:
        np.testing.assert_array_equal(got_state[name], want_state[name], err_msg=name)
    assert rounds == want_rounds
    assert (got >= 0).any()
    valid = np.asarray(args["valid"])
    whole = int(np.asarray(args["ring"])[np.asarray(args["group_eval"])[args["groups"]]][valid]
                .sum())
    if case in ("limit_2", "limit_14"):
        assert walked < whole  # every committed lane's walk stopped at its window
    if case == "full_ring":
        assert walked == whole


# ---------------------------------------------------------------------------
# the dirty-row scatter with blocks that own output rows
# ---------------------------------------------------------------------------

def block_owned_scatter(used, rows, vals, block_rows):
    """Each block of ``block_rows`` output rows reads every lane, keeps the
    lowest lane on each of its rows, and writes each row once from vals or
    from used."""
    N = used.shape[0]
    out = np.empty_like(used)
    sentinel = np.iinfo(np.int32).max
    for row0 in range(0, N, block_rows):
        n_rows = min(block_rows, N - row0)
        first = np.full(block_rows, sentinel, np.int64)
        for lane, r in enumerate(rows):
            r = int(r) - row0
            if 0 <= r < n_rows:
                first[r] = min(first[r], lane)
        mine = first[:n_rows]
        hit = mine != sentinel
        out[row0:row0 + n_rows] = used[row0:row0 + n_rows]
        out[row0:row0 + n_rows][hit] = vals[mine[hit]]
    return out


def _scatter_case(kind, N, rng):
    if kind == "empty":
        rows = np.zeros(0, np.int32)
    elif kind == "duplicates":
        rows = rng.choice(40, 64).astype(np.int32)  # many lanes on each row
    else:  # outside: rows below 0 and at or past N among real ones
        rows = rng.integers(-3, N + 3, 300).astype(np.int32)
        rows[:4] = [-1, N, N + 2, -3]
    vals = rng.integers(0, 2**30, (len(rows), 4)).astype(np.int32)  # duplicates differ
    return rows, vals


@pytest.mark.parametrize("block_rows", [256, 7])
@pytest.mark.parametrize("N", [1000, 512])
@pytest.mark.parametrize("kind", ["empty", "duplicates", "outside"])
def test_block_owned_scatter_matches_plain(kind, N, block_rows):
    """Duplicate rows whose values differ, rows outside [0, N), no lanes
    at all, and N a multiple of the block's rows or not."""
    rng = np.random.default_rng(N + block_rows)
    used = rng.integers(0, 2**30, (N, 4)).astype(np.int32)
    rows, vals = _scatter_case(kind, N, rng)
    want = mirror.scatter_rows_ref(*(torch.from_numpy(x) for x in (used, rows, vals))).numpy()
    np.testing.assert_array_equal(block_owned_scatter(used, rows, vals, block_rows), want)
    got = mirror.scatter_rows(*(torch.from_numpy(x) for x in (used, rows, vals)))
    np.testing.assert_array_equal(got.numpy(), want)
