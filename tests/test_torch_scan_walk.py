"""The host-checkable rules of the exact scan's and the window sweep's
kernels, against the JAX package on the CPU.

The exact-scan kernel (``csrc/exact_scan.cu``) walks each step's ring from
the eval's cursor in chunks and stops after the chunk in which the kept
options reach the step's limit; only a walk that exhausts the ring replays
the deferred options. ``chunked_scan`` below is a numpy model of that walk
(scores from the port's plain ``_scores``); it must give JAX's
``_plan_batch_jit`` placements, final state and cursors exactly, for limits
that stop inside the first chunk, full-ring limits, chunks shorter than
the ring, a multi-eval batch with rings shorter than N, and a case that
defers and replays.

The window sweep's kernel (``csrc/paging.cu``) forms each tile's two base
windows in closed form from the tile's counts; ``closed_form_bases`` must
equal the bases of JAX's ``_tile_window_jit`` on every tile of the paged
planner's rounds.
"""

import numpy as np
import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

from nomad_tpu.tpu import kernel as jk
from nomad_tpu.tpu import paging as jpaging
from nomad_tpu_torch.tpu import drain, problems
from nomad_tpu_torch.tpu import kernel as tk

MAX_SKIP = 3


def chunked_scan(args: dict, init: dict, chunk: int, first: int):
    """The exact scan, each step walking its ring in ``first`` rotated
    positions and then ``chunk`` at a time, and stopping after the chunk in
    which the window fills. Returns (final state dict, placements, positions
    walked, steps that replayed)."""
    a = tk.from_numpy(args, "cpu")
    used, coll, counts, present, offset = (np.array(init[k]) for k in tk.BatchState._fields)
    N = a.capacity.shape[0]
    placements = np.full(len(args["groups"]), -1, np.int32)
    walked = replays = 0
    for i, g in enumerate(args["groups"]):
        if not args["valid"][i]:
            continue
        e = int(args["group_eval"][g])
        ring, limit, off = int(args["ring"][e]), int(args["limits"][i]), int(offset[e])
        dem = args["demands"][i]
        state = tk.from_numpy(dict(used=used, collisions=coll, spread_counts=counts,
                                   spread_present=present, offset=offset), "cpu")
        score = tk._scores(a, state, int(g), torch.from_numpy(dem)).numpy()
        fit_node = args["feasible"][g] & (used + dem[None, :] <= args["capacity"]).all(axis=1)

        run_fit = run_np = 0
        full = False
        cands, deferred, last = [], [], -1
        bounds = [0, *range(first, ring, chunk), ring]
        for base, end in zip(bounds, bounds[1:]):
            r = np.arange(base, end)
            nodes = args["perm"][e][(off + r) % ring]
            fit, sc = fit_node[nodes], score[nodes]
            nonpos = fit & (sc <= 0.0)
            fit_r = run_fit + np.cumsum(fit)
            np_r = run_np + np.cumsum(nonpos)
            skipped = nonpos & (np_r <= MAX_SKIP)
            returned = fit & ~skipped & (fit_r - np.minimum(np_r, MAX_SKIP) <= limit)
            deferred += [(sc[k], r[k], nodes[k]) for k in np.flatnonzero(skipped)]
            cands += [(sc[k], r[k], nodes[k]) for k in np.flatnonzero(returned)]
            if returned.any():
                last = int(r[returned].max())
            run_fit += int(fit.sum())
            run_np += int(nonpos.sum())
            walked += len(r)
            if run_fit - min(run_np, MAX_SKIP) >= limit:
                full = True
                break
        if not full:
            need = limit - (run_fit - min(run_np, MAX_SKIP))
            replay = deferred[:max(need, 0)]
            replays += bool(replay)
            cands += [(s, rot + N, node) for s, rot, node in replay]
        if cands:
            best = max(cands, key=lambda c: (c[0], -c[1]))  # first strict max in visit order
            b = int(best[2])
            placements[i] = b
            used[b] += dem
            coll[g, b] += 1
            v = int(args["node_value"][g, b])
            if args["spread_active"][g] and 0 <= v < counts.shape[1]:
                counts[g, v] += 1
                present[g, v] = True
        consumed = last + 1 if full else ring
        offset[e] = (off + consumed) % max(ring, 1)
    state = dict(used=used, collisions=coll, spread_counts=counts, spread_present=present,
                 offset=offset)
    return state, placements, walked, replays


def _tenants(limit):
    args, init = problems.wavefront_problem(problems.build_cluster(400, 160, seed=41), n_groups=3)
    if limit is not None:
        args["limits"] = np.full_like(args["limits"], limit)
    return args, init


def _multi_eval():
    """A fused drain batch: six evals with rings over 1-4 datacenters
    (shorter than N), limits of the ring or ceil(log2 ring), spread and
    affinity planes, invalid padding lanes."""
    n = 600
    c = problems.build_cluster(n, 1, seed=43)
    shared, preps = problems.drain_problem(c, 6, "drain-tenant", seed=43)
    order = [drain.DrainPrep.from_dict(d) for d in preps]
    shape = drain.batch_shape(order, n, 8)
    args, state, _ = drain.assemble(order, n, shape)
    k = shape[3] - n
    args.update(capacity=np.concatenate([shared["capacity"], np.zeros((k, 4), np.int32)]),
                usable=np.concatenate([shared["usable"], np.ones((k, 2), np.float32)]))
    state["used"] = np.concatenate([shared["used0"], np.full((k, 4), 2**30, np.int32)])
    return args, state


def _nonpositive(seed=44):
    """Scores at or below zero on most nodes, random limits: deferral on
    every step, replay where the ring runs out."""
    rng = np.random.default_rng(seed)
    args, init = problems.exact_problem(problems.build_cluster(300, 200, seed=seed), spread=False)
    args.update(group_count=np.ones(1, np.int32),
                limits=rng.integers(1, 301, 200).astype(np.int32))
    init["collisions"] = (rng.random((1, 300)) < 0.8).astype(np.int32)
    return args, init


WALK_CASES = {
    "limit_2": lambda: _tenants(2),
    "limit_14": lambda: _tenants(14),
    "full_ring": lambda: _tenants(None),
    "multi_eval": _multi_eval,
    "nonpositive_replay": _nonpositive,
}


@pytest.mark.parametrize("first,chunk", [(64, 64), (100, 100), (16, 64)])
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_chunked_walk_matches_jax(case, first, chunk):
    args, init = WALK_CASES[case]()
    jargs, jinit = jk.BatchArgs(**args), jk.BatchState(**init)
    n_real = int(np.max(args["ring"]))
    with jk.deterministic_scope():
        (want_state, want), _ = jk._dispatch("exact", jk._plan_batch_jit, (jargs, jinit, n_real),
                                             "exact")
    got_state, got, walked, replays = chunked_scan(args, init, chunk, first)
    np.testing.assert_array_equal(got, np.asarray(want))
    for name in jk.BatchState._fields:
        np.testing.assert_array_equal(got_state[name], np.asarray(getattr(want_state, name)))
    assert (got >= 0).any()
    valid = np.asarray(args["valid"])
    rings = np.asarray(args["ring"])[np.asarray(args["group_eval"])[args["groups"]]][valid]
    whole = int(rings.sum())
    if case in ("limit_2", "limit_14"):
        assert walked < whole  # the walk stopped at its window
    if case == "full_ring":
        assert walked == whole
    if case == "nonpositive_replay":
        assert replays > 0


# ---------------------------------------------------------------------------
# the window sweep's base windows in closed form
# ---------------------------------------------------------------------------

BIG = 2**30


def closed_form_bases(cap, feas, used, demand, limit, t0, offset, n_real, flat_base, x0, total,
                      w_use):
    """The tile's two base windows from its counts: its wrapped rows (pos <
    offset) precede its other rows, so the first wrapped feasible row has
    rank total - x0 + flat_base and the first other one flat_base + before
    - x0; a base is that rank's window where such a row exists and the
    window is below w_use."""
    pos = t0 + np.arange(cap.shape[0])
    fit = feas & (used + demand[None, :] <= cap).all(axis=1) & (pos < n_real)
    cnt, before = int(fit.sum()), int((fit & (pos < offset)).sum())
    lm = max(limit, 1)
    lo = hi = BIG
    if before > 0 and (total - x0 + flat_base) // lm < w_use:
        hi = (total - x0 + flat_base) // lm
    if cnt > before and (flat_base + before - x0) // lm < w_use:
        lo = (flat_base + before - x0) // lm
    return np.array([lo, hi], np.int32), cnt, before


def _jax_tile_windows(seed, monkeypatch):
    """Every tile-window sweep of JAX's paged run of ``paged_case(seed)`` in
    64-row tiles, as (host args, host outputs); the nodes of ring tile 2
    are made infeasible, so one tile has no feasible row."""
    case = list(problems.paged_case(seed, 700, 600, limit=3))
    feasible = case[2].copy()
    feasible[case[3][128:192]] = False
    case[2] = feasible
    calls = []
    orig = jk._dispatch

    def record(name, jitfn, call_args, key, *rest, **kw):
        out = orig(name, jitfn, call_args, key, *rest, **kw)
        if jitfn is jpaging._tile_window_jit:
            calls.append(([np.array(x) for x in call_args], [np.array(o) for o in out[0]]))
        return out

    monkeypatch.setattr(jk, "_dispatch", record)
    jpaging.configure(enabled=True, tile_nodes=64)
    try:
        with jk.deterministic_scope():
            jpaging.plan_batch_paged(*case)
    finally:
        jpaging.reset()
        monkeypatch.undo()
    return calls


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_closed_form_bases_match_jax(seed, monkeypatch):
    from nomad_tpu.state import planes as state_planes

    tile_rows = state_planes.TILE_ROWS
    try:
        calls = _jax_tile_windows(seed, monkeypatch)
    finally:
        state_planes.TILE_ROWS = tile_rows
    kinds = set()
    for a, want in calls:
        cap, _, feas, used, _, _, demand = a[:7]
        limit, t0, offset, n_real, flat_base, x0, total, w_use = (int(x) for x in a[8:])
        got, cnt, before = closed_form_bases(cap, feas, used, demand, limit, t0, offset, n_real,
                                             flat_base, x0, total, w_use)
        np.testing.assert_array_equal(got, want[0])
        if cnt == 0:
            kinds.add("no feasible row")
        elif before == cnt:
            kinds.add("all wrapped")
        elif before == 0:
            kinds.add("none wrapped")
        else:
            kinds.add("straddles")
        if (want[0] == BIG).any() and cnt > 0:
            kinds.add("a group past w_use")
    assert len(calls) > 11
    assert kinds >= {"no feasible row", "all wrapped", "none wrapped", "straddles"}


def test_plain_scan_counts_no_walk():
    """Only the kernel walks chunks: the plain version refuses a count."""
    args, init = problems.exact_problem(problems.build_cluster(64, 8, seed=3))
    a, s = tk.from_numpy(args, "cpu"), tk.from_numpy(init, "cpu")
    with pytest.raises(ValueError, match="walks"):
        tk.plan_batch(a, s, 64, walked=torch.zeros(1, dtype=torch.int64))
    _, placements = tk.plan_batch(a, s, 64)
    _, want = tk.plan_batch_ref(a, s, 64)
    assert torch.equal(placements, want)
