"""The run planner's cluster round (``csrc/runs.cu``), modelled in numpy and
held against the JAX package's ``_plan_batch_runs_jit`` on the CPU.

The kernel splits the rotation-order positions evenly and in order across
the blocks of one thread block cluster. A round reduces each block's
positions to one record (the fit count, the best score, how many positions
hold it and the first four of them, the largest score below it, the first
MAX_SKIP nonpositive fit positions), merges the blocks' records, and takes
from the merge the winner, both runner-ups and the deferred positions.
Each block ranks its positions at its own best score within their class;
a block at the round's best score adds the tie counts of the blocks before
it. The first-accepted lanes go to every block when each block holds at
most ``slots`` of them, and every block resolves the guard, the acceptance
and each lane's slot (its rank in the merged order) itself; otherwise each
block sorts its accepted lanes and a lane's slot is its own index plus a
binary search in every other block's sorted lanes. ``cluster_rounds``
models all of that, merging records in a shuffled order; it must give
JAX's placements and round count exactly, round by round, for spread,
affinity, even mode, a fill run cut at RUNCAP, many spread classes and a
uniform ring whose first sweep accepts most of it, with 16 blocks and 64
slots (the kernel's) and with 3 blocks and 2 slots (uneven blocks, the
sorted path).
"""

import bisect
import functools

import jax
import numpy as np
import pytest
from torch_for_tests import gil_handoff, runcap_problem, torch  # noqa: F401

from nomad_tpu.tpu import kernel as jk
from nomad_tpu.tpu import multichip as mc
from nomad_tpu_torch.tpu import kernel as tk

RUNCAP = 512
A_PAD = 1024  # one compiled shape per node count and class count
NEG = float(np.float32(-1e30))
BIG = 2**31 - 1


def _f32(x):
    return np.float32(x)


def float_order(x: float) -> int:
    """score.cuh's order-preserving map of a float32 to uint32, -0 on +0."""
    b = int(np.array([0.0 if x == 0.0 else x], np.float32).view(np.uint32)[0])
    return (~b & 0xFFFFFFFF) if b & 0x80000000 else b | 0x80000000


def packed(key: float, visit: int) -> int:
    return (float_order(-key) << 32) | visit


# ---------------------------------------------------------------------------
# barrier 1's record and its merge
# ---------------------------------------------------------------------------

IDENTITY = (0, NEG, 0, (BIG,) * 4, NEG, (BIG,) * 3)


def first_k(a, b, k):
    """The first ``k`` of the union of two ascending lists (BIG pads)."""
    vals = sorted(x for x in a + b if x != BIG)[:k]
    return tuple(vals + [BIG] * (k - len(vals)))


def r1_merge(a, b):
    nfit = a[0] + b[0]
    if a[1] == b[1]:
        s, nt, t, below = a[1], a[2] + b[2], first_k(a[3], b[3], 4), max(a[4], b[4])
    elif a[1] > b[1]:
        s, nt, t, below = a[1], a[2], a[3], max(a[4], b[1])
    else:
        s, nt, t, below = b[1], b[2], b[3], max(b[4], a[1])
    return (nfit, s, nt, t, below, first_k(a[5], b[5], 3))


def r1_of(p, fit, score):
    if not fit:
        return IDENTITY
    return (1, score, 1, (p, BIG, BIG, BIG), NEG, (p, BIG, BIG) if score <= 0.0 else (BIG,) * 3)


def fold(records, rng):
    """Merge records pairwise in a shuffled tree order."""
    recs = list(records)
    rng.shuffle(recs)
    while len(recs) > 1:
        recs = [r1_merge(recs[i], recs[i + 1]) if i + 1 < len(recs) else recs[i]
                for i in range(0, len(recs), 2)]
    return recs[0] if recs else IDENTITY


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------

def _planes(args, init):
    a = tk.from_numpy(dict(args._asdict() if hasattr(args, "_asdict") else args), "cpu")
    used, coll, counts, present = (torch.from_numpy(np.array(x)) for x in init)
    return a, used.to(torch.int32), coll.to(torch.int32), counts.to(torch.int32), present.bool()


def cluster_rounds(args, init, a_pad, even_mode, blocks, slots, seed=0):
    """The kernel's rounds: (placements, rounds, [(first slot, end) a round],
    rounds on the sorted path)."""
    rng = np.random.default_rng(seed)
    a, used, coll, counts, present = _planes(args, init)
    N = a.capacity.shape[0]
    V = counts.shape[0]
    cls = torch.where(a.node_value >= 0, a.node_value, V).long()
    cls_np = cls.numpy()
    count_f = a.group_count.float()
    aff_term = torch.where(a.affinity_present, a.affinity, 0.0)
    aff_f = a.affinity_present.float()
    desired_eff = torch.where(a.spread_desired >= 0.0, a.spread_desired, a.spread_implicit)
    delta_v = torch.where(desired_eff >= 0.0,
                          a.spread_weight_frac / torch.clamp_min(desired_eff, _f32(1e-9)), 0.0)
    delta_v = torch.where(a.spread_active & ~a.spread_even, delta_v, 0.0)
    delta = torch.cat([delta_v, delta_v.new_zeros(1)]).numpy()
    active = bool(a.spread_active)
    n_allocs = int(a.n_allocs)
    per = -(-N // blocks)
    owner = np.arange(N) // per

    def score_at(boosts, extra):
        util = (used + (1 + extra) * a.demand[None, :])[:, :2].float()
        free = 1.0 - util / a.usable
        bp = tk._binpack(free[:, 0], free[:, 1])
        ce = coll + extra
        ap = ce > 0
        an = torch.where(ap, -(ce.float() + 1.0) / count_f, 0.0)
        sp = boosts[cls] - extra * torch.from_numpy(delta)[cls]
        fired = a.spread_active & (sp != 0.0)
        num = 1.0 + ap.float() + aff_f + fired.float()
        return ((bp + an + aff_term + torch.where(fired, sp, 0.0)) / num).numpy(), num.numpy()

    placements = np.full(a_pad, -1, np.int32)
    placed = rounds = sorted_rounds = 0
    spans = []
    while placed < n_allocs:
        fit = (a.feasible & (used + a.demand[None, :] <= a.capacity).all(dim=1)).numpy()
        boosts = tk._class_boosts(counts, present, a.spread_desired, a.spread_implicit,
                                  a.spread_weight_frac, a.spread_even, a.spread_active)
        score, num = score_at(boosts, 0)
        # 1. each block's record, merged in a shuffled order
        recs = [fold([r1_of(p, fit[p], float(score[p])) for p in range(b * per, min(N, (b + 1) * per))],
                     rng) for b in range(blocks)]
        g = fold(recs, rng)
        rounds += 1
        fit_p = np.flatnonzero(fit)
        assert g[0] == len(fit_p)
        if g[0] == 0:
            break
        s = g[1]
        tied = fit & (score == np.float32(s))
        nonpos = np.flatnonzero(fit & (score <= 0.0))
        assert g[2] == tied.sum() and g[3] == tuple(list(np.flatnonzero(tied)[:4]) + [BIG] * (4 - min(4, tied.sum())))
        assert g[5] == tuple(list(nonpos[:3]) + [BIG] * (3 - min(3, len(nonpos))))
        best = g[3][0]
        if not s > 0.0:
            best = next((t for t in g[3] if t != BIG and t not in g[5]), g[3][0])
        r_other = s if g[2] >= 2 else g[4]
        r_nontied = g[4]
        remaining = n_allocs - placed
        deferred = set(g[5])

        n_acc = 0
        if not even_mode:
            # each block's positions at its own best score, ranked in class
            t_in, tot = {}, np.zeros((blocks, V + 1), np.int64)
            for b in range(blocks):
                for p in range(b * per, min(N, (b + 1) * per)):
                    if fit[p] and score[p] == np.float32(recs[b][1]):
                        t_in[p] = tot[b, cls_np[p]]
                        tot[b, cls_np[p]] += 1
            keys, acc0 = {}, {}
            for p in np.flatnonzero(tied):
                b = owner[p]
                assert recs[b][1] == s
                pre = sum(tot[q, cls_np[p]] for q in range(b) if recs[q][1] == s)
                t_own = _f32(t_in[p] + pre)
                keys[p] = float(_f32(score[p]) - _f32(_f32(t_own * _f32(delta[cls_np[p]]))
                                                     / _f32(num[p])))
                acc0[p] = keys[p] > r_nontied
            score2, _ = score_at(boosts, 1)
            first = [p for p in sorted(keys) if acc0[p]]
            kmin = min(keys[p] for p in first)
            n0 = np.bincount(owner[first], minlength=blocks)
            bad = max([keys[p] for p in first if not score2[p] <= kmin], default=NEG)
            accepted = [p for p in first if keys[p] > bad]
            n_acc = len(accepted)
            visit = {p: p + (N if p in deferred else 0) for p in accepted}
            if n0.max() <= slots:
                # every block holds every first-accepted lane: a lane's slot
                # is the accepted lanes before it in the merged order
                slot = {p: sum(packed(keys[q], visit[q]) < packed(keys[p], visit[p])
                               for q in accepted) for p in accepted}
            else:
                sorted_rounds += 1
                lists = [sorted(packed(keys[p], visit[p]) for p in accepted if owner[p] == b)
                         for b in range(blocks)]
                slot = {}
                for p in accepted:
                    me = packed(keys[p], visit[p])
                    b = owner[p]
                    slot[p] = lists[b].index(me) + sum(
                        bisect.bisect_left(lists[q], me) for q in range(blocks) if q != b)
            assert sorted(slot.values()) == list(range(n_acc))
            if n_acc > 1:
                take = min(remaining, n_acc)
                for k, p in sorted((slot[p], p) for p in accepted if slot[p] < take):
                    placements[placed + k] = int(a.perm[p])
                    used[p] += a.demand
                    coll[p] += 1
                    if active and cls_np[p] < V:
                        counts[cls_np[p]] += 1
                        present[cls_np[p]] = True
                spans.append((placed, placed + take))
                placed += take
        if n_acc <= 1:
            # fill: the winner's trajectory, RUNCAP points
            jj = torch.arange(RUNCAP, dtype=torch.int32)
            jf = jj.float()
            ub = used[best]
            util_j = ub[:2].float()[None, :] + (jf[:, None] + 1.0) * a.demand[:2].float()[None, :]
            free_j = 1.0 - util_j / a.usable[best][None, :]
            coll_j = coll[best].float() + jf
            ap_j = coll_j > 0.0
            an_j = torch.where(ap_j, -(coll_j + 1.0) / count_f, 0.0)
            sp_j = boosts[cls[best]] - jf * float(delta[cls_np[best]])
            fired_j = a.spread_active & (sp_j != 0.0)
            num_j = 1.0 + ap_j.float() + aff_f[best] + fired_j.float()
            traj = ((tk._binpack(free_j[:, 0], free_j[:, 1]) + an_j + aff_term[best]
                     + torch.where(fired_j, sp_j, 0.0)) / num_j).numpy()
            fits = (ub[None, :] + (jj[:, None] + 1) * a.demand[None, :]
                    <= a.capacity[best][None, :]).all(dim=1).numpy()
            ok = fits & (traj > np.float32(r_other)) & (np.arange(RUNCAP) < remaining)
            bad_j = [j for j in range(1, RUNCAP) if even_mode or not ok[j]]
            run = min(bad_j[0] if bad_j else RUNCAP, remaining)
            placements[placed: placed + run] = int(a.perm[best])
            used[best] += run * a.demand
            coll[best] += run
            if active and cls_np[best] < V:
                counts[cls_np[best]] += run
                present[cls_np[best]] |= run > 0
            spans.append((placed, placed + run))
            placed += run
    return placements, rounds, spans, sorted_rounds


# ---------------------------------------------------------------------------
# cases, from the JAX package's builders
# ---------------------------------------------------------------------------

def _uniform():
    c = mc.build_cluster(96, 700, seed=8)
    c["feasible"][:] = True
    c["capacity"][:] = [16000, 32768, 100 * 1024, 1000]
    c["usable"][:] = [15900, 32512]
    return mc.runs_problem(c, affinity=False, spread=True)


def _even():
    args, init = mc.runs_problem(mc.build_cluster(96, 300, n_values=3, seed=5), affinity=False,
                                 spread=True)
    return args._replace(spread_even=np.bool_(True)), init


CASES = {
    "spread": lambda: mc.runs_problem(mc.build_cluster(96, 700, seed=4), affinity=False),
    "affinity": lambda: mc.runs_problem(mc.build_cluster(96, 700, seed=4), spread=False),
    "aff_spread": lambda: mc.runs_problem(mc.build_cluster(96, 700, seed=4)),
    "even": _even,
    "runcap": lambda: runcap_problem(mc.build_cluster, mc.runs_problem),
    "many_classes": lambda: mc.runs_problem(mc.build_cluster(96, 700, n_values=40, seed=9),
                                            affinity=False),
    "uniform": _uniform,
}


@functools.lru_cache(maxsize=None)
def _jax(case):
    args, init = CASES[case]()
    args = args if hasattr(args, "_fields") else jk.RunArgs(**args)
    even = bool(args.spread_even)
    with jk.deterministic_scope():
        out, _ = jk._dispatch("runs", jk._plan_batch_runs_jit, (args, init, A_PAD, even), "runs")
    placements, rounds = jax.tree_util.tree_map(np.asarray, out)
    return placements, int(rounds)


@pytest.mark.parametrize("blocks,slots", [(16, 64), (3, 2)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cluster_round_matches_jax(case, blocks, slots):
    args, init = CASES[case]()
    even = bool(np.asarray(args["spread_even"] if isinstance(args, dict) else args.spread_even))
    want, want_rounds = _jax(case)
    got, rounds, spans, sorted_rounds = cluster_rounds(args, init, A_PAD, even, blocks, slots)
    for k, (lo, hi) in enumerate(spans):  # round by round
        np.testing.assert_array_equal(got[lo:hi], want[lo:hi], err_msg=f"round {k + 1}")
    np.testing.assert_array_equal(got, want)
    assert rounds == want_rounds
    if slots == 2 and case in ("uniform", "spread"):
        assert sorted_rounds > 0  # the sorted path ran
    if case == "uniform":
        assert max(hi - lo for lo, hi in spans) > 64  # a sweep of more than 64 lanes
