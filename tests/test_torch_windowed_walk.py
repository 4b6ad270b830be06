"""The windowed planner's cluster round (``csrc/windowed.cu``), modelled in
numpy and held against the JAX package's ``_plan_batch_windowed_jit`` on
the CPU.

The kernel splits the ring's real positions evenly and in order across the
blocks of one thread block cluster, ``P`` a block, and keeps each
position's fit and score, which change only when the position wins. A
round counts each block's fit positions and those before the cursor and
exchanges the counts (barrier 1); from them every block has the round's
total, the count before the cursor and its own exclusive base, and so each
fit position's rank in rotation order from the cursor and its window.
Every position in a window that places bids its key (``order(score) << 32
| ~rank``) into its window's one key with an atomic max, and the position
of rank ``w_use * L - 1`` pushes the cursor's advance (barrier 2); a
position wins when its window's key is its own. ``cluster_rounds`` models
that with each block's partial key a window (its best bid in the window)
folded into the window's key block by block in a shuffled order, as the
atomics land; it must give JAX's placements and round count, round by
round, at shapes where windows straddle blocks, a window spans more than
two blocks (L > P), the wrap point falls inside a block, the round's
feasible count is under L, L is 1 or 0, the ring is padded and the ring
exhausts.
"""

import functools

import jax
import numpy as np
import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

from nomad_tpu.tpu import kernel as jk
from nomad_tpu.tpu import multichip as mc
from nomad_tpu_torch.tpu import kernel as tk


def float_order(x: np.ndarray) -> np.ndarray:
    """score.cuh's order-preserving map of float32 to uint32 (-0 on +0)."""
    x = np.where(x == 0.0, np.float32(0.0), x).astype(np.float32)
    b = x.view(np.uint32).astype(np.uint64)
    return np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)


def keys_of(score: np.ndarray, rank: np.ndarray) -> np.ndarray:
    return (float_order(score) << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - rank.astype(np.uint64))


def _state(args, used0, coll0):
    a = tk.from_numpy(dict(args._asdict()), "cpu")
    used = torch.from_numpy(np.array(used0, np.int32))
    coll = torch.from_numpy(np.array(coll0, np.int32))
    return a, used, coll


def cluster_rounds(args, used0, coll0, n_real, a_pad, blocks, seed=0):
    """The kernel's rounds: (placements, rounds, [(placed, w_use) a round],
    what the shape exercised)."""
    rng = np.random.default_rng(seed)
    a, used, coll = _state(args, used0, coll0)
    L = int(a.limit)
    lm = max(L, 1)
    n_allocs = int(a.n_allocs)
    count_f = a.group_count.float()
    perm = a.perm.numpy().astype(np.int64)
    per = -(-n_real // blocks)
    positions = np.arange(n_real)
    block_of = positions // per

    def rescore(nodes):
        """(fit, score) of these nodes from their rows (the kernel's
        per-position registers, refreshed only for a winner)."""
        n = torch.from_numpy(nodes)
        u = used[n] + a.demand[None, :]
        fit = a.feasible[n] & (u <= a.capacity[n]).all(dim=1)
        free_cpu = 1.0 - u[:, 0].float() / a.usable[n, 0]
        free_mem = 1.0 - u[:, 1].float() / a.usable[n, 1]
        cl = coll[n]
        ap = cl > 0
        anti = torch.where(ap, -(cl.float() + 1.0) / count_f, 0.0)
        score = (tk._binpack(free_cpu, free_mem) + anti) / (1.0 + ap.float())
        return fit.numpy(), score.numpy()

    fit, score = rescore(perm[:n_real])
    placements = np.full(a_pad, -1, np.int32)
    offset = placed = rounds = 0
    spans = []
    seen = dict(wrap_inside=0, spans_3=0, short=0, cross=0, exhausted=0)
    while placed < n_allocs:
        rounds += 1
        # barrier 1: each block's fit count and count before the cursor
        cnt = np.bincount(block_of, weights=fit, minlength=blocks).astype(np.int64)
        bef = np.bincount(block_of, weights=fit & (positions < offset),
                          minlength=blocks).astype(np.int64)
        total, x_off = int(cnt.sum()), int(bef.sum())
        base = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        remaining = n_allocs - placed
        w_avail = max(total // lm, 1) if total > 0 else 0
        w_use = min(w_avail, remaining)
        if w_use == 0:
            seen["exhausted"] += 1
            break  # nothing feasible: the progress flag drops
        seen["short"] += total < L
        exhausted = total < w_use * L

        partial = []  # per block: window -> its best bid in the block
        bids = []  # (window, key, position) of every bid
        watermark = None
        for b in range(blocks):
            p0, p1 = b * per, min((b + 1) * per, n_real)
            partial.append({})
            if p0 >= p1:
                continue
            seen["wrap_inside"] += p0 < offset < p1
            f = fit[p0:p1]
            pos = positions[p0:p1]
            xex = base[b] + np.cumsum(f) - f  # the thread's exclusive prefix
            wrapped = pos < offset
            rank = np.where(wrapped, total - x_off + xex, xex - x_off)
            w = rank // lm
            active = f & (w < w_use)
            k = keys_of(score[p0:p1], rank)
            for q in np.nonzero(active)[0]:
                wq, kq = int(w[q]), int(k[q])
                partial[b][wq] = max(partial[b].get(wq, 0), kq)
                bids.append((wq, kq, p0 + int(q)))
            hit = f & (rank == w_use * L - 1)
            if L > 0 and not exhausted and hit.any():
                assert watermark is None
                q = p0 + int(np.nonzero(hit)[0][0])
                watermark = q - offset if q >= offset else n_real - offset + q

        # the atomics land block by block, in any order
        window_key = {}
        for b in rng.permutation(blocks):
            for w, key in partial[b].items():
                window_key[w] = max(window_key.get(w, 0), key)
        holders = {}
        for b in range(blocks):
            for w in partial[b]:
                holders.setdefault(w, set()).add(b)
        seen["cross"] += sum(len(h) > 1 for h in holders.values())
        seen["spans_3"] += sum(len(h) > 2 for h in holders.values())
        # barrier 2: a bidder wins when its window's key is its own
        winners = {w: q for w, key, q in bids if window_key[w] == key}
        assert sorted(winners) == list(range(w_use))
        assert len(winners) == sum(window_key[w] == key for w, key, _ in bids)
        win_w = np.array(sorted(winners), np.int64)
        win_pos = np.array([winners[w] for w in win_w], np.int64)
        nodes = perm[win_pos]
        placements[placed + win_w] = nodes
        used[torch.from_numpy(nodes)] += a.demand
        coll[torch.from_numpy(nodes)] += 1
        fit[win_pos], score[win_pos] = rescore(nodes)

        if exhausted:
            consumed = n_real
        else:
            consumed = 0 if L == 0 else watermark + 1
        offset = (offset + consumed) % n_real
        spans.append((placed, w_use))
        placed += w_use
    return placements, rounds, spans, seen


# ---------------------------------------------------------------------------
# cases, from the JAX package's builders
# ---------------------------------------------------------------------------

def _small_nodes(n, a, seed):
    """Nodes that hold 2-3 allocs each: the ring exhausts."""
    c = mc.build_cluster(n, a, seed=seed)
    c["capacity"][:, 0] = np.where(np.arange(n) % 2, 400, 300)
    c["usable"][:, 0] = c["capacity"][:, 0] - c["reserved"][:, 0]
    return c


#: name -> (cluster, n_real, a_pad, limit, blocks, what the case must show)
CASES = {
    "l2_b16": (lambda: mc.build_cluster(96, 127, seed=8), 96, 128, 2, 16, ("cross",)),
    "l10_b16": (lambda: mc.build_cluster(96, 127, seed=8), 96, 128, 10, 16,
                ("cross", "spans_3", "wrap_inside")),
    "l1_b16": (lambda: mc.build_cluster(96, 127, seed=9), 96, 128, 1, 16, ()),
    "l0_b16": (lambda: mc.build_cluster(96, 127, seed=9), 96, 128, 0, 16, ()),
    "short_l200": (lambda: mc.build_cluster(96, 40, seed=10), 96, 64, 200, 16,
                   ("short", "spans_3")),
    "exhaust_l3": (lambda: _small_nodes(96, 400, seed=11), 96, 512, 3, 16,
                   ("exhausted", "cross", "wrap_inside")),
    "padded_l4": (lambda: mc.pad_cluster(mc.build_cluster(90, 200, seed=12), 96), 90, 256, 4,
                  16, ("cross", "wrap_inside")),
    "uneven_b3": (lambda: mc.build_cluster(97, 300, seed=13), 97, 512, 7, 3,
                  ("cross", "wrap_inside")),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    build, n_real, a_pad, limit, blocks, _ = CASES[name]
    args, used0, coll0 = mc.window_problem(build(), limit=limit)
    with jk.deterministic_scope():
        out, _ = jk._dispatch("windowed", jk._plan_batch_windowed_jit,
                              (args, used0, coll0, n_real, a_pad), "windowed")
    placements, rounds = jax.tree_util.tree_map(np.asarray, out)
    return args, used0, coll0, placements, int(rounds)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cluster_round_matches_jax(name):
    _, n_real, a_pad, _, blocks, shows = CASES[name]
    args, used0, coll0, want, want_rounds = _case(name)
    got, rounds, spans, seen = cluster_rounds(args, used0, coll0, n_real, a_pad, blocks)
    for k, (lo, n) in enumerate(spans):  # round by round
        np.testing.assert_array_equal(got[lo:lo + n], want[lo:lo + n], err_msg=f"round {k + 1}")
    np.testing.assert_array_equal(got, want)
    assert rounds == want_rounds
    for what in shows:
        assert seen[what] > 0, f"{name} did not exercise {what}: {seen}"
