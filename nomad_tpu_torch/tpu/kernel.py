"""The placement planners: args, plain PyTorch versions and kernel wrappers.

Counterpart of ``nomad_tpu/tpu/kernel.py``. Three planners share the
score primitives (``_pow10``, ``_binpack``, ``_class_boosts``, ``_scores``,
``_rot_incl``):

- ``plan_batch``: the exact sequential scan, one step per alloc lane (the
  device oracle the other two are held against);
- ``plan_batch_runs``: the run planner for one group with spread or
  affinity and an unbounded limit (fill runs and sweep tie-runs);
- ``plan_batch_windowed``: the windowed planner for one group with a
  bounded limit and no dynamic score planes;

and the plan applier's dense verify, ``verify_rows`` (the per-row fit
check of a plan's aggregated usage deltas).

Each ``*_ref`` function is the plain PyTorch version: it follows the JAX
program's op order so that its float32 bits match (see the float contract
in ``nomad_tpu_torch/tpu/__init__.py``). Each public wrapper runs the plain
version for tensors on the CPU and launches its hand-written CUDA kernel
(``csrc/``) for tensors on a CUDA card; a failed launch raises. Every
planner launch enters the device ledger (``debug/devprof.py``) under the
JAX package's planner names and shape keys, and records its rounds.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..debug import devprof as _devprof

MAX_SKIP = 3  # ref stack.go:17
NEG_INF = -1e30
RUNCAP = 512  # max placements resolved by a single fill run


class KernelFault(ValueError):
    """An input the planners' kernels do not take, refused by a wrapper
    before any launch (today: a resource column count outside what a
    kernel keeps), or an error injected at the ``tpu.kernel`` fault point.
    The ``tpu-batch`` scheduler degrades exactly this to its exact-np host
    oracle, and the applier its dense verify to the host oracle; a CUDA
    build, launch or sync error is not one and propagates."""


class BatchArgs(NamedTuple):
    """Static planes of one batch of G groups across E evals (``C`` is the
    resource column count: 4, or 5 when devices ride the kernel)."""

    capacity: torch.Tensor  # i32[N,C]
    usable: torch.Tensor  # f32[N,2]
    feasible: torch.Tensor  # bool[G,N]
    affinity: torch.Tensor  # f32[G,N]
    affinity_present: torch.Tensor  # bool[G,N]
    group_count: torch.Tensor  # i32[G]
    group_eval: torch.Tensor  # i32[G] owning eval per group
    node_value: torch.Tensor  # i32[G,N] (-1 = missing)
    spread_desired: torch.Tensor  # f32[G,V] (-1 = absent)
    spread_implicit: torch.Tensor  # f32[G] (-1 = none)
    spread_weight_frac: torch.Tensor  # f32[G] (0 = no spread)
    spread_even: torch.Tensor  # bool[G]
    spread_active: torch.Tensor  # bool[G]
    perm: torch.Tensor  # i32[E,N] node id at shuffled ring position p
    ring: torch.Tensor  # i32[E] ring size per eval
    demands: torch.Tensor  # i32[A,C]
    groups: torch.Tensor  # i32[A]
    limits: torch.Tensor  # i32[A]
    valid: torch.Tensor  # bool[A]


class BatchState(NamedTuple):
    used: torch.Tensor  # i32[N,C]
    collisions: torch.Tensor  # i32[G,N]
    spread_counts: torch.Tensor  # i32[G,V]
    spread_present: torch.Tensor  # bool[G,V]
    offset: torch.Tensor  # i32[E] ring cursor per eval


class RunArgs(NamedTuple):
    """Node-axis planes in ROTATION order; ``perm`` maps a position back to
    its node id."""

    capacity: torch.Tensor  # i32[N,C]
    usable: torch.Tensor  # f32[N,2]
    feasible: torch.Tensor  # bool[N]
    affinity: torch.Tensor  # f32[N]
    affinity_present: torch.Tensor  # bool[N]
    group_count: torch.Tensor  # i32 scalar
    node_value: torch.Tensor  # i32[N] (-1 = missing)
    spread_desired: torch.Tensor  # f32[V] (-1 = absent)
    spread_implicit: torch.Tensor  # f32 scalar (-1 = none)
    spread_weight_frac: torch.Tensor  # f32 scalar
    spread_even: torch.Tensor  # bool scalar
    spread_active: torch.Tensor  # bool scalar
    perm: torch.Tensor  # i32[N]
    demand: torch.Tensor  # i32[C]
    n_allocs: torch.Tensor  # i32 scalar


class WindowArgs(NamedTuple):
    capacity: torch.Tensor  # i32[N,C]
    usable: torch.Tensor  # f32[N,2]
    feasible: torch.Tensor  # bool[N]
    perm: torch.Tensor  # i32[N]
    demand: torch.Tensor  # i32[C]
    group_count: torch.Tensor  # i32 scalar
    limit: torch.Tensor  # i32 scalar
    n_allocs: torch.Tensor  # i32 scalar


_ARG_TYPES = {frozenset(t._fields): t for t in (BatchArgs, BatchState, RunArgs, WindowArgs)}


def _fault_point() -> None:
    """The ``tpu.kernel`` fault point of the JAX package's wrappers
    (``testing/faults.py``): an error a test injects there reaches the
    scheduler as a ``KernelFault``, which it degrades to exact-np as it
    degrades the JAX package's device errors. A plain ``None`` check when
    no fault plane is installed."""
    from ..testing import faults

    try:
        faults.fault_point("tpu.kernel")
    except Exception as e:
        raise KernelFault(f"tpu.kernel fault point: {e}") from e


def _to_tensor(x, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.bool_:
        out = a
    elif np.issubdtype(a.dtype, np.integer):
        if a.size and (a.min() < np.iinfo(np.int32).min or a.max() > np.iinfo(np.int32).max):
            raise ValueError("integer plane does not fit int32")
        out = a.astype(np.int32)
    elif np.issubdtype(a.dtype, np.floating):
        out = a.astype(np.float32)
    else:
        raise TypeError(f"unsupported plane dtype {a.dtype}")
    return torch.from_numpy(np.array(out, order="C")).to(device)  # a copy: callers' arrays may be read-only


def from_numpy(obj, device=None):
    """The port's tensors from numpy planes: a NamedTuple or dict with the
    field names of ``BatchArgs``/``BatchState``/``RunArgs``/``WindowArgs``
    (the JAX package's args or ``problems``' dicts) becomes that NamedTuple;
    any other tuple a tuple of the same conversions; an array one tensor.
    Dtypes are pinned to int32, float32 and bool."""
    dev = resolve_device(device)
    if isinstance(obj, dict) or hasattr(obj, "_fields"):
        fields = dict(obj) if isinstance(obj, dict) else dict(zip(obj._fields, obj))
        cls = _ARG_TYPES.get(frozenset(fields))
        if cls is None:
            raise ValueError(f"no planner args with fields {sorted(fields)}")
        return cls(**{k: _to_tensor(v, dev) for k, v in fields.items()})
    if isinstance(obj, (tuple, list)):
        return tuple(from_numpy(x, dev) for x in obj)
    return _to_tensor(obj, dev)


# ---------------------------------------------------------------------------
# score primitives (plain versions)
# ---------------------------------------------------------------------------

def _f32(x: float) -> float:
    """A float32 constant as a Python float (exactly representable, so a
    tensor op with it computes on the float32 value JAX uses)."""
    return float(np.float32(x))


_LOG2_10 = 3.3219280948873623
_LOG2_10_HI = 3.322265625  # log2(10) rounded to 12 mantissa bits
_LOG2_10_LO = _LOG2_10 - _LOG2_10_HI
# XLA rewrites a division by a constant as a multiplication by its
# reciprocal: ``x / 18.0`` in the JAX _binpack computes x * float32(1/18).
# A true division differs by one ulp on about 11% of inputs, and the
# planners break ties by exact float equality, so both versions multiply.
_INV18 = _f32(1.0 / 18.0)
_EXP2_POLY = tuple(
    _f32(c)
    for c in (
        1.535336188319500e-4,
        1.339887440266574e-3,
        9.618437357674640e-3,
        5.550332471162809e-2,
        2.402264791363012e-1,
        6.931472028550421e-1,
        1.0,
    )
)


def _two_pow(e: torch.Tensor) -> torch.Tensor:
    return ((e + 127) << 23).to(torch.int32).view(torch.float32)


def _pow10(x: torch.Tensor) -> torch.Tensor:
    """Bit-stable 10^x in float32 (the JAX ``_pow10``): 2^(x*log2 10) with a
    Veltkamp-split range reduction, a fixed Cephes exp2f Horner chain and
    the exponent applied by bit assembly in two exact steps."""
    x = torch.clamp(x, _f32(-45.2), _f32(45.2))
    c = x * _f32(4097.0)
    x_hi = c - (c - x)
    x_lo = x - x_hi
    y_hi = x_hi * _f32(_LOG2_10_HI)
    y_lo = x_hi * _f32(_LOG2_10_LO) + x_lo * _f32(_LOG2_10)
    n = torch.round(y_hi + y_lo)
    f = (y_hi - n) + y_lo
    p = f * _EXP2_POLY[0] + _EXP2_POLY[1]
    for coef in _EXP2_POLY[2:]:
        p = p * f + coef
    n_i = n.to(torch.int32)
    n1 = torch.clamp(n_i, -126, 127)
    n2 = torch.clamp(n_i - n1, -126, 127)
    return p * _two_pow(n1) * _two_pow(n2)


def _binpack(free_cpu: torch.Tensor, free_mem: torch.Tensor) -> torch.Tensor:
    """Normalized ScoreFit: clip(20 - 10^fcpu - 10^fmem, 0, 18) / 18."""
    total = _pow10(free_cpu) + _pow10(free_mem)
    return torch.clamp(20.0 - total, 0.0, 18.0) * _INV18


def _class_boosts(counts, present, desired, implicit, weight_frac, even_flag, active_flag):
    """Spread boost per value class plus the missing-value class at index V
    (target mode: (desired - used)/desired weighted; even mode: boost the
    classes below the minimum count)."""
    eps = _f32(1e-9)
    used_count = counts.float() + 1.0
    desired_eff = torch.where(desired >= 0.0, desired, implicit)
    target = torch.where(
        desired_eff >= 0.0,
        (desired_eff - used_count) / torch.clamp_min(desired_eff, eps) * weight_frac,
        -1.0,
    )
    counts_f = counts.float()
    big = float(2**30)
    any_present = present.any()
    min_count = torch.where(any_present, torch.where(present, counts_f, big).min(), 0.0)
    max_count = torch.where(any_present, torch.where(present, counts_f, -big).max(), 0.0)
    delta_boost = torch.where(
        min_count == 0.0, -1.0, (min_count - counts_f) / torch.clamp_min(min_count, eps)
    )
    even = torch.where(
        counts_f != min_count,
        delta_boost,
        torch.where(
            min_count == max_count,
            -1.0,
            torch.where(
                min_count == 0.0,
                1.0,
                (max_count - min_count) / torch.clamp_min(min_count, eps),
            ),
        ),
    )
    even = torch.where(any_present, even, 0.0)
    per_class = torch.where(even_flag, even, target)
    boosts = torch.cat([per_class, per_class.new_full((1,), -1.0)])
    return torch.where(active_flag, boosts, torch.zeros_like(boosts))


def _scores(args: BatchArgs, state: BatchState, g: int, demand: torch.Tensor) -> torch.Tensor:
    """Final score per node for one placement (mean over fired planes)."""
    util = state.used + demand[None, :]
    free_cpu = 1.0 - util[:, 0].float() / args.usable[:, 0]
    free_mem = 1.0 - util[:, 1].float() / args.usable[:, 1]
    binpack = _binpack(free_cpu, free_mem)

    coll = state.collisions[g]
    anti_present = coll > 0
    anti = torch.where(
        anti_present, -(coll.float() + 1.0) / args.group_count[g].float(), 0.0
    )
    aff = args.affinity[g]
    aff_present = args.affinity_present[g]

    v = args.node_value[g]
    boosts = _class_boosts(
        state.spread_counts[g],
        state.spread_present[g],
        args.spread_desired[g],
        args.spread_implicit[g],
        args.spread_weight_frac[g],
        args.spread_even[g],
        args.spread_active[g],
    )
    V = args.spread_desired.shape[1]
    cls = torch.where(v >= 0, v, V)
    # a gather, where the JAX run planner multiplies by a one-hot matrix:
    # one nonzero product per row, so both give the same bits
    spread_score = boosts[cls]
    spread_fired = args.spread_active[g] & (spread_score != 0.0)
    spread_score = torch.where(spread_fired, spread_score, 0.0)

    num = 1.0 + anti_present.float() + aff_present.float() + spread_fired.float()
    return (
        binpack
        + torch.where(anti_present, anti, 0.0)
        + torch.where(aff_present, aff, 0.0)
        + spread_score
    ) / num


def _rot_incl(x: torch.Tensor, offset, total, positions: torch.Tensor) -> torch.Tensor:
    """Inclusive count of ``x`` along rotation order up to each position,
    the ring starting at ``offset`` (two-segment prefix sum)."""
    xi = x.to(torch.int32)
    xc = torch.cumsum(xi, 0, dtype=torch.int32)
    x_off = (xc - xi)[offset]
    return torch.where(positions >= offset, xc - x_off, total - x_off + xc)


# ---------------------------------------------------------------------------
# plain versions of the three planners
# ---------------------------------------------------------------------------

def plan_batch_ref(args: BatchArgs, init: BatchState, n_real: int):
    """Plain version of the exact sequential scan (JAX ``_plan_batch_jit``):
    returns (final state, node index per alloc or -1). ``n_real`` is unused
    by the scan itself (each eval's ``ring`` bounds its positions); it is
    kept for the JAX signature."""
    del n_real
    n_pad = args.capacity.shape[0]
    dev = args.capacity.device
    positions = torch.arange(n_pad, dtype=torch.int32, device=dev)
    used, coll, counts, present, offset = (t.clone() for t in init)
    groups = args.groups.tolist()
    limits = args.limits.tolist()
    valid = args.valid.tolist()
    group_eval = args.group_eval.tolist()
    ring = args.ring.tolist()
    out = torch.full((len(groups),), -1, dtype=torch.int32, device=dev)
    for i, g in enumerate(groups):
        if not valid[i]:
            continue  # places nothing, cursor unchanged
        demand = args.demands[i]
        limit = limits[i]
        e = group_eval[g]
        ring_size = ring[e]
        perm = args.perm[e]
        in_ring = positions < ring_size
        state = BatchState(used, coll, counts, present, offset)

        fit_nodes = args.feasible[g] & (used + demand[None, :] <= args.capacity).all(dim=1)
        final = _scores(args, state, g, demand)
        fit_p = fit_nodes[perm] & in_ring
        score_p = final[perm]
        off = int(offset[e])

        # limit-iterator window (select.go:35-67): defer up to 3 options <= 0
        nonpos = fit_p & (score_p <= 0.0)
        nonpos_incl = _rot_incl(nonpos, off, nonpos.sum(dtype=torch.int32), positions)
        skipped = nonpos & (nonpos_incl <= MAX_SKIP)
        kept = fit_p & ~skipped
        ret_incl = _rot_incl(kept, off, kept.sum(dtype=torch.int32), positions)
        returned = kept & (ret_incl <= limit)
        n_returned = int(returned.sum())
        # replay deferred options only when the ring exhausted before limit
        need = max(limit - n_returned, 0)
        skip_incl = _rot_incl(skipped, off, skipped.sum(dtype=torch.int32), positions)
        replay = skipped & (skip_incl <= need)
        candidates = returned | replay

        rot_rank = torch.where(positions >= off, positions - off, ring_size - off + positions)
        max_score = torch.where(candidates, score_p, NEG_INF).max()
        # first strict max in the order the iterator sees options: returned
        # options in rotation order, then the replayed deferred ones
        tie = candidates & (score_p == max_score)
        visit_order = rot_rank + torch.where(replay, n_pad, 0)
        best_p = torch.argmin(torch.where(tie, visit_order, 2**30))
        last_ret_rank = int(torch.where(returned, rot_rank, -1).max())
        consumed = last_ret_rank + 1 if n_returned >= limit else ring_size

        if bool(candidates.any()):
            b = int(perm[best_p])
            out[i] = b
            used[b] += demand
            coll[g, b] += 1
            v = int(args.node_value[g, b])
            if bool(args.spread_active[g]) and v >= 0:
                counts[g, v] += 1
                present[g, v] = True
        offset[e] = (off + consumed) % max(ring_size, 1)
    return BatchState(used, coll, counts, present, offset), out


def _lexsort_key(x: torch.Tensor) -> torch.Tensor:
    """int32 key that sorts like ``lax.sort`` sorts floats: ascending, with
    -0.0 folded onto +0.0."""
    bits = torch.where(x == 0.0, 0.0, x).view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def plan_batch_runs_ref(args: RunArgs, init, a_pad: int, even_mode: bool = False):
    """Plain version of the run planner (JAX ``_plan_batch_runs_jit``):
    returns (node index per alloc slot [a_pad], -1 = unplaced; rounds)."""
    n_pad = args.capacity.shape[0]
    dev = args.capacity.device
    used, coll, counts, present = (t.clone() for t in init)
    V = counts.shape[0]
    count_f = args.group_count.float()
    pos = torch.arange(n_pad, dtype=torch.int32, device=dev)
    cls = torch.where(args.node_value >= 0, args.node_value, V).long()
    aff_term = torch.where(args.affinity_present, args.affinity, 0.0)
    aff_f = args.affinity_present.float()
    desired_eff = torch.where(
        args.spread_desired >= 0.0, args.spread_desired, args.spread_implicit
    )
    delta_v = torch.where(
        desired_eff >= 0.0,
        args.spread_weight_frac / torch.clamp_min(desired_eff, _f32(1e-9)),
        0.0,
    )
    delta_v = torch.where(args.spread_active & ~args.spread_even, delta_v, 0.0)
    delta_node = torch.cat([delta_v, delta_v.new_zeros(1)])[cls]
    demand_f2 = args.demand[:2].float()
    active = bool(args.spread_active)
    n_allocs = int(args.n_allocs)

    def score_at(used, coll, boosts, extra: int):
        """Scores with ``extra`` more demands and collisions on every node
        and ``extra`` more own-class placements."""
        util = (used + (1 + extra) * args.demand[None, :])[:, :2].float()
        free = 1.0 - util / args.usable
        binpack = _binpack(free[:, 0], free[:, 1])
        coll_e = coll + extra
        ap = coll_e > 0
        an = torch.where(ap, -(coll_e.float() + 1.0) / count_f, 0.0)
        sp = boosts[cls] - extra * delta_node
        fired = args.spread_active & (sp != 0.0)
        num = 1.0 + ap.float() + aff_f + fired.float()
        return (binpack + an + aff_term + torch.where(fired, sp, 0.0)) / num, num

    placements = torch.full((a_pad,), -1, dtype=torch.int32, device=dev)
    placed = rounds = 0
    progress = True
    while placed < n_allocs and progress:
        rounds += 1
        fit = args.feasible & (used + args.demand[None, :] <= args.capacity).all(dim=1)
        boosts = _class_boosts(
            counts, present, args.spread_desired, args.spread_implicit,
            args.spread_weight_frac, args.spread_even, args.spread_active,
        )
        score, num = score_at(used, coll, boosts, 0)
        progress = bool(fit.any())
        if not progress:
            break
        max_score = torch.where(fit, score, NEG_INF).max()

        # the first 3 nonpositive options in rotation order are visited last
        nonpos = fit & (score <= 0.0)
        deferred = nonpos & (torch.cumsum(nonpos.to(torch.int32), 0) <= MAX_SKIP)
        visit = pos + torch.where(deferred, n_pad, 0)

        tied = fit & (score == max_score)
        best = int(torch.argmin(torch.where(tied, visit, 2**30)))
        runner_other = torch.where(fit & (pos != best), score, NEG_INF).max()
        runner_nontied = torch.where(fit & ~tied, score, NEG_INF).max()
        remaining = n_allocs - placed

        n_acc = 0
        if not even_mode:
            # sweep tie-run: keys of the tied set in merged order
            onehot = torch.nn.functional.one_hot(cls, V + 1).to(torch.int32)
            t_mat = torch.cumsum(onehot * tied[:, None].to(torch.int32), 0)
            t_own = t_mat.gather(1, cls[:, None])[:, 0].float() - 1.0
            key = score - t_own * delta_node / num
            accept0 = tied & (key > runner_nontied)
            key_min0 = torch.where(accept0, key, float("inf")).min()
            score2, _ = score_at(used, coll, boosts, 1)
            guard = score2 <= key_min0
            bad_key = torch.where(accept0 & ~guard, key, NEG_INF).max()
            accept = accept0 & (key > bad_key)
            n_acc = int(accept.sum())

        if n_acc > 1:
            order = torch.sort(visit, stable=True).indices
            order = order[torch.sort(_lexsort_key(-key[order]).masked_fill(~accept[order], 2**31 - 1), stable=True).indices]
            take = min(remaining, n_acc)
            chosen = order[:take]
            placements[placed: placed + take] = args.perm[chosen]
            used[chosen] += args.demand
            coll[chosen] += 1
            if active:
                hit = torch.bincount(cls[chosen], minlength=V + 1)[:V].to(torch.int32)
                counts += hit
                present |= hit > 0
            placed += take
        else:
            # fill run: the winner's trajectory under j self-placements
            used_b = used[best]
            coll_b = coll[best].float()
            cls_b = int(cls[best])
            jj = torch.arange(RUNCAP, dtype=torch.int32, device=dev)
            jf = jj.float()
            util_j = used_b[:2].float()[None, :] + (jf[:, None] + 1.0) * demand_f2[None, :]
            free_j = 1.0 - util_j / args.usable[best][None, :]
            bp_j = _binpack(free_j[:, 0], free_j[:, 1])
            coll_j = coll_b + jf
            ap_j = coll_j > 0.0
            an_j = torch.where(ap_j, -(coll_j + 1.0) / count_f, 0.0)
            sp_j = boosts[cls_b] - jf * delta_node[best]
            fired_j = args.spread_active & (sp_j != 0.0)
            num_j = 1.0 + ap_j.float() + aff_f[best] + fired_j.float()
            traj = (bp_j + an_j + aff_term[best] + torch.where(fired_j, sp_j, 0.0)) / num_j
            fit_j = (
                used_b[None, :] + (jj[:, None] + 1) * args.demand[None, :]
                <= args.capacity[best][None, :]
            ).all(dim=1)
            if even_mode:
                ok = torch.zeros(RUNCAP, dtype=torch.bool, device=dev)
            else:
                ok = fit_j & (traj > runner_other) & (jj < remaining)
            # ok[j]: the (j+1)-th consecutive placement happens; the first
            # is granted (best already won this round)
            run = 1 + int(torch.cumprod(ok[1:].to(torch.int32), 0).sum())
            run = min(run, remaining)
            placements[placed: placed + run] = args.perm[best]
            used[best] += run * args.demand
            coll[best] += run
            if active and cls_b < V:
                counts[cls_b] += run
                present[cls_b] |= run > 0
            placed += run
    return placements, rounds


def plan_batch_windowed_ref(args: WindowArgs, used0, collisions0, n_real: int, a_pad: int):
    """Plain version of the windowed planner (JAX
    ``_plan_batch_windowed_jit``): returns (node index per alloc slot
    [a_pad], -1 = unplaced; rounds)."""
    n_pad = args.capacity.shape[0]
    dev = args.capacity.device
    positions = torch.arange(n_pad, dtype=torch.int32, device=dev)
    in_ring = positions < n_real
    nseg = n_real + 1
    L = int(args.limit)
    n_allocs = int(args.n_allocs)
    count_f = args.group_count.float()
    used = used0.clone()
    collisions = collisions0.clone()
    placements = torch.full((a_pad,), -1, dtype=torch.int32, device=dev)
    offset = placed = rounds = 0
    progress = True
    while placed < n_allocs and progress:
        rounds += 1
        fit_nodes = args.feasible & (used + args.demand[None, :] <= args.capacity).all(dim=1)
        util = used + args.demand[None, :]
        free_cpu = 1.0 - util[:, 0].float() / args.usable[:, 0]
        free_mem = 1.0 - util[:, 1].float() / args.usable[:, 1]
        binpack = _binpack(free_cpu, free_mem)
        anti_present = collisions > 0
        anti = torch.where(anti_present, -(collisions.float() + 1.0) / count_f, 0.0)
        final = (binpack + anti) / (1.0 + anti_present.float())

        fit_p = fit_nodes[args.perm] & in_ring
        score_p = final[args.perm]
        total_feas = int(fit_p.sum())
        feas_rank = _rot_incl(fit_p, offset, total_feas, positions) - fit_p.to(torch.int32)

        remaining = n_allocs - placed
        w_avail = max(total_feas // max(L, 1), 1) if total_feas > 0 else 0
        w_use = min(w_avail, remaining)
        window = feas_rank // max(L, 1)
        active = fit_p & (window < w_use)
        seg = torch.where(active, window, nseg - 1).long()

        # per window: max score, then the first in rotation among the maxima
        seg_max = torch.full((nseg,), float("-inf"), device=dev).scatter_reduce(
            0, seg, torch.where(active, score_p, NEG_INF), "amax", include_self=False
        )
        is_best = active & (score_p == seg_max[seg])
        seg_min_rank = torch.full((nseg,), 2**30, dtype=torch.int32, device=dev).scatter_reduce(
            0, seg, torch.where(is_best, feas_rank, 2**30), "amin", include_self=False
        )
        chosen = is_best & (feas_rank == seg_min_rank[seg])

        nodes = args.perm[chosen].long()
        used[nodes] += args.demand
        collisions[nodes] += 1
        placements[(placed + window[chosen]).long()] = args.perm[chosen]

        # consumed ring positions: through the (w_use*L)-th feasible node,
        # or the whole ring when the pass exhausted it
        rot_rank = torch.where(positions >= offset, positions - offset, n_real - offset + positions)
        last = int(torch.where(fit_p & (feas_rank < w_use * L), rot_rank, -1).max())
        consumed = n_real if total_feas < w_use * L else last + 1
        offset = (offset + max(consumed, 0)) % n_real
        placed += w_use
        progress = w_use > 0
    return placements, rounds


# ---------------------------------------------------------------------------
# public wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------

#: kernel launches per kernel since the last ``reset_launches`` (the
#: wrappers of the other kernels live in ``drain.py``, ``mirror.py``,
#: ``wavefront.py`` and ``paging.py``)
LAUNCHES = {
    "exact_scan": 0, "runs": 0, "windowed": 0,
    "used_bases": 0, "scatter_rows": 0, "verify_rows": 0,
    "wavefront": 0, "tile_count": 0, "tile_window": 0,
    "binpack": 0, "class_boosts": 0, "scores": 0, "rot_incl": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# each plane's shape, one letter per dimension: N nodes, C resource
# columns, G groups, V spread values, E evals, A alloc lanes; a digit is a
# fixed size and "" a scalar
_EXACT_SHAPES = dict(
    capacity="NC", usable="N2", feasible="GN", affinity="GN", affinity_present="GN",
    group_count="G", group_eval="G", node_value="GN", spread_desired="GV",
    spread_implicit="G", spread_weight_frac="G", spread_even="G", spread_active="G",
    perm="EN", ring="E", demands="AC", groups="A", limits="A", valid="A",
    used="NC", collisions="GN", spread_counts="GV", spread_present="GV", offset="E",
)
_RUN_SHAPES = dict(
    capacity="NC", usable="N2", feasible="N", affinity="N", affinity_present="N",
    group_count="", node_value="N", spread_desired="V", spread_implicit="",
    spread_weight_frac="", spread_even="", spread_active="", perm="N", demand="C",
    n_allocs="", used="NC", collisions="N", spread_counts="V", spread_present="V",
)
_WINDOW_SHAPES = dict(
    capacity="NC", usable="N2", feasible="N", perm="N", demand="C", group_count="",
    limit="", n_allocs="", used="NC", collisions="N",
)


def _check_cuda(named: dict, shapes: dict, device: torch.device) -> dict:
    """Check what a kernel takes (device, dtype, contiguity and shapes that
    agree); returns the size of each dimension letter."""
    want = {torch.int32, torch.float32, torch.bool}
    dims = {}
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype not in want:
            raise TypeError(f"{name} has dtype {t.dtype}; planes are int32/float32/bool")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        spec = shapes[name]
        if t.dim() != len(spec):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected [{','.join(spec)}]")
        for letter, size in zip(spec, t.shape):
            expect = int(letter) if letter.isdigit() else dims.setdefault(letter, size)
            if size != expect:
                raise ValueError(f"{name} has shape {tuple(t.shape)}: {letter} is {expect} elsewhere")
    return dims


def _check_int32(named: dict, shapes: dict, device: torch.device) -> dict:
    """``_check_cuda`` for kernels whose every plane is int32."""
    for name, t in named.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected int32")
    return _check_cuda(named, shapes, device)


def _check_index(t: torch.Tensor, hi: int, name: str) -> None:
    """The kernels index with these values: they must lie in [0, hi)."""
    if t.numel() and (int(t.min()) < 0 or int(t.max()) >= hi):
        raise ValueError(f"{name} holds an index outside [0, {hi})")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch_status(name: str, rc: int) -> None:
    """Raise on a C entry point's non-zero status."""
    from . import _build

    if rc != 0:
        msg = _build.library().ntt_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def _launch(name: str, fn, *call_args) -> None:
    _launch_status(name, fn(*call_args))
    LAUNCHES[name] += 1


#: torch's query of a device's current stream as a pointer (CUDA builds),
#: which makes no Stream object
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream_ptr(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an int."""
    index = torch.cuda.current_device() if device.index is None else device.index
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(_stream_ptr(device))


def _ledger(planner: str, shape_key: str, device: torch.device, t0: float) -> None:
    """Note a planner launch in the device ledger: the first of its
    (planner, shape, flavor) in the process counts as its compile, timed
    from ``t0`` by the host clock (nothing waits for the card)."""
    flavor = "cuda" if device.type == "cuda" else "plain"
    _devprof.record_launch(planner, shape_key, flavor, time.perf_counter() - t0)


def _library():
    """The kernel library, loaded before a wrapper starts its clock (its
    load enters the ledger under its own key)."""
    from . import _build

    return _build.library()


#: resource columns the exact-scan kernel keeps in registers
SCAN_MAX_COLS = 6
#: spread classes whose boosts the exact-scan and wavefront kernels hold in
#: each block's shared memory; more classes take each position's boost from
#: the classes' count range, read from L2
SCAN_MAX_CLASSES = 49_152


def plan_batch(args: BatchArgs, init: BatchState, n_real: int, n_valid: int = None,
               walked: torch.Tensor | None = None):
    """Run the exact placement scan; returns (final state, node index per
    alloc or -1). On the card it is one launch of one thread block cluster
    (``csrc/exact_scan.cu``); a card that cannot hold the cluster raises.
    ``n_valid`` is the count of real alloc lanes, against which the round
    ledger charges the scan's one step per lane (all lanes when omitted).
    ``walked``, a one-element int64 tensor on the card, gets the ring
    positions the kernel's steps walked added to it (the plain version
    walks no chunks and takes none)."""
    _fault_point()
    device = args.capacity.device
    A = int(args.demands.shape[0])
    key = f"E{args.perm.shape[0]}G{args.feasible.shape[0]}A{A}N{args.capacity.shape[0]}"
    if device.type == "cpu":
        if walked is not None:
            raise ValueError("only the kernel counts the ring positions it walks")
        t0 = time.perf_counter()
        out = plan_batch_ref(args, init, n_real)
    else:
        lib = _library()
        t0 = time.perf_counter()
        out = _plan_batch_cuda(lib, args, init, walked, device)
    _ledger("exact", key, device, t0)
    # one scan step per alloc lane, each a full-ring score and argmax
    _devprof.count_rounds("exact", A, A if n_valid is None else int(n_valid), False)
    return out


def _plan_batch_cuda(lib, args: BatchArgs, init: BatchState, walked, device):
    d = _check_cuda({**args._asdict(), **init._asdict()}, _EXACT_SHAPES, device)
    N, C, G, V, E, A = (d[k] for k in "NCGVEA")
    _check_index(args.perm, N, "perm")
    _check_index(args.groups, G, "groups")
    _check_index(args.group_eval, E, "group_eval")
    if not 2 <= C <= SCAN_MAX_COLS:
        raise KernelFault(f"the exact scan takes 2 to {SCAN_MAX_COLS} resource columns, not {C}")
    if walked is not None and (walked.shape != (1,) or walked.dtype != torch.int64
                               or walked.device != device):
        raise ValueError("walked must be a one-element int64 tensor on the scan's device")
    state = BatchState(*(t.clone() for t in init))
    placements = torch.empty(A, dtype=torch.int32, device=device)
    _launch(
        "exact_scan",
        lib.ntt_exact_scan,
        *(_ptr(t) for t in args),
        *(_ptr(t) for t in state),
        _ptr(placements), None if walked is None else _ptr(walked),
        N, C, G, V, E, A,
        _stream(device),
    )
    return state, placements


def plan_batch_runs(args: RunArgs, init, a_pad: int, even_mode: bool = False,
                    n_valid: int = None):
    """Place ``n_allocs`` identical asks under full-ring selection; returns
    (node index per alloc slot [a_pad], -1 = unplaced; rounds). On the card
    ``rounds`` is a device tensor, so the call does not wait for the
    kernel. The round ledger gets the rounds against ``n_valid`` (the
    host's count of ``n_allocs``; the device scalar itself when omitted)
    without waiting either."""
    _fault_point()
    device = args.capacity.device
    key = f"N{args.capacity.shape[0]}A{a_pad}"
    if device.type == "cpu":
        t0 = time.perf_counter()
        placements, rounds = plan_batch_runs_ref(args, init, a_pad, even_mode)
    else:
        lib = _library()
        t0 = time.perf_counter()
        placements, rounds = _plan_batch_runs_cuda(lib, args, init, a_pad, even_mode, device)
    _ledger("runs", key, device, t0)
    _devprof.count_rounds("runs", rounds, args.n_allocs if n_valid is None else n_valid, False)
    return placements, rounds


def _plan_batch_runs_cuda(lib, args: RunArgs, init, a_pad: int, even_mode: bool, device):
    init = dict(zip(("used", "collisions", "spread_counts", "spread_present"), init))
    d = _check_cuda({**args._asdict(), **init}, _RUN_SHAPES, device)
    N, C, V = d["N"], d["C"], d["V"]
    if C < 2:
        raise KernelFault(f"the run planner takes at least 2 resource columns, not {C}")
    used, coll, counts, present = (t.clone() for t in init.values())
    placements = torch.empty(a_pad, dtype=torch.int32, device=device)
    rounds = torch.zeros(1, dtype=torch.int32, device=device)
    size = ctypes.c_longlong(0)
    _launch_status("runs", lib.ntt_runs_scratch(ctypes.addressof(size), N, C, V, _stream(device)))
    # every block's class arrays and sort list; round records past 1,024 positions a block
    scratch = torch.zeros(max(size.value, 16), dtype=torch.uint8, device=device)
    _launch(
        "runs",
        lib.ntt_runs,
        *(_ptr(t) for t in args),
        _ptr(used), _ptr(coll), _ptr(counts), _ptr(present),
        _ptr(placements), _ptr(rounds), _ptr(scratch),
        N, C, V, a_pad, int(bool(even_mode)),
        _stream(device),
    )
    return placements, rounds[0]


def _check_perm(perm: torch.Tensor, n: int) -> None:
    """The windowed kernel keeps each node's state with its one ring
    position: ``perm`` must be a permutation of [0, n). The check waits for
    the card."""
    ring = torch.arange(n, dtype=perm.dtype, device=perm.device)
    if not torch.equal(torch.sort(perm).values, ring):
        raise ValueError(f"perm is not a permutation of [0, {n})")


def windowed_shape(N: int, C: int, n_real: int) -> dict:
    """The windowed kernel's launch at this shape: its cluster's blocks,
    threads a block, ring positions a thread, and whether the positions'
    state stays in registers."""
    from . import _build

    out = (ctypes.c_int * 4)()
    _launch_status("windowed", _build.library().ntt_windowed_shape(out, N, C, n_real, None))
    return dict(blocks=out[0], threads=out[1], positions_a_thread=out[2],
                state_in_registers=bool(out[3]))


def plan_batch_windowed(args: WindowArgs, used0, collisions0, n_real: int, a_pad: int,
                        n_valid: int = None):
    """Place ``n_allocs`` identical asks in windows of ``limit`` feasible
    ring positions; returns (node index per alloc slot [a_pad], -1 =
    unplaced; rounds). On the card it is one launch of one thread block
    cluster (``csrc/windowed.cu``) that reads ``used0`` and ``collisions0``
    and writes neither; ``rounds`` is a device tensor, so the call does not
    wait for the kernel (its permutation check does). The round ledger gets
    the rounds against ``n_valid`` (the host's count of ``n_allocs``; the
    device scalar itself when omitted) without waiting."""
    _fault_point()
    device = args.capacity.device
    key = f"N{args.capacity.shape[0]}A{a_pad}"
    if device.type == "cpu":
        t0 = time.perf_counter()
        placements, rounds = plan_batch_windowed_ref(args, used0, collisions0, n_real, a_pad)
    else:
        lib = _library()
        t0 = time.perf_counter()
        placements, rounds = _plan_batch_windowed_cuda(lib, args, used0, collisions0, n_real,
                                                       a_pad, device)
    _ledger("windowed", key, device, t0)
    _devprof.count_rounds("windowed", rounds, args.n_allocs if n_valid is None else n_valid,
                          False)
    return placements, rounds


def _plan_batch_windowed_cuda(lib, args: WindowArgs, used0, collisions0, n_real: int,
                              a_pad: int, device):
    d = _check_cuda({**args._asdict(), "used": used0, "collisions": collisions0},
                    _WINDOW_SHAPES, device)
    N, C = d["N"], d["C"]
    _check_perm(args.perm, N)
    if not 0 < n_real <= N:
        raise ValueError(f"n_real {n_real} outside (0, {N}]")
    if C < 2:
        raise KernelFault(f"the windowed planner takes at least 2 resource columns, not {C}")
    placements = torch.empty(a_pad, dtype=torch.int32, device=device)
    rounds = torch.empty(1, dtype=torch.int32, device=device)
    size = ctypes.c_longlong(0)
    _launch_status("windowed", lib.ntt_windowed_scratch(ctypes.addressof(size), N, C, n_real,
                                                        _stream(device)))
    # the window keys and, past the register path, a record a ring position
    scratch = torch.empty(size.value, dtype=torch.uint8, device=device)
    _launch(
        "windowed",
        lib.ntt_windowed,
        *(_ptr(t) for t in args),
        _ptr(used0), _ptr(collisions0), _ptr(placements), _ptr(rounds), _ptr(scratch),
        N, C, n_real, a_pad,
        _stream(device),
    )
    return placements, rounds[0]


# ---------------------------------------------------------------------------
# the score primitives alone (the planners inline them; csrc/primitives.cu
# applies each to one plane, to hold it against its plain version)
# ---------------------------------------------------------------------------

def _plane(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor")


def binpack(free_cpu: torch.Tensor, free_mem: torch.Tensor) -> torch.Tensor:
    """ScoreFit per node from its free fractions (``_binpack``)."""
    if free_cpu.device.type == "cpu":
        return _binpack(free_cpu, free_mem)
    from . import _build

    for name, t in (("free_cpu", free_cpu), ("free_mem", free_mem)):
        _plane(t, name, torch.float32)
    if free_cpu.shape != free_mem.shape or free_cpu.dim() != 1:
        raise ValueError("binpack takes two planes of one shape [N]")
    out = torch.empty_like(free_cpu)
    _launch("binpack", _build.library().ntt_binpack, _ptr(free_cpu), _ptr(free_mem), _ptr(out),
            free_cpu.numel(), _stream(free_cpu.device))
    return out


def class_boosts(counts, present, desired, implicit, weight_frac, even_flag, active_flag):
    """Spread boost per value class plus the missing-value class at index V
    (``_class_boosts``); the scalars are one-element tensors on the card."""
    if counts.device.type == "cpu":
        return _class_boosts(counts, present, desired, implicit, weight_frac, even_flag,
                             active_flag)
    from . import _build

    named = dict(counts=counts, present=present, desired=desired, implicit=implicit,
                 weight_frac=weight_frac, even_flag=even_flag, active_flag=active_flag)
    d = _check_cuda({k: t.reshape(-1) for k, t in named.items()},
                    dict(counts="V", present="V", desired="V", implicit="1", weight_frac="1",
                         even_flag="1", active_flag="1"), counts.device)
    out = torch.empty(d["V"] + 1, dtype=torch.float32, device=counts.device)
    _launch("class_boosts", _build.library().ntt_class_boosts,
            *(_ptr(t.reshape(-1)) for t in named.values()), _ptr(out), d["V"],
            _stream(counts.device))
    return out


def scores(args: BatchArgs, state: BatchState, g: int, demand: torch.Tensor) -> torch.Tensor:
    """Final score per node of group ``g`` for one placement (``_scores``)."""
    device = args.capacity.device
    if device.type == "cpu":
        return _scores(args, state, g, demand)
    from . import _build

    N, C = state.used.shape
    V = args.spread_desired.shape[1]
    row = dict(
        used=state.used, usable=args.usable, collisions=state.collisions[g],
        group_count=args.group_count[g:g + 1], affinity=args.affinity[g],
        affinity_present=args.affinity_present[g], node_value=args.node_value[g],
        demand=demand, counts=state.spread_counts[g], present=state.spread_present[g],
        desired=args.spread_desired[g], implicit=args.spread_implicit[g:g + 1],
        weight_frac=args.spread_weight_frac[g:g + 1], even=args.spread_even[g:g + 1],
        active=args.spread_active[g:g + 1],
    )
    _check_cuda(row, dict(used="NC", usable="N2", collisions="N", group_count="1", affinity="N",
                          affinity_present="N", node_value="N", demand="C", counts="V",
                          present="V", desired="V", implicit="1", weight_frac="1", even="1",
                          active="1"), device)
    if C < 2:
        raise ValueError(f"scores take at least 2 resource columns, not {C}")
    out = torch.empty(N, dtype=torch.float32, device=device)
    _launch("scores", _build.library().ntt_scores, *(_ptr(t) for t in row.values()), _ptr(out),
            N, C, V, _stream(device))
    return out


def rot_incl(x: torch.Tensor, offset: int) -> torch.Tensor:
    """Inclusive count of the bool plane ``x`` along the ring that starts at
    ``offset`` (``_rot_incl`` with the plane's own total)."""
    if x.device.type == "cpu":
        positions = torch.arange(x.numel(), dtype=torch.int32)
        return _rot_incl(x, offset, x.to(torch.int32).sum(dtype=torch.int32), positions)
    from . import _build

    _plane(x, "x", torch.bool)
    if x.dim() != 1 or not 0 <= offset < max(x.numel(), 1):
        raise ValueError("rot_incl takes a bool plane [N] and an offset in [0, N)")
    out = torch.empty(x.numel(), dtype=torch.int32, device=x.device)
    _launch("rot_incl", _build.library().ntt_rot_incl, _ptr(x), _ptr(out), int(offset), x.numel(),
            _stream(x.device))
    return out


# ---------------------------------------------------------------------------
# dense plan verify (the applier's commit-time fit check)
# ---------------------------------------------------------------------------

def verify_rows_ref(capacity, used, rows, deltas):
    """Plain version of the dense verify (JAX ``_verify_rows_jit``): add
    each lane's deltas into its row of ``used`` (lanes on one row see the
    sum of all their deltas; int32 adds wrap as JAX's do) and test every
    column against ``capacity``; returns the verdict per lane, bool[R].
    ``used`` is not written. A lane whose row lies outside [0, N) adds
    nothing and fails (the kernel's rule; the JAX program never sees one)."""
    N = used.shape[0]
    ok = (rows >= 0) & (rows < N)
    at = torch.where(ok, rows, 0).long()
    stacked = used.index_add(0, at, torch.where(ok[:, None], deltas, 0))
    fits = (stacked <= capacity).all(dim=1)
    return fits[at] & ok


_VERIFY_SHAPES = dict(capacity="NC", used="NC", rows="R", deltas="RC")


def _verify_dims(capacity, used, rows, deltas) -> tuple:
    """(N, C, R) of what the verify kernel takes: int32 planes,
    contiguous, on one device, of shapes [N,C], [N,C], [R] and [R,C]. One
    combined test; where it fails, the full check names the fault and
    raises."""
    i32 = torch.int32
    if (capacity.dtype is used.dtype is rows.dtype is deltas.dtype is i32
            and capacity.device == used.device == rows.device == deltas.device
            and capacity.is_contiguous() and used.is_contiguous() and rows.is_contiguous()
            and deltas.is_contiguous() and len(capacity.shape) == 2
            and used.shape == capacity.shape and len(rows.shape) == 1
            and deltas.shape == (rows.shape[0], capacity.shape[1])):
        return capacity.shape[0], capacity.shape[1], rows.shape[0]
    d = _check_int32(dict(capacity=capacity, used=used, rows=rows, deltas=deltas),
                     _VERIFY_SHAPES, capacity.device)
    return d["N"], d["C"], d["R"]


def verify_rows(capacity, used, rows, deltas):
    """Per-lane fit of ``used`` plus the summed deltas of every lane on the
    same row, against ``capacity``; bool[R]. Checks what the kernel takes
    on either device; on the CPU the plain version, on the card one launch
    (``csrc/verify.cu``) that does not wait for the card. It enters the
    device ledger like the planners but records no rounds."""
    _fault_point()
    N, C, R = _verify_dims(capacity, used, rows, deltas)
    device = capacity.device
    key = f"N{N}R{R}"
    if device.type == "cpu":
        t0 = time.perf_counter()
        fits = verify_rows_ref(capacity, used, rows, deltas)
        _ledger("verify_rows", key, device, t0)
        return fits
    lib = _library()
    t0 = time.perf_counter()
    fits = rows.new_empty(R, dtype=torch.bool)
    if R == 0:
        return fits
    rc = lib.ntt_verify_rows(capacity.data_ptr(), used.data_ptr(), rows.data_ptr(),
                             deltas.data_ptr(), fits.data_ptr(), N, C, R, _stream_ptr(device))
    if rc:
        _launch_status("verify_rows", rc)
    LAUNCHES["verify_rows"] += 1
    _ledger("verify_rows", key, device, t0)
    return fits


def verify_shape(N: int, C: int) -> dict:
    """The verify's launch on the current card over N rows of C columns:
    its ``blocks`` and the ``rows`` each owns (their sums in its shared
    memory)."""
    from . import _build

    out = (ctypes.c_int * 2)()
    _launch_status("verify_rows", _build.library().ntt_verify_shape(out, N, C, 0, None))
    return dict(blocks=out[0], rows=out[1])
