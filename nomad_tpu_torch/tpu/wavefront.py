"""Wavefront placement: conflict-free batched commits over the exact scan.

Counterpart of ``nomad_tpu/tpu/wavefront.py``. Each round scores a window
of W pending alloc lanes *as if* each were next (the exact step's
selection against the round-start state), then commits the longest prefix
of lanes that no earlier lane of the window can affect, and defers the
rest to the next round. A lane j is affected by an earlier lane i when one
of i's top-M candidate nodes is feasible for j's group (i's placement
moves the scores, fit or collisions j sees) or when i moves the ring
cursor of j's eval. The committed prefix is what the sequential scan
would have produced, so placements and final state equal
``kernel.plan_batch``'s bit for bit.

The config stanza reads the JAX package's env names and defaults:
``NOMAD_TPU_WAVEFRONT`` (off unless ``1``), ``NOMAD_TPU_WAVEFRONT_MAX_ROUND``
(W, 32) and ``NOMAD_TPU_WAVEFRONT_TOP_M`` (M, 1); ``configure`` wins over
the environment and ``reset`` goes back to it.

The reductions of the selection are staged as tournaments over an
``[S, N/S]`` view of the node axis (a local stage per shard, then an
S-wide finish), as the JAX module stages them for a mesh. Integer sums
and float max are order-free, so every S gives the same bits.

``plan_batch_wavefront_ref`` is the plain PyTorch version and
``plan_batch_wavefront`` the wrapper: the plain version for CPU tensors,
the hand-written CUDA kernel ``csrc/wavefront.cu`` for CUDA tensors (one
cooperative launch of a thread block cluster per lane of the window, each
walking its lane's ring only as far as its limit window). A tree that
``shard.put`` placed under ``shard.wavefront_specs()`` (the node axis split
into S shards) runs the sharded plain version on the CPU and the sharded
kernel K11s (``csrc/mesh.cu``, one cooperative launch of S x Q blocks) on
the card, with S taken from the tree. Each launch enters the device ledger
(sharded launches keyed apart) and records its rounds, as the JAX module's
do.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time

import torch

from ..debug import devprof as _devprof
from . import kernel
from . import shard as _shard
from .kernel import (MAX_SKIP, NEG_INF, BatchArgs, BatchState, _rot_incl_t, _scores,  # noqa: F401
                     _tcumsum, _tmax, _tmin, _tsum)

DEFAULT_MAX_ROUND = 32
DEFAULT_TOP_M = 1

_lock = threading.Lock()
_state = {"enabled": None, "max_round": None, "top_m": None}


def configure(enabled=None, max_round=None, contention_top_m=None):
    """Set the wavefront knobs; ``None`` leaves a knob on its env/default
    resolution."""
    with _lock:
        if enabled is not None:
            _state["enabled"] = bool(enabled)
        if max_round is not None:
            _state["max_round"] = max(1, int(max_round))
        if contention_top_m is not None:
            _state["top_m"] = max(1, int(contention_top_m))


def reset():
    """Back to env/default resolution."""
    with _lock:
        _state.update({"enabled": None, "max_round": None, "top_m": None})


def enabled() -> bool:
    """Whether the exact-scan routes (``planner.plan_eval`` and the drain
    batch) run the wavefront planner instead of the sequential scan."""
    with _lock:
        v = _state["enabled"]
    if v is not None:
        return v
    return os.environ.get("NOMAD_TPU_WAVEFRONT", "0") == "1"


def max_round() -> int:
    """Window width W: the most placements attempted per round."""
    with _lock:
        v = _state["max_round"]
    if v is not None:
        return v
    return max(1, int(os.environ.get("NOMAD_TPU_WAVEFRONT_MAX_ROUND", str(DEFAULT_MAX_ROUND))))


def contention_top_m() -> int:
    """Candidate nodes per lane fed to the conflict test. M = 1 tests the
    winner alone (already exact); M > 1 is more conservative."""
    with _lock:
        v = _state["top_m"]
    if v is not None:
        return v
    return max(1, int(os.environ.get("NOMAD_TPU_WAVEFRONT_TOP_M", str(DEFAULT_TOP_M))))


def window_for(a_pad: int) -> int:
    """The window width for an ``a_pad``-lane batch."""
    return max(1, min(max_round(), int(a_pad)))


def shards_for(n_pad: int, n_shards: int) -> int:
    """The tournament width: ``n_shards`` when it divides the node axis,
    else 1 (flat reductions)."""
    s = max(1, int(n_shards))
    return s if n_pad % s == 0 else 1


_BIG = 2**30


def _select(args: BatchArgs, state: BatchState, s: int, m: int, demand: torch.Tensor,
            g: int, limit: int, valid: bool) -> tuple:
    """What the exact step would select for this alloc against ``state``,
    without changing it: (best node or -1, placed, advances the cursor,
    ring positions consumed, the M candidate nodes). Slot 0 of the
    candidates is the winner in visit order; slots 1..M-1 are the first
    M-1 entries of the top-M scores, ties to the lower ring position, so
    the winner may appear twice."""
    n_pad = args.capacity.shape[0]
    positions = torch.arange(n_pad, dtype=torch.int32, device=args.capacity.device)
    e = int(args.group_eval[g])
    ring_size = int(args.ring[e])
    perm = args.perm[e]
    in_ring = positions < ring_size

    fit_nodes = args.feasible[g] & (state.used + demand[None, :] <= args.capacity).all(dim=1)
    final = _scores(args, state, g, demand)
    fit_p = fit_nodes[perm] & in_ring
    score_p = final[perm]
    offset = int(state.offset[e])

    nonpos = fit_p & (score_p <= 0.0)
    nonpos_total = _tsum(nonpos.to(torch.int32), s)
    nonpos_incl = _rot_incl_t(nonpos, offset, nonpos_total, positions, s)
    skipped = nonpos & (nonpos_incl <= MAX_SKIP)

    kept = fit_p & ~skipped
    kept_total = _tsum(kept.to(torch.int32), s)
    ret_incl = _rot_incl_t(kept, offset, kept_total, positions, s)
    returned = kept & (ret_incl <= limit)
    n_returned = int(_tsum(returned.to(torch.int32), s))

    need = max(limit - n_returned, 0)
    skip_total = _tsum(skipped.to(torch.int32), s)
    skip_incl = _rot_incl_t(skipped, offset, skip_total, positions, s)
    replay = skipped & (skip_incl <= need)
    candidates = returned | replay

    rot_rank = torch.where(positions >= offset, positions - offset, ring_size - offset + positions)
    found = int(_tmax(candidates.to(torch.int32), s)) > 0
    max_score = _tmax(torch.where(candidates, score_p, NEG_INF), s)
    tie = candidates & (score_p == max_score)
    visit_order = rot_rank + torch.where(replay, n_pad, 0)
    # the first strict max as a two-stage tournament: the least visit rank
    # among the ties, then the one position that holds it
    best_visit = _tmin(torch.where(tie, visit_order, _BIG), s)
    best_p = int(_tmin(torch.where(tie & (visit_order == best_visit), positions, _BIG), s))
    best_node = int(perm[min(best_p, n_pad - 1)])

    last_ret_rank = int(_tmax(torch.where(returned, rot_rank, -1), s))
    consumed = last_ret_rank + 1 if n_returned >= limit else ring_size

    place = found and valid
    best_node = best_node if place else -1
    # the cursor moves iff the lane is valid and consumes part of the ring
    advances = valid and consumed % max(ring_size, 1) != 0
    top_nodes = [best_node]
    if m > 1:
        sc = torch.where(candidates, score_p, NEG_INF)
        # lax.top_k order: descending, ties to the lower position
        idxs = torch.sort(sc, descending=True, stable=True).indices[:m].tolist()
        ok = candidates.tolist()
        top_nodes += [int(perm[i]) if ok[i] else -1 for i in idxs[: m - 1]]
    if not place:
        top_nodes = [-1] * len(top_nodes)
    return best_node, place, advances, consumed, top_nodes


def plan_batch_wavefront_ref(args: BatchArgs, init: BatchState, n_real: int, window: int,
                             top_m: int, n_shards: int):
    """Plain version of the wavefront drive (JAX ``_plan_batch_wavefront_jit``):
    returns (final state, node index per alloc or -1, rounds). ``n_real``
    is unused (each eval's ``ring`` bounds its positions), kept for the JAX
    signature.

    A round's lanes are selected in order and the first lane that an
    earlier lane of the window blocks ends the committed prefix; the lanes
    after it are deferred whatever they would select, so they are not
    selected here (the JAX program selects all W and discards them)."""
    del n_real
    a_pad = args.demands.shape[0]
    dev = args.capacity.device
    used, coll, counts, present, offset = (t.clone() for t in init)
    groups = args.groups.tolist()
    limits = args.limits.tolist()
    valid = args.valid.tolist()
    group_eval = args.group_eval.tolist()
    ring = args.ring.tolist()
    feasible = args.feasible.cpu().numpy()
    node_value = args.node_value.cpu().numpy()
    spread_active = args.spread_active.tolist()
    placements = torch.full((a_pad,), -1, dtype=torch.int32, device=dev)
    stop = max((k + 1 for k in range(a_pad) if valid[k]), default=0)
    i = rounds = 0
    while i < stop:
        state = BatchState(used, coll, counts, present, offset)
        lanes = []  # (lane, group, eval, best, placed, advances, consumed, candidates)
        for k in range(window):
            lane = i + k
            li = min(lane, a_pad - 1)
            g = groups[li]
            e = group_eval[g]
            blocked = any(
                (adv and e_i == e) or any(n >= 0 and feasible[g, n] for n in top)
                for _, _, e_i, _, _, adv, _, top in lanes
            )
            if blocked:
                break
            if lane < a_pad and valid[li]:
                sel = _select(args, state, n_shards, top_m, args.demands[li], g, limits[li], True)
            else:
                sel = (-1, False, False, 0, [-1] * top_m)
            lanes.append((lane, g, e, *sel))
        start = offset.clone()
        for lane, g, e, best, place, adv, consumed, _ in lanes:
            if lane >= a_pad:
                continue
            placements[lane] = best
            if place:
                used[best] += args.demands[lane]
                coll[g, best] += 1
                v = int(node_value[g, best])
                if spread_active[g] and v >= 0:
                    counts[g, v] += 1
                    present[g, v] = True
            if adv:
                offset[e] = (int(start[e]) + consumed) % max(ring[e], 1)
        i += len(lanes)
        rounds += 1
    return BatchState(used, coll, counts, present, offset), placements, rounds


def plan_batch_wavefront_sharded_ref(args: BatchArgs, init: BatchState, n_real: int,
                                     window: int, top_m: int):
    """Sharded plain version of the wavefront drive (JAX
    ``_plan_batch_wavefront_jit`` on a tree placed under
    ``shard.wavefront_specs()``): the plain version on the gathered planes
    with its tournaments staged over the tree's shards; returns (final
    state, split as ``init`` is, node index per alloc or -1, rounds)."""
    s = shards_for(int(args.capacity.shape[0]), _shard.shards_of((args, init)))
    state, placements, rounds = plan_batch_wavefront_ref(
        _shard.gather(args), _shard.gather(init), n_real, window, top_m, s)
    return _shard.split_like(state, init), placements, rounds


#: candidates per lane whose best M - 1 keys the kernel's threads keep in
#: registers; more candidates keep them in a sorted list in global memory
WAVE_MAX_TOP_M = 4


def cluster_shape(window: int, n_classes: int, top_m: int, device: torch.device,
                  n_nodes: int | None = None) -> tuple:
    """(Q, clusters, scratch ints) of the kernel's launch for a window of
    ``window`` lanes over ``n_nodes`` nodes: the largest power of two Q (at
    most 16) for which the card co-schedules ``window`` clusters of Q
    blocks, or Q = 1 and as many clusters as fit, which take the lanes in
    turn. The scratch holds the round's lane slots and, past the shared
    memory's budgets, each block's window records and each thread's
    candidate keys, so it depends on ``n_nodes``: without it the scratch
    is None. Only a card that cannot hold one cluster raises."""
    from . import _build

    lib = _build.library()
    out = (ctypes.c_longlong * 3)()
    rc = lib.ntt_wavefront_shape(ctypes.addressof(out), 1 if n_nodes is None else n_nodes,
                                 window, n_classes, top_m, kernel._stream(device))
    if rc != 0:
        raise RuntimeError(f"no launch of the wavefront kernel for W={window}, M={top_m}: "
                           f"{lib.ntt_error_string(rc).decode()} ({rc})")
    q, clusters, scratch = out
    return q, clusters, None if n_nodes is None else scratch


def plan_batch_wavefront(args: BatchArgs, init: BatchState, n_real: int, n_valid: int = None,
                         walked: torch.Tensor | None = None, n_shards: int | None = None):
    """Run the wavefront drive with the stanza's W and M; returns (final
    state, node index per alloc or -1, rounds). A drop-in for
    ``kernel.plan_batch``. On the card ``rounds`` is a device scalar, so
    the call does not wait for the kernel; the caller syncs when it reads
    it. ``n_valid`` (the real placements asked for; every lane when
    omitted) is what the round ledger charges the rounds against, without
    waiting for them.
    ``walked``, a one-element int64 tensor on the card, gets the ring
    positions the committed lanes' selections walked added to it (the
    unsharded kernel only: the plain versions walk no chunks and K11s
    walks every position of each step, so they take none).
    A tree split over a mesh runs sharded, its shard count taken from the
    tree; ``n_shards`` (the JAX signature's) must agree with it."""
    kernel._fault_point()
    A = int(args.demands.shape[0])
    n_pad = int(args.capacity.shape[0])
    W = window_for(A)
    M = contention_top_m()
    sharded = _shard.is_sharded((args, init))
    tree_shards = _shard.shards_of((args, init))
    if n_shards is not None and int(n_shards) != tree_shards:
        raise ValueError(f"n_shards {n_shards} for a tree split over {tree_shards} shards")
    S = shards_for(n_pad, tree_shards)
    key = f"E{args.perm.shape[0]}G{args.feasible.shape[0]}A{A}N{n_pad}W{W}M{M}S{S}"
    device = args.capacity.device
    if walked is not None and (sharded or device.type == "cpu"):
        raise ValueError("only the unsharded kernel counts the ring positions it walks")
    if device.type == "cpu":
        t0 = time.perf_counter()
        if sharded:
            out = plan_batch_wavefront_sharded_ref(args, init, n_real, W, M)
        else:
            out = plan_batch_wavefront_ref(args, init, n_real, W, M, S)
    else:
        lib = kernel._library()
        t0 = time.perf_counter()
        if sharded:
            out = _plan_batch_wavefront_mesh_cuda(lib, args, init, W, M, device)
        else:
            out = _plan_batch_wavefront_cuda(lib, args, init, walked, W, M, device)
    kernel._ledger("wavefront", key, device, t0, sharded)
    _devprof.count_rounds("wavefront", out[2], A if n_valid is None else int(n_valid), sharded)
    return out


def _plan_batch_wavefront_cuda(lib, args: BatchArgs, init: BatchState, walked, W: int, M: int,
                               device):
    A = int(args.demands.shape[0])
    d = kernel._check_cuda({**args._asdict(), **init._asdict()}, kernel._EXACT_SHAPES, device)
    N, C, G, V, E = (d[k] for k in "NCGVE")
    kernel._check_index(args.perm, N, "perm")
    kernel._check_index(args.groups, G, "groups")
    kernel._check_index(args.group_eval, E, "group_eval")
    if not 2 <= C <= kernel.SCAN_MAX_COLS:
        raise kernel.KernelFault(f"the wavefront takes 2 to {kernel.SCAN_MAX_COLS} resource columns, "
                         f"not {C}")
    if walked is not None and (walked.shape != (1,) or walked.dtype != torch.int64
                               or walked.device != device):
        raise ValueError("walked must be a one-element int64 tensor on the wavefront's device")
    _, _, scratch_ints = cluster_shape(W, V, M, device, N)
    state = BatchState(*(t.clone() for t in init))
    placements = torch.full((A,), -1, dtype=torch.int32, device=device)
    rounds = torch.zeros(1, dtype=torch.int32, device=device)
    lane_info = torch.empty((A, 8), dtype=torch.int32, device=device)  # each lane's inputs
    scratch = torch.empty(scratch_ints, dtype=torch.int32, device=device)  # the round's lane slots
    kernel._launch(
        "wavefront",
        lib.ntt_wavefront,
        *(kernel._ptr(t) for t in args),
        *(kernel._ptr(t) for t in state),
        kernel._ptr(placements), kernel._ptr(rounds),
        None if walked is None else kernel._ptr(walked), kernel._ptr(lane_info),
        kernel._ptr(scratch),
        N, C, G, V, E, A, W, M,
        kernel._stream(device),
    )
    return state, placements, rounds[0]


def _plan_batch_wavefront_mesh_cuda(lib, args: BatchArgs, init: BatchState, W: int, M: int,
                                    device):
    """K11s: one cooperative launch of S x Q blocks over the tree's slabs
    (``csrc/mesh.cu``), the exact scan's step a lane under the wavefront's
    round rule."""
    aspec, sspec = _shard.wavefront_specs()
    d = kernel._check_mesh({**args._asdict(), **init._asdict()},
                           {**aspec._asdict(), **sspec._asdict()}, kernel._EXACT_SHAPES, device)
    N, C, G, V, E, A, S = (d[k] for k in "NCGVEAS")
    for t in args.perm.slabs:
        kernel._check_index(t, N, "perm")
    kernel._check_index(args.groups, G, "groups")
    kernel._check_index(args.group_eval, E, "group_eval")
    if not 2 <= C <= kernel.MESH_MAX_COLS:
        raise kernel.KernelFault(f"the sharded wavefront takes 2 to {kernel.MESH_MAX_COLS} "
                                 f"resource columns, not {C}")
    shape = kernel.mesh_shape("mesh_wavefront", S, N, G, V, E, W, M)
    state = BatchState(*(kernel._clone(x) for x in init))
    placements = torch.empty(A, dtype=torch.int32, device=device)
    rounds = torch.zeros(1, dtype=torch.int32, device=device)
    scratch = torch.empty(max(shape["scratch"], 16), dtype=torch.uint8, device=device)
    kernel._launch_mesh("mesh_wavefront", lib.ntt_mesh_wavefront,
                        [*args, *state, placements, rounds, scratch],
                        S, shape["blocks_a_shard"], N, C, G, V, E, A, W, M, device=device)
    return state, placements, rounds[0]
