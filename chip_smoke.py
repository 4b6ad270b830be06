#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (nomad_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card: its name and power limit from nvidia-smi;
2. build: nvcc compiles the port's kernels (nomad_tpu_torch/tpu/csrc) for
   sm_90a, one process per source, and prints ptxas's resource lines;
3. kernel vs plain version on the card at mid sizes: the exact scan, the
   run planner and the windowed planner must give the same placements,
   final state and round counts as their plain PyTorch versions; the
   wavefront planner on the 8-group exact-scan planes (N = 2,048, A =
   1,024) for windows of 8 and 32 lanes and 1 and 3 candidates per lane,
   against its plain version on the CPU (placements, final state, rounds);
   the paged planner on an 8,192-node eval in 1,024-row tiles under a
   budget of half its planes (LRU eviction), against the flat windowed
   kernel and the numpy oracle, with every tile sweep it launched against
   that sweep's plain version on the same inputs;
4. the main path at full width: ``planner.plan_eval`` on a 10K-node eval
   of 50K allocs spread over 4 values (run planner), a 10K x 50K eval with
   limit 10 (windowed planner) and a 10K-node eval of 8 groups (exact
   scan), with every launch counter set to 0 before and read after; then
   the same 8-group eval with the wavefront stanza on (W = 32, M = 1),
   counted on its own, whose placements must be the exact-scan kernel's;
   then a 1,000,000-node eval of 100,000 allocs (limit 8) with paging on
   (65,536-row tiles, an 8 MB budget that cannot hold the 45 MB of planes),
   counted on its own, whose placements and rounds must be the flat
   windowed kernel's on the same planes; then output checks (no node over
   capacity), timings, parity of the run and windowed planners against the
   exact-scan kernel on the same planes, the exact scan against the float64
   host oracle on a small eval, and each kernel against its plain version
   at the main-path shape (the exact scan's bound from the ring positions
   its result needs, with the positions the kernel counts itself walking
   beside them; the wavefront's microseconds a round, cluster shape and
   ring positions walked against needed; each one-shot wrapper's host
   microseconds beside its event and device time, the tile count's as the
   paged drive calls it, through its per-eval launcher, with the public
   wrapper's host time beside it; the run planner's round
   split by clock64 stamps from a second, stamped build, with its sweep
   and fill rounds, nomad_tpu_torch/tools/runs_round_sweep.py; the
   windowed planner's the same way, nomad_tpu_torch/tools/
   windowed_round_sweep.py, with its launch's shape, its times at mid
   size and on the paged eval's planes, and ``plan_eval`` end to end at
   the windowed cell; the four
   score primitives the planners inline, each applied alone to the
   headline eval's node plane by csrc/primitives.cu, against its plain
   version; a primitive's ``launches`` counts its own kernel's launches on
   the paths, none since the planners inline it, and ``inlined_launches``
   those of the kernels that inline it);
   then, counted on its own, the spread past the kernels' shared memory
   (ROADMAP C1): a 50,000-node eval of 256 allocs in 32 groups over 49,153
   spread values through ``planner.plan_eval``, once by the exact scan and
   once by the wavefront with 5 candidates a lane, each placing exactly as
   its plain version on the same planes;
5. the server path: a fused drain batch of 8 evals and 1,024 lanes on
   the card against the same batch through the plain versions on the
   CPU; then, with every launch counter set to 0 before and read after,
   a ``DeviceState`` over the 10K-node cluster (10,240 rows) refreshed
   with 3,000 dirty rows, a 32-thread drain batch of bench_drain's job
   mix through the collector on that state, the dense verify of its
   grants, a refresh with those grants, and a 32-thread multi-tenant
   batch (4,096 lanes) with its verify. Then output checks: each eval's
   placements equal its solo exact scan from its usage base, the bases
   thread the earlier evals' grants, no node over capacity, every
   placement in the eval's ring and feasible, the verify passes the
   grants and fails exactly the rows pushed one over, and both batches
   give the same placements and bases through the plain versions on the
   CPU; timings of each batch, repeated on the planes of its first run;
   both batches again on those planes with the wavefront stanza on,
   counted on their own, whose placements and bases must be the exact
   route's; the exact scan at the drain-bench batch's shape (limit 14)
   against its plain version; the wavefront kernel at both batches'
   shapes against its plain version, with its microseconds a round, its
   cluster shape and the ring positions its committed lanes walked, which
   must hold the ones the result needs (as at the multi-tenant eval in
   phase 4); and the usage-base, dirty-row scatter and dense-verify
   kernels against their plain versions and the nearest PyTorch calls at
   the main-path shapes, with the scatter's launches a call (one) and its
   host microseconds by part; the usage bases and the verify timed as the
   server path calls them (the collector's call once a batch,
   dense_verify's once a plan, each through the public wrapper), with
   the device operations a call beside them (each must be one), and the
   usage bases again at the drain-bench batch;
6. the scheduler front, with every launch counter set to 0 before and
   read after: real evals through the port's ``tpu-batch`` scheduler
   (``Harness(seed=5, device="cuda").process("tpu-batch", eval)``) from
   state stores carried from the same ``to_dict()`` documents: the
   headline eval (10,000 mock nodes in 4 datacenters with
   tests/test_tpu_parity.py's cpu and memory tiers, one group of 50,000
   allocs spread over the datacenters by target; the run planner), a
   service eval of 50,000 allocs with no spread (limit 14; the windowed
   planner), an 8-group eval of 1,024 allocs (the exact scan) and again
   with the wavefront stanza on (W = 32, M = 1), the service eval with the
   paging stanza on (1,024-row tiles, a budget of half its planes; the
   paged planner), a device-ask eval (two groups of 300 allocs asking one
   TPU instance each on 4,000 nodes, C = 5; the exact scan) and a drain
   batch of 8 evals on 8 threads through one collector on a DeviceState
   (brought to the snapshot's usage by one dirty-row refresh) on the
   service eval's final state. Checks: each eval's placements and failure
   metrics equal those of the same documents, seed and eval through the
   port's scheduler on the CPU; no node over capacity after a plan; the
   scheduler counted exactly the expected modes and no fallback, and each
   of the path's kernels launched. Then the headline eval three more times
   on fresh stores. ``process()`` is timed as bench.py's ``run_once`` times
   it, with the plan recorded and not applied, and split into the columnar
   build, the dispatch (padding, upload, launch, the overlapped template
   and id build, the sync; within it the planner from launch to sync and
   by CUDA events), the materialize and the rest (reconcile); the
   harness's plan apply follows on its own clock;
7. the server, with every launch counter set to 0 before and read after:
   the port's ``Server(config, device="cuda")`` on the soak scenario's
   server config (nomad_tpu/loadgen/scenarios.py:125-190: seed 42,
   ``tpu-batch``, ``batch_drain`` 8, ``plan_apply_batch`` 8, the event
   broker on) with 10,000 mock nodes registered through
   ``node_register`` (the scheduler phase's tiers, 4 datacenters); with
   no worker running, 8 batch jobs of 7,500-10,000 allocs (cpu 50/100,
   memory 32/64, the soak's preload) are registered, then two drain
   workers start; after them a system job (``tpu-system``, one alloc a
   ready node) and a service job of 5,000 allocs that a worker plans solo
   (the windowed planner). Checks: every eval completes, every job has
   its count, no node over capacity, no scheduler fallback, and the fused
   drain's scan (or wavefront) and usage bases, the mirror's dirty-row
   scatter, the applier's dense verify and the solo eval's planner each
   launched; every call of the run to the usage bases, the dirty-row
   scatter and the dense verify, and the planners' calls from the fewest
   lanes up (within 30 s of replays a kernel, at least one), equal their
   plain versions on the card on a copy of the same inputs. Printed: each
   drained eval's registration-to-complete time, the fused batches and
   modes, the applier's plans, device verifies and degrades, the stages'
   counts, summed times and wall covered (``StageClock``, over the whole
   run), the mirror's uploads, refreshes and rows scattered, raft
   applies, each kernel's calls by CUDA events and the calls held
   against the plain versions. Then the same phase
   at 1,000 nodes, 8 batch jobs of 200 allocs and one drain worker, on
   the card and on the CPU, must place identically;
8. the agent, through the system's normal entry point in a fresh
   process: ``python -m nomad_tpu_torch agent -device cuda -config
   <file> -port 0`` in the networked server mode with phase 7's server
   settings, ``prewarm_kernels`` on and ``prewarm_drain_nodes`` 10,000.
   The phase reads the HTTP and RPC addresses from the agent's start line
   and polls ``/v1/metrics`` until the warm-up reports its count of
   programs warmed (``tpu_prewarm``) within 120 s of the spawn; the count
   must be the ladder's and the device ledger (``tpu_devprof``) must hold
   every (planner, shape) of the ladder (``agent_ladder``, from
   ``warmup.bucket_shape``, ``DEFAULT_SHAPES`` and the stanzas), so a
   warm-up launch that failed (logged, the count short) fails the phase
   with the agent's warnings. It registers 10,000 nodes (phase 7's) over the RPC
   listener (``Node.Register`` through ``rpc.ConnPool``); runs ``job
   init``, ``job plan`` and ``job run`` on ``example.nomad`` through the
   CLI; registers four of phase 7's batch jobs and its system job through
   ``api.ApiClient`` and waits on ``/v1/evaluation/<id>`` for each, then
   for the follow-up evals. Checks: every eval completes, every job has
   its count of live allocs, no node over capacity (recomputed on the
   host from ``/v1/nodes``, ``/v1/allocations`` and the documents sent),
   no library build or load and no new planner in the ledger after the
   warm-up (new shapes are printed with their first-launch seconds), the
   mirror's counted upload equals its planes' bytes (10,240 rows) and
   the ledger's h2d holds it, the exact scan's rounds are the padded lanes
   of the fused batches it launched (each the bucket of its real lanes,
   read from the batches' ``drain.kernel_dispatch`` spans over
   ``/v1/trace``) and those batches account for its lanes, the kernels the jobs launched (the agent's own counts over
   ``/v1/metrics``, read before and after the jobs) include a planner,
   the usage bases, the dirty-row scatter and the dense verify, ``operator
   device`` prints its report, and SIGTERM ends the agent with exit 0
   within 30 s. The agent is another process, so its
   kernel calls are held against their plain versions only by phases 3-7;
9. one JSON line of per-kernel numbers (a kernel's ``paths`` gain its
   scheduler, server and agent launches), the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Without a CUDA card it exits with status 2 and prints no result.
"""

import contextlib
import json
import random
import re
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations to score one node: two bit-stable 10^x (about 32
# each), the two free fractions, binpack, anti-affinity, the plane count,
# sum and mean
SCORE_OPS = 95
# integer operations of one fit check: an add and a compare per column
FIT_OPS_PER_COL = 2
# float32 operations of one binpack (two bit-stable 10^x, the sum, clip
# and scale) and of one class boost (its desired count, target and even
# terms)
BINPACK_OPS = 70
CLASS_BOOST_OPS = 12
# int32 adds and compares outside the tensor cores: half the float32 rate
# (64 int32 lanes per SM and clock against 128 float32)
I32_OPS_PER_S = F32_OPS_PER_S / 2

NODES, ALLOCS, VALUES = 10_000, 50_000, 4
#: ROADMAP C1's eval at a reduced alloc count: (nodes, allocs, spread
#: values, candidates a lane on the wavefront)
C1_NODES, C1_ALLOCS, C1_VALUES, C1_TOP_M = 50_000, 256, 49_153, 5
EXACT_GROUPS, EXACT_ALLOCS = 8, 8_192
LIMIT = 10
DRAIN_EVALS, DIRTY_ROWS = 32, 3_000
#: the wavefront stanza of the full-width runs
WAVEFRONT_W, WAVEFRONT_M = 32, 1
#: the paged eval: bench.py bench_paged's shape (seed, nodes, allocs, tile
#: rows, budget), and the mid-size one it checks parity on
PAGED_SEED, PAGED_NODES, PAGED_ALLOCS, PAGED_TILE, PAGED_BUDGET_MB = (
    20260807, 1_000_000, 100_000, 65_536, 8)
MID_PAGED = (7, 8192, 1024)  # seed, nodes, allocs; limit 4, 1,024-row tiles
#: the kernels of the server path and of the planners' entry-point path
SERVER_KERNELS = ("exact_scan", "used_bases", "scatter_rows", "verify_rows")
PLAN_EVAL_KERNELS = ("exact_scan", "runs", "windowed")
PAGED_KERNELS = ("tile_count", "tile_window")
#: the score primitives and the kernels that inline them (K1-K4)
PRIMITIVES = {
    "binpack": ("nomad_tpu/tpu/kernel.py:151",
                ("exact_scan", "runs", "windowed", "wavefront", "tile_window")),
    "class_boosts": ("nomad_tpu/tpu/kernel.py:161", ("exact_scan", "runs", "wavefront")),
    "scores": ("nomad_tpu/tpu/kernel.py:203", ("exact_scan", "runs", "wavefront")),
    "rot_incl": ("nomad_tpu/tpu/kernel.py:255", ("exact_scan", "windowed", "wavefront")),
}


def log(msg: str) -> None:
    print(msg, flush=True)


#: launches of the standalone K1-K4 kernels (csrc/primitives.cu) in the
#: main paths' runs, added up at each read-out; the planners inline the
#: primitives, so none is expected
PRIMITIVES_ON_PATH = dict.fromkeys(PRIMITIVES, 0)


def path_launches(names) -> dict:
    """Launches per kernel of ``names`` since the last reset, read just
    after a path ran; adds that run's standalone primitive launches to
    PRIMITIVES_ON_PATH."""
    from nomad_tpu_torch.tpu import kernel

    for name in PRIMITIVES:
        PRIMITIVES_ON_PATH[name] += kernel.LAUNCHES[name]
    return {name: kernel.LAUNCHES[name] for name in names}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, samples: int = 3) -> tuple:
    """(median ms per call by CUDA events after one warm-up call, result)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), out


def _device_trace(fn, calls: int):
    """(device records, calls) of a torch.profiler trace whose every record
    count is a multiple of its calls (see ``device_us``), or None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for n in (calls, 2 * calls, 4 * calls) * 2:
        traces = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: traces.append(p.key_averages())) as prof:
            for _ in range(2):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        records = [e for e in traces[0] if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation and not e.key.startswith("ProfilerStep")]
        if records and all(e.count % n == 0 for e in records):
            return records, n
    return None


def device_us(fn, calls: int = 20):
    """Device microseconds per call from a torch.profiler trace of
    ``calls`` calls: the durations of the kernel, copy and memset records
    the calls put on the card, summed over the trace and divided by the
    calls, without the host's dispatch gaps between them (which CUDA events
    around a call include). The torch operations that launched some of
    them are not counted again. The trace is the second step of a profiler
    schedule whose first step, ``calls`` more calls, is traced and thrown
    away: a trace's first records can be lost (on the H100, 7 of a
    trace's first kernels in a process that had traced before). Every
    call puts the same records on the card, so each record's count is a
    multiple of the calls; a trace with fewer is taken again with twice the
    calls, then four times, and that round once more (a loaded host has
    lost records of all three). None when no trace holds every record."""
    trace = _device_trace(fn, calls)
    if trace is None:
        return None
    records, n = trace
    return sum(e.self_device_time_total for e in records) / n


def device_ops(fn, calls: int = 10):
    """Device operations (kernel, copy and memset records) one call puts on
    the card, by ``device_us``'s trace; None when no trace holds every
    record."""
    trace = _device_trace(fn, calls)
    if trace is None:
        return None
    records, n = trace
    return sum(e.count for e in records) / n


def host_ms(fn) -> tuple:
    """(ms of one call ending in a synchronize, result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def wrapper_host_us(fn, calls: int = 20) -> float:
    """Host microseconds one wrapper call holds the calling thread (its
    checks, allocations, the ctypes call and the launches it enqueues),
    without a synchronize: median of ``calls`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def ledger_host_us(fn, calls: int = 50) -> dict:
    """Host microseconds of one wrapper call with the device ledger
    (debug/devprof.py) on and off, each arm the lower of the two medians
    ``wrapper_host_us`` takes in turn (on, off, on, off), and what the
    ledger adds to the call."""
    from nomad_tpu_torch.debug import devprof

    arms: dict = {True: [], False: []}
    for on in (True, False, True, False):
        prior = devprof.enable(on)
        try:
            arms[on].append(wrapper_host_us(fn, calls))
        finally:
            devprof.enable(prior)
    on, off = min(arms[True]), min(arms[False])
    return dict(on=on, off=off, added=on - off)


def scan_positions(bargs, bstate, n_real: int) -> dict:
    """The ring positions the exact scan's result needs, over its valid
    lanes: each step's consumed prefix (the positions through the
    limit-th returned option), or the whole ring where the window does not
    fill. A limit of the ring or more fills it only with the whole ring;
    otherwise the plain version runs lane by lane on the CPU and each
    step's cursor advance gives its prefix. Also the statically feasible
    positions among them (the ones scored)."""
    from nomad_tpu_torch.tpu import kernel

    a = kernel.BatchArgs(*(t.cpu() for t in bargs))
    valid = a.valid.numpy()
    groups = a.groups.numpy()
    evals = a.group_eval.numpy()[groups]
    rings = a.ring.numpy()[evals]
    limits = a.limits.numpy()
    perm, feasible = a.perm.numpy(), a.feasible.numpy()
    lanes = np.flatnonzero(valid)
    offsets = np.zeros(len(groups), np.int64)  # a whole ring's positions from any start
    if (limits[lanes] >= rings[lanes]).all():
        needed = rings.astype(np.int64)
    else:
        needed = np.zeros(len(groups), np.int64)
        state = kernel.BatchState(*(t.cpu() for t in bstate))
        for i in lanes:
            one = a._replace(demands=a.demands[i:i + 1], groups=a.groups[i:i + 1],
                             limits=a.limits[i:i + 1], valid=a.valid[i:i + 1])
            off = int(state.offset[evals[i]])
            state, _ = kernel.plan_batch_ref(one, state, n_real)
            offsets[i] = off
            needed[i] = (int(state.offset[evals[i]]) - off) % max(int(rings[i]), 1) or rings[i]
    scored = 0
    for i in lanes:
        e, ring = evals[i], int(rings[i])
        ring_pos = (offsets[i] + np.arange(needed[i])) % max(ring, 1)
        scored += int(feasible[groups[i]][perm[e][ring_pos]].sum())
    return dict(needed=int(needed[lanes].sum()), scored=scored, lanes=len(lanes))


def scan_walked(bargs, bstate, n_real: int, needed: int) -> int:
    """The ring positions the exact-scan kernel counts itself walking in
    one more call on these inputs (each chunk's positions, cut at the
    ring's end), which must hold the ``needed`` positions."""
    from nomad_tpu_torch.tpu import kernel

    walked = torch.zeros(1, dtype=torch.int64, device=bargs.capacity.device)
    kernel.plan_batch(bargs, bstate, n_real, walked=walked)
    walked = int(walked.item())
    if walked < needed:
        fail(f"exact_scan: the kernel walked {walked} ring positions, fewer than the "
             f"{needed} its result needs")
    return walked


def wavefront_walk(label: str, bargs, bstate, n_real: int, pos: dict, plain: bool) -> dict:
    """The wavefront kernel at one shape with the stanza's W and M: ms per
    launch by CUDA events, us a round, its cluster shape (Q blocks a lane,
    clusters launched) and the ring positions its committed lanes walked,
    which must hold the ``pos['needed']`` positions the result needs. With
    ``plain`` it is also held against its plain version on the card
    (placements, final state, rounds)."""
    from nomad_tpu_torch.tpu import wavefront

    dev = bargs.capacity.device

    def run():
        return wavefront.plan_batch_wavefront(bargs, bstate, n_real)

    ms, (state, placements, rounds) = cuda_ms(run)
    rounds = int(rounds)
    err = 0
    if plain:
        W, M = wavefront.window_for(bargs.demands.shape[0]), wavefront.contention_top_m()
        want_state, want, want_rounds = wavefront.plan_batch_wavefront_ref(
            bargs, bstate, n_real, W, M, 1)
        err = max_abs_err([(placements, want), *zip(state, want_state)]) + abs(rounds - want_rounds)
        if err:
            fail(f"wavefront at {label}: kernel differs from its plain version ({err})")
    walked = torch.zeros(1, dtype=torch.int64, device=dev)
    wavefront.plan_batch_wavefront(bargs, bstate, n_real, walked=walked)
    walked = int(walked.item())
    if walked < pos["needed"]:
        fail(f"wavefront at {label}: the kernel walked {walked} ring positions, fewer than the "
             f"{pos['needed']} its result needs")
    q, clusters, _ = wavefront.cluster_shape(wavefront.window_for(bargs.demands.shape[0]),
                                             bstate.spread_counts.shape[1],
                                             wavefront.contention_top_m(), dev,
                                             bargs.capacity.shape[0])
    row = dict(ms=ms, rounds=rounds, us_per_round=ms * 1e3 / max(rounds, 1), q=q,
               clusters=clusters, positions_needed=pos["needed"], positions_walked=walked,
               max_abs_err=err)
    log(f"wavefront at {label}: {ms:.4f} ms per launch, {rounds} rounds, "
        f"{row['us_per_round']:.3f} us a round; clusters of Q={q} blocks, {clusters} launched; "
        f"{pos['needed']} ring positions needed, {walked} walked"
        + ("; identical to its plain version" if plain else ""))
    return row


def scatter_host_split(used, rows, vals) -> dict:
    """Host microseconds of each part of one dirty-row scatter wrapper call
    (no synchronize, median of 20 after a warm-up): the argument checks, the
    allocation of the new plane, the current stream and the ctypes call
    with the launch it enqueues."""
    from nomad_tpu_torch.tpu import _build, kernel, mirror

    dev = used.device
    lib = _build.library()
    out = torch.empty_like(used)
    stream = kernel._stream(dev)
    ptrs = [kernel._ptr(t) for t in (used, rows, vals, out)]
    N, C, R = used.shape[0], used.shape[1], rows.shape[0]
    return dict(
        checks=wrapper_host_us(lambda: kernel._check_int32(
            dict(used=used, rows=rows, vals=vals), mirror._SCATTER_SHAPES, dev)),
        alloc=wrapper_host_us(lambda: torch.empty_like(used)),
        stream=wrapper_host_us(lambda: kernel._stream(dev)),
        ctypes_call=wrapper_host_us(lambda: lib.ntt_scatter_rows(*ptrs, N, C, R, stream)),
    )


def scan_bound(pos: dict, bargs, bstate, cols: int) -> tuple:
    """(bytes, operations) the exact scan's result needs: per needed
    position its ring entry and its node's planes (8C + 26 bytes), no more
    than every input once, plus per lane its inputs (4C + 9 bytes) and
    outputs (the placement, the winner's used row and collision: 4C + 8);
    a fit check per needed position and a score per scored one."""
    lanes = bargs.valid.numel()
    per_position = 8 * cols + 26
    moved = min(nbytes(bargs, bstate), pos["needed"] * per_position) + lanes * (8 * cols + 17)
    return moved, scan_ops(pos["needed"], pos["scored"], cols)


def nbytes(*trees) -> int:
    total = 0
    for t in trees:
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, (tuple, list)):
            total += nbytes(*t)
    return total


def scan_ops(positions: int, scored: int, cols: int) -> int:
    """Operations of fit-checking ``positions`` nodes and scoring ``scored``."""
    return positions * cols * FIT_OPS_PER_COL + scored * SCORE_OPS


def bound(bytes_moved: int, ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(pairs) -> int:
    """Largest difference of integer outputs; float32 outputs are compared
    as their bits (0 means bit-identical)."""
    err = 0
    for got, want in pairs:
        got, want = torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu()
        if got.dtype == torch.float32 and want.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        got, want = got.to(torch.int64), want.to(torch.int64)
        if got.shape != want.shape:
            fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
        if got.numel():
            err = max(err, int((got - want).abs().max()))
    return err


def check_capacity(planes: dict, placements: np.ndarray, what: str) -> int:
    """No node over capacity after the placements; returns the count placed."""
    n_real = planes["n_real"]
    if placements.dtype != np.int32 or placements.shape != (planes["a_real"],):
        fail(f"{what}: placements {placements.dtype}{placements.shape}")
    placed = placements >= 0
    if (placements[placed] >= n_real).any():
        fail(f"{what}: placement on a node outside the ring")
    used = planes["used0"].astype(np.int64).copy()
    groups = planes["groups"][: planes["a_real"]]
    np.add.at(used, placements[placed], planes["demands"][: planes["a_real"]][placed])
    if (used > planes["capacity"]).any():
        fail(f"{what}: a node is over capacity")
    for g in np.unique(groups[placed]):
        if not planes["feasible"][g][placements[placed & (groups == g)]].all():
            fail(f"{what}: placement on an infeasible node")
    return int(placed.sum())


@contextlib.contextmanager
def recorded_sweeps():
    """Record every tile sweep the paged planner launches as (name,
    arguments, outputs); the launches still go through the wrappers (sweep
    1 through the drive's per-eval launcher, ``paging._tile_counter``)."""
    from nomad_tpu_torch.tpu import paging

    calls = []
    names = (*PAGED_KERNELS, "_tile_counter")
    wrapped = {name: getattr(paging, name) for name in names}

    def recorder(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((name, args, out if isinstance(out, tuple) else (out,)))
            return out
        return call

    def counter(cap, feas, used, demand, counts):
        count = wrapped["_tile_counter"](cap, feas, used, demand, counts)

        def call(t, cap, feas, used, t0, offset, n_real):
            count(t, cap, feas, used, t0, offset, n_real)
            # the drive reuses ``counts`` every round: keep this tile's row
            calls.append(("tile_count", (cap, feas, used, demand, t0, offset, n_real),
                          (counts[t].clone(),)))
        return call

    for name, fn in wrapped.items():
        setattr(paging, name, counter if name == "_tile_counter" else recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in wrapped.items():
            setattr(paging, name, fn)


def sweeps_err(calls) -> int:
    """Each recorded tile sweep against its plain version on its inputs."""
    from nomad_tpu_torch.tpu import paging

    plain = {"tile_count": paging.tile_count_ref, "tile_window": paging.tile_window_ref}
    err = 0
    for name, args, out in calls:
        want = plain[name](*args)
        err = max(err, max_abs_err(zip(out, want if isinstance(want, tuple) else (want,))))
    return err


def c1_phase(dev) -> dict:
    """ROADMAP C1's eval through ``plan_eval`` on the card, once by the
    exact scan and once by the wavefront (M = C1_TOP_M), each held against
    its plain version on the card on the same planes; returns the launches
    per route."""
    from nomad_tpu_torch.tpu import kernel, planner, problems, wavefront

    planes = problems.eval_planes(*problems.wavefront_problem(
        problems.build_cluster(C1_NODES, C1_ALLOCS, n_values=C1_VALUES)))
    p = planner.pad_planes(planes)
    args, state = planner.exact_inputs(p, dev)
    launches = {}
    for mode, top_m in (("exact-scan", None), ("wavefront", C1_TOP_M)):
        if top_m is not None:
            wavefront.configure(enabled=True, contention_top_m=top_m)
        try:
            kernel.reset_launches()
            placements, stats = planner.plan_eval(planes, dev)
            name = "wavefront" if top_m is not None else "exact_scan"
            launches[mode] = path_launches((name,))[name]
            if stats["mode"] != mode or launches[mode] < 1:
                fail(f"C1 {mode}: planned in mode {stats['mode']}, launches {launches[mode]}")
            if top_m is None:
                _, want = kernel.plan_batch_ref(args, state, p["n_real"])
            else:
                W = wavefront.window_for(p["demands"].shape[0])
                _, want, _ = wavefront.plan_batch_wavefront_ref(args, state, p["n_real"], W,
                                                                top_m, 1)
        finally:
            wavefront.reset()
        want = want[: p["a_real"]].cpu().numpy()
        diff = int((placements != want).sum())
        if diff:
            fail(f"C1 {mode}: {diff} placements differ from the plain version")
        log(f"C1 {mode}: {C1_ALLOCS} allocs x {C1_NODES} nodes over {C1_VALUES} spread values"
            + (f", M={top_m}" if top_m else "") + f": placed {int((placements >= 0).sum())}, "
            f"identical to the plain version; rounds {stats['rounds']}, kernel "
            f"{stats['kernel_s'] * 1e3:.2f} ms, launches {launches[mode]}")
    return launches


def primitive_rows(dev, planes: dict) -> list:
    """K1-K4, which the planners inline: each primitive applied alone to
    the headline eval's node plane (csrc/primitives.cu, one launch), held
    against its plain version, with its time, bound and host us; JSON rows
    without their launches."""
    from nomad_tpu_torch.tpu import kernel, planner

    p = planner.pad_planes(planes)
    args, state = planner.exact_inputs(p, dev)
    N, C = p["capacity"].shape
    V = state.spread_counts.shape[1]
    demand = args.demands[0]
    # a spread state part way into the eval: a seeded third of the allocs
    rng = np.random.default_rng(25)
    counts = torch.from_numpy(rng.integers(0, ALLOCS // (3 * V), (1, V)).astype(np.int32)).to(dev)
    state = state._replace(spread_counts=counts, spread_present=counts > 0)
    util = state.used + demand[None, :]
    fc = (1.0 - util[:, 0].float() / args.usable[:, 0]).contiguous()
    fm = (1.0 - util[:, 1].float() / args.usable[:, 1]).contiguous()
    fit = (args.feasible[0] & (util <= args.capacity).all(dim=1))[args.perm[0].long()].contiguous()
    offset = N // 3
    positions = torch.arange(N, dtype=torch.int32, device=dev)
    boost_args = (state.spread_counts[0], state.spread_present[0], args.spread_desired[0],
                  args.spread_implicit[0], args.spread_weight_frac[0], args.spread_even[0],
                  args.spread_active[0])
    # used, usable, collisions, affinity, its presence, node_value, out
    score_bytes = N * (4 * C + 8 + 4 + 4 + 1 + 4 + 4) + V * 9
    cases = {
        "binpack": (lambda: kernel.binpack(fc, fm), lambda: kernel._binpack(fc, fm),
                    3 * N * 4, N * BINPACK_OPS, f"N={N}"),
        "class_boosts": (lambda: kernel.class_boosts(*boost_args),
                         lambda: kernel._class_boosts(*boost_args),
                         V * 9 + 16 + (V + 1) * 4, V * CLASS_BOOST_OPS, f"V={V}"),
        "scores": (lambda: kernel.scores(args, state, 0, demand),
                   lambda: kernel._scores(args, state, 0, demand),
                   score_bytes, N * SCORE_OPS + V * CLASS_BOOST_OPS, f"N={N} C={C} V={V}"),
        "rot_incl": (lambda: kernel.rot_incl(fit, offset),
                     lambda: kernel._rot_incl(fit, offset, fit.sum(dtype=torch.int32), positions),
                     N + N * 4, 2 * N, f"N={N} offset={offset}"),
    }
    rows = []
    for name, (kern, plain, moved, ops, shape) in cases.items():
        ms, got = cuda_ms(kern)
        plain_ms, want = cuda_ms(plain)
        err = max_abs_err([(got, want)])
        if err:
            fail(f"{name}: the primitive differs from its plain version ({err})")
        bound_ms, bound_by = bound(moved, ops)
        replaces, inside = PRIMITIVES[name]
        rows.append(dict(
            name=name, route="cuda", source="nomad_tpu_torch/tpu/csrc/primitives.cu",
            replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None, device_us=device_us(kern),
            host_us=wrapper_host_us(kern), shape=shape, inlined_in=list(inside),
        ))
        us = rows[-1]["device_us"]
        log(f"{name} (inlined in {', '.join(inside)}; alone): {ms:.4f} ms per launch (plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by}), on the card by the "
            "profiler " + ("not measured" if us is None else f"{us:.2f} us") + f"; {shape}")
    return rows


# ---------------------------------------------------------------------------
# the server path: fused drain batches on a device-resident state, verify
# ---------------------------------------------------------------------------

def drive_batch(shared, preps, dev, pad_evals=DRAIN_EVALS) -> tuple:
    """Submit every prep from a thread of its own, all released together;
    returns ({eval id: (placements, usage base) as numpy}, e2e ms from the
    first submit to the last slice on the host, kernel ms of the batch)."""
    from nomad_tpu_torch.tpu import drain

    collector = drain.KernelBatchCollector(shared, expected=len(preps), pad_evals=pad_evals,
                                           device=dev)
    gate = threading.Barrier(len(preps))
    out, marks, errors = {}, [], []

    def one(d):
        prep = drain.DrainPrep.from_dict(d)
        gate.wait()
        t0 = time.perf_counter()
        try:
            placements, base = collector.submit(prep)
            out[d["eval_id"]] = (placements.cpu().numpy(), base.cpu().numpy())
        except Exception as e:  # reported below: the phase fails
            errors.append(f"{d['eval_id']}: {e!r}")
        marks.append((t0, time.perf_counter()))

    threads = [threading.Thread(target=one, args=(d,)) for d in preps]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads) or collector.invocations != 1:
        fail(f"drain batch failed: {errors or 'a thread did not finish'}")
    e2e = (max(m[1] for m in marks) - min(m[0] for m in marks)) * 1e3
    return out, e2e, drain.last_kernel_s() * 1e3


def batch_order(preps: list) -> list:
    return sorted(preps, key=lambda d: (-d["priority"], d["create_index"], d["eval_id"]))


def check_batch(label: str, shared: dict, planes: tuple, preps: list, out: dict, dev) -> tuple:
    """Each eval's placements equal its solo exact scan from its usage base,
    the bases thread the earlier evals' grants, every placement lies in the
    eval's ring on a feasible node, and no node ends over capacity; returns
    the batch's grants per node (int64 [n, C])."""
    from nomad_tpu_torch.tpu import drain

    n_real = shared["n_real"]
    used = planes[2].cpu().numpy().astype(np.int64)
    running = used.copy()
    for d in batch_order(preps):
        placements, base = out[d["eval_id"]]
        if not np.array_equal(base, running):
            fail(f"{label} {d['eval_id']}: usage base differs from the earlier evals' grants")
        prep = drain.DrainPrep.from_dict(d)
        solo = drain.solo_scan(prep, (planes[0], planes[1], torch.from_numpy(base).to(dev)),
                               n_real, dev)
        if not np.array_equal(solo.cpu().numpy(), placements):
            fail(f"{label} {d['eval_id']}: fused placements differ from the solo scan")
        placed = placements >= 0
        nodes, lanes = placements[placed], prep.gid_real[placed]
        if not np.isin(nodes, prep.perm_eligible).all():
            fail(f"{label} {d['eval_id']}: placement outside the eval's ring")
        for g, planes_g in enumerate(prep.planes_list):
            if not planes_g.feasible[nodes[lanes == g]].all():
                fail(f"{label} {d['eval_id']}: placement on an infeasible node")
        np.add.at(running, nodes, prep.g_demand[lanes])
    if (running[:n_real] > shared["capacity"]).any():
        fail(f"{label}: a node is over capacity")
    return (running - used)[:n_real]


def grant_rows(grants: np.ndarray) -> tuple:
    rows = np.flatnonzero(grants.any(axis=1))
    return rows, list(grants[rows])


def server_path(dev) -> tuple:
    """Phase 5; returns (the server path's launches per kernel, the
    wavefront route's launches per kernel, JSON rows of the server kernels
    without their launches)."""
    from nomad_tpu_torch.core import plan_apply
    from nomad_tpu_torch.tpu import drain, kernel, mirror, problems, wavefront

    cluster = problems.build_cluster(NODES, 1, n_values=VALUES, seed=20)
    shared, bench = problems.drain_problem(cluster, DRAIN_EVALS, "drain-bench", seed=21)
    _, tenant = problems.drain_problem(cluster, DRAIN_EVALS, "drain-tenant", seed=22)
    capacity, usable, used0 = shared["capacity"], shared["usable"], shared["used0"]
    N = problems.bucket(NODES)

    # a fused batch on the card against the same batch on the CPU
    _, mixed = problems.drain_problem(cluster, 8, "drain-tenant", seed=23)
    host = drain.SharedCluster(capacity, usable, used0)
    got, e2e, kms = drive_batch(host, mixed, dev, pad_evals=8)
    want, cpu_e2e, _ = drive_batch(host, mixed, torch.device("cpu"), pad_evals=8)
    lanes = sum(len(d["gid_real"]) for d in mixed)
    err = max_abs_err([(got[k][i], want[k][i]) for k in want for i in (0, 1)])
    if err or sorted(got) != sorted(want):
        fail(f"fused batch on the card differs from the plain versions ({err})")
    log(f"fused batch 8 evals x {lanes} lanes (host upload): identical to the plain versions "
        f"on the CPU; card e2e {e2e:.2f} ms, kernel {kms:.3f} ms; CPU e2e {cpu_e2e:.0f} ms")

    # ---- the main path, counted ---------------------------------------------
    rng = np.random.default_rng(24)
    dirty = rng.choice(NODES, DIRTY_ROWS, replace=False)
    used1 = used0.copy()
    used1[dirty, 0] += rng.choice([100, 250, 500], DIRTY_ROWS).astype(np.int32)
    used1[dirty, 1] += rng.choice([128, 256, 512], DIRTY_ROWS).astype(np.int32)

    kernel.reset_launches()
    ds = mirror.DeviceState(0, N, capacity, usable, used0, dev)
    plane0 = ds.arrays()[2]
    ds.pending.update(int(r) for r in dirty)
    ds.refresh(used1)
    planes_b = ds.arrays()
    out_b, e2e_b, kms_b = drive_batch(drain.SharedCluster(capacity, usable, used1, ds), bench, dev)
    grants_b = np.zeros((NODES, 4), np.int64)
    for d in bench:  # the applier's per-row aggregation of the batch's plans
        placements = out_b[d["eval_id"]][0]
        placed = placements >= 0
        np.add.at(grants_b, placements[placed], d["g_demand"][d["gid_real"][placed]])
    rows_b, deltas_b = grant_rows(grants_b)
    fits_b = plan_apply.dense_verify(planes_b, rows_b, deltas_b)
    used2 = used1 + grants_b.astype(np.int32)
    ds.pending.update(int(r) for r in rows_b)
    ds.refresh(used2)
    planes_t = ds.arrays()
    shared_t = drain.SharedCluster(capacity, usable, used2, ds)
    out_t, e2e_t, kms_t = drive_batch(shared_t, tenant, dev)
    grants_t = np.zeros((NODES, 4), np.int64)
    for d in tenant:
        placements = out_t[d["eval_id"]][0]
        placed = placements >= 0
        np.add.at(grants_t, placements[placed], d["g_demand"][d["gid_real"][placed]])
    rows_t, deltas_t = grant_rows(grants_t)
    fits_t = plan_apply.dense_verify(planes_t, rows_t, deltas_t)
    launches = path_launches(SERVER_KERNELS)
    log(f"server path launches: {launches}")
    for name, n in launches.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the server path")

    # ---- output checks -------------------------------------------------------
    want_plane = np.full((N, 4), 2**30, np.int32)
    want_plane[:NODES] = used1
    if not np.array_equal(planes_b[2].cpu().numpy(), want_plane):
        fail("DeviceState.refresh: used plane differs from the committed one")
    if not np.array_equal(plane0.cpu().numpy()[:NODES], used0):
        fail("DeviceState.refresh wrote a plane it had handed out")
    shared_b = dict(shared, used0=used1)
    for label, sh, planes, preps, out, grants, fits, rows in (
        ("drain-bench", shared_b, planes_b, bench, out_b, grants_b, fits_b, rows_b),
        ("drain-tenant", dict(shared, used0=used2), planes_t, tenant, out_t, grants_t, fits_t,
         rows_t),
    ):
        got_grants = check_batch(label, sh, planes, preps, out, dev)
        if not np.array_equal(got_grants, grants):
            fail(f"{label}: grants differ")
        if not fits.all():
            fail(f"{label}: dense verify refused a batch's own grants")
        # push one column of a few rows one over capacity
        cap_p, used_p = planes[0].cpu().numpy(), planes[2].cpu().numpy()
        deltas = grants[rows].copy()
        over = rng.choice(len(rows), 5, replace=False)
        for i in over:
            c = int(rng.integers(0, 4))
            deltas[i, c] = int(cap_p[rows[i], c]) - int(used_p[rows[i], c]) + 1
        pushed = plan_apply.dense_verify(planes, rows, list(deltas))
        want = np.ones(len(rows), bool)
        want[over] = False
        if not np.array_equal(pushed, want):
            fail(f"{label}: dense verify did not fail exactly the rows pushed over capacity")
        lanes = sum(len(d["gid_real"]) for d in preps)
        n_placed = sum(int((out[d["eval_id"]][0] >= 0).sum()) for d in preps)
        log(f"{label}: {len(preps)} evals x {lanes} lanes on the DeviceState, placed {n_placed}, "
            f"solo scans identical, no node over capacity, verify {len(rows)} rows fit and "
            f"fails exactly 5 pushed rows")

    # the same two batches through the plain versions on the CPU, from the
    # host planes the DeviceState holds: identical placements and bases
    cpu = torch.device("cpu")
    for label, used, preps, out in (("drain-bench", used1, bench, out_b),
                                    ("drain-tenant", used2, tenant, out_t)):
        want, cpu_e2e, _ = drive_batch(drain.SharedCluster(capacity, usable, used), preps, cpu)
        err = max_abs_err([(out[k][i], want[k][i]) for k in want for i in (0, 1)])
        if err or sorted(out) != sorted(want):
            fail(f"{label}: the batch on the card differs from the plain versions ({err})")
        log(f"{label}: placements and bases identical to the plain versions on the CPU "
            f"(host upload; CPU e2e {cpu_e2e:.0f} ms)")

    # ---- timings of the two batches, each on the planes of its first run ---
    ds_b = mirror.DeviceState(0, N, capacity, usable, used1, dev)
    for label, sh, preps, first, e2e, kms in (
        ("drain-bench", drain.SharedCluster(capacity, usable, used1, ds_b), bench, out_b, e2e_b,
         kms_b),
        ("drain-tenant", shared_t, tenant, out_t, e2e_t, kms_t),
    ):
        samples = [(e2e, kms)]
        for _ in range(3):
            again, e2e, kms = drive_batch(sh, preps, dev)
            samples.append((e2e, kms))
            if max_abs_err([(again[k][i], first[k][i]) for k in first for i in (0, 1)]):
                fail(f"{label}: a repeated batch placed differently")
        stats = drain.LAST_DRAIN_STATS
        log(f"{label} batch (e2e ms, kernel ms; first run, then 3 more): "
            + ", ".join(f"({e:.3f}, {k:.3f})" for e, k in samples)
            + f"; padded E,G,A,N,V = {stats['padded']}, build {stats['build_s'] * 1e3:.3f} ms")

    # ---- the wavefront route: both batches again on the same planes --------
    wavefront.configure(enabled=True, max_round=WAVEFRONT_W, contention_top_m=WAVEFRONT_M)
    kernel.reset_launches()
    wf_samples = {}
    for label, sh, preps, first in (
        ("drain-bench", drain.SharedCluster(capacity, usable, used1, ds_b), bench, out_b),
        ("drain-tenant", shared_t, tenant, out_t),
    ):
        samples = []
        for _ in range(3):
            again, e2e, kms = drive_batch(sh, preps, dev)
            stats = drain.LAST_DRAIN_STATS
            if stats["planner"] != "wavefront":
                fail(f"{label}: the batch ran the {stats['planner']} planner")
            if max_abs_err([(again[k][i], first[k][i]) for k in first for i in (0, 1)]):
                fail(f"{label}: the wavefront placed or based differently from the exact scan")
            samples.append((e2e, kms, int(stats["rounds"])))
        wf_samples[label] = samples
    wf_launches = path_launches(("wavefront", "used_bases"))
    wavefront.reset()
    log(f"server path, wavefront route launches: {wf_launches}")
    for name, n in wf_launches.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the server's wavefront route")
    for label, samples in wf_samples.items():
        lanes = sum(len(d["gid_real"]) for d in (bench if label == "drain-bench" else tenant))
        log(f"{label} wavefront W={WAVEFRONT_W} M={WAVEFRONT_M}: placements and bases identical "
            f"to the exact scan's; rounds {samples[0][2]} for {lanes} lanes "
            f"({samples[0][2] / lanes:.4f} per lane); (e2e ms, kernel ms): "
            + ", ".join(f"({e:.3f}, {k:.3f})" for e, k, _ in samples))

    # ---- K5 at the drain-bench batch's shape (limit 14 on every lane) -------
    order = [drain.DrainPrep.from_dict(d) for d in batch_order(bench)]
    shape = drain.batch_shape(order, NODES, DRAIN_EVALS)
    args_np, state_np, _ = drain.assemble(order, NODES, shape)
    bargs, init = drain.batch_inputs(planes_b, args_np, state_np, dev)

    def scan_kernel():
        return kernel.plan_batch(bargs, init, NODES)

    ms, (got_state, got) = cuda_ms(scan_kernel)
    plain_ms, (want_state, want) = host_ms(lambda: kernel.plan_batch_ref(bargs, init, NODES))
    err = max_abs_err([(got, want), *zip(got_state, want_state)])
    fused = np.concatenate([out_b[p.eval_id][0] for p in order])
    if err or not np.array_equal(got[: len(fused)].cpu().numpy(), fused):
        fail(f"drain-bench: the exact scan of the assembled batch differs from its plain "
             f"version or the collector's ({err})")
    pos = scan_positions(bargs, init, NODES)
    pos["walked"] = scan_walked(bargs, init, NODES, pos["needed"])
    moved, ops = scan_bound(pos, bargs, init, 4)
    bound_ms, bound_by = bound(moved, ops)
    E, G, A, N_b, _ = shape
    scan_bench = dict(ms=ms, device_us=device_us(scan_kernel, calls=3), plain_ms=plain_ms,
                      max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                      positions_needed=pos["needed"], positions_walked=pos["walked"],
                      lanes=pos["lanes"], shape=f"E={E} G={G} A={A} N={N_b}, limits "
                      f"{sorted(set(args_np['limits'][args_np['valid']].tolist()))}")
    us = scan_bench["device_us"]
    log(f"exact_scan at the drain-bench batch: {ms:.4f} ms per launch (plain {plain_ms:.1f} ms, "
        f"bound {bound_ms:.5f} ms by {bound_by}), on the card by the profiler "
        + ("not measured" if us is None else f"{us:.2f} us")
        + f"; {pos['lanes']} lanes, {pos['needed']} ring positions needed, {pos['walked']} "
        f"walked; {scan_bench['shape']}")
    # K9 at the same batch: (used, placements, demands, eval_of, E)
    bench_bases = (init.used, got, bargs.demands,
                   kernel.from_numpy(args_np["group_eval"][args_np["groups"]], dev), E)
    # the wavefront kernel on the same batch, against its plain version
    wavefront.configure(max_round=WAVEFRONT_W, contention_top_m=WAVEFRONT_M)
    wf_drain = {"drain_bench": wavefront_walk("drain-bench", bargs, init, NODES, pos, plain=True)}
    wavefront.reset()

    # ---- the server kernels at the main-path shapes -------------------------
    rows_out = []
    extras = {}  # name -> the row's fields past the common ones
    C = 4
    # K10: the 3,000-row refresh
    r_np, v_np = mirror.dirty_lanes(np.sort(dirty), used1)
    r, v = torch.from_numpy(r_np).to(dev), torch.from_numpy(v_np).to(dev)
    r_long = r.long()

    def scatter_kernel():
        return mirror.scatter_rows(plane0, r, v)

    def scatter_library():
        return plane0.index_copy(0, r_long, v)

    ms, got = cuda_ms(scatter_kernel)
    plain_ms, want = cuda_ms(lambda: mirror.scatter_rows_ref(plane0, r, v))
    lib_ms, lib = cuda_ms(scatter_library)
    err = max_abs_err([(got, want), (got, lib), (got, planes_b[2])])
    R = len(r_np)
    before = kernel.LAUNCHES["scatter_rows"]
    scatter_kernel()
    scatter_extra = dict(launches_per_call=kernel.LAUNCHES["scatter_rows"] - before,
                         host_split_us=scatter_host_split(plane0, r, v),
                         ledger_host_us=ledger_host_us(scatter_kernel))
    if scatter_extra["launches_per_call"] != 1:
        fail(f"scatter_rows: {scatter_extra['launches_per_call']} launches a call")
    log(f"scatter_rows: {scatter_extra['launches_per_call']} launch a call; host us by part "
        + ", ".join(f"{k} {u:.1f}" for k, u in scatter_extra["host_split_us"].items()))
    extras["scatter_rows"] = scatter_extra
    rows_out.append(("scatter_rows", "nomad_tpu_torch/tpu/csrc/scatter.cu",
                     "nomad_tpu/tpu/mirror.py:251", err, ms, plain_ms, lib_ms,
                     (device_us(scatter_kernel), device_us(scatter_library),
                      wrapper_host_us(scatter_kernel)),
                     2 * N * C * 4 + R * 4 + R * C * 4, 0, f"N={N} R={R} ({DIRTY_ROWS} dirty)"))

    # K9: the multi-tenant batch's usage bases, from its scan's placements
    order = [drain.DrainPrep.from_dict(d) for d in batch_order(tenant)]
    shape = drain.batch_shape(order, NODES, DRAIN_EVALS)
    E, _, A, _, _ = shape
    args_np, state_np, _ = drain.assemble(order, NODES, shape)
    bargs, init = drain.batch_inputs(planes_t, args_np, state_np, dev)
    _, placements = kernel.plan_batch(bargs, init, NODES)
    fused = np.concatenate([out_t[p.eval_id][0] for p in order])
    if not np.array_equal(placements[: len(fused)].cpu().numpy(), fused):
        fail("drain-tenant: the scan of the assembled batch differs from the collector's")
    wavefront.configure(max_round=WAVEFRONT_W, contention_top_m=WAVEFRONT_M)
    wf_drain["drain_tenant"] = wavefront_walk("drain-tenant", bargs, init, NODES,
                                              scan_positions(bargs, init, NODES), plain=True)
    wavefront.reset()
    eval_of = kernel.from_numpy(args_np["group_eval"][args_np["groups"]], dev)
    used_t = init.used

    def bases_kernel():  # the collector's call, once a batch
        return drain.used_bases(used_t, placements, bargs.demands, eval_of, E, NODES)

    ms, got = cuda_ms(bases_kernel)
    plain_ms, want = cuda_ms(
        lambda: drain.used_bases_ref(used_t, placements, bargs.demands, eval_of, E, NODES))
    valid = (placements >= 0) & (placements < NODES)
    flat = (eval_of.long() * N + placements.clamp(0, N - 1).long())
    contrib = torch.where(valid[:, None], bargs.demands, 0)

    def library_bases():
        delta = torch.zeros((E * N, C), dtype=torch.int32, device=dev).index_add_(0, flat, contrib)
        delta = delta.view(E, N, C)
        return used_t[None] + (delta.cumsum(0, dtype=torch.int32) - delta)

    lib_ms, lib = cuda_ms(library_bases)
    bases_host = np.stack([out_t[p.eval_id][1] for p in order])
    err = max_abs_err([(got, want), (got, lib), (got[: len(order)], bases_host)])
    n_valid = int(valid.sum())
    # the same kernel at the drain-bench batch (E 32, A 128)
    b_used, b_placements, b_demands, b_eval_of, b_E = bench_bases

    def bench_kernel():
        return drain.used_bases(b_used, b_placements, b_demands, b_eval_of, b_E, NODES)

    b_ms, b_got = cuda_ms(bench_kernel)
    b_err = max_abs_err([(b_got, drain.used_bases_ref(b_used, b_placements, b_demands, b_eval_of,
                                                      b_E, NODES))])
    if b_err:
        fail(f"used_bases: kernel differs from its plain version at drain-bench ({b_err})")
    b_A = b_placements.shape[0]
    extras["used_bases"] = dict(
        device_ops=device_ops(bases_kernel), ledger_host_us=ledger_host_us(bases_kernel),
        drain_bench=dict(ms=b_ms, device_us=device_us(bench_kernel),
                         host_us=wrapper_host_us(bench_kernel),
                         device_ops=device_ops(bench_kernel), max_abs_err=b_err,
                         bound_ms=bound(N * C * 4 + b_A * 4 * 2 + b_A * C * 4 + b_E * N * C * 4,
                                        b_E * N * C, I32_OPS_PER_S)[0],
                         shape=f"E={b_E} N={N} A={b_A}"))
    rows_out.append(("used_bases", "nomad_tpu_torch/tpu/csrc/bases.cu",
                     "nomad_tpu/tpu/drain.py:181", err, ms, plain_ms, lib_ms,
                     (device_us(bases_kernel), device_us(library_bases),
                      wrapper_host_us(bases_kernel)),
                     N * C * 4 + A * 4 + A * C * 4 + A * 4 + E * N * C * 4,
                     n_valid * C + E * N * C, f"E={E} N={N} A={A} ({n_valid} placed)"))

    # K8: the multi-tenant batch's verify, as dense_verify calls it on the
    # DeviceState's planes
    p_np, d_np = plan_apply.verify_lanes(rows_t, deltas_t)
    pr, pd = torch.from_numpy(p_np).to(dev), torch.from_numpy(d_np).to(dev)
    pr_long = pr.long()
    cap_t, used_v = planes_t[0], planes_t[2]

    def verify_kernel():  # dense_verify's call, once a plan
        return kernel.verify_rows(cap_t, used_v, pr, pd)

    def verify_library():
        return (used_v.index_add(0, pr_long, pd) <= cap_t).all(dim=1)[pr_long]

    ms, got = cuda_ms(verify_kernel)
    plain_ms, want = cuda_ms(lambda: kernel.verify_rows_ref(cap_t, used_v, pr, pd))
    lib_ms, lib = cuda_ms(verify_library)
    err = max_abs_err([(got, want), (got, lib), (got[: len(rows_t)], fits_t)])
    R, k = len(p_np), len(rows_t)
    extras["verify_rows"] = dict(device_ops=device_ops(verify_kernel),
                                 launch=kernel.verify_shape(N, C),
                                 ledger_host_us=ledger_host_us(verify_kernel))
    rows_out.append(("verify_rows", "nomad_tpu_torch/tpu/csrc/verify.cu",
                     "nomad_tpu/tpu/kernel.py:1061", err, ms, plain_ms, lib_ms,
                     (device_us(verify_kernel), device_us(verify_library),
                      wrapper_host_us(verify_kernel)),
                     k * C * 4 * 2 + R * 4 + R * C * 4 + R, R * C * FIT_OPS_PER_COL,
                     f"N={N} R={R} ({k} rows)"))

    # one launch a call and nothing else on the card, measured or failed
    for name, ops in (("used_bases", extras["used_bases"]["device_ops"]),
                      ("used_bases at drain-bench", extras["used_bases"]["drain_bench"]["device_ops"]),
                      ("verify_rows", extras["verify_rows"]["device_ops"])):
        if ops != 1:
            fail(f"{name}: {'no trace held every record of' if ops is None else ops} "
                 "device operations a call")
    server_rows = []
    for name, source, replaces, err, ms, plain_ms, lib_ms, dev_us, moved, ops, shape in rows_out:
        if err:
            fail(f"{name}: kernel differs from its plain version at the main-path shape ({err})")
        bound_ms, bound_by = bound(moved, ops, I32_OPS_PER_S)
        server_rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
            device_us=dev_us[0], library_device_us=dev_us[1], host_us=dev_us[2], shape=shape,
            **extras.get(name, {}),
        ))
        us = ["not measured" if u is None else f"{u:.2f} us" for u in dev_us[:2]]
        more = extras.get(name, {})
        public = ("" if "device_ops" not in more else
                  f" (the server path's), {more['device_ops']} device operations a call")
        log(f"{name}: {ms:.4f} ms per launch (plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
            f"bound {bound_ms:.5f} ms by {bound_by}); on the card by the profiler {us[0]}, "
            f"library {us[1]}; wrapper call on the host {dev_us[2]:.1f} us{public}; {shape}")
        if "ledger_host_us" in more:
            led = more["ledger_host_us"]
            log(f"{name}: wrapper call on the host {led['on']:.1f} us with the device ledger, "
                f"{led['off']:.1f} us without it: the ledger adds {led['added']:.1f} us")
        if "drain_bench" in more:
            b = more["drain_bench"]
            log(f"{name} at drain-bench ({b['shape']}): {b['ms']:.4f} ms per launch, on the card "
                + ("not measured" if b["device_us"] is None else f"{b['device_us']:.2f} us")
                + f", host {b['host_us']:.1f} us, {b['device_ops']} device operations a call, "
                f"bound {b['bound_ms']:.5f} ms")
    return launches, wf_launches, server_rows, scan_bench, wf_drain


# ---------------------------------------------------------------------------
# the scheduler front: real evals through the port's tpu-batch scheduler
# ---------------------------------------------------------------------------

#: the scheduler phase's shapes: nodes and datacenters of its cluster, the
#: headline eval's allocs (spread over the datacenters; also the service
#: eval's, whose limit is then ceil(log2(nodes)) = 14), the 8-group eval,
#: the device eval (nodes, groups, allocs a group) and the drain batch
#: (evals, allocs an eval)
SCHED = dict(nodes=10_000, dcs=4, allocs=50_000, groups=8, group_allocs=128,
             dev_nodes=4_000, dev_groups=2, dev_allocs=300, drain_evals=8, drain_allocs=256)
SCHED_SEED = 5
#: the kernels the scheduler phase must launch
SCHED_KERNELS = ("runs", "windowed", "exact_scan", "wavefront", "tile_count", "tile_window",
                 "used_bases", "scatter_rows")


def sched_nodes(n: int, dcs: int) -> list:
    """tests/test_tpu_parity.py's cluster: cpu and memory tiers from a seeded
    rng, the datacenters in turn."""
    from nomad_tpu_torch import mock

    rng = random.Random(99)
    nodes = []
    for i in range(n):
        node = mock.node()
        node.node_resources.cpu.cpu_shares = rng.choice([2000, 4000, 8000])
        node.node_resources.memory.memory_mb = rng.choice([4096, 8192, 16384])
        node.datacenter = f"dc{i % dcs + 1}"
        nodes.append(node)
    return nodes


def sched_device_nodes(n: int) -> list:
    """tests/test_tpu_devices.py's cluster: every 4th node carries two TPU
    instances, the rest one of two cpu/memory tiers."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import compute_class
    from nomad_tpu_torch.structs.model import generate_uuid

    rng = random.Random(7)
    templates = []
    for make, cpu, mem in ((mock.node, 4000, 8192), (mock.node, 8000, 16384),
                           (mock.tpu_node, None, None)):
        t = make()
        if cpu is not None:
            t.node_resources.cpu.cpu_shares = cpu
            t.node_resources.memory.memory_mb = mem
        t.node_resources.networks = []
        t.reserved_resources.networks.reserved_host_ports = ""
        compute_class(t)
        templates.append(t)
    nodes = []
    for i in range(n):
        node = (templates[2] if i % 4 == 0 else templates[rng.randrange(2)]).copy()
        node.id = generate_uuid()
        nodes.append(node)
    return nodes


def sched_job(count: int, dcs: int, spread: bool = False, groups: int = 1, device: bool = False):
    """A mock service job over ``dcs`` datacenters with no network ask:
    ``count`` allocs in each of ``groups`` groups (each group its own cpu
    ask), spread evenly over the datacenters by target when ``spread``,
    one TPU instance an alloc when ``device``."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs.model import RequestedDevice, Spread, SpreadTarget, TaskGroup

    job = mock.job()
    job.datacenters = [f"dc{i + 1}" for i in range(dcs)]
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.networks = []
    if device:
        tg.tasks[0].resources.cpu, tg.tasks[0].resources.memory_mb = 100, 64
        tg.tasks[0].resources.devices = [RequestedDevice(name="tpu", count=1)]
    if spread:
        job.spreads = [Spread(attribute="${node.datacenter}", weight=100, spread_target=[
            SpreadTarget(value=d, percent=100 // dcs) for d in job.datacenters])]
    for g in range(1, groups):
        other = TaskGroup.from_dict(tg.to_dict())
        other.name = f"web{g}"
        other.tasks[0].resources.cpu = tg.tasks[0].resources.cpu + 50 * g
        job.task_groups.append(other)
    return job


def sched_eval(job, eval_id: str):
    from nomad_tpu_torch.structs.model import Evaluation

    return Evaluation(id=eval_id, namespace=job.namespace, priority=job.priority,
                      type="service", triggered_by="job-register", job_id=job.id,
                      status="pending")


class SchedCase:
    """One eval's documents: the nodes in one transaction, then each job
    and its eval. ``harness(dev)`` carries them into a new state store."""

    def __init__(self, node_docs: list, jobs: list, evals: list):
        self.records = [(1, "nodes", node_docs)]
        for job, ev in zip(jobs, evals):
            self.records.append((len(self.records) + 1, "job", job.to_dict()))
            self.records.append((len(self.records) + 1, "evals", [ev.to_dict()]))
        self.jobs, self.evals = jobs, evals

    def harness(self, dev):
        from nomad_tpu_torch.scheduler import Harness
        from nomad_tpu_torch.state.carry import carry_state

        h = Harness(state=carry_state(self.records), seed=SCHED_SEED, device=dev)
        while h.next_index() < len(self.records):
            pass
        return h


def sched_process(h, ev):
    """(scheduler, process() seconds, the scheduler's LAST_KERNEL_STATS with
    ``apply_s``). As bench.py's ``run_once`` does, only ``process()`` is
    timed, with a planner that records the plan without applying it
    (bench.py's NullPlanner); the plan is then applied to the harness's
    store on its own clock, ``apply_s``."""
    from nomad_tpu_torch.scheduler.scheduler import new_scheduler
    from nomad_tpu_torch.structs.model import Evaluation, PlanResult
    from nomad_tpu_torch.tpu import batch_sched

    ev = Evaluation.from_dict(ev.to_dict())
    recorded = []

    class Recorder:
        def submit_plan(self, plan):
            result = PlanResult(
                node_update=plan.node_update, node_allocation=plan.node_allocation,
                node_preemptions=plan.node_preemptions, deployment=plan.deployment,
                deployment_updates=plan.deployment_updates, alloc_index=h.next_index())
            recorded.append((plan, result))
            return result, None

        def update_eval(self, ev):
            pass

        create_eval = reblock_eval = update_eval

    h.planner = Recorder()
    sched = new_scheduler("tpu-batch", h.snapshot(), h, rng=random.Random(h.seed),
                          device=h.device)
    t0 = time.perf_counter()
    sched.process(ev)
    secs = time.perf_counter() - t0
    h.planner = None
    t0 = time.perf_counter()
    for plan, result in recorded:
        h.state.upsert_plan_results(result.alloc_index, plan, result)
    return sched, secs, dict(batch_sched.LAST_KERNEL_STATS, apply_s=time.perf_counter() - t0)


def sched_outcome(h, jobs, scheds) -> dict:
    """What the phase compares: placements (job, alloc name) -> node id and
    each scheduler's failure metrics, without their wall-clock field."""
    placements = {(job.id, a.name): a.node_id
                  for job in jobs for a in h.state.allocs_by_job(job.namespace, job.id)}
    failed = {}
    for sched in scheds:
        for name, m in sched.failed_tg_allocs.items():
            d = m.to_dict()
            d.pop("allocation_time")
            failed[(sched.job.id if sched.job else "", name)] = d
    return dict(placements=placements, failed=failed)


def sched_over_capacity(h, device_ask=None) -> int:
    """Nodes of ``h``'s state whose allocs ask more than the node has, in
    any resource column (and, with ``device_ask``, in matching device
    instances)."""
    from nomad_tpu_torch.tpu.columnar import ColumnarCluster

    snap = h.state.snapshot()
    cluster = ColumnarCluster(list(snap.nodes()))
    over = (cluster.initial_used(snap) > cluster.capacity).any(axis=1)
    if device_ask is not None:
        cap, match_sets, _ = cluster.device_plane(device_ask)
        over |= cluster.device_used(snap, match_sets) > cap
    return int(over.sum())


def sched_drain(h, evs, dev, wavefront_on: bool) -> list:
    """The drain batch: ``evs`` on one thread each through one collector
    whose shared planes live in a DeviceState, brought up to the snapshot's
    usage by one dirty-row refresh (from the bare reserved planes). Returns
    the schedulers."""
    from nomad_tpu_torch.structs.model import Evaluation
    from nomad_tpu_torch.tpu import batch_sched, drain, mirror, problems

    snap = h.state.snapshot()
    shared = drain.SharedCluster.from_snapshot(snap)
    ds = mirror.DeviceState(0, problems.bucket(shared.n_real), shared.capacity, shared.usable,
                            shared.cluster.reserved, device=dev)
    dirty = np.flatnonzero((shared.used0 != shared.cluster.reserved).any(axis=1))
    if not len(dirty):
        fail("the drain batch's state holds no allocation: its refresh would scatter nothing")
    ds.pending.update(dirty.tolist())
    ds.refresh(shared.used0)
    shared.device_state = ds
    collector = drain.KernelBatchCollector(shared, expected=len(evs), timeout=120, device=dev)
    scheds, errors = [None] * len(evs), []

    def run_one(i, ev):
        sched = batch_sched.TPUBatchScheduler(snap, h, rng=random.Random(SCHED_SEED), device=dev)
        sched.drain_collector = collector
        scheds[i] = sched
        try:
            sched.process(Evaluation.from_dict(ev.to_dict()))
        except BaseException as e:  # reported below: the phase fails
            errors.append(e)
        finally:
            if not collector.consumed(ev.id):
                collector.leave(ev.id)

    threads = [threading.Thread(target=run_one, args=(i, ev), daemon=True)
               for i, ev in enumerate(evs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads):
        fail("a drain eval of the scheduler phase did not finish")
    if errors:
        raise errors[0]
    if collector.invocations != 1:
        fail(f"the drain evals took {collector.invocations} batches, not one")
    want = "wavefront" if wavefront_on else "exact"
    if drain.LAST_DRAIN_STATS["planner"] != want:
        fail(f"the drain batch ran {drain.LAST_DRAIN_STATS['planner']}, not {want}")
    return scheds


def scheduler_phase(dev, size: dict = SCHED) -> tuple:
    """Six evals through the port's Harness on ``dev`` (see the module
    docstring, phase 6), each against the same documents, seed and eval
    through the port's scheduler on the CPU. Returns (launches per kernel
    in the counted run, the headline eval's timings)."""
    from nomad_tpu_torch.native import fastobj
    from nomad_tpu_torch.tpu import batch_sched, kernel, paging, problems, wavefront

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    log(f"scheduler: the host materialize loop is "
        f"{'the C module' if fastobj() is not None else 'pure Python (no C toolchain)'}")
    n, dcs, a = size["nodes"], size["dcs"], size["allocs"]
    node_docs = [nd.to_dict() for nd in sched_nodes(n, dcs)]
    dev_docs = [nd.to_dict() for nd in sched_device_nodes(size["dev_nodes"])]

    headline = sched_job(a, dcs, spread=True)
    service = sched_job(a, dcs)
    groups = sched_job(size["group_allocs"], dcs, groups=size["groups"])
    device = sched_job(size["dev_allocs"], dcs, groups=size["dev_groups"], device=True)
    device.datacenters = ["dc1"]
    drains = [sched_job(size["drain_allocs"], dcs) for _ in range(size["drain_evals"])]
    for i, job in enumerate(drains):
        job.priority = 50 + 10 * (i % 2)
    cases = {
        "headline": (SchedCase(node_docs, [headline], [sched_eval(headline, "ev-headline")]),
                     "runs", False, False),
        "service": (SchedCase(node_docs, [service], [sched_eval(service, "ev-service")]),
                    "windowed", False, False),
        "groups": (SchedCase(node_docs, [groups], [sched_eval(groups, "ev-groups")]),
                   "exact-scan", False, False),
        "groups_wavefront": (SchedCase(node_docs, [groups], [sched_eval(groups, "ev-groups")]),
                             "wavefront", True, False),
        "paged": (SchedCase(node_docs, [service], [sched_eval(service, "ev-service")]),
                  "paged", False, True),
        "device": (SchedCase(dev_docs, [device], [sched_eval(device, "ev-device")]),
                   "exact-scan", False, False),
    }
    drain_evs = [sched_eval(job, f"ev-drain-{i}") for i, job in enumerate(drains)]

    @contextlib.contextmanager
    def stanzas(wf_on: bool, paged_on: bool):
        if wf_on:
            wavefront.configure(enabled=True, max_round=WAVEFRONT_W, contention_top_m=WAVEFRONT_M)
        if paged_on:  # a budget of half the planes
            planes = paging.plane_bytes(problems.bucket(n), 4)
            paging.configure(enabled=True, tile_nodes=1024)
            patch = mock.patch.object(paging, "budget_mb", lambda: planes / 2 / (1 << 20))
        else:
            patch = contextlib.nullcontext()
        try:
            with patch:
                yield
        finally:
            wavefront.reset()
            paging.reset()

    def run_all(on) -> dict:
        """Every case on ``on``; returns name -> (outcome, stats, seconds,
        over-capacity nodes)."""
        out = {}
        service_h = None
        for name, (case, mode, wf_on, paged_on) in cases.items():
            h = case.harness(on)
            with stanzas(wf_on, paged_on):
                sched, secs, stats = sched_process(h, case.evals[0])
            if stats.get("mode") != mode:
                fail(f"scheduler {name}: planned in mode {stats.get('mode')}, expected {mode}")
            ask = device.task_groups[0].tasks[0].resources.devices[0] if name == "device" else None
            out[name] = (sched_outcome(h, case.jobs, [sched]), stats, secs,
                         sched_over_capacity(h, ask))
            if name == "service":
                service_h = h
        # the drain batch, on the service eval's final state
        for job, ev in zip(drains, drain_evs):
            service_h.state.upsert_job(service_h.next_index(), job.copy())
            ev.create_index = service_h.next_index()
            service_h.state.upsert_evals(ev.create_index, [ev.copy()])
        t0 = time.perf_counter()
        scheds = sched_drain(service_h, drain_evs, on, wavefront_on=False)
        out["drain"] = (sched_outcome(service_h, drains, scheds), {"mode": "drain"},
                        time.perf_counter() - t0, sched_over_capacity(service_h))
        return out

    # ---- the counted run on the card --------------------------------------
    before = batch_sched.counters_snapshot()
    kernel.reset_launches()
    got = run_all(dev)
    launches = path_launches(SCHED_KERNELS)
    after = batch_sched.counters_snapshot()
    log(f"scheduler path launches: {launches}")
    modes = {k: v - before["modes"].get(k, 0) for k, v in after["modes"].items()
             if v != before["modes"].get(k, 0)}
    reasons = {k: v - before["fallback_reasons"].get(k, 0)
               for k, v in after["fallback_reasons"].items()
               if v != before["fallback_reasons"].get(k, 0)}
    want_modes = {"runs": 1, "windowed": 1, "exact-scan": 2, "wavefront": 1, "paged": 1}
    if modes != want_modes:
        fail(f"scheduler modes {modes}, expected {want_modes}")
    if reasons:
        fail(f"scheduler fallbacks {reasons}: every eval must ride its planner")
    drained = after["drain_evals"] - before["drain_evals"]
    if drained != size["drain_evals"]:
        fail(f"{drained} evals rode the drain batch, expected {size['drain_evals']}")
    if dev.type == "cuda":
        for name, count in launches.items():
            if count < 1:
                fail(f"kernel {name} was not launched on the scheduler path")

    # ---- the same documents, seed and evals through the plain versions ----
    want = run_all(cpu)
    for name, (outcome, stats, secs, over) in got.items():
        ref = want[name][0]
        if outcome["placements"] != ref["placements"]:
            diff = sum(ref["placements"].get(k) != v for k, v in outcome["placements"].items())
            fail(f"scheduler {name}: {diff} of {len(ref['placements'])} placements differ from "
                 f"the plain versions' ({len(outcome['placements'])} placed)")
        if outcome["failed"] != ref["failed"]:
            fail(f"scheduler {name}: failure metrics differ from the plain versions'")
        if over:
            fail(f"scheduler {name}: {over} nodes over capacity after the plan")
        log(f"scheduler {name}: mode {stats['mode']}, {len(outcome['placements'])} placed, "
            f"{len(outcome['failed'])} groups failed, identical to the plain versions; "
            f"process {secs * 1e3:.1f} ms (plain {want[name][2] * 1e3:.1f} ms)")

    # ---- the headline eval's timings: three more runs on fresh stores -------
    case = cases["headline"][0]
    timings = [got["headline"]]
    for _ in range(3):
        h = case.harness(dev)
        sched, secs, stats = sched_process(h, case.evals[0])
        timings.append((sched_outcome(h, case.jobs, [sched]), stats, secs, 0))
        if timings[-1][0] != got["headline"][0]:
            fail("a rerun of the headline eval placed differently")
    runs = []
    for _, stats, secs, _ in timings:
        ms = {k[:-2] + "_ms": stats[k] * 1e3 if stats[k] is not None else None for k in (
            "columnar_s", "dispatch_s", "kernel_s", "device_s", "materialize_s", "apply_s")}
        rest = secs * 1e3 - ms["columnar_ms"] - ms["dispatch_ms"] - ms["materialize_ms"]
        runs.append(dict(process_ms=secs * 1e3, **ms, reconcile_ms=rest, rounds=stats["rounds"],
                         launches=stats["launches"]))
        log(f"scheduler headline: process {secs * 1e3:.1f} ms = columnar "
            f"{ms['columnar_ms']:.1f} + dispatch {ms['dispatch_ms']:.1f} (planner launch to "
            f"sync {ms['kernel_ms']:.1f}, by events {ms['device_ms']}) + materialize "
            f"{ms['materialize_ms']:.1f} + reconcile and the rest {rest:.1f} ms; rounds "
            f"{stats['rounds']}; then plan apply {ms['apply_ms']:.1f} ms")
    log(f"scheduler phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, dict(nodes=n, allocs=a, runs=runs)


#: the server phase's full-width run: the soak scenario's server config
#: (nomad_tpu/loadgen/scenarios.py:125-190) and its preload of batch jobs
SERVER = dict(nodes=10_000, dcs=4, batch_jobs=8, batch_allocs=(7_500, 10_000),
              service_allocs=5_000, workers=2)
#: the smaller run, placed on the card and on the CPU: one drain worker, so
#: the batch's evals fuse the same way in both runs
SERVER_SMALL = dict(nodes=1_000, dcs=4, batch_jobs=8, batch_allocs=(200, 200),
                    service_allocs=1_000, workers=1)
SERVER_CONFIG = {"seed": 42, "heartbeat_ttl": 86400.0, "default_scheduler": "tpu-batch",
                 "batch_drain": 8, "plan_apply_batch": 8, "nack_timeout": 120.0,
                 "event_broker": {"event_buffer_size": 16384}}
#: the kernels the server phase must launch: the fused drain's scan (or the
#: wavefront) and usage bases, the mirror's dirty-row scatter, the
#: applier's dense verify and the solo service eval's windowed planner
SERVER_RUN_KERNELS = ("exact_scan", "wavefront", "used_bases", "scatter_rows", "verify_rows",
                      "windowed")


def server_jobs(size: dict, seed: int = 42) -> tuple:
    """(batch jobs, system job, service job) as documents: the soak's
    preload of batch jobs (counts from ``batch_allocs``, cpu 50/100,
    memory 32/64), one system job and one service job, all over the
    ``dcs`` datacenters with no network ask."""
    from nomad_tpu_torch import mock

    rng = random.Random(seed)
    dcs = [f"dc{i + 1}" for i in range(size["dcs"])]
    batch = []
    for _ in range(size["batch_jobs"]):
        job = mock.batch_job()
        job.datacenters = dcs
        task = job.task_groups[0].tasks[0]
        job.task_groups[0].count = rng.randint(*size["batch_allocs"])
        task.resources.cpu, task.resources.memory_mb = rng.choice((50, 100)), rng.choice((32, 64))
        batch.append(job.to_dict())
    system = mock.system_job()
    system.datacenters = dcs
    system.task_groups[0].tasks[0].resources.networks = []
    service = mock.job()
    service.datacenters = dcs
    service.task_groups[0].count = size["service_allocs"]
    service.task_groups[0].tasks[0].resources.networks = []
    return batch, system.to_dict(), service.to_dict()


def _snapshot(x):
    """``x`` with every tensor in it cloned (namedtuples, tuples and lists
    kept); on the caller's stream, so the clone is what the kernel just
    read or wrote."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_snapshot(t) for t in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_snapshot(t) for t in x)
    return x


def _flat(x) -> list:
    """The tensors and numbers of a kernel's output, in order."""
    if isinstance(x, (tuple, list)):
        return [t for part in x for t in _flat(part)]
    return [x]


class ServerProbe:
    """Records every call of the server path's kernel wrappers during a
    run: its CUDA events on the caller's stream (the server launches on
    the default stream from every thread) and a copy of its inputs and
    output, which ``check`` replays through the kernel's plain version on
    the same device after the run."""

    #: the wrappers the server path calls: (module, attribute, kernel)
    TARGETS = (("kernel", "plan_batch", "exact_scan"),
               ("wavefront", "plan_batch_wavefront", "wavefront"),
               ("kernel", "plan_batch_windowed", "windowed"), ("kernel", "plan_batch_runs", "runs"),
               ("drain", "used_bases", "used_bases"), ("mirror", "scatter_rows", "scatter_rows"),
               ("kernel", "verify_rows", "verify_rows"))
    #: the planners, whose plain versions walk the lanes one by one: their
    #: calls replay from the fewest lanes up while the replays of the
    #: kernel have taken under this many seconds (at least one call each);
    #: every call of the other kernels replays
    PLANNER_REPLAY_S = 30.0
    PLANNERS = ("exact_scan", "wavefront", "windowed", "runs")

    def __init__(self, dev):
        self.dev = dev
        self.spans: dict = {}
        self.calls: dict = {}
        self._lock = threading.Lock()

    def _wrap(self, name, fn):
        def probed(*args, **kwargs):
            timed = self.dev.type == "cuda"
            if timed:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            out = fn(*args, **kwargs)
            if timed:
                end.record()
            call = (_snapshot(args), _snapshot(out))
            with self._lock:
                if timed:
                    self.spans.setdefault(name, []).append((start, end))
                self.calls.setdefault(name, []).append(call)
            return out
        return probed

    @contextlib.contextmanager
    def installed(self):
        from nomad_tpu_torch.tpu import drain, kernel, mirror, wavefront

        modules = dict(kernel=kernel, wavefront=wavefront, drain=drain, mirror=mirror)
        with contextlib.ExitStack() as stack:
            for module, attr, name in self.TARGETS:
                m = modules[module]
                stack.enter_context(mock.patch.object(m, attr, self._wrap(name, getattr(m, attr))))
            yield self

    def event_ms(self) -> dict:
        torch.cuda.synchronize()
        return {name: [s.elapsed_time(e) for s, e in pairs] for name, pairs in self.spans.items()}

    @staticmethod
    def _lanes(name, args) -> int:
        """The lanes a planner's plain version walks in this call."""
        if name in ("exact_scan", "wavefront"):
            return int(args[0].valid.sum())
        return int(args[0].n_allocs)

    @staticmethod
    def _plain(name, args):
        from nomad_tpu_torch.tpu import drain, kernel, mirror, wavefront

        if name == "exact_scan":
            return kernel.plan_batch_ref(*args[:3])
        if name == "wavefront":
            bargs, init, n_real = args[:3]
            return wavefront.plan_batch_wavefront_ref(
                bargs, init, n_real, wavefront.window_for(int(bargs.demands.shape[0])),
                wavefront.contention_top_m(), wavefront.shards_for(bargs.capacity.shape[0], 1))
        return dict(windowed=kernel.plan_batch_windowed_ref, runs=kernel.plan_batch_runs_ref,
                    used_bases=drain.used_bases_ref, scatter_rows=mirror.scatter_rows_ref,
                    verify_rows=kernel.verify_rows_ref)[name](*args)

    def check(self) -> dict:
        """Replays the recorded calls through the plain versions; returns
        kernel -> {calls, replayed, lanes replayed, max_abs_err, seconds}.
        The caller fails on any error."""
        out = {}
        for name, calls in self.calls.items():
            t0 = time.perf_counter()
            order = list(range(len(calls)))
            lanes = [0] * len(calls)
            if name in self.PLANNERS:
                lanes = [self._lanes(name, args) for args, _ in calls]
                order.sort(key=lanes.__getitem__)
            err, replayed = 0, []
            for i in order:
                if (replayed and name in self.PLANNERS
                        and time.perf_counter() - t0 > self.PLANNER_REPLAY_S):
                    break
                args, got = calls[i]
                want = self._plain(name, args)
                err = max(err, max_abs_err(zip(_flat(got), _flat(want))))
                replayed.append(i)
            out[name] = dict(calls=len(calls), replayed=len(replayed),
                             lanes_replayed=sum(lanes[i] for i in replayed),
                             lanes_left=sum(lanes) - sum(lanes[i] for i in replayed),
                             max_abs_err=err, seconds=time.perf_counter() - t0)
        return out


class StageClock:
    """Sums the server's stage timers over a run, whatever the metrics'
    window keeps: every ``metrics.sample`` of a named stage adds its
    seconds to the stage's total and its interval (ending at the sample)
    to the stage's intervals, whose union is the wall time in which at
    least one such stage ran (commits of one applier overlap)."""

    STAGES = ("eval.e2e", "plan.submit", "plan.queue_wait", "plan.evaluate",
              "plan.verify_device", "plan.raft_apply", "drain.batch_build")

    def __init__(self):
        self.spans = {name: [] for name in self.STAGES}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def installed(self):
        from nomad_tpu_torch import metrics

        real = metrics.sample

        def sample(name, seconds, exemplar=None):
            if name in self.spans:
                now = time.monotonic()
                with self._lock:
                    self.spans[name].append((now - seconds, now))
            return real(name, seconds, exemplar)

        with mock.patch.object(metrics, "sample", sample):
            yield self

    def stats(self, wall_s: float) -> dict:
        """stage -> {count, sum_ms, wall_ms, wall_share of ``wall_s``}."""
        out = {}
        for name, spans in self.spans.items():
            covered, end = 0.0, float("-inf")
            for a, b in sorted(spans):
                if b > end:
                    covered += b - max(a, end)
                    end = b
            out[name] = dict(count=len(spans), sum_ms=1e3 * sum(b - a for a, b in spans),
                             wall_ms=1e3 * covered, wall_share=covered / wall_s if wall_s else None)
        return out


def server_run(dev, size: dict, node_docs: list, jobs: tuple) -> dict:
    """One run of the server phase on ``dev`` (module docstring, phase 7):
    returns its placements, the checks' findings and its numbers."""
    from nomad_tpu_torch import metrics
    from nomad_tpu_torch.core.server import Server
    from nomad_tpu_torch.structs.model import Job, Node
    from nomad_tpu_torch.tpu import batch_sched, drain

    batch_docs, system_doc, service_doc = jobs
    drain0, modes0 = dict(drain.DRAIN_COUNTERS), batch_sched.counters_snapshot()
    metrics0 = metrics.snapshot()
    threads0 = set(threading.enumerate())
    server = Server(dict(SERVER_CONFIG), device=dev)
    out: dict = {}
    clock = StageClock()
    with clock.installed():
        try:
            server.start(num_workers=0, wait_for_leader=5.0)
            t0 = time.perf_counter()
            for d in node_docs:
                server.node_register(Node.from_dict(d))
            out["register_s"] = time.perf_counter() - t0

            def wait(ids: list, registered: dict, limit_s: float) -> dict:
                """Poll until every eval completes; returns eval id -> seconds
                from its registration to the first poll that saw it complete."""
                done: dict = {}
                deadline = time.perf_counter() + limit_s
                while len(done) < len(ids):
                    now = time.perf_counter()
                    for e in ids:
                        if e not in done:
                            ev = server.state.eval_by_id(e)
                            if ev is not None and ev.status == "complete":
                                done[e] = now - registered[e]
                            elif ev is not None and ev.status in ("failed", "cancelled"):
                                fail(f"server: eval {e} ended {ev.status}: {ev.status_description}")
                    if now > deadline:
                        fail(f"server: {len(ids) - len(done)} evals not complete in {limit_s:.0f} s")
                    time.sleep(0.005)
                return done

            jobs_all, registered = [], {}
            t_jobs = time.perf_counter()
            for d in batch_docs:
                job = Job.from_dict(d)
                jobs_all.append(job)
                t = time.perf_counter()
                eid = server.job_register(job)
                registered[eid] = t
            batch_ids = list(registered)
            t_workers = time.perf_counter()
            server.start_workers(size["workers"])
            out["batch_latency_s"] = wait(batch_ids, registered, 300.0)
            out["batch_wall_s"] = time.perf_counter() - t_workers
            for label, d in (("system", system_doc), ("service", service_doc)):
                job = Job.from_dict(d)
                jobs_all.append(job)
                t = time.perf_counter()
                eid = server.job_register(job)
                out[f"{label}_latency_s"] = wait([eid], {eid: t}, 300.0)[eid]
            # the follow-up evals (the system job preempts batch allocs on the
            # nodes the fused scan packed full; each preempted job's eval
            # places their replacements) run to their end before the checks
            t = time.perf_counter()
            while True:
                evs = server.state.evals()
                if all(e.terminal_status() or e.should_block() for e in evs):
                    break
                if time.perf_counter() - t > 300.0:
                    fail("server: follow-up evals not terminal in 300 s")
                time.sleep(0.02)
            out["follow_up_s"] = time.perf_counter() - t
            out["jobs_wall_s"] = time.perf_counter() - t_jobs
            out["evals"] = {}
            for e in evs:
                key = f"{e.triggered_by}:{e.status}"
                out["evals"][key] = out["evals"].get(key, 0) + 1

            snap = server.state.snapshot()
            live = [(j, a) for j in jobs_all for a in snap.allocs_by_job(j.namespace, j.id)]
            out["preempted"] = sum(1 for _, a in live if a.terminal_status())
            placed = sorted((j.id, a.name, a.node_id) for j, a in live if not a.terminal_status())
            counts = {j.id: 0 for j in jobs_all}
            for job_id, _, _ in placed:
                counts[job_id] += 1
            eligible = sum(1 for n in snap.nodes() if n.ready())
            want = {j.id: (eligible if j.type == "system" else j.task_groups[0].count) for j in jobs_all}
            short = {k: (counts[k], want[k]) for k in want if counts[k] != want[k]}
            out.update(placed=placed, short=short, over=sched_over_capacity(server),
                       mirror=server.columnar_mirror.stats(), raft_applied=server.raft.last_applied)
        finally:
            server.stop()
            # a thread of the server still running at the interpreter's exit
            # can abort the process: every one must end here
            t = time.perf_counter()
            while True:
                left = [th for th in threading.enumerate() if th not in threads0 and th.is_alive()
                        and th.name != "eval-broker-timers"]
                if not left or time.perf_counter() - t > 60.0:
                    break
                time.sleep(0.05)
            if left:
                fail(f"server: threads alive 60 s after stop: {[th.name for th in left]}")
    after = batch_sched.counters_snapshot()
    out["drain"] = {k: drain.DRAIN_COUNTERS[k] - drain0[k] for k in drain0}
    out["modes"] = {k: v - modes0["modes"].get(k, 0) for k, v in after["modes"].items()
                    if v != modes0["modes"].get(k, 0)}
    out["fallbacks"] = {k: v - modes0["fallback_reasons"].get(k, 0)
                        for k, v in after["fallback_reasons"].items()
                        if v != modes0["fallback_reasons"].get(k, 0)}
    m1 = metrics.snapshot()
    counters = {k: v - metrics0["counters"].get(k, 0) for k, v in m1["counters"].items()
                if v != metrics0["counters"].get(k, 0)}
    # the stages' host times over the run, from the first job's
    # registration to the end of the follow-up evals: the eval end to end,
    # the worker's plan submit, the plan's wait in the queue, its verify
    # (of which the dense verify on the device), the raft commit of the
    # applier's batches (which overlap) and the drain's batch build; each
    # with its count, its sum and the wall time it covered
    out["stages"] = clock.stats(out.get("jobs_wall_s", 0.0))
    out["applier"] = dict(
        plans_evaluated=out["stages"]["plan.evaluate"]["count"],
        device_verify_calls=out["stages"]["plan.verify_device"]["count"],
        degrades={k: v for k, v in counters.items() if k.startswith("plan.verify_device_degrade")},
        mirror_stale=counters.get("tpu.mirror_stale", 0))
    return out


def server_phase(dev) -> dict:
    """The server phase (module docstring, phase 7). Returns the launches
    per kernel of the full-width run and its kernel ms by events."""
    from nomad_tpu_torch.tpu import kernel

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    node_docs = [n.to_dict() for n in sched_nodes(SERVER["nodes"], SERVER["dcs"])]
    jobs = server_jobs(SERVER)
    probe = ServerProbe(dev)
    kernel.reset_launches()
    with probe.installed():
        run = server_run(dev, SERVER, node_docs, jobs)
        launches = path_launches(SERVER_RUN_KERNELS)
    event_ms = probe.event_ms()
    log(f"server phase launches: {launches}")
    planner_launches = launches["exact_scan"] + launches["wavefront"]
    missing = [k for k in ("used_bases", "scatter_rows", "verify_rows", "windowed")
               if launches[k] < 1]
    if planner_launches < 1 or missing:
        fail(f"server phase: kernels not launched: {missing or ['exact_scan or wavefront']}")
    if run["short"]:
        fail(f"server phase: jobs short of their count (placed, wanted): {run['short']}")
    if run["over"]:
        fail(f"server phase: {run['over']} nodes over capacity")
    # a follow-up eval of a few placements rides the scalar oracle by design
    # (the small-eval gate); any other fallback fails the phase
    if set(run["fallbacks"]) - {"small_eval"}:
        fail(f"server phase: scheduler fallbacks {run['fallbacks']}")
    # every call of the run against its kernel's plain version, on the
    # inputs it was given (the planners' calls from the fewest lanes up)
    held = probe.check()
    for name, h in sorted(held.items()):
        log(f"server: {name} held against its plain version on {h['replayed']} of its "
            f"{h['calls']} calls ({h['lanes_replayed']} lanes replayed, {h['lanes_left']} not) in "
            f"{h['seconds']:.1f} s, max abs err {h['max_abs_err']}")
        if h["max_abs_err"]:
            fail(f"server phase: {name} differs from its plain version (max abs err "
                 f"{h['max_abs_err']})")
    lat = sorted(run["batch_latency_s"].values())
    log(f"server: {SERVER['nodes']} nodes registered in {run['register_s']:.1f} s; "
        f"{len(run['placed'])} allocs placed, every job at its count, no node over capacity")
    log(f"server: drained evals, registration to complete (s): "
        f"{', '.join(f'{x:.3f}' for x in lat)}; the batch's wall from start_workers "
        f"{run['batch_wall_s']:.3f} s")
    log(f"server: system eval {run['system_latency_s']:.3f} s, service eval (solo) "
        f"{run['service_latency_s']:.3f} s registration to complete; then the follow-up "
        f"evals {run['follow_up_s']:.3f} s; evals by trigger and status {run['evals']}; "
        f"{run['preempted']} batch allocs preempted by the system job and placed again")
    log(f"server: fused batches and evals {run['drain']}; modes {run['modes']}")
    log(f"server: applier {run['applier']}")
    for name, st in run["stages"].items():
        log(f"server: stage {name}: {st['count']} samples, {st['sum_ms']:.1f} ms summed, "
            f"{st['wall_ms']:.1f} ms of wall covered ({100 * st['wall_share']:.1f}% of the "
            f"{run['jobs_wall_s']:.1f} s from the first job's registration to the last eval)")
    m = run["mirror"]
    log(f"server: mirror uploads {m['uploads']}, refreshes {m['refreshes']}, rows scattered "
        f"{m['rows_scattered']}, hits {m['hits']}, stale {m['stale']}; raft applies "
        f"{run['raft_applied']}")
    # the server launches from several threads onto one stream, so a call's
    # events can hold another thread's kernels too: the least call is the
    # kernel's own time
    for name, ms in sorted(event_ms.items()):
        log(f"server: {name} by events, ms a call (least {min(ms):.4f}, median "
            f"{float(np.median(ms)):.4f}): {', '.join(f'{x:.4f}' for x in ms)}")
    log(f"server timings: {json.dumps(dict(batch_latency_s=lat, batch_wall_s=run['batch_wall_s'], system_latency_s=run['system_latency_s'], service_latency_s=run['service_latency_s'], register_s=run['register_s'], follow_up_s=run['follow_up_s'], jobs_wall_s=run['jobs_wall_s'], evals=run['evals'], preempted=run['preempted'], event_ms=event_ms, held=held, drain=run['drain'], modes=run['modes'], applier=run['applier'], stages=run['stages'], mirror=m, raft_applied=run['raft_applied']))}")

    # ---- the smaller run, on the card and on the CPU ------------------------
    small_nodes = [n.to_dict() for n in sched_nodes(SERVER_SMALL["nodes"], SERVER_SMALL["dcs"])]
    small_jobs = server_jobs(SERVER_SMALL, seed=7)
    got = server_run(dev, SERVER_SMALL, small_nodes, small_jobs)
    want = server_run(cpu, SERVER_SMALL, small_nodes, small_jobs)
    for label, r in (("card", got), ("cpu", want)):
        if r["short"] or r["over"] or set(r["fallbacks"]) - {"small_eval"}:
            fail(f"server small run on the {label}: short {r['short']}, over {r['over']}, "
                 f"fallbacks {r['fallbacks']}")
    if got["placed"] != want["placed"]:
        diff = len(set(got["placed"]) ^ set(want["placed"]))
        fail(f"server small run: {diff} placements differ between the card and the CPU")
    if got["drain"] != want["drain"]:
        fail(f"server small run: drain {got['drain']} on the card, {want['drain']} on the CPU")
    log(f"server small run: {len(got['placed'])} allocs placed identically on the card and the "
        f"CPU; drain {got['drain']}; modes {got['modes']}")
    log(f"server phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, event_ms=event_ms, held=held)


#: the agent phase (phase 8): the soak's server settings, as phase 7 runs
#: them, in the networked server mode of a fresh ``python -m
#: nomad_tpu_torch agent`` process; 10,000 nodes registered over RPC, then
#: the example job through the CLI and four of phase 7's batch jobs and its
#: system job over HTTP
AGENT = dict(nodes=10_000, dcs=4, batch_jobs=4, batch_allocs=(7_500, 10_000),
             service_allocs=5_000)
#: the same phase at a size the CPU runs it in seconds (a rehearsal with
#: ``agent_phase("cpu", AGENT_SMALL)``)
AGENT_SMALL = dict(nodes=400, dcs=4, batch_jobs=4, batch_allocs=(300, 500), service_allocs=100)
#: seconds the child gets to start, to warm every kernel of its ladder,
#: to place every eval, and to exit after SIGTERM
AGENT_START_S, AGENT_WARM_S, AGENT_EVALS_S, AGENT_STOP_S = 120.0, 120.0, 600.0, 30.0
#: seconds between polls of the evals (each poll is an HTTP request the
#: agent serves beside its scheduler)
AGENT_POLL_S = 0.1
AGENT_DRAIN = 8
AGENT_HCL = """name = "agent-1"
log_level = "WARN"
server {{
  enabled = true
  num_schedulers = 2
  seed = 42
  default_scheduler = "tpu-batch"
  batch_drain = {drain}
  plan_apply_batch = 8
  heartbeat_ttl = 86400
  prewarm_kernels = true
  prewarm_drain_nodes = {nodes}
  rpc_port = {rpc}
  voters {{
    agent-1 = "127.0.0.1:{rpc}"
  }}
}}
event_broker {{
  enabled = true
  event_buffer_size = 16384
}}
"""
#: the device planes' bytes a node row: capacity and used (4 int32
#: columns each) and usable (2 float32)
PLANE_ROW_BYTES = 4 * 4 + 2 * 4 + 4 * 4


def agent_ladder(nodes: int, drain: int) -> tuple:
    """The (planner, shape) launch-ledger keys the agent's warm-up covers
    with no wavefront or paging stanza, and the count of programs it warms
    (tpu/warmup.py): the planners at every shape of the default ladder, the
    fused drain scan for ``nodes`` and a batch of ``drain`` evals, its usage
    bases (no ledger entry of their own) and the dense verify's two
    smallest row buckets."""
    from nomad_tpu_torch.tpu import warmup
    from nomad_tpu_torch.tpu.mirror import DeviceState
    from nomad_tpu_torch.tpu.problems import bucket

    keys = set()
    for n_pad, a_pad in warmup.DEFAULT_SHAPES:
        keys |= {("runs", f"N{n_pad}A{a_pad}"), ("windowed", f"N{n_pad}A{a_pad}"),
                 ("exact", f"E1G1A{a_pad}N{n_pad}")}
    n_pad, _ = warmup.bucket_shape(nodes, 1)
    e = bucket(drain)
    keys.add(("exact", f"E{e}G{e}A{bucket(drain * 4)}N{n_pad}"))
    keys |= {("verify_rows", f"N{n_pad}R{b}") for b in DeviceState._ROW_BUCKETS[:2]}
    return keys, 3 * len(warmup.DEFAULT_SHAPES) + 2 + len(DeviceState._ROW_BUCKETS[:2])


def agent_over_capacity(node_docs: list, allocs: list, asks: dict) -> int:
    """Nodes whose live allocs ask more cpu, memory or disk than the node
    has after its reservation, recomputed on the host from the node
    documents registered, the allocs listed over HTTP and each job's ask."""
    cap = {}
    for d in node_docs:
        r, res = d["node_resources"], d.get("reserved_resources") or {}

        def left(kind, key):
            return r[kind][key] - ((res.get(kind) or {}).get(key) or 0)

        cap[d["id"]] = np.array([left("cpu", "cpu_shares"), left("memory", "memory_mb"),
                                 left("disk", "disk_mb")], np.int64)
    used = {}
    for a in allocs:
        if a["DesiredStatus"] != "run" or a["ClientStatus"] in ("complete", "failed", "lost"):
            continue
        used[a["NodeID"]] = used.get(a["NodeID"], 0) + asks[a["JobID"]]
    return sum(1 for node, u in used.items() if (u > cap[node]).any())


def job_ask(doc: dict) -> np.ndarray:
    """One alloc's cpu, memory and disk ask of a one-group job document."""
    tg = doc["task_groups"][0]
    cpu = sum(t["resources"]["cpu"] for t in tg["tasks"])
    mem = sum(t["resources"]["memory_mb"] for t in tg["tasks"])
    return np.array([cpu, mem, tg["ephemeral_disk"]["size_mb"]], np.int64)


def exact_batches(api) -> list:
    """(padded lanes, real lanes) of each fused exact-scan batch the agent
    launched, from the drain.kernel_dispatch spans of its traces (a
    batch's span is recorded in the tree of every eval it planned)."""
    batches = {}
    for t in api.get("/v1/trace", limit=500)[0]["traces"]:
        for s in api.get(f"/v1/trace/{t['trace_id']}")[0]["spans"]:
            tags = s["tags"] or {}
            if s["name"] == "drain.kernel_dispatch" and tags.get("planner") == "exact":
                batches[(s["start"], tags["padded"])] = (tags["collective_rounds"],
                                                         tags["placements"])
    return list(batches.values())


def _ledger_keys(metrics: dict, flavor: str) -> dict:
    """(planner, shape) -> first-launch seconds of the flavor's entries."""
    ledger = (metrics.get("tpu_devprof") or {}).get("compile_ledger") or []
    return {(e["planner"], e["shape"]): e["compile_s"] for e in ledger
            if e["flavor"] == flavor}


def agent_phase(device: str = "cuda", size: dict = AGENT) -> dict:
    """The agent phase (module docstring, phase 8). Returns the agent
    path's launches per kernel and its numbers."""
    import importlib
    import io
    import os
    import queue
    import signal
    import socket
    import tempfile

    from nomad_tpu_torch.api import ApiClient
    from nomad_tpu_torch.jobspec import parse_job
    from nomad_tpu_torch.rpc import ConnPool
    from nomad_tpu_torch.tpu import warmup
    from nomad_tpu_torch.tpu.problems import bucket

    cli = importlib.import_module("nomad_tpu_torch.cli.main")
    flavor = "cuda" if device == "cuda" else "plain"
    root = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    out: dict = {}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        rpc_port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_agent_") as tmp:
        hcl = os.path.join(tmp, "agent.hcl")
        with open(hcl, "w") as f:
            f.write(AGENT_HCL.format(drain=AGENT_DRAIN, nodes=size["nodes"], rpc=rpc_port))
        t_spawn = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "nomad_tpu_torch", "agent", "-device", device,
             "-config", hcl, "-port", "0"],
            cwd=root, stdout=subprocess.PIPE, text=True)
        lines: queue.Queue = queue.Queue()
        reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                                  name="agent-stdout", daemon=True)
        reader.start()
        pool = ConnPool()
        try:
            # ---- start: the addresses from the start line ------------------
            start = None
            while start is None:
                try:
                    ln = lines.get(timeout=max(0.1, AGENT_START_S - (time.perf_counter() - t_spawn)))
                except queue.Empty:
                    fail(f"agent: no start line in {AGENT_START_S:.0f} s")
                start = re.search(r"http (\S+) rpc (\S+)", ln)
            http, rpc_addr = start.groups()
            out["start_s"] = time.perf_counter() - t_spawn
            api = ApiClient(address=http)
            # ---- warm-up: the ladder's count, every kernel in the ledger ------
            want, want_warmed = agent_ladder(size["nodes"], AGENT_DRAIN)
            while True:
                m0 = api.metrics()
                warmed = m0["tpu_prewarm"]["warmed"]
                if warmed is not None:
                    break
                if time.perf_counter() - t_spawn > AGENT_WARM_S:
                    fail(f"agent: the warm-up not done {AGENT_WARM_S:.0f} s after spawn")
                time.sleep(0.2)
            out["warm_s"] = time.perf_counter() - t_spawn
            have = _ledger_keys(m0, flavor)
            if warmed != want_warmed:
                warnings = api.agent_monitor(log_level="WARNING")["Entries"]
                fail(f"agent: the warm-up launched {warmed} programs, not the ladder's "
                     f"{want_warmed}; its log:\n" + "\n".join(e["message"] for e in warnings))
            if not want <= set(have):
                fail(f"agent: the warm-up left out of the ledger {sorted(want - set(have))}")
            out["warmed"] = warmed
            libs0 = {**_ledger_keys(m0, "load"), **_ledger_keys(m0, "build")}
            out["ledger_warm"] = {f"{p} {s}": sec for (p, s), sec in sorted(have.items())}
            log(f"agent: started in {out['start_s']:.1f} s (http {http}, rpc {rpc_addr}); warm "
                f"{out['warm_s']:.1f} s after spawn: {warmed} programs warmed, {len(want)} ladder "
                f"entries of {len(have)} launched, library {libs0}")
            for (planner_name, shape), sec in sorted(have.items()):
                log(f"agent: first launch {planner_name} {shape}: {sec:.4f} s")

            # ---- the cluster, over the RPC listener ------------------------
            node_docs = [n.to_dict() for n in sched_nodes(size["nodes"], size["dcs"])]
            t0 = time.perf_counter()
            for d in node_docs:
                pool.call(rpc_addr, "Node.Register", {"node": d})
            out["register_s"] = time.perf_counter() - t0
            log(f"agent: {len(node_docs)} nodes registered over RPC in {out['register_s']:.1f} s")
            launches0 = api.metrics()["tpu_launches"]

            # ---- jobs: the example job through the CLI -----------------------
            def run_cli(*argv) -> tuple:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(["-address", http, *argv])
                return rc, buf.getvalue()

            example = os.path.join(tmp, "example.nomad")
            if cli.main(["job", "init", example]) != 0:
                fail("agent: job init failed")
            t0 = time.perf_counter()
            rc, plan_out = run_cli("job", "plan", example)
            out["plan_s"] = time.perf_counter() - t0
            if rc != 0 or "1 place" not in plan_out:
                fail(f"agent: job plan exited {rc}: {plan_out}")
            log(f"agent: job plan example.nomad on {len(node_docs)} nodes in {out['plan_s']:.3f} "
                f"s: {plan_out.strip().splitlines()[-2].strip()}")
            t0 = time.perf_counter()
            rc, run_out = run_cli("job", "run", example)
            if rc != 0 or "Evaluation status: complete" not in run_out:
                fail(f"agent: job run exited {rc}: {run_out}")
            out["first_eval_s"] = time.perf_counter() - t0

            # ---- jobs: phase 7's batch jobs and system job over HTTP ---------
            batch_docs, system_doc, _ = server_jobs(size)
            with open(example) as f:
                example_doc = parse_job(f.read()).to_dict()
            docs = [example_doc, *batch_docs, system_doc]
            registered = {}
            for d in (*batch_docs, system_doc):
                t = time.perf_counter()
                registered[api.register_job(d)["EvalID"]] = t
            done = {}
            deadline = time.perf_counter() + AGENT_EVALS_S
            while len(done) < len(registered):
                for e, t in registered.items():
                    if e in done:
                        continue
                    ev = api.evaluation(e)
                    if ev["status"] == "complete":
                        done[e] = time.perf_counter() - t
                    elif ev["status"] in ("failed", "canceled"):
                        fail(f"agent: eval {e} ended {ev['status']}: {ev['status_description']}")
                if time.perf_counter() > deadline:
                    fail(f"agent: {len(registered) - len(done)} evals not complete in "
                         f"{AGENT_EVALS_S:.0f} s")
                time.sleep(AGENT_POLL_S)
            out["eval_s"] = [done[e] for e in registered]
            # the follow-up evals (the system job preempts batch allocs, as
            # in phase 7) run to their end before the checks
            t0 = time.perf_counter()
            while True:
                evs = api.evaluations()
                if all(e["status"] in ("complete", "failed", "canceled", "blocked") for e in evs):
                    break
                if time.perf_counter() - t0 > AGENT_EVALS_S:
                    fail("agent: follow-up evals not terminal")
                time.sleep(AGENT_POLL_S)
            out["follow_up_s"] = time.perf_counter() - t0
            out["evals"] = {}
            for e in evs:
                key = f"{e['triggered_by']}:{e['status']}"
                out["evals"][key] = out["evals"].get(key, 0) + 1
            failed = [e for e in evs if e["status"] in ("failed", "canceled")]
            if failed:
                fail(f"agent: evals ended {[(e['id'], e['status']) for e in failed]}")
            m1 = api.metrics()
            launches = {k: v - launches0.get(k, 0) for k, v in m1["tpu_launches"].items()}

            # ---- checks ---------------------------------------------------------
            nodes = api.get("/v1/nodes")[0]
            if sorted(n["ID"] for n in nodes) != sorted(d["id"] for d in node_docs):
                fail("agent: /v1/nodes does not list the nodes registered")
            ready = sum(1 for n in nodes if n["Status"] == "ready"
                        and n["SchedulingEligibility"] == "eligible")
            allocs = api.get("/v1/allocations")[0]
            live: dict = {}
            for a in allocs:
                if a["DesiredStatus"] == "run" and a["ClientStatus"] not in ("complete", "failed",
                                                                             "lost"):
                    live[a["JobID"]] = live.get(a["JobID"], 0) + 1
            wanted = {d["id"]: (ready if d["type"] == "system" else d["task_groups"][0]["count"])
                      for d in docs}
            short = {j: (live.get(j, 0), n) for j, n in wanted.items() if live.get(j, 0) != n}
            if short:
                fail(f"agent: jobs short of their count (live, wanted): {short}")
            over = agent_over_capacity(node_docs, allocs, {d["id"]: job_ask(d) for d in docs})
            if over:
                fail(f"agent: {over} nodes over capacity")
            have1 = _ledger_keys(m1, flavor)
            libs1 = {**_ledger_keys(m1, "load"), **_ledger_keys(m1, "build")}
            if libs1 != libs0:
                fail(f"agent: the library was built or loaded again after the warm-up: {libs1}")
            new_planners = {p for p, _ in have1} - {p for p, _ in have}
            if new_planners:
                fail(f"agent: planners first launched after the warm-up: {new_planners}")
            out["ledger_new"] = {f"{p} {s}": sec for (p, s), sec in sorted(have1.items())
                                 if (p, s) not in have}
            for key, sec in out["ledger_new"].items():
                log(f"agent: new ledger entry after the warm-up: {key}, first launch {sec:.4f} s")
            mirror = m1["tpu_mirror"]
            n_pad = warmup.bucket_shape(size["nodes"], 1)[0]
            if mirror["uploads"] < 1 or mirror["upload_bytes"] != (
                    mirror["uploads"] * n_pad * PLANE_ROW_BYTES):
                fail(f"agent: the mirror's counted upload {mirror['upload_bytes']} B is not "
                     f"{mirror['uploads']} x {n_pad} rows x {PLANE_ROW_BYTES} B")
            summ = m1["tpu_devprof"]["summary"]
            if (mirror["upload_bytes"] + mirror["refresh_bytes"]) / 1e6 > summ["h2d_mb"] + 5e-4:
                fail(f"agent: the ledger's h2d {summ['h2d_mb']} MB holds less than the mirror's "
                     f"{mirror['upload_bytes'] + mirror['refresh_bytes']} B")
            rounds = m1["tpu_devprof"]["rounds"]
            exact = rounds.get("exact") or rounds.get("wavefront")
            if not exact or not exact["placements"]:
                fail(f"agent: no exact-scan rounds in the ledger: {rounds}")
            rpp = exact["rounds"] / exact["placements"]
            # the scan takes one round a lane of its padded batch (the JAX
            # ledger counts the padded lanes too): each fused batch's rounds
            # are the bucket of its real lanes (floored at the drain's
            # padding), and the batches account for the ledger's rounds and
            # lanes; a solo exact eval pads to the bucket of its own lanes
            batches = exact_batches(api)
            padding = [(a, n) for a, n in batches if a != bucket(max(n, 4 * AGENT_DRAIN))]
            solo = (exact["dispatches"] - len(batches),
                    exact["rounds"] - sum(a for a, _ in batches),
                    exact["placements"] - sum(n for _, n in batches))
            solo_ok = (solo == (0, 0, 0) or (solo[0] == 1 and solo[1] == bucket(solo[2]))
                       or (solo[0] > 1 and 0 <= solo[1] - solo[2] < 1024 * solo[0]))
            if padding or not solo_ok:
                fail(f"agent: the exact scan's rounds {exact['rounds']} for "
                     f"{exact['placements']} lanes in {exact['dispatches']} launches are not "
                     f"its batches' padded lanes: batches (padded, real) {batches}")
            out["exact_batches"] = batches
            planner_launches = sum(launches.get(k, 0) for k in ("exact_scan", "wavefront",
                                                                "runs", "windowed"))
            missing = [k for k in ("used_bases", "scatter_rows", "verify_rows")
                       if launches.get(k, 0) < 1]
            # (the plain versions on the CPU count no launch)
            if device == "cuda" and (planner_launches < 1 or missing):
                fail(f"agent: kernels not launched by the jobs: "
                     f"{missing or ['a planner']} ({launches})")
            rc, device_out = run_cli("operator", "device")
            if rc != 0 or "compiles:" not in device_out or "exact" not in device_out:
                fail(f"agent: operator device exited {rc}: {device_out}")
            log("agent: operator device:\n" + device_out.rstrip())

            # ---- stop -----------------------------------------------------------
            t0 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=AGENT_STOP_S)
            except subprocess.TimeoutExpired:
                fail(f"agent: still running {AGENT_STOP_S:.0f} s after SIGTERM")
            out["stop_s"] = time.perf_counter() - t0
            if rc != 0:
                fail(f"agent: exited {rc} on SIGTERM")
        finally:
            pool.close()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            reader.join(timeout=5)

    stages = m1["stages"]["timers"]
    commit = stages.get("plan.raft_apply", {})
    verify = stages.get("plan.verify_device", {})
    log(f"agent: every eval complete, every job at its count ({sum(live.values())} live "
        f"allocs), no node over capacity; launches by the jobs {launches}")
    log(f"agent: example job (the first eval) {out['first_eval_s']:.3f} s through job run; "
        f"batch and system evals, registration to complete (s): "
        f"{', '.join(f'{x:.3f}' for x in out['eval_s'])}; follow-ups {out['follow_up_s']:.3f} "
        f"s; evals {out['evals']}")
    log(f"agent: ledger h2d {summ['h2d_mb']} MB / {summ['h2d_calls']} calls, d2h "
        f"{summ['d2h_mb']} MB / {summ['d2h_calls']} calls, paged tiles "
        f"{summ['paged_tile_uploads']}, rounds {summ['rounds']} for {summ['placements']} "
        f"placements (exact {exact['rounds']} / {exact['placements']} = {rpp:.4f} over "
        f"fused batches (padded, real lanes) {batches}); mirror "
        f"{mirror}; drain {m1['drain']}")
    log(f"agent: plan commit {commit.get('count', 0)} samples, "
        f"{commit.get('count', 0) * commit.get('mean_ms', 0.0):.1f} ms summed; dense verify "
        f"{verify.get('count', 0)} samples, "
        f"{verify.get('count', 0) * verify.get('mean_ms', 0.0):.1f} ms summed (the metrics' "
        f"last 512 samples a stage)")
    log(f"agent: exit 0 {out['stop_s']:.1f} s after SIGTERM; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    log(f"agent timings: {json.dumps(dict(out, launches=launches, rounds=rounds, summary=summ))}")
    return dict(launches=launches, timings=out)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    from nomad_tpu_torch.tools import runs_round_sweep, windowed_round_sweep
    from nomad_tpu_torch.tpu import _build, exact_np, kernel, paging, planner, problems, wavefront

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def phase_done(label: str) -> None:
        log(f"{label}: done {time.perf_counter() - t_start:.1f} s after the start")

    card = card_line()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"build: {lib_path} in {time.perf_counter() - t0:.1f}s")
    for line in (lib_path.parent / _build.PTXAS_LOG).read_text().splitlines():
        log(f"  {line}")

    # kernel vs plain, max abs (float outputs as bits)
    errs = {name: 0 for name in (*PLAN_EVAL_KERNELS, "wavefront", *PAGED_KERNELS)}

    phase_done("build")
    # ---- 3. kernel vs plain version on the card, mid sizes ----------------
    mid = problems.pad_cluster(problems.build_cluster(2000, 1024, seed=11), 2048)
    for label, (args, init) in (
        ("exact G=1", problems.exact_problem(mid)),
        ("exact G=8", problems.wavefront_problem(mid, n_groups=8)),
    ):
        a, s = kernel.from_numpy(args, dev), kernel.from_numpy(init, dev)
        got_state, got = kernel.plan_batch(a, s, 2000)
        torch.cuda.synchronize()
        want_state, want = kernel.plan_batch_ref(a, s, 2000)
        err = max_abs_err([(got, want), *zip(got_state, want_state)])
        if err:
            fail(f"{label}: kernel differs from the plain version (max abs err {err})")
        errs["exact_scan"] = max(errs["exact_scan"], err)
        log(f"mid {label}: N=2048 A=1024 identical, placed {int((got >= 0).sum())}")

    # the wavefront on the G=8 planes; its plain version runs on the CPU
    # from the same inputs, and both must be the exact scan's
    a_cpu, s_cpu = kernel.from_numpy(args, "cpu"), kernel.from_numpy(init, "cpu")
    for top_m in (1, 3):
        for window in (8, 32):
            wavefront.configure(max_round=window, contention_top_m=top_m)
            wf_state, wf, rounds = wavefront.plan_batch_wavefront(a, s, 2000)
            torch.cuda.synchronize()
            want_state, want, want_rounds = wavefront.plan_batch_wavefront_ref(
                a_cpu, s_cpu, 2000, window, top_m, 1)
            err = max_abs_err([(wf, want), *zip(wf_state, want_state)])
            err += abs(int(rounds) - want_rounds)
            if err:
                fail(f"wavefront W={window} M={top_m}: kernel differs from the plain version "
                     f"({err}; rounds {int(rounds)} vs {want_rounds})")
            if max_abs_err([(wf, got), *zip(wf_state, got_state)]):
                fail(f"wavefront W={window} M={top_m}: differs from the exact scan")
            errs["wavefront"] = max(errs["wavefront"], err)
            log(f"mid wavefront G=8 W={window} M={top_m}: N=2048 A=1024 identical to the plain "
                f"version and the exact scan, rounds {want_rounds}")
    wavefront.reset()

    # the paged planner under a budget of half its planes, against the flat
    # windowed kernel and the numpy oracle; every tile sweep against its
    # plain version
    seed, n_p, a_p = MID_PAGED
    case = problems.paged_case(seed, n_p, a_p, limit=4)
    paging.configure(tile_nodes=1024)
    # half the planes is under the stanza's least budget, 1 MB
    half_mb = paging.plane_bytes(n_p, 4) / 2 / (1 << 20)
    with recorded_sweeps() as sweeps, mock.patch.object(paging, "budget_mb", lambda: half_mb):
        got, rounds, stats = paging.plan_batch_paged(*case, device=dev)
    for name in PAGED_KERNELS:
        errs[name] = sweeps_err([c for c in sweeps if c[0] == name])
        if errs[name]:
            fail(f"{name}: a tile sweep differs from its plain version ({errs[name]})")
    paging.reset()
    wargs = kernel.from_numpy(dict(
        capacity=case[0], usable=case[1], feasible=case[2], perm=case[3], demand=case[4],
        group_count=np.int32(case[5]), limit=np.int32(case[6]), n_allocs=np.int32(case[7])), dev)
    flat, flat_rounds = kernel.plan_batch_windowed(wargs, *kernel.from_numpy(case[8:10], dev), n_p, a_p)
    oracle, oracle_rounds = paging.plan_windowed_np(*case)
    if not (np.array_equal(got, flat.cpu().numpy()) and rounds == int(flat_rounds)):
        fail("paged planner differs from the flat windowed kernel")
    if not (np.array_equal(got, oracle) and rounds == oracle_rounds):
        fail("paged planner differs from the numpy oracle")
    if stats["evictions"] < 1:
        fail("the mid paged run evicted no tile")
    log(f"mid paged: N={n_p} A={a_p} L=4 in {stats['tiles']} tiles of 1024, rounds {rounds}, "
        f"identical to the flat windowed kernel and the numpy oracle; "
        f"{sum(c[0] == 'tile_count' for c in sweeps)} count and "
        f"{sum(c[0] == 'tile_window' for c in sweeps)} window sweeps identical to the plain "
        f"versions; cache {stats}")
    mid = problems.pad_cluster(problems.build_cluster(4000, 8192, seed=12), 4096)
    rargs, rinit = kernel.from_numpy(problems.runs_problem(mid), dev)
    got, got_rounds = kernel.plan_batch_runs(rargs, rinit, 8192)
    torch.cuda.synchronize()
    want, want_rounds = kernel.plan_batch_runs_ref(rargs, rinit, 8192)
    err = max_abs_err([(got, want)]) + abs(int(got_rounds) - want_rounds)
    if err:
        fail(f"runs: kernel differs from the plain version ({err}; rounds "
             f"{int(got_rounds)} vs {want_rounds})")
    log(f"mid runs: N=4096 A=8192 identical, rounds {want_rounds}")
    wargs, wused, wcoll = problems.window_problem(mid, limit=LIMIT)
    wa, wu, wc = kernel.from_numpy(wargs, dev), *kernel.from_numpy((wused, wcoll), dev)
    got, got_rounds = kernel.plan_batch_windowed(wa, wu, wc, 4000, 8192)
    torch.cuda.synchronize()
    want, want_rounds = kernel.plan_batch_windowed_ref(wa, wu, wc, 4000, 8192)
    err = max_abs_err([(got, want)]) + abs(int(got_rounds) - want_rounds)
    if err:
        fail(f"windowed: kernel differs from the plain version ({err})")
    windowed_mid_ms, _ = cuda_ms(lambda: kernel.plan_batch_windowed(wa, wu, wc, 4000, 8192))
    w_valid = int(wa.n_allocs)  # the host count the planner passes
    windowed_ledger = ledger_host_us(
        lambda: kernel.plan_batch_windowed(wa, wu, wc, 4000, 8192, n_valid=w_valid))
    log(f"mid windowed: N=4096 A=8192 L={LIMIT} identical, rounds {want_rounds}, "
        f"{windowed_mid_ms:.4f} ms; wrapper call on the host {windowed_ledger['on']:.1f} us with "
        f"the device ledger (its rounds a pinned copy behind the launch), "
        f"{windowed_ledger['off']:.1f} us without it: the ledger adds "
        f"{windowed_ledger['added']:.1f} us")

    phase_done("mid sizes")
    # ---- 4. the main path at full width ------------------------------------
    cluster = problems.build_cluster(NODES, ALLOCS, n_values=VALUES, seed=0)
    spread = problems.eval_planes(*problems.exact_problem(cluster, spread=True))
    windowed = problems.eval_planes(*problems.exact_problem(cluster, spread=False))
    windowed["limits"] = np.full_like(windowed["limits"], LIMIT)
    tenants = problems.eval_planes(*problems.wavefront_problem(
        problems.build_cluster(NODES, EXACT_ALLOCS, n_values=VALUES, seed=1),
        n_groups=EXACT_GROUPS))
    evals = {"runs": spread, "windowed": windowed, "exact-scan": tenants}

    kernel.reset_launches()
    results = {mode: planner.plan_eval(planes, dev) for mode, planes in evals.items()}
    launches = path_launches(PLAN_EVAL_KERNELS)
    log(f"main path launches: {launches}")
    for mode, (_, stats) in results.items():
        if stats["mode"] != mode:
            fail(f"eval planned in mode {stats['mode']}, expected {mode}")
    for name, n in launches.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the main path")
    for mode, (placements, stats) in results.items():
        placed = check_capacity(evals[mode], placements, mode)
        log(f"main {mode}: {evals[mode]['a_real']} allocs x {evals[mode]['n_real']} nodes, "
            f"placed {placed}, rounds {stats['rounds']}, kernel {stats['kernel_s'] * 1e3:.2f} ms")

    # the wavefront route: the 8-group eval with the stanza on, counted
    wavefront.configure(enabled=True, max_round=WAVEFRONT_W, contention_top_m=WAVEFRONT_M)
    kernel.reset_launches()
    wf_placements, wf_stats = planner.plan_eval(tenants, dev)
    wf_launches = path_launches(("wavefront",))
    log(f"main path, wavefront route launches: {wf_launches}")
    if wf_stats["mode"] != "wavefront" or wf_launches["wavefront"] < 1:
        fail(f"the wavefront route planned in mode {wf_stats['mode']}, launches {wf_launches}")
    if not np.array_equal(wf_placements, results["exact-scan"][0]):
        fail("the wavefront route placed differently from the exact-scan kernel")
    samples = []
    for _ in range(3):
        t = time.perf_counter()
        _, stats = planner.plan_eval(tenants, dev)
        samples.append(((time.perf_counter() - t) * 1e3, stats["kernel_s"] * 1e3))
    wavefront.reset()
    placed = check_capacity(tenants, wf_placements, "wavefront")
    log(f"main wavefront W={WAVEFRONT_W} M={WAVEFRONT_M}: {tenants['a_real']} allocs x "
        f"{tenants['n_real']} nodes, placed {placed}, identical to the exact-scan kernel; rounds "
        f"{wf_stats['rounds']} ({wf_stats['rounds'] / tenants['a_real']:.4f} per placement); "
        f"(e2e ms, kernel ms): " + ", ".join(f"({e:.2f}, {k:.2f})" for e, k in samples))

    # the paged route: bench_paged's 1M-node eval over an 8 MB budget, counted
    pcase = problems.paged_case(PAGED_SEED, PAGED_NODES, PAGED_ALLOCS)
    paged = problems.paged_eval_planes(pcase)
    plane_bytes = paging.plane_bytes(planner.pad_planes(paged)["capacity"].shape[0], 4)
    if plane_bytes <= PAGED_BUDGET_MB << 20:
        fail(f"the paged eval's planes ({plane_bytes} bytes) fit the budget")
    paging.configure(enabled=True, device_node_budget_mb=PAGED_BUDGET_MB, tile_nodes=PAGED_TILE)
    kernel.reset_launches()
    with recorded_sweeps() as big_sweeps:
        t = time.perf_counter()
        pg_placements, pg_stats = planner.plan_eval(paged, dev)
        pg_e2e = (time.perf_counter() - t) * 1e3
    paged_launches = path_launches(PAGED_KERNELS)
    samples = []
    for _ in range(3):
        t = time.perf_counter()
        _, stats = planner.plan_eval(paged, dev)
        samples.append(((time.perf_counter() - t) * 1e3, stats["kernel_s"] * 1e3))
    paging.reset()
    log(f"main path, paged route launches: {paged_launches}")
    for name, n in paged_launches.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the paged route")
    if pg_stats["mode"] != "paged" or pg_stats["resident_peak_bytes"] > pg_stats["limit_bytes"]:
        fail(f"paged route: {pg_stats}")
    p = planner.pad_planes(paged)
    wargs, wused, wcoll = planner.window_inputs(p, dev)
    windowed_million_ms, (flat, flat_rounds) = cuda_ms(lambda: kernel.plan_batch_windowed(
        wargs, wused, wcoll, p["n_real"], p["demands"].shape[0]))
    windowed_million_shape = kernel.windowed_shape(*p["capacity"].shape, p["n_real"])
    if not (np.array_equal(pg_placements, flat[: p["a_real"]].cpu().numpy())
            and pg_stats["rounds"] == int(flat_rounds)):
        fail("the paged route differs from the flat windowed kernel on the same planes")
    log(f"flat windowed kernel on the paged eval's planes: {windowed_million_ms:.4f} ms, rounds "
        f"{int(flat_rounds)}, launch {windowed_million_shape}")
    placed = check_capacity(paged, pg_placements, "paged")
    log(f"main paged: {PAGED_ALLOCS} allocs x {PAGED_NODES} nodes, planes {plane_bytes} bytes "
        f"over a {PAGED_BUDGET_MB} MB budget, placed {placed}, rounds {pg_stats['rounds']}, "
        f"identical to the flat windowed kernel; first run e2e {pg_e2e:.2f} ms (plan_eval), "
        f"planner {pg_stats['kernel_s'] * 1e3:.2f} ms; 3 more (e2e ms, planner ms): "
        + ", ".join(f"({e:.2f}, {k:.2f})" for e, k in samples) + "; cache "
        + json.dumps({k: v for k, v in pg_stats.items()
                      if k not in ("mode", "kernel_s", "device_s", "launches", "rounds")}))

    # C1: spread past the kernels' shared memory, counted on its own
    c1_phase(dev)

    # timings of the headline eval through the entry point
    samples = []
    planner.plan_eval(spread, dev)  # warm-up
    for _ in range(3):
        t = time.perf_counter()
        _, stats = planner.plan_eval(spread, dev)
        samples.append(((time.perf_counter() - t) * 1e3, stats["kernel_s"] * 1e3))
    log("headline plan_eval 10K x 50K spread (e2e ms, kernel ms): "
        + ", ".join(f"({e:.2f}, {k:.2f})" for e, k in samples))
    windowed_e2e = windowed_round_sweep.plan_eval_samples(planner, windowed, dev)
    log(f"windowed plan_eval 10K x 50K limit {LIMIT} (e2e ms, kernel ms): "
        + ", ".join(f"({e:.2f}, {k:.2f})" for e, k in windowed_e2e))

    # parity of the fast planners against the exact-scan kernel
    for mode in ("runs", "windowed"):
        p = planner.pad_planes(evals[mode])
        args, state = planner.exact_inputs(p, dev)
        _, exact = kernel.plan_batch(args, state, p["n_real"])
        exact = exact[: p["a_real"]].cpu().numpy()
        parity = float((exact == results[mode][0]).mean())
        log(f"{mode} vs exact-scan kernel: parity {parity:.6f}")
        if parity < 0.99:
            fail(f"{mode} parity {parity} < 0.99")

    # the exact scan against the float64 host oracle on a small eval
    small = problems.build_cluster(1000, 2000, seed=3)
    sargs, sinit = problems.exact_problem(small)
    _, got = kernel.plan_batch(kernel.from_numpy(sargs, dev), kernel.from_numpy(sinit, dev), 1000)
    oracle = exact_np.plan_exact_np(
        sargs["capacity"].astype(np.int64), sargs["usable"].astype(np.float64),
        sargs["feasible"], sargs["affinity"].astype(np.float64), sargs["affinity_present"],
        sargs["group_count"].astype(np.int64), sargs["node_value"].astype(np.int64),
        sargs["spread_desired"].astype(np.float64), sargs["spread_implicit"].astype(np.float64),
        sargs["spread_weight_frac"].astype(np.float64), sargs["spread_even"],
        sargs["spread_active"], sargs["perm"][0].astype(np.int64),
        sargs["demands"].astype(np.int64), sargs["groups"].astype(np.int64),
        sargs["limits"].astype(np.int64), sinit["used"].astype(np.int64),
        sinit["collisions"].astype(np.int64), sinit["spread_counts"].astype(np.int64),
        sinit["spread_present"],
    )
    parity = float((got.cpu().numpy() == oracle).mean())
    log(f"exact-scan kernel vs float64 host oracle (1000 x 2000): parity {parity:.6f}")
    if parity < 0.99:
        fail(f"exact scan vs host oracle parity {parity} < 0.99")

    # each kernel at its main-path shape: time, device time, plain version,
    # bound
    rows, planner_us = [], {}
    p = planner.pad_planes(spread)
    rargs, rinit = planner.runs_inputs(p, dev)
    A = p["demands"].shape[0]
    ms, (got, rounds) = cuda_ms(lambda: kernel.plan_batch_runs(rargs, rinit, A))
    planner_us["runs"] = device_us(lambda: kernel.plan_batch_runs(rargs, rinit, A), calls=3)
    plain_ms, (want, want_rounds) = host_ms(lambda: kernel.plan_batch_runs_ref(rargs, rinit, A))
    errs["runs"] = max_abs_err([(got, want)]) + abs(int(rounds) - want_rounds)
    N, C = p["capacity"].shape
    rounds = int(rounds)
    rows.append(("runs", "nomad_tpu_torch/tpu/csrc/runs.cu", "nomad_tpu/tpu/kernel.py:716",
                 ms, plain_ms, nbytes(rargs, rinit, got),
                 rounds * scan_ops(N, int(p["feasible"][0].sum()) + kernel.RUNCAP, C), rounds,
                 f"N={N} A={A} V={VALUES}"))
    # its round split by clock64 stamps, from a second, stamped build
    runs_split = runs_round_sweep.split_report(_build, kernel, cuda_ms, rargs, rinit, A)
    log(f"runs round split (us a round of {runs_split['us_per_round']:.3f}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in runs_split["split_us"].items())
        + f"; {runs_split['sweep_rounds']} sweep rounds placed {runs_split['sweep_placed']}, "
        f"{runs_split['fill_rounds']} fill rounds placed {runs_split['fill_placed']}; n_acc "
        + json.dumps(runs_split["n_acc_pow2"]))

    p = planner.pad_planes(windowed)
    wargs, wused, wcoll = planner.window_inputs(p, dev)
    A, (N, C) = p["demands"].shape[0], p["capacity"].shape
    ms, (got, rounds) = cuda_ms(lambda: kernel.plan_batch_windowed(wargs, wused, wcoll, p["n_real"], A))
    planner_us["windowed"] = device_us(
        lambda: kernel.plan_batch_windowed(wargs, wused, wcoll, p["n_real"], A), calls=3)
    plain_ms, (want, want_rounds) = host_ms(
        lambda: kernel.plan_batch_windowed_ref(wargs, wused, wcoll, p["n_real"], A))
    errs["windowed"] = max_abs_err([(got, want)]) + abs(int(rounds) - want_rounds)
    rounds = int(rounds)
    rows.append(("windowed", "nomad_tpu_torch/tpu/csrc/windowed.cu",
                 "nomad_tpu/tpu/kernel.py:954", ms, plain_ms, nbytes(wargs, wused, wcoll, got),
                 rounds * scan_ops(N, int(p["feasible"][0].sum()), C), rounds,
                 f"N={N} A={A} L={LIMIT}"))
    # its round split by clock64 stamps, from a second, stamped build
    windowed_split = windowed_round_sweep.split_report(_build, kernel, wargs, wused, wcoll,
                                                       p["n_real"], A)
    windowed_split["launch"] = kernel.windowed_shape(N, C, p["n_real"])
    log(f"windowed round split (us a round of {windowed_split['us_per_round']:.3f}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in windowed_split["split_us"].items())
        + f"; launch {windowed_split['launch']}")

    p = planner.pad_planes(tenants)
    bargs, bstate = planner.exact_inputs(p, dev)
    A, (N, C) = p["demands"].shape[0], p["capacity"].shape
    ms, (got_state, got) = cuda_ms(lambda: kernel.plan_batch(bargs, bstate, p["n_real"]))
    planner_us["exact_scan"] = device_us(lambda: kernel.plan_batch(bargs, bstate, p["n_real"]),
                                         calls=3)
    plain_ms, (want_state, want) = host_ms(lambda: kernel.plan_batch_ref(bargs, bstate, p["n_real"]))
    errs["exact_scan"] = max(errs["exact_scan"],
                             max_abs_err([(got, want), *zip(got_state, want_state)]))
    scan_pos = scan_positions(bargs, bstate, p["n_real"])
    scan_pos["walked"] = scan_walked(bargs, bstate, p["n_real"], scan_pos["needed"])
    scan_moved, scan_work = scan_bound(scan_pos, bargs, bstate, C)
    rows.append(("exact_scan", "nomad_tpu_torch/tpu/csrc/exact_scan.cu",
                 "nomad_tpu/tpu/kernel.py:361", ms, plain_ms, scan_moved, scan_work, p["a_real"],
                 f"N={N} A={A} G={EXACT_GROUPS}, {scan_pos['needed']} ring positions needed, "
                 f"{scan_pos['walked']} walked"))

    # the wavefront at the same shape; its plain version runs on the card
    wavefront.configure(max_round=WAVEFRONT_W, contention_top_m=WAVEFRONT_M)

    def wavefront_kernel():
        return wavefront.plan_batch_wavefront(bargs, bstate, p["n_real"])

    ms, (wf_state, wf, wf_rounds) = cuda_ms(wavefront_kernel)
    planner_us["wavefront"] = device_us(wavefront_kernel, calls=3)
    plain_ms, (pw_state, pw, pw_rounds) = host_ms(lambda: wavefront.plan_batch_wavefront_ref(
        bargs, bstate, p["n_real"], WAVEFRONT_W, WAVEFRONT_M, 1))
    wf_walk = wavefront_walk("multi-tenant", bargs, bstate, p["n_real"], scan_pos, plain=False)
    wavefront.reset()
    errs["wavefront"] = max(errs["wavefront"], max_abs_err([(wf, pw), *zip(wf_state, pw_state)])
                            + abs(int(wf_rounds) - pw_rounds))
    if max_abs_err([(wf, got), *zip(wf_state, got_state)]):
        fail("wavefront: differs from the exact scan at the main-path shape")
    wf_rounds = int(wf_rounds)
    # the work the result needs: one selection per real lane, as the exact
    # scan (a blocked lane's selection is never read: the conflict rule
    # tests the earlier lanes' candidates against the later lane's group),
    # plus the conflict tests, counted as at most W - 1 earlier lanes' M
    # candidates and eval for each committed lane and one blocked lane a
    # round. The kernel itself selects W lanes a round.
    conflict_ops = (p["a_real"] + wf_rounds) * (WAVEFRONT_W - 1) * (WAVEFRONT_M + 1)
    wf_row = ("wavefront", "nomad_tpu_torch/tpu/csrc/wavefront.cu",
              "nomad_tpu/tpu/wavefront.py:300", ms, plain_ms,
              nbytes(bargs, bstate, wf, wf_state), scan_work + conflict_ops, wf_rounds,
              f"N={N} A={A} G={EXACT_GROUPS} W={WAVEFRONT_W} M={WAVEFRONT_M}, "
              f"{wf_rounds * WAVEFRONT_W} lane selections for {p['a_real']} placements")

    # the tile sweeps on the first tile of the paged eval's first round
    _, cargs, _ = next(c for c in big_sweeps if c[0] == "tile_count")
    _, targs, _ = next(c for c in big_sweeps if c[0] == "tile_window")
    cap, feas, used, demand, t0_c, off_c, n_real_c = cargs
    T, C = cap.shape
    pos = t0_c + torch.arange(T, dtype=torch.int32, device=dev)

    # the call the paged drive makes a tile: its launcher, checked once an eval
    tile_counts = torch.full((1, 2), -1, dtype=torch.int32, device=dev)
    count_tile = paging._tile_counter(cap, feas, used, demand, tile_counts)

    def count_kernel():
        count_tile(0, cap, feas, used, t0_c, off_c, n_real_c)
        return tile_counts[0]

    def count_library():  # a mask and two sums
        fit = feas & (used + demand[None, :] <= cap).all(dim=1) & (pos < n_real_c)
        return torch.stack([fit.sum(dtype=torch.int32), (fit & (pos < off_c)).sum(dtype=torch.int32)])

    ms, got_c = cuda_ms(count_kernel)
    plain_ms, want_c = cuda_ms(lambda: paging.tile_count_ref(*cargs))
    lib_ms, lib_c = cuda_ms(count_library)
    errs["tile_count"] = max(errs["tile_count"], max_abs_err(
        [(got_c, want_c), (got_c, lib_c), (paging.tile_count(*cargs), want_c)]))
    n_fit = int(want_c[0])
    count_public_us = wrapper_host_us(lambda: paging.tile_count(*cargs))
    sweep_rows = [("tile_count", "nomad_tpu_torch/tpu/csrc/paging.cu",
                   "nomad_tpu/tpu/paging.py:344", ms, plain_ms, lib_ms,
                   (device_us(count_kernel), device_us(count_library),
                    wrapper_host_us(count_kernel)),
                   nbytes(cap, feas, used, demand) + 8, T * C * FIT_OPS_PER_COL + 2 * T,
                   I32_OPS_PER_S, f"T={T} C={C} ({n_fit} feasible)")]

    def window_kernel():
        return paging.tile_window(*targs)

    # the library composition: the segmented max / min alone (scatter_reduce
    # amax and amin with their gathers) on the rows' scores and segments
    seg_in = paging._tile_segments(*targs[:5], targs[6], *targs[7:])[:4]

    def window_library():
        return paging._segment_winners(*seg_in, targs[5])

    ms, got_w = cuda_ms(window_kernel)
    plain_ms, want_w = cuda_ms(lambda: paging.tile_window_ref(*targs))
    lib_ms, lib_w = cuda_ms(window_library)
    errs["tile_window"] = max(errs["tile_window"], max_abs_err(zip(got_w, want_w))
                              + max_abs_err(zip(got_w[1:4], lib_w)))
    sweep_rows.append(("tile_window", "nomad_tpu_torch/tpu/csrc/paging.cu",
                       "nomad_tpu/tpu/paging.py:358", ms, plain_ms, lib_ms,
                       (device_us(window_kernel), device_us(window_library),
                        wrapper_host_us(window_kernel)),
                       nbytes(*targs[:7]) + 8 + 3 * (2 * T + 1) * 4 + 4,
                       T * C * FIT_OPS_PER_COL + n_fit * SCORE_OPS, F32_OPS_PER_S,
                       f"T={T} C={C} ({n_fit} feasible), window sweep of round 1"))

    for name, err in errs.items():
        if err:
            fail(f"{name}: kernel differs from its plain version at the main-path shape ({err})")

    kernels = []
    for name, source, replaces, ms, plain_ms, moved, ops, rounds, shape in (*rows, wf_row):
        bound_ms, bound_by = bound(moved, ops)
        paths = ({"plan_eval_wavefront": wf_launches[name]} if name == "wavefront"
                 else {"plan_eval": launches[name]})
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, max_abs_err=errs[name],
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            device_us=planner_us[name], rounds=rounds, shape=shape,
            paths=paths,
        ))
        us = planner_us[name]
        log(f"{name}: {ms:.3f} ms per launch (plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
            f"by {bound_by}), on the card by the profiler "
            + ("not measured" if us is None else f"{us:.1f} us") + f", rounds {rounds}, {shape}")
    next(row for row in kernels if row["name"] == "runs").update(
        {k: runs_split[k] for k in ("us_per_round", "split_us", "sweep_rounds", "fill_rounds",
                                    "sweep_placed", "fill_placed", "n_acc_pow2")})
    next(row for row in kernels if row["name"] == "windowed").update(
        us_per_round=windowed_split["us_per_round"], split_us=windowed_split["split_us"],
        launch=windowed_split["launch"], mid_ms=windowed_mid_ms,
        mid_ledger_host_us=windowed_ledger,
        million_ms=windowed_million_ms, million_launch=windowed_million_shape,
        plan_eval_ms=windowed_e2e)
    scan_row = next(row for row in kernels if row["name"] == "exact_scan")
    scan_row.update(positions_needed=scan_pos["needed"], positions_walked=scan_pos["walked"])
    wf_json = next(row for row in kernels if row["name"] == "wavefront")
    wf_json.update({k: wf_walk[k] for k in ("us_per_round", "q", "clusters", "positions_needed",
                                            "positions_walked")})
    for (name, source, replaces, ms, plain_ms, lib_ms, dev_us, moved, ops, rate,
         shape) in sweep_rows:
        bound_ms, bound_by = bound(moved, ops, rate)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, max_abs_err=errs[name],
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
            device_us=dev_us[0], library_device_us=dev_us[1], host_us=dev_us[2], shape=shape,
            paths={"plan_eval_paged": paged_launches[name]},
        ))
        public = ""
        if name == "tile_count":  # the drive's call above; the public wrapper's beside it
            kernels[-1]["public_host_us"] = count_public_us
            public = f" (the paged drive's; public wrapper {count_public_us:.1f} us)"
        us = ["not measured" if u is None else f"{u:.2f} us" for u in dev_us[:2]]
        log(f"{name}: {ms:.4f} ms per launch (plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
            f"bound {bound_ms:.5f} ms by {bound_by}); on the card by the profiler {us[0]}, "
            f"library {us[1]}; wrapper call on the host {dev_us[2]:.1f} us{public}; {shape}")

    primitives = primitive_rows(dev, spread)

    phase_done("main path at full width")
    # ---- 5. the server path -------------------------------------------------
    server_launches, server_wf_launches, server_rows, scan_bench, wf_drain = server_path(dev)
    next(row for row in kernels if row["name"] == "exact_scan")["drain_bench"] = scan_bench
    wf_json.update(wf_drain)
    for row in server_rows:
        row["paths"] = {}
        kernels.append(row)
    for row in kernels:
        name = row["name"]
        if name in server_launches:
            row["paths"]["server"] = server_launches[name]
        if name in server_wf_launches:
            row["paths"]["server_wavefront"] = server_wf_launches[name]
        row["launches"] = sum(row["paths"].values())
    phase_done("server path")
    # ---- 6. the scheduler front ---------------------------------------------
    sched_launches, sched_timings = scheduler_phase(dev)
    for row in kernels:
        if row["name"] in sched_launches:
            row["paths"]["scheduler"] = sched_launches[row["name"]]
            row["launches"] = sum(row["paths"].values())
    log(f"scheduler timings: {json.dumps(sched_timings)}")
    phase_done("scheduler front")
    # ---- 7. the server ------------------------------------------------------
    server_run_out = server_phase(dev)
    for row in kernels:
        name = row["name"]
        if name in server_run_out["launches"] and server_run_out["launches"][name]:
            row["paths"]["server_run"] = server_run_out["launches"][name]
            row["launches"] = sum(row["paths"].values())
            row["server_run_event_ms"] = server_run_out["event_ms"].get(name, [])
        if name in server_run_out["held"]:
            row["server_run_held"] = server_run_out["held"][name]
            row["max_abs_err"] = max(row["max_abs_err"], server_run_out["held"][name]["max_abs_err"])
    phase_done("server")
    # ---- 8. the agent -------------------------------------------------------
    agent = agent_phase("cuda")
    for row in kernels:
        if agent["launches"].get(row["name"]):
            row["paths"]["agent"] = agent["launches"][row["name"]]
            row["launches"] = sum(row["paths"].values())
    for name in PRIMITIVES:
        PRIMITIVES_ON_PATH[name] += agent["launches"].get(name, 0)
    # K1-K4's own kernels are not launched on the paths: the primitives run
    # inside every launch of the kernels that inline them
    launched = {row["name"]: row["launches"] for row in kernels}
    for row in primitives:
        row["launches"] = PRIMITIVES_ON_PATH[row["name"]]
        row["inlined_launches"] = sum(launched[k] for k in row["inlined_in"])
        row["paths"] = {"inlined": {k: launched[k] for k in row["inlined_in"]}}
    kernels = primitives + kernels
    phase_done("agent")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
