"""Kernel prewarm: launch the planner shape ladder before the first eval.

The port's copy of ``nomad_tpu/tpu/warmup.py``. Where the JAX package
lowers and compiles each planner program for the configured (nodes,
allocs) buckets, the port launches each hand-written kernel once at that
shape on ``device``: the first launch of a kernel in a process pays the
library's load, the lazy module load, the kernel attributes and the
scratch allocation, and the device ledger (``debug/devprof.py``) records
it as that ``(planner, shape)``'s compile event. ``prewarm_async`` runs
the ladder in a daemon thread at agent start, so real evals arrive to
warm kernels.

The example inputs place one alloc (the JAX ladder builds ``n_allocs=1``),
so a launch costs about one round; the warm-up's transfers and rounds move
no ledger counter (``devprof.warming``), as the JAX warm-up compiles
without dispatching.

Shapes must match production exactly to hit: the batch scheduler and the
drain collector bucket the node and alloc axes (``problems.bucket``, the
port's copy of the JAX scheduler's ``_bucket``), so warming the bucket
ladder covers every cluster size that rounds into it.
"""

from __future__ import annotations

import logging
import threading

from .problems import bucket as _bucket

logger = logging.getLogger("nomad_tpu.tpu.warmup")


def bucket_shape(n_nodes: int, n_allocs: int, mesh=None) -> tuple[int, int]:
    """The exact padded shape production hits for a real (nodes, allocs)
    pair — computed through the ONE bucketing policy (problems.bucket;
    shard.node_bucket for the node axis when a mesh is given) so the
    prewarm ladder can never drift from the scheduler."""
    from .shard import node_bucket

    return node_bucket(n_nodes, mesh), _bucket(n_allocs)


#: default ladder: dev/CI clusters and the 10K-node / 50K-alloc headline,
#: expressed as the REAL cluster sizes and bucketed through production's
#: padding policy
DEFAULT_SIZES = ((100, 100), (1000, 1000), (10000, 50000))
DEFAULT_SHAPES = tuple(bucket_shape(n, a) for n, a in DEFAULT_SIZES)
#: spread value-table width launched for (datacenter-style spreads)
DEFAULT_V = 4


def _failed(what: str, shape) -> None:
    logger.warning("prewarm of %s at %s failed; the count falls short", what, shape,
                   exc_info=True)


def _batch_inputs(torch, N: int, G: int, E: int, A: int, V: int, ring: int, limit: int, dev):
    """(BatchArgs, BatchState) of a fused scan over N nodes with one valid
    lane: every group in eval 0, feasible everywhere, demand 1."""
    from .kernel import BatchArgs, BatchState

    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    valid = torch.zeros(A, **b8)
    valid[0] = True
    args = BatchArgs(
        capacity=torch.ones((N, 4), **i32),
        usable=torch.ones((N, 2), **f32),
        feasible=torch.ones((G, N), **b8),
        affinity=torch.zeros((G, N), **f32),
        affinity_present=torch.zeros((G, N), **b8),
        group_count=torch.ones(G, **i32),
        group_eval=torch.zeros(G, **i32),
        node_value=torch.full((G, N), -1, **i32),
        spread_desired=torch.full((G, V), -1.0, **f32),
        spread_implicit=torch.full((G,), -1.0, **f32),
        spread_weight_frac=torch.zeros(G, **f32),
        spread_even=torch.zeros(G, **b8),
        spread_active=torch.zeros(G, **b8),
        perm=torch.arange(N, **i32).repeat(E, 1),
        ring=torch.full((E,), ring, **i32),
        demands=torch.ones((A, 4), **i32),
        groups=torch.zeros(A, **i32),
        limits=torch.full((A,), limit, **i32),
        valid=valid,
    )
    init = BatchState(
        used=torch.zeros((N, 4), **i32),
        collisions=torch.zeros((G, N), **i32),
        spread_counts=torch.zeros((G, V), **i32),
        spread_present=torch.zeros((G, V), **b8),
        offset=torch.zeros(E, **i32),
    )
    return args, init


def _sync(torch, dev) -> None:
    """Wait for the launches, so an error on the card surfaces here."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prewarm(shapes=DEFAULT_SHAPES, v_values: int = DEFAULT_V, device=None) -> int:
    """Launch the planners once for each (node_bucket, alloc_bucket) shape
    on ``device`` (CUDA unless the caller asks for the CPU); returns the
    number of programs warmed, one per program the JAX function compiles
    for the same shapes and stanzas. A failure must never take the agent
    down: it is logged at warning level with its exception and the count
    falls short."""
    import torch

    from .. import resolve_device
    from ..debug import devprof as _devprof
    from . import paging as _paging
    from . import wavefront as _wavefront
    from .kernel import (
        RunArgs,
        WindowArgs,
        plan_batch,
        plan_batch_runs,
        plan_batch_windowed,
    )

    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    compiled = 0
    with _devprof.warming():
        for n_pad, a_pad in shapes:
            V = v_values
            try:
                capacity = torch.ones((n_pad, 4), **i32)
                usable = torch.ones((n_pad, 2), **f32)
                feas = torch.ones(n_pad, **b8)
                perm = torch.arange(n_pad, **i32)
                demand = torch.ones(4, **i32)
                used0 = torch.zeros((n_pad, 4), **i32)
                coll0 = torch.zeros(n_pad, **i32)

                rargs = RunArgs(
                    capacity=capacity,
                    usable=usable,
                    feasible=feas,
                    affinity=torch.zeros(n_pad, **f32),
                    affinity_present=torch.zeros(n_pad, **b8),
                    group_count=torch.tensor(1, **i32),
                    node_value=torch.zeros(n_pad, **i32),
                    spread_desired=torch.full((V,), -1.0, **f32),
                    spread_implicit=torch.tensor(-1.0, **f32),
                    spread_weight_frac=torch.tensor(1.0, **f32),
                    spread_even=torch.tensor(False, **b8),
                    spread_active=torch.tensor(True, **b8),
                    perm=perm,
                    demand=demand,
                    n_allocs=torch.tensor(1, **i32),
                )
                rinit = (used0, coll0, torch.zeros(V, **i32), torch.zeros(V, **b8))
                plan_batch_runs(rargs, rinit, a_pad, False, n_valid=1)
                _sync(torch, dev)
                compiled += 1

                wargs = WindowArgs(
                    capacity=capacity,
                    usable=usable,
                    feasible=feas,
                    perm=perm,
                    demand=demand,
                    group_count=torch.tensor(1, **i32),
                    limit=torch.tensor(2, **i32),
                    n_allocs=torch.tensor(1, **i32),
                )
                plan_batch_windowed(wargs, used0, coll0, n_pad, a_pad, n_valid=1)
                _sync(torch, dev)
                compiled += 1

                bargs, binit = _batch_inputs(torch, n_pad, 1, 1, a_pad, V, n_pad, n_pad, dev)
                plan_batch(bargs, binit, n_pad)
                _sync(torch, dev)
                compiled += 1

                # the wavefront drive shares the exact scan's planes, so
                # its ladder entry reuses the example trees just built
                if _wavefront.enabled():
                    _wavefront.plan_batch_wavefront(bargs, binit, n_pad)
                    _sync(torch, dev)
                    compiled += 1
            except Exception:
                _failed("the planners", (n_pad, a_pad))
                continue
        # the paged planner's tile sweeps launch per TILE shape, not per
        # cluster shape — one (count, window) pair covers every node axis
        # the pager streams
        if _paging.enabled():
            try:
                tn = _paging.tile_rows()
                cap_t = torch.ones((tn, 4), **i32)
                usable_t = torch.ones((tn, 2), **f32)
                feas_t = torch.ones(tn, **b8)
                used_t = torch.zeros((tn, 4), **i32)
                coll_t = torch.zeros(tn, **i32)
                nodes_t = torch.arange(tn, **i32)
                demand_t = torch.ones(4, **i32)
                counts = torch.empty((1, 2), **i32)
                ckey, wkey = _paging.sweep_keys(tn)
                _paging.count_sweep(cap_t, feas_t, used_t, demand_t, counts, 0, tn, ckey)
                _sync(torch, dev)
                compiled += 1
                _paging.window_sweep(cap_t, usable_t, feas_t, used_t, coll_t, nodes_t, demand_t,
                                     1, 2, 0, 0, tn, 0, 0, 1, 1, wkey)
                _sync(torch, dev)
                compiled += 1
            except Exception:
                _failed("the paged sweeps", "one tile")
    return compiled


def prewarm_drain(n_nodes: int, batch: int, v_values: int = 8, device=None) -> int:
    """Launch the FUSED drain-batch shapes for a (cluster size, drain
    size) pair: the multi-eval scan plus the per-eval usage bases the
    collector launches alongside it (drain.batch_shape's paddings), then
    the applier's dense verify at its two smallest row buckets. Returns
    programs warmed; failures are logged and short the count like
    ``prewarm``."""
    import torch

    from .. import resolve_device
    from ..debug import devprof as _devprof
    from . import shard as _shard
    from . import wavefront as _wavefront
    from .drain import used_bases
    from .kernel import plan_batch, verify_rows
    from .mirror import DeviceState

    dev = resolve_device(device)
    _shard.refuse_under_mesh("the drain warm-up under a mesh", n_nodes)
    N = _bucket(n_nodes)
    E = _bucket(batch)
    G = _bucket(batch)
    A = _bucket(batch * 4)
    V = _bucket(max(v_values, 8))
    compiled = 0
    with _devprof.warming():
        try:
            args, init = _batch_inputs(torch, N, G, E, A, V, n_nodes, 2, dev)
            _, placements = plan_batch(args, init, n_nodes)
            _sync(torch, dev)
            compiled += 1
            if _wavefront.enabled():
                _, placements, _ = _wavefront.plan_batch_wavefront(args, init, n_nodes)
                _sync(torch, dev)
                compiled += 1
            eval_of = torch.zeros(A, dtype=torch.int32, device=dev)
            used_bases(init.used, placements, args.demands, eval_of, E, n_nodes)
            _sync(torch, dev)
            compiled += 1
        except Exception:
            _failed("the drain batch", (N, batch))
        # the plan applier's dense device verify rides the same (N-padded)
        # committed planes: warm its small row-bucket shapes so the first
        # big plan after startup doesn't pay a first launch inside the
        # apply loop
        try:
            cap_w = torch.ones((N, 4), dtype=torch.int32, device=dev)
            used_w = torch.zeros((N, 4), dtype=torch.int32, device=dev)
            for b in DeviceState._ROW_BUCKETS[:2]:
                verify_rows(cap_w, used_w, torch.zeros(b, dtype=torch.int32, device=dev),
                            torch.zeros((b, 4), dtype=torch.int32, device=dev))
                _sync(torch, dev)
                compiled += 1
        except Exception:
            _failed("the dense verify", N)
    return compiled


def prewarm_async(shapes=DEFAULT_SHAPES, drain: tuple = None, device=None) -> threading.Thread:
    """Fire-and-forget prewarm on ``device``; returns the daemon thread.
    ``drain`` optionally adds the fused (n_nodes, batch) drain shapes. The
    thread's ``warmed`` is None until the ladder ends, then the programs
    warmed (``prewarm`` plus ``prewarm_drain``), so a failed launch shows
    as a short count to whoever reads it (``GET /v1/metrics``)."""

    def run():
        warmed = prewarm(shapes, device=device)
        if drain is not None:
            warmed += prewarm_drain(*drain, device=device)
        t.warmed = warmed

    t = threading.Thread(target=run, name="tpu-prewarm", daemon=True)
    t.warmed = None
    t.start()
    return t
