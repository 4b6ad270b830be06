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
ladder covers every cluster size that rounds into it. Under a mesh
(``tpu/shard.py``) the example inputs are placed through the runtime's
spec trees (``shard.put``), so the sharded kernels warm at the shapes and
splits the runtime launches: the flat planners, the wavefront
(``shard.wavefront_specs()``) and the paged sweeps on a tile of
``paging.tile_rows(mesh)`` rows split by ``shard.paged_specs()``.
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


def _expand(shapes, mesh) -> list:
    """(n_pad, a_pad, mesh or None) for each shape, as the JAX prewarm
    expands them: the runtime's gate tests the REAL node count, and the
    real counts that bucket into ``n_pad`` may lie on both sides of
    ``MIN_NODES``, so such a bucket warms both flavors; a sharded shape
    re-rounds to a mesh multiple (``shard.node_bucket``)."""
    from . import shard as _shard

    expanded = []
    for n_pad, a_pad in shapes:
        if mesh is None or n_pad < _shard.MIN_NODES:
            expanded.append((n_pad, a_pad, None))
            continue
        expanded.append((_shard.node_bucket(n_pad, mesh), a_pad, mesh))
        prev_bucket = n_pad - 1024 if n_pad > 1024 else n_pad // 2
        if prev_bucket < _shard.MIN_NODES:
            expanded.append((n_pad, a_pad, None))
    return expanded


def _placed(tree, specs, mesh):
    """``tree`` placed over ``mesh`` by ``specs`` (as it is without one)."""
    from . import shard as _shard

    return tree if mesh is None else _shard.put(tree, specs, mesh)


def prewarm(shapes=DEFAULT_SHAPES, v_values: int = DEFAULT_V, device=None, mesh=None) -> int:
    """Launch the planners once for each (node_bucket, alloc_bucket) shape
    on ``device`` (CUDA unless the caller asks for the CPU); returns the
    number of programs warmed, one per program the JAX function compiles
    for the same shapes and stanzas. A failure must never take the agent
    down: it is logged at warning level with its exception and the count
    falls short. With ``mesh``, shapes at or past ``shard.MIN_NODES`` warm
    the sharded kernels over it (node buckets already rounded through
    ``bucket_shape(..., mesh=mesh)``)."""
    import torch

    from .. import resolve_device
    from ..debug import devprof as _devprof
    from . import paging as _paging
    from . import shard as _shard
    from . import wavefront as _wavefront
    from .kernel import (
        RunArgs,
        WindowArgs,
        plan_batch,
        plan_batch_runs,
        plan_batch_windowed,
    )

    dev = resolve_device(device)
    if mesh is not None and mesh.device.type != dev.type:
        raise ValueError(f"a mesh on {mesh.device} for a warm-up on {dev}")
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    compiled = 0
    with _devprof.warming():
        for n_pad, a_pad, shape_mesh in _expand(shapes, mesh):
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
                raspec, rispec = _shard.run_specs()
                plan_batch_runs(_placed(rargs, raspec, shape_mesh),
                                _placed(rinit, rispec, shape_mesh), a_pad, False, n_valid=1)
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
                waspec, wispec = _shard.window_specs()
                wused0, wcoll0 = _placed((used0, coll0), wispec, shape_mesh)
                plan_batch_windowed(_placed(wargs, waspec, shape_mesh), wused0, wcoll0, n_pad,
                                    a_pad, n_valid=1)
                _sync(torch, dev)
                compiled += 1

                bargs, binit = _batch_inputs(torch, n_pad, 1, 1, a_pad, V, n_pad, n_pad, dev)
                baspec, bsspec = _shard.batch_specs()
                bargs, binit = _placed(bargs, baspec, shape_mesh), _placed(binit, bsspec,
                                                                           shape_mesh)
                plan_batch(bargs, binit, n_pad)
                _sync(torch, dev)
                compiled += 1

                # the wavefront drive shares the exact scan's planes (and
                # wavefront_specs() is batch_specs()), so its ladder entry
                # reuses the example trees just placed
                if _wavefront.enabled():
                    _wavefront.plan_batch_wavefront(bargs, binit, n_pad)
                    _sync(torch, dev)
                    compiled += 1
            except Exception:
                _failed("the planners", (n_pad, a_pad))
                continue
        # the paged planner's tile sweeps launch per TILE shape, not per
        # cluster shape — one (count, window) pair covers every node axis
        # the pager streams; under a mesh the tile is split over it
        if _paging.enabled():
            try:
                tn = _paging.tile_rows(mesh)
                sspec, dspec = _shard.paged_specs()
                cap_t, usable_t, feas_t, nodes_t = _placed(
                    (torch.ones((tn, 4), **i32), torch.ones((tn, 2), **f32),
                     torch.ones(tn, **b8), torch.arange(tn, **i32)), sspec, mesh)
                used_t, coll_t = _placed((torch.zeros((tn, 4), **i32), torch.zeros(tn, **i32)),
                                         dspec, mesh)
                demand_t = torch.ones(4, **i32)
                counts = torch.empty((1, 2), **i32)
                ckey, wkey = _paging.sweep_keys(tn, _shard.mesh_size(mesh))
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


def prewarm_drain(n_nodes: int, batch: int, v_values: int = 8, device=None,
                  mesh=None) -> int:
    """Launch the FUSED drain-batch shapes for a (cluster size, drain
    size) pair: the multi-eval scan plus the per-eval usage bases the
    collector launches alongside it (drain.batch_shape's paddings), then
    the applier's dense verify at its two smallest row buckets and the
    mirror's dirty-row scatter at its smallest (which the JAX ladder
    leaves to the first refresh, so it is not counted). Returns programs
    warmed; failures are logged and short the count like ``prewarm``.
    With ``mesh`` the launches are the sharded kernels, on planes split as
    the collector and the mirror split them, unless ``n_nodes`` is below
    ``shard.MIN_NODES``: the runtime's gate, under which it warms
    unsharded."""
    import torch

    from .. import resolve_device
    from ..debug import devprof as _devprof
    from . import shard as _shard
    from . import wavefront as _wavefront
    from .drain import used_bases
    from .kernel import plan_batch, verify_rows
    from .mirror import DeviceState, scatter_rows

    dev = resolve_device(device)
    if mesh is not None and n_nodes < _shard.MIN_NODES:
        mesh = None  # the runtime gate: small clusters launch unsharded
    if mesh is not None and mesh.device.type != dev.type:
        raise ValueError(f"a mesh on {mesh.device} for a warm-up on {dev}")
    N = _shard.node_bucket(n_nodes, mesh)
    E = _bucket(batch)
    G = _bucket(batch)
    A = _bucket(batch * 4)
    V = _bucket(max(v_values, 8))
    compiled = 0
    with _devprof.warming():
        args = init = None
        try:
            args, init = _batch_inputs(torch, N, G, E, A, V, n_nodes, 2, dev)
            aspec, sspec = _shard.batch_specs()
            args, init = _placed(args, aspec, mesh), _placed(init, sspec, mesh)
            _, placements = plan_batch(args, init, n_nodes)
            _sync(torch, dev)
            compiled += 1
            eval_of = torch.zeros(A, dtype=torch.int32, device=dev)
            used_bases(init.used, placements, args.demands, eval_of, E, n_nodes)
            _sync(torch, dev)
            compiled += 1
        except Exception:
            _failed("the drain batch", (N, batch))
        if _wavefront.enabled() and args is not None:
            try:
                _wavefront.plan_batch_wavefront(args, init, n_nodes)
                _sync(torch, dev)
                compiled += 1
            except Exception:
                _failed("the wavefront drain batch", (N, batch))
        # the plan applier's dense device verify rides the same (N-padded)
        # committed planes: warm its small row-bucket shapes so the first
        # big plan after startup doesn't pay a first launch inside the
        # apply loop
        try:
            cap_w, used_w = _placed((torch.ones((N, 4), dtype=torch.int32, device=dev),
                                     torch.zeros((N, 4), dtype=torch.int32, device=dev)),
                                    (_shard.ROWS, _shard.ROWS), mesh)
            for b in DeviceState._ROW_BUCKETS[:2]:
                verify_rows(cap_w, used_w, torch.zeros(b, dtype=torch.int32, device=dev),
                            torch.zeros((b, 4), dtype=torch.int32, device=dev))
                _sync(torch, dev)
                compiled += 1
            b = DeviceState._ROW_BUCKETS[0]
            scatter_rows(used_w, torch.zeros(b, dtype=torch.int32, device=dev),
                         torch.zeros((b, 4), dtype=torch.int32, device=dev))
            _sync(torch, dev)
        except Exception:
            _failed("the dense verify and the dirty-row scatter", N)
    return compiled


def prewarm_async(shapes=DEFAULT_SHAPES, drain: tuple = None, device=None,
                  mesh=None) -> threading.Thread:
    """Fire-and-forget prewarm on ``device``; returns the daemon thread.
    ``drain`` optionally adds the fused (n_nodes, batch) drain shapes;
    ``mesh`` warms the shapes past the mesh's gate sharded. The thread's
    ``warmed`` is None until the ladder ends, then the programs warmed
    (``prewarm`` plus ``prewarm_drain``), so a failed launch shows as a
    short count to whoever reads it (``GET /v1/metrics``)."""

    def run():
        warmed = prewarm(shapes, device=device, mesh=mesh)
        if drain is not None:
            warmed += prewarm_drain(*drain, device=device, mesh=mesh)
        t.warmed = warmed

    t = threading.Thread(target=run, name="tpu-prewarm", daemon=True)
    t.warmed = None
    t.start()
    return t
