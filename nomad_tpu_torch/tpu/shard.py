"""The mesh: the planner node axis split into shards.

The port's copy of ``nomad_tpu/tpu/shard.py``. The node axis is the
framework's scale axis (clusters grow in nodes, not resource columns), so
it is the ONE axis partitioned across the mesh: every planner's
capacity/usable/used planes split by node rows, the per-group
feasibility/affinity/value planes split by node columns, and the small
per-group / per-alloc tables replicate. Where the JAX package lets GSPMD
insert the collectives for the cross-shard reductions (the argmax over
candidate scores, the spread-count updates, the fit all-reduce), the
port's sharded kernels (``csrc/mesh.cu``, collectives in ``csrc/mesh.cuh``)
and their plain versions (``kernel.plan_batch_sharded_ref`` and its two
siblings) write them by hand: a local stage over each shard's slab, then
an S-wide finish. ``tests/test_torch_shard.py`` pins sharded == unsharded
placements value for value.

What differs from the JAX module, at the device seams only:

- :class:`Mesh` is the port's own: S shards, the device they live on and
  the contiguous row range of each shard. ``configure(n, device=...)``
  builds S shards on that one device (the counterpart of the JAX
  package's forced host device count); without ``device`` it counts the
  visible CUDA cards as the JAX package counts devices, and a mesh whose
  shards would fall on more than one card raises (ROADMAP A12c);
- the spec trees' leaves are the port's markers :data:`ROWS` (JAX
  ``P(AXIS, None)``), :data:`COLS` (``P(None, AXIS)``, and the usage
  bases' ``P(None, AXIS, None)``), :data:`LANE` (``P(AXIS)``) and
  :data:`REP` (``P()``);
- :func:`put` splits each row-, column- or lane-split leaf into S
  contiguous slabs, each a tensor of its own uploaded through the counted
  ``devprof.device_put``, and uploads a replicated leaf once; the result
  is a tree with :class:`Sharded` leaves that the kernel wrappers
  recognise (:func:`is_sharded`). A leaf already split over the mesh (the
  mirror's row-sharded planes) passes through as it is, as a JAX
  ``device_put`` of an array already carrying its sharding does.

Every route of the device tier runs under the mesh: the flat planners
(K5s-K7s), the wavefront drive (K11s, ``csrc/mesh.cu``, on the exact
scan's placement) and the paged tile sweeps (K12s and K13s,
``csrc/paging.cu``, each tile split by :func:`paged_specs`); on the server
path the mirror keeps its planes as ROWS slabs
(``mirror.DeviceState(mesh=...)``), and the fused drain batch (the scan or
the wavefront), the usage bases, the dirty-row scatter and the applier's
dense verify launch the sharded kernels on them (``csrc/mesh.cu``,
``csrc/mesh_server.cu``). Only a mesh over several cards raises
(``configure``; ROADMAP A12c).

Everything degrades to the unsharded path when no mesh is active: the
helpers return their inputs untouched and the planners run exactly the
single-card programs.

The mesh of S shards on ONE card is a correctness stand-in for a mesh
over several cards (ROADMAP A12c): it runs the decomposition and the
hand-written collectives a multi-card mesh needs, and the only one a
one-card machine can check. It buys no speed: on an H100 the sharded
kernels are slower than the unsharded ones at the one size measured
(10,240 nodes; PERF.md), so no deployment should enable it.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger("nomad_tpu.tpu.shard")

#: the mesh axis every node-dimension plane is partitioned over
AXIS = "nodes"

#: clusters below this many real nodes never shard even when a mesh is
#: configured. The value and its rationale (per-shard work smaller than
#: the collective latency it buys) are the JAX package's, copied: no
#: measurement of the port's kernels sets it
MIN_NODES = int(os.environ.get("NOMAD_TPU_SHARD_MIN_NODES", "4096"))

#: spec markers: node rows split (axis 0 of an [N, k] plane), node
#: columns split (axis 1: of a [k, N] plane, and the node rows of the
#: usage bases' [E, N, C], each slab then [E, N/S, C]), a node lane split
#: (a 1-D [N] plane) and replicated
ROWS, COLS, LANE, REP = "rows", "cols", "lane", "rep"
_AXIS_OF = {ROWS: 0, COLS: 1, LANE: 0}

_lock = threading.Lock()
_state = {"configured": False, "mesh": None}


class Mesh:
    """``n_shards`` shards of the node axis on ``device``; shard s holds
    the contiguous rows ``rows(n)[s]`` of an n-row axis."""

    def __init__(self, n_shards: int, device):
        import torch

        self.n_shards = int(n_shards)
        self.device = torch.device(device)

    @property
    def size(self) -> int:
        return self.n_shards

    def rows(self, n: int) -> list:
        """[start, stop) of each shard over an axis of ``n`` rows (a
        multiple of the shard count, as ``node_bucket`` pads it)."""
        if n % self.n_shards:
            raise ValueError(f"{n} rows do not split into {self.n_shards} equal shards")
        r = n // self.n_shards
        return [(s * r, (s + 1) * r) for s in range(self.n_shards)]

    def __repr__(self) -> str:
        return f"Mesh({self.n_shards} shards on {self.device})"


class Sharded:
    """One leaf split over the mesh: ``split`` is ROWS, COLS or LANE and
    ``slabs`` holds shard s's contiguous part as a tensor of its own."""

    __slots__ = ("split", "slabs")

    def __init__(self, split: str, slabs):
        self.split = split
        self.slabs = tuple(slabs)

    @property
    def axis(self) -> int:
        return _AXIS_OF[self.split]

    @property
    def shape(self) -> tuple:
        shape = list(self.slabs[0].shape)
        shape[self.axis] = sum(t.shape[self.axis] for t in self.slabs)
        return tuple(shape)

    @property
    def device(self):
        return self.slabs[0].device

    def full(self):
        """The slabs concatenated back into one tensor."""
        import torch

        return torch.cat(self.slabs, dim=self.axis)

    def __repr__(self) -> str:
        return f"Sharded({self.split}, {len(self.slabs)} x {tuple(self.slabs[0].shape)})"


def _env_enabled() -> bool:
    return os.environ.get("NOMAD_TPU_SHARD", "0") == "1"


def _visible_cards() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def configure(n_devices: Optional[int] = None, enabled: bool = True, device=None):
    """Build (or tear down, with ``enabled=False``) the process mesh.
    Returns the active mesh or None. Safe to call repeatedly; bench and
    tests call it explicitly, the server path calls it from config.

    With ``device`` (``"cpu"``, ``"cuda"``) the mesh is ``n_devices``
    shards on that one device. Without it, ``n_devices`` (or
    ``NOMAD_TPU_SHARD_DEVICES``, default every visible card) counts CUDA
    cards: fewer visible than asked stays unsharded with a warning, and
    shards on more than one card raise ``NotImplementedError``."""
    with _lock:
        _state["configured"] = True
        if not enabled:
            _state["mesh"] = None
            return None
        if device is not None:
            from .. import resolve_device

            dev = resolve_device(device)
            want = int(n_devices or os.environ.get("NOMAD_TPU_SHARD_DEVICES", "0"))
            if want < 2:
                logger.warning("shard: %d shards requested; staying unsharded", want)
                _state["mesh"] = None
                return None
            _state["mesh"] = Mesh(want, dev)
            return _state["mesh"]
        visible = _visible_cards()
        want = n_devices or int(os.environ.get("NOMAD_TPU_SHARD_DEVICES", str(visible)))
        if want < 2 or visible < want:
            logger.warning(
                "shard: %d devices requested, %d visible; staying unsharded",
                want, visible,
            )
            _state["mesh"] = None
            return None
        _state["mesh"] = None
        raise NotImplementedError(
            f"a mesh of {want} shards over {want} CUDA cards needs a transport "
            "between cards, not ported yet (ROADMAP A12c); "
            "configure(n, device='cuda') splits the node axis on one card"
        )


def active_mesh(n_nodes: Optional[int] = None):
    """The process mesh, or None when sharding is off (or ``n_nodes`` is
    given and below the MIN_NODES gate). First call resolves the env
    gate so library code never needs an explicit configure()."""
    with _lock:
        configured = _state["configured"]
        mesh = _state["mesh"]
    if not configured:
        mesh = configure(enabled=_env_enabled())
    if mesh is None:
        return None
    if n_nodes is not None and n_nodes < MIN_NODES:
        return None
    return mesh


def mesh_size(mesh) -> int:
    """Shards in ``mesh`` (1 for None — the unsharded degenerate).
    Takes the mesh EXPLICITLY: callers that were gated off (small
    cluster, sharding disabled) pass None and must get 1, never a
    re-resolved global mesh."""
    return int(mesh.size) if mesh is not None else 1


def shard_tags(mesh) -> dict:
    """Trace-span tags describing the dispatch's shard topology."""
    return {"shards": int(mesh.size), "mesh_axis": AXIS}


def node_bucket(n: int, mesh) -> int:
    """Padded node-axis size under ``mesh`` (None → unsharded): the ONE
    bucketing policy (problems.bucket, the scheduler's ``_bucket``)
    rounded up to a mesh-size multiple so shards are equal-sized (the
    last shard absorbs the padding rows)."""
    from .problems import bucket

    b = bucket(n)
    k = mesh_size(mesh)
    if k > 1 and b % k:
        b = ((b // k) + 1) * k
    return b


# ---------------------------------------------------------------------------
# spec trees, one per planner (the single placement source)
# ---------------------------------------------------------------------------


def batch_specs():
    """(BatchArgs, BatchState) spec trees for the exact-scan multi-eval
    planner: node rows/cols sharded, group/alloc tables replicated (they
    are O(evals), not O(cluster))."""
    from .kernel import BatchArgs, BatchState

    rows, cols, rep = ROWS, COLS, REP
    args = BatchArgs(
        capacity=rows, usable=rows, feasible=cols, affinity=cols,
        affinity_present=cols, group_count=rep, group_eval=rep,
        node_value=cols, spread_desired=rep, spread_implicit=rep,
        spread_weight_frac=rep, spread_even=rep, spread_active=rep,
        perm=cols, ring=rep, demands=rep, groups=rep, limits=rep,
        valid=rep,
    )
    state = BatchState(
        used=rows, collisions=cols, spread_counts=rep,
        spread_present=rep, offset=rep,
    )
    return args, state


def wavefront_specs():
    """(BatchArgs, BatchState) spec trees for the wavefront planner: the
    wavefront is an alternative DRIVE over the exact-scan batch — same
    planes, same carry — so its layout IS ``batch_specs()`` (K11s reads
    the exact scan's slabs)."""
    return batch_specs()


def run_specs():
    """(RunArgs, init-tuple) spec trees for the run-based full-ring
    planner (the spread/affinity headline path)."""
    from .kernel import RunArgs

    rows, node, rep = ROWS, LANE, REP
    args = RunArgs(
        capacity=rows, usable=rows, feasible=node, affinity=node,
        affinity_present=node, group_count=rep, node_value=node,
        spread_desired=rep, spread_implicit=rep, spread_weight_frac=rep,
        spread_even=rep, spread_active=rep, perm=node, demand=rep,
        n_allocs=rep,
    )
    init = (rows, node, rep, rep)
    return args, init


def window_specs():
    """(WindowArgs, (used0, collisions0)) spec trees for the
    rotation-parallel windowed planner."""
    from .kernel import WindowArgs

    rows, node, rep = ROWS, LANE, REP
    args = WindowArgs(
        capacity=rows, usable=rows, feasible=node, perm=node,
        demand=rep, group_count=rep, limit=rep, n_allocs=rep,
    )
    return args, (rows, node)


def paged_specs():
    """(static-tile, dynamic-tile) spec trees for the paged planner's
    tile stream: a tile is a contiguous node-row slab, so the layout is
    the windowed planner's restricted to one tile (K12s and K13s read a
    tile's slabs through its pointer table)."""
    rows, node = ROWS, LANE
    return (rows, rows, node, node), (rows, node)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _map(fn, tree, spec_tree):
    """``fn(leaf, spec)`` over ``tree``'s structure (NamedTuples and
    tuples), with ``spec_tree`` mirroring it."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x, s) for x, s in zip(tree, spec_tree)))
    if isinstance(tree, (tuple, list)):
        return tuple(_map(fn, x, s) for x, s in zip(tree, spec_tree))
    return fn(tree, spec_tree)


def put(tree, spec_tree, mesh, pinned: bool = False):
    """Upload a planner arg tree with its spec tree: each ROWS, COLS or
    LANE leaf as ``mesh.size`` contiguous slabs (a :class:`Sharded`), each
    REP leaf once. Leaves are numpy arrays or scalars (or tensors, moved
    through host memory); integer planes are pinned to int32 and floats
    to float32 as ``kernel.from_numpy`` pins them. A :class:`Sharded` leaf
    is already placed: it must be split as its spec says, over the mesh's
    shard count, and passes through uncopied and uncounted. ``pinned``:
    the leaves are numpy planes of those dtypes in pinned host memory (the
    paged tile stream's), whose slabs upload as they are, on the current
    stream, without waiting for it.

    Placement routes through ``devprof.device_put`` — THE counted
    wrapper — so every host→device byte the mesh path moves lands in
    the transfer ledger (debug/devprof.py)."""
    from ..debug import devprof as _devprof
    from .kernel import pin_host

    def _put(x, spec):
        if isinstance(x, Sharded):
            if x.split != spec or len(x.slabs) != mesh.size:
                raise ValueError(f"a leaf split {x.split} over {len(x.slabs)} shards, "
                                 f"placed as {spec} over {mesh.size}")
            return x
        a = x if pinned else pin_host(x.cpu().numpy() if hasattr(x, "data_ptr") else x)
        if spec == REP:
            return _devprof.device_put(a, mesh.device, non_blocking=pinned)
        axis = _AXIS_OF[spec]
        slabs = []
        for r0, r1 in mesh.rows(a.shape[axis]):
            part = a[r0:r1] if axis == 0 else a[:, r0:r1]
            slabs.append(_devprof.device_put(np.ascontiguousarray(part), mesh.device,
                                             non_blocking=pinned))
        return Sharded(spec, slabs)

    return _map(_put, tree, spec_tree)


def _leaves(tree):
    if hasattr(tree, "_fields") or isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def is_sharded(tree) -> bool:
    """Whether any leaf of ``tree`` is split over a mesh."""
    return any(isinstance(x, Sharded) for x in _leaves(tree))


def shards_of(tree) -> int:
    """The shard count of a sharded tree (1 when no leaf is split); every
    split leaf must agree."""
    counts = {len(x.slabs) for x in _leaves(tree) if isinstance(x, Sharded)}
    if len(counts) > 1:
        raise ValueError(f"leaves split over different shard counts {sorted(counts)}")
    return counts.pop() if counts else 1


def gather(tree):
    """``tree`` with every :class:`Sharded` leaf concatenated back into one
    tensor (the other leaves as they are)."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(gather(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return tuple(gather(x) for x in tree)
    return tree.full() if isinstance(tree, Sharded) else tree


def split(t, spec: str, n_shards: int) -> Sharded:
    """The full tensor ``t`` split as ``spec`` says into ``n_shards``
    contiguous slabs, on its own device."""
    return Sharded(spec, (x.contiguous() for x in t.chunk(n_shards, _AXIS_OF[spec])))


def split_like(tree, like):
    """Full tensors of ``tree`` split as the leaves of ``like`` are (a
    sharded leaf's split and shard count; a replicated leaf as it is)."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(split_like(x, y) for x, y in zip(tree, like)))
    if isinstance(tree, (tuple, list)):
        return tuple(split_like(x, y) for x, y in zip(tree, like))
    if not isinstance(like, Sharded):
        return tree
    return split(tree, like.split, len(like.slabs))
