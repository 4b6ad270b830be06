"""Paged node axis: the windowed planner with the node planes streamed
through device memory in tiles.

Counterpart of ``nomad_tpu/tpu/paging.py``. The eval's planes are gathered
on the host into ring order (row q is ring position q's node) and cut
into ``tile_rows()``-row tiles. Each round of the windowed planner is two
sweeps over the tiles:

1. ``tile_count``: per tile, the feasible count and the count before the
   ring cursor. The host sums them into the ring's feasible total, the
   count before the cursor and each tile's exclusive base, which gives
   every tile its exact rotation ranks.
2. ``tile_window``: per tile, the partial winner (max score, then least
   feasible rank, and its node) of every window the tile meets, in two
   straddle groups (positions at or past the cursor rank low, wrapped ones
   high), plus the last consumed ring position. The host merges the
   partials by the same (max score, min rank) rule; float max and integer
   min are order-free, so the winners are the flat planner's.

The host then applies the winners to its ring-order planes, marks their
tiles dirty, and moves the cursor. Placements and rounds equal the flat
windowed planner's (``kernel.plan_batch_windowed``) bit for bit.

``TileCache`` keeps at most ``limit_bytes`` of tiles on the device (the
configured budget, floored at two tiles so that the next tile can upload
while this one computes), evicts the least recently used tile, uploads
the static planes once per residency and re-uploads the dynamic ones
(used, collisions) only for dirtied tiles. On CUDA the host planes live
in pinned memory, uploads run on a side stream, and the compute stream
waits on each tile's upload event: the next tile's copy overlaps this
tile's sweep. On the CPU (the caller asked for it) a tile is a copy.

Under a mesh (``plan_batch_paged(..., mesh=...)``, the JAX module's
``mesh``) a tile's rows are split into the mesh's S slabs as
``shard.paged_specs()`` places them (``tile_rows(mesh)`` rounds the tile
to a multiple of S), and the sweeps run sharded: on the CPU their sharded
plain versions, on the card K12s and K13s (``csrc/paging.cu``'s kernels
on a tile read through a pointer table, which the cache builds once per
upload of a tile). Sharding is a layout: the tile bytes uploaded, the
placements and the rounds are the unsharded run's.

Config stanza, with the JAX package's env names and defaults:
``NOMAD_TPU_PAGING`` (off unless ``1``), ``NOMAD_TPU_PAGING_BUDGET_MB``
(256) and ``NOMAD_TPU_PAGING_TILE_NODES`` (65,536). ``planner.plan_eval``
routes a windowed eval here when ``should_page`` says its planes exceed
the budget.

The device ledger counts each tile's upload (bytes h2d and the tile-
granular uploads and re-uploads), each tile's sweep-2 results device to
host, the route's rounds, and the two sweeps' launches under planner
``paged`` with the JAX package's shape keys.

``plan_windowed_np`` (with ``_pow10_np``/``_binpack_np``) is the port's
copy of the JAX package's pure-numpy windowed planner, the host oracle of
this route.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..debug import devprof as _devprof
from . import kernel
from . import shard as _shard
from .kernel import _LOG2_10, _LOG2_10_HI, _LOG2_10_LO, NEG_INF, _binpack

_BIG = 2**30
_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1

DEFAULT_BUDGET_MB = 256
DEFAULT_TILE_NODES = 65536
#: the least tile the policy rounds to
MIN_TILE_NODES = 64

_lock = threading.Lock()
_state = {"enabled": None, "budget_mb": None, "tile_nodes": None}


def configure(enabled=None, device_node_budget_mb=None, tile_nodes=None):
    """Set the paging knobs; ``None`` leaves a knob on its env/default
    resolution."""
    with _lock:
        if enabled is not None:
            _state["enabled"] = bool(enabled)
        if device_node_budget_mb is not None:
            _state["budget_mb"] = max(1, int(device_node_budget_mb))
        if tile_nodes is not None:
            _state["tile_nodes"] = max(1, int(tile_nodes))


def reset():
    """Back to env/default resolution."""
    with _lock:
        _state.update({"enabled": None, "budget_mb": None, "tile_nodes": None})


def enabled() -> bool:
    """Whether over-budget node axes may be paged (``NOMAD_TPU_PAGING=1``)."""
    with _lock:
        v = _state["enabled"]
    if v is not None:
        return v
    return os.environ.get("NOMAD_TPU_PAGING", "0") == "1"


def budget_mb() -> int:
    """Device-resident node-plane budget in MB."""
    with _lock:
        v = _state["budget_mb"]
    if v is not None:
        return v
    return max(1, int(os.environ.get("NOMAD_TPU_PAGING_BUDGET_MB", str(DEFAULT_BUDGET_MB))))


def _tile_nodes_raw() -> int:
    with _lock:
        v = _state["tile_nodes"]
    if v is not None:
        return v
    return max(1, int(os.environ.get("NOMAD_TPU_PAGING_TILE_NODES", str(DEFAULT_TILE_NODES))))


def tile_rows(mesh=None) -> int:
    """The tile policy: the configured ``tile_nodes`` rounded up to a power
    of two, never below ``MIN_TILE_NODES``, and up to a multiple of
    ``mesh``'s shards."""
    t = max(MIN_TILE_NODES, _tile_nodes_raw())
    p = 1
    while p < t:
        p *= 2
    m = _shard.mesh_size(mesh)
    return -(-p // m) * m


def plane_bytes_per_node(r_cols: int = 3) -> int:
    """Device bytes per node of the paged layout: capacity and used i32[C],
    usable f32[2], node id i32, collisions i32, feasible bool."""
    return 8 * r_cols + 13


def plane_bytes(n_pad: int, r_cols: int = 3) -> int:
    """Device bytes the flat windowed planner would hold for ``n_pad`` rows,
    the number the budget gate compares."""
    return int(n_pad) * plane_bytes_per_node(r_cols)


def should_page(n_pad: int, r_cols: int = 3) -> bool:
    """True when paging is on and the flat planes exceed the budget."""
    return enabled() and plane_bytes(n_pad, r_cols) > budget_mb() * (1 << 20)


# ---------------------------------------------------------------------------
# the tile cache
# ---------------------------------------------------------------------------

def _tree_nbytes(tree) -> int:
    return sum(int(np.asarray(x).nbytes) for x in tree)


class TileCache:
    """LRU tile cache under a device byte budget. ``ensure(t)`` returns tile
    ``t``'s entry (``static``: capacity, usable, feasible, node ids;
    ``dyn``: used, collisions), uploading what is absent or dirty; resident
    bytes stay at or under ``limit_bytes``, the budget floored at two tiles
    (``budget_raised`` says when the floor engaged). The builders return
    numpy arrays; on CUDA they should view pinned memory. With ``mesh`` the
    planes are placed by ``shard.paged_specs()`` (each a ``shard.Sharded``
    of the mesh's slabs) and, on the card, the entry's ``table`` holds the
    tile's pointer table for the sharded sweeps."""

    def __init__(self, budget_bytes: int, build_static, build_dynamic, device=None, mesh=None):
        self.budget_bytes = int(budget_bytes)
        self._build_static = build_static
        self._build_dynamic = build_dynamic
        self.device = resolve_device(device)
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"a mesh on {mesh.device} for tiles on {self.device}")
        self.mesh = mesh
        self._copy_stream = None
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
        self._resident: dict[int, dict] = {}
        self._dirty: set[int] = set()
        self._clock = 0
        self._tile_bytes = None  # learned from the first upload
        self.limit_bytes = int(budget_bytes)
        self.budget_raised = False
        self.uploads = 0
        self.reuploads = 0
        self.upload_bytes = 0
        self.reupload_bytes = 0
        self.evictions = 0
        self.hits = 0
        self.resident_peak_bytes = 0
        self._ever: set[int] = set()

    def _put(self, tree, ent: dict) -> tuple:
        """Copy a tile's arrays to the device (under a mesh, split by
        ``shard.paged_specs()`` through the counted ``devprof.device_put``).
        On CUDA the copies run on the side stream and ``ent["ready"]``
        becomes their completion event."""
        if self.mesh is not None:
            static_specs, dyn_specs = _shard.paged_specs()
            spec = static_specs if len(tree) == len(static_specs) else dyn_specs
        if self._copy_stream is None:
            if self.mesh is not None:
                return _shard.put(tuple(np.array(x) for x in tree), spec, self.mesh)
            _devprof.count_tree_h2d(tree)
            return tuple(torch.from_numpy(np.array(x)) for x in tree)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            if self.mesh is not None:
                out = _shard.put(tuple(tree), spec, self.mesh, pinned=True)
            else:
                _devprof.count_tree_h2d(tree)
                out = tuple(torch.from_numpy(x).to(self.device, non_blocking=True) for x in tree)
            ent["ready"] = torch.cuda.Event()
            ent["ready"].record(self._copy_stream)
        for x in out:  # freed at eviction only after the sweeps queued on it
            for t in (x.slabs if self.mesh is not None else (x,)):
                t.record_stream(compute)
        return out

    def _placed(self, ent: dict) -> None:
        """Note that the entry's planes changed: on the card under a mesh,
        its pointer table is rebuilt (once per upload, not per sweep)."""
        if self.mesh is not None and self._copy_stream is not None:
            cap, usable, feas, nodes = ent["static"]
            used, coll = ent["dyn"]
            ent["table"] = _tile_table(cap, usable, feas, nodes, used, coll)

    def wait(self, ent: dict) -> None:
        """Make the compute stream wait for the entry's uploads."""
        if "ready" in ent:
            torch.cuda.current_stream(self.device).wait_event(ent["ready"])

    def mark_dirty(self, tiles) -> None:
        for t in tiles:
            self._dirty.add(int(t))

    def _resident_bytes(self) -> int:
        if self._tile_bytes is None:
            return 0
        return len(self._resident) * self._tile_bytes

    def _evict_for(self, incoming: int) -> None:
        if self._tile_bytes is None:
            return
        while self._resident and self._resident_bytes() + self._tile_bytes > self.limit_bytes:
            victim = min(self._resident, key=lambda t: self._resident[t]["stamp"])
            if victim == incoming:
                break
            del self._resident[victim]
            self.evictions += 1

    def ensure(self, t: int) -> dict:
        """Tile ``t``'s entry, uploading what is absent or stale. Call
        ``ensure(t + 1)`` before computing on tile ``t`` and the copy
        overlaps the compute."""
        self._clock += 1
        ent = self._resident.get(t)
        if ent is not None:
            ent["stamp"] = self._clock
            if t in self._dirty:
                dyn = self._build_dynamic(t)
                nbytes = _tree_nbytes(dyn)
                ent["dyn"] = self._put(dyn, ent)
                self._placed(ent)
                self._dirty.discard(t)
                self.reuploads += 1
                self.reupload_bytes += nbytes
                self.upload_bytes += nbytes
                _devprof.count_tile_upload(nbytes, reupload=True)
            else:
                self.hits += 1
            return ent
        static = self._build_static(t)
        dyn = self._build_dynamic(t)
        s_bytes = _tree_nbytes(static)
        d_bytes = _tree_nbytes(dyn)
        if self._tile_bytes is None:
            self._tile_bytes = s_bytes + d_bytes
            # two tiles must fit for the copy to overlap the compute
            floor = 2 * self._tile_bytes
            if self.budget_bytes < floor:
                self.limit_bytes = floor
                self.budget_raised = True
        self._evict_for(t)
        revisit = t in self._ever
        ent = {"stamp": self._clock}
        ent["static"] = self._put(static, ent)
        ent["dyn"] = self._put(dyn, ent)
        self._placed(ent)
        self._resident[t] = ent
        self._dirty.discard(t)
        self._ever.add(t)
        self.uploads += 1
        self.upload_bytes += s_bytes + d_bytes
        if revisit:
            self.reuploads += 1
            self.reupload_bytes += s_bytes + d_bytes
        _devprof.count_tile_upload(s_bytes + d_bytes, reupload=revisit)
        self.resident_peak_bytes = max(self.resident_peak_bytes, self._resident_bytes())
        return ent

    def stats(self) -> dict:
        return {
            "budget_bytes": self.budget_bytes,
            "limit_bytes": self.limit_bytes,
            "budget_raised": self.budget_raised,
            "tile_bytes": self._tile_bytes or 0,
            "uploads": self.uploads,
            "reuploads": self.reuploads,
            "upload_bytes": self.upload_bytes,
            "reupload_bytes": self.reupload_bytes,
            "evictions": self.evictions,
            "hits": self.hits,
            "resident_peak_bytes": self.resident_peak_bytes,
        }


# ---------------------------------------------------------------------------
# the two tile sweeps: plain versions and wrappers
# ---------------------------------------------------------------------------

def _tile_fit(cap, feas, used, demand, t0: int, n_real: int):
    pos = t0 + torch.arange(cap.shape[0], dtype=torch.int32, device=cap.device)
    return pos, feas & (used + demand[None, :] <= cap).all(dim=1) & (pos < n_real)


def tile_count_ref(cap, feas, used, demand, t0: int, offset: int, n_real: int):
    """Plain version of sweep 1 (JAX ``_tile_count_jit``): int32 [2], the
    tile's feasible count and its count before the ring offset."""
    pos, fit = _tile_fit(cap, feas, used, demand, t0, n_real)
    cnt = fit.sum(dtype=torch.int32)
    before = (fit & (pos < offset)).sum(dtype=torch.int32)
    return torch.stack([cnt, before])


def _tile_segments(cap, usable, feas, used, coll, demand, group_count: int, limit: int,
                   t0: int, offset: int, n_real: int, flat_base: int, x0: int, total: int,
                   w_use: int):
    """Sweep 2 up to its segmented reductions: per row the score, the
    feasible rank, whether it bids, and its segment (2T for the rows that
    do not bid); the straddle groups' base windows and the watermark."""
    tn = cap.shape[0]
    dev = cap.device
    pos, fit = _tile_fit(cap, feas, used, demand, t0, n_real)

    util = used + demand[None, :]
    free_cpu = 1.0 - util[:, 0].float() / usable[:, 0]
    free_mem = 1.0 - util[:, 1].float() / usable[:, 1]
    binpack = _binpack(free_cpu, free_mem)
    anti_present = coll > 0
    count_f = torch.tensor(group_count, dtype=torch.int32, device=dev).float()
    anti = torch.where(anti_present, -(coll.float() + 1.0) / count_f, 0.0)
    score = (binpack + anti) / (1.0 + anti_present.float())

    fit_i = fit.to(torch.int32)
    local_ex = torch.cumsum(fit_i, 0, dtype=torch.int32) - fit_i
    xex = flat_base + local_ex
    wrapped = pos < offset
    feas_rank = torch.where(wrapped, total - x0 + xex, xex - x0)

    lm = max(limit, 1)
    window = torch.div(feas_rank, lm, rounding_mode="floor")
    active = fit & (window < w_use)
    big = torch.tensor(_BIG, dtype=torch.int32, device=dev)
    base_lo = torch.where(active & ~wrapped, window, big).min()
    base_hi = torch.where(active & wrapped, window, big).min()
    seg_lo = torch.clamp(window - base_lo, 0, tn - 1)
    seg_hi = tn + torch.clamp(window - base_hi, 0, tn - 1)
    seg = torch.where(active, torch.where(wrapped, seg_hi, seg_lo), 2 * tn).long()

    rot_rank = torch.where(wrapped, n_real - offset + pos, pos - offset)
    consumed_window = fit & (feas_rank < w_use * limit)
    last = torch.where(consumed_window, rot_rank, -1).max()
    return score, feas_rank, active, seg, torch.stack([base_lo, base_hi]), last


def _segment_winners(score, feas_rank, active, seg, nodes):
    """Per segment of 2T+1: the max score, the least rank among the rows at
    that max, and that row's node (JAX's segment_max / segment_min, with
    their fills where no row lands)."""
    s = 2 * score.shape[0] + 1
    dev = score.device
    big = torch.tensor(_BIG, dtype=torch.int32, device=dev)
    seg_score = torch.full((s,), float("-inf"), device=dev).scatter_reduce(
        0, seg, torch.where(active, score, NEG_INF), "amax")
    is_best = active & (score == seg_score[seg])
    seg_rank = torch.full((s,), _I32_MAX, dtype=torch.int32, device=dev).scatter_reduce(
        0, seg, torch.where(is_best, feas_rank, big), "amin")
    winner = is_best & (feas_rank == seg_rank[seg])
    seg_node = torch.full((s,), _I32_MIN, dtype=torch.int32, device=dev).scatter_reduce(
        0, seg, torch.where(winner, nodes, -1), "amax")
    return seg_score, seg_rank, seg_node


def tile_window_ref(cap, usable, feas, used, coll, nodes, demand, group_count: int, limit: int,
                    t0: int, offset: int, n_real: int, flat_base: int, x0: int, total: int,
                    w_use: int):
    """Plain version of sweep 2 (JAX ``_tile_window_jit``): (bases i32[2],
    score f32[2T+1], rank i32[2T+1], node i32[2T+1], last i32). Segment
    T*k + (window - base_k) holds the partial winner of a window of
    straddle group k; segment 2T gathers the rows that do not bid. Segments
    no row reaches keep JAX's fill values (-inf, INT32_MAX, INT32_MIN)."""
    score, feas_rank, active, seg, bases, last = _tile_segments(
        cap, usable, feas, used, coll, demand, group_count, limit, t0, offset, n_real,
        flat_base, x0, total, w_use)
    return (bases, *_segment_winners(score, feas_rank, active, seg, nodes), last)


def tile_count_sharded_ref(cap, feas, used, demand, t0: int, offset: int, n_real: int):
    """Sharded plain version of sweep 1 (JAX ``_tile_count_jit`` on a tile
    placed by ``shard.paged_specs()``): the unsharded one on the gathered
    tile, whose two counts are replicated (``split_like`` of a replicated
    output is the output)."""
    return tile_count_ref(*_shard.gather((cap, feas, used)), demand, t0, offset, n_real)


def tile_window_sharded_ref(cap, usable, feas, used, coll, nodes, demand, group_count: int,
                            limit: int, t0: int, offset: int, n_real: int, flat_base: int,
                            x0: int, total: int, w_use: int):
    """Sharded plain version of sweep 2 (JAX ``_tile_window_jit`` on a tile
    placed by ``shard.paged_specs()``): the unsharded one on the gathered
    tile; its outputs are replicated."""
    return tile_window_ref(*_shard.gather((cap, usable, feas, used, coll, nodes)), demand,
                           group_count, limit, t0, offset, n_real, flat_base, x0, total, w_use)


_COUNT_SHAPES = dict(cap="TC", feas="T", used="TC", demand="C", counts="K2")
_WINDOW_SHAPES = dict(cap="TC", usable="T2", feas="T", used="TC", coll="T", nodes="T", demand="C")
#: how the sharded sweeps take a tile's planes (``shard.paged_specs()``),
#: and their shapes with the tile's rows as the split axis N
_TILE_SPECS = dict(cap=_shard.ROWS, usable=_shard.ROWS, feas=_shard.LANE, nodes=_shard.LANE,
                   used=_shard.ROWS, coll=_shard.LANE, demand=_shard.REP, counts=_shard.REP)
_MESH_COUNT_SHAPES = {k: v.replace("T", "N") for k, v in _COUNT_SHAPES.items()}
_MESH_WINDOW_SHAPES = {k: v.replace("T", "N") for k, v in _WINDOW_SHAPES.items()}


def _tile_table(cap, usable, feas, nodes, used, coll) -> np.ndarray:
    """The pointer table K12s and K13s take: the six planes of a sharded
    tile in ``shard.paged_specs()``'s order, each its slabs; a plane the
    sweep does not read may be None (null pointers)."""
    none = _shard.Sharded(_shard.ROWS, ())
    return kernel._table([none if x is None else x for x in (cap, usable, feas, nodes, used, coll)])

#: (device index, stream) -> the zeroed ticket word sweep 1's kernel draws
#: its blocks' tickets from (the last block clears it)
_TICKETS: dict = {}


def tile_count(cap, feas, used, demand, t0: int, offset: int, n_real: int, out=None):
    """Sweep 1 over one tile; int32 [2] (count, count before the offset),
    written into ``out`` when given. On the card one launch, whatever
    ``out`` held before (K12s on a tile split over a mesh). Does not wait
    for the card."""
    sharded = _shard.is_sharded((cap, feas, used))
    if cap.device.type == "cpu":
        ref = tile_count_sharded_ref if sharded else tile_count_ref
        res = ref(cap, feas, used, demand, t0, offset, n_real)
        return res if out is None else out.copy_(res)
    from . import _build

    device = cap.device
    if out is None:
        out = torch.empty(2, dtype=torch.int32, device=device)
    if sharded:
        _tile_counter(cap, feas, used, demand, out[None])(0, cap, feas, used, t0, offset, n_real)
        return out
    d = kernel._check_cuda(dict(cap=cap, feas=feas, used=used, demand=demand, out=out),
                           dict(_COUNT_SHAPES, out="2"), device)
    stream = torch.cuda.current_stream(device).cuda_stream
    kernel._launch(
        "tile_count", _build.library().ntt_tile_count,
        *(kernel._ptr(t) for t in (cap, feas, used, demand, out, _ticket(device, stream))),
        d["T"], d["C"], t0, offset, n_real,
        ctypes.c_void_p(stream),
    )
    return out


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The zeroed ticket word of a stream of the device."""
    ticket = _TICKETS.get((device.index, stream))
    if ticket is None:
        ticket = _TICKETS[(device.index, stream)] = torch.zeros(1, dtype=torch.int64,
                                                                 device=device)
    return ticket


def _tile_counter(cap, feas, used, demand, counts):
    """Sweep 1 for the tiles of one paged eval: a callable ``(t, cap, feas,
    used, t0, offset, n_real, table=None)`` that writes tile t's counts into
    row t of ``counts`` [K, 2]. On the card the shapes, dtypes and device
    are checked here, once, against the first tile's planes: every tile of
    the eval has those, and the calls pass pointers only (a tile split over
    a mesh its pointer table, ``table`` when the tile cache keeps it)."""
    if cap.device.type == "cpu":
        def count(t, cap, feas, used, t0, offset, n_real, table=None):
            tile_count(cap, feas, used, demand, t0, offset, n_real, out=counts[t])
        return count
    from . import _build

    device = cap.device
    if _shard.is_sharded((cap, feas, used)):
        return _mesh_tile_counter(cap, feas, used, demand, counts)
    d = kernel._check_cuda(dict(cap=cap, feas=feas, used=used, demand=demand, counts=counts),
                           _COUNT_SHAPES, device)
    T, C, K = d["T"], d["C"], d["K"]
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = _build.library().ntt_tile_count
    fixed = (demand.data_ptr(), counts.data_ptr(), _ticket(device, stream).data_ptr())
    launches = kernel.LAUNCHES

    def count(t, cap, feas, used, t0, offset, n_real, table=None, _keep=(demand, counts)):
        if not 0 <= t < K:
            raise IndexError(f"tile {t} has no row in counts [{K}, 2]")
        rc = fn(cap.data_ptr(), feas.data_ptr(), used.data_ptr(), fixed[0], fixed[1] + 8 * t,
                fixed[2], T, C, t0, offset, n_real, stream)
        if rc:
            kernel._launch_status("tile_count", rc)
        launches["tile_count"] += 1
    return count


def _mesh_tile_counter(cap, feas, used, demand, counts):
    """``_tile_counter`` on tiles split over a mesh: K12s, one launch a
    tile over its S slabs, the counts and the ticket word as the unsharded
    sweep keeps them."""
    from . import _build

    device = cap.device
    d = kernel._check_mesh(dict(cap=cap, feas=feas, used=used, demand=demand, counts=counts),
                           _TILE_SPECS, _MESH_COUNT_SHAPES, device)
    S, T, C, K = d["S"], d["N"], d["C"], d["K"]
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = _build.library().ntt_mesh_tile_count
    fixed = (demand.data_ptr(), counts.data_ptr(), _ticket(device, stream).data_ptr())
    launches = kernel.LAUNCHES

    def count(t, cap, feas, used, t0, offset, n_real, table=None, _keep=(demand, counts)):
        if not 0 <= t < K:
            raise IndexError(f"tile {t} has no row in counts [{K}, 2]")
        if table is None:
            table = _tile_table(cap, None, feas, None, used, None)
        rc = fn(table.ctypes.data, fixed[0], fixed[1] + 8 * t, fixed[2], S, T, C, t0, offset,
                n_real, stream)
        if rc:
            kernel._launch_status("mesh_tile_count", rc)
        launches["mesh_tile_count"] += 1
    return count


def tile_window(cap, usable, feas, used, coll, nodes, demand, group_count: int, limit: int,
                t0: int, offset: int, n_real: int, flat_base: int, x0: int, total: int,
                w_use: int, table=None):
    """Sweep 2 over one tile; the outputs of ``tile_window_ref`` as device
    tensors. On the card, three short launches of a grid over the tile's
    rows (score, bid, winner); on a tile split over a mesh, K13s (the same
    three over the slabs, through ``table``, the tile cache's pointer
    table, or one built here). Does not wait for the card."""
    scalars = (group_count, limit, t0, offset, n_real, flat_base, x0, total, w_use)
    planes = dict(cap=cap, usable=usable, feas=feas, used=used, coll=coll, nodes=nodes)
    sharded = _shard.is_sharded(tuple(planes.values()))
    if cap.device.type == "cpu":
        ref = tile_window_sharded_ref if sharded else tile_window_ref
        return ref(cap, usable, feas, used, coll, nodes, demand, *scalars)
    from . import _build

    device = cap.device
    if sharded:
        d = kernel._check_mesh(dict(planes, demand=demand), _TILE_SPECS, _MESH_WINDOW_SHAPES,
                               device)
        d["T"] = d["N"]
    else:
        d = kernel._check_cuda(dict(planes, demand=demand), _WINDOW_SHAPES, device)
    T, C = d["T"], d["C"]
    i32 = dict(dtype=torch.int32, device=device)
    bases = torch.empty(2, **i32)
    seg_score = torch.empty(2 * T + 1, dtype=torch.float32, device=device)
    seg_rank = torch.empty(2 * T + 1, **i32)
    seg_node = torch.empty(2 * T + 1, **i32)
    last = torch.empty(1, **i32)
    scratch = (
        torch.empty(T, dtype=torch.float32, device=device),  # score
        torch.empty(T, **i32),  # feasible rank, -1 when not feasible
        torch.empty(2 * T, dtype=torch.int64, device=device),  # per-segment best key
        torch.empty(-(-T // 1024), **i32),  # per block of rows: fit counts
    )
    outs = (bases, seg_score, seg_rank, seg_node, last, *scratch)
    if sharded:
        if table is None:
            table = _tile_table(cap, usable, feas, nodes, used, coll)
        kernel._launch(
            "mesh_tile_window", _build.library().ntt_mesh_tile_window,
            ctypes.c_void_p(table.ctypes.data), *(kernel._ptr(t) for t in (demand, *outs)),
            d["S"], T, C, *scalars,
            kernel._stream(device),
        )
    else:
        kernel._launch(
            "tile_window", _build.library().ntt_tile_window,
            *(kernel._ptr(t) for t in (cap, usable, feas, used, coll, nodes, demand, *outs)),
            T, C, *scalars,
            kernel._stream(device),
        )
    return bases, seg_score, seg_rank, seg_node, last[0]


def sweep_keys(tn: int, n_shards: int = 1) -> tuple:
    """The device ledger's shape keys of the two sweeps over tiles of
    ``tn`` rows split into ``n_shards`` slabs (planner ``paged``)."""
    return f"T{tn}S{n_shards}c", f"T{tn}S{n_shards}w"


def count_sweep(cap, feas, used, demand, counts, offset: int, n_real: int, key: str,
                table=None):
    """Sweep 1's counter for the tiles of one eval (``_tile_counter``),
    made and launched on tile 0 (``table``: its pointer table, on a tile
    split over a mesh); the launch enters the device ledger under ``key``,
    sharded apart. Returns the counter for the other tiles."""
    if cap.device.type == "cuda":
        kernel._library()
    t0 = time.perf_counter()
    count = _tile_counter(cap, feas, used, demand, counts)
    count(0, cap, feas, used, 0, offset, n_real, table=table)
    kernel._ledger("paged", key, cap.device, t0, _shard.is_sharded(cap))
    return count


def window_sweep(cap, usable, feas, used, coll, nodes, demand, group_count: int, limit: int,
                 t0: int, offset: int, n_real: int, flat_base: int, x0: int, total: int,
                 w_use: int, key: str, table=None):
    """``tile_window`` over one tile, its launch entered in the device
    ledger under ``key`` (sharded apart)."""
    if cap.device.type == "cuda":
        kernel._library()
    start = time.perf_counter()
    out = tile_window(cap, usable, feas, used, coll, nodes, demand, group_count, limit, t0,
                      offset, n_real, flat_base, x0, total, w_use, table=table)
    kernel._ledger("paged", key, cap.device, start, _shard.is_sharded(cap))
    return out


# ---------------------------------------------------------------------------
# the paged windowed planner: host-driven rounds over the tile stream
# ---------------------------------------------------------------------------

def _host_plane(shape, dtype, pinned: bool) -> np.ndarray:
    """An uninitialised host plane: a view of pinned memory when the tiles
    upload to a card, else plain numpy."""
    if not pinned:
        return np.empty(shape, dtype)
    return torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                       pin_memory=True).numpy()


def plan_batch_paged(capacity, usable, feasible, perm, demand, group_count, limit, n_allocs,
                     used0, collisions0, n_real: int, a_pad: int, device=None, mesh=None):
    """Windowed placement with the node axis streamed in tiles. Same inputs
    as the flat windowed planner (host numpy planes in node-id space and the
    ring permutation); returns ``(placements i32[a_pad], rounds, stats)``
    with the flat planner's placements and rounds, under the stanza's
    budget (``budget_mb()`` MB). With ``mesh`` each tile is split into the
    mesh's slabs and swept by the sharded sweeps (JAX ``mesh``)."""
    kernel._fault_point()
    dev = resolve_device(device)
    pinned = dev.type == "cuda"
    capacity = np.asarray(capacity, dtype=np.int32)
    usable = np.asarray(usable, dtype=np.float32)
    feasible = np.asarray(feasible, dtype=bool)
    perm = np.asarray(perm, dtype=np.int32)
    used_nodes = np.asarray(used0, dtype=np.int32)
    coll_nodes = np.asarray(collisions0, dtype=np.int32)
    n0, c = capacity.shape

    tn = tile_rows(mesh)
    n_tiles = max(1, -(-int(n_real) // tn))
    n_pad = n_tiles * tn
    m = min(n0, n_pad)

    # ring-order planes: row q is ring position q's node (pad rows are never
    # in the ring; their values only have to be type-safe)
    ring = perm[:m]

    def gathered(plane, shape, dtype, fill):
        out = _host_plane(shape, dtype, pinned)
        np.take(plane, ring, axis=0, out=out[:m])
        out[m:] = fill
        return out

    cap_r = gathered(capacity, (n_pad, c), np.int32, 0)
    usable_r = gathered(usable, (n_pad, usable.shape[1]), np.float32, 1.0)
    feas_r = gathered(feasible, n_pad, np.bool_, False)
    nodes_r = _host_plane(n_pad, np.int32, pinned)
    nodes_r[:m], nodes_r[m:] = ring, 0
    used_r = gathered(used_nodes, (n_pad, c), np.int32, _BIG)
    coll_r = gathered(coll_nodes, n_pad, np.int32, 0)
    inv = np.zeros(n0, np.int64)
    inv[ring] = np.arange(m)

    def build_static(t):
        sl = slice(t * tn, (t + 1) * tn)
        return (cap_r[sl], usable_r[sl], feas_r[sl], nodes_r[sl])

    def build_dynamic(t):
        sl = slice(t * tn, (t + 1) * tn)
        return (used_r[sl], coll_r[sl])

    cache = TileCache(budget_mb() * (1 << 20), build_static, build_dynamic, dev, mesh)
    ckey, wkey = sweep_keys(tn, _shard.mesh_size(mesh))
    demand_np = np.asarray(demand, dtype=np.int32)
    demand_d = torch.from_numpy(demand_np.copy()).to(dev)
    a = int(n_allocs)
    lraw = int(limit)
    lm = max(lraw, 1)

    placements = np.full(a_pad, -1, np.int32)
    offset = 0
    placed = 0
    rounds = 0
    n_real = int(n_real)
    # sweep 1's counts a tile (read back once a round) and its launcher
    counts = torch.empty((n_tiles, 2), dtype=torch.int32, device=dev)
    count = None
    while placed < a:
        rounds += 1

        # sweep 1: per-tile feasible counts, read once for the sweep (tile
        # t+1 uploads while tile t computes)
        ent = cache.ensure(0)
        for t in range(n_tiles):
            cur = ent
            if t + 1 < n_tiles:
                ent = cache.ensure(t + 1)
            cache.wait(cur)
            cap_t, _, feas_t, _ = cur["static"]
            used_t, _ = cur["dyn"]
            if count is None:  # tile 0
                count = count_sweep(cap_t, feas_t, used_t, demand_d, counts, offset, n_real,
                                    ckey, table=cur.get("table"))
            else:
                count(t, cap_t, feas_t, used_t, t * tn, offset, n_real, table=cur.get("table"))
        tile_counts = counts.cpu().numpy().astype(np.int64)
        cnts, befs = tile_counts[:, 0], tile_counts[:, 1]

        total = int(cnts.sum())
        x0 = int(befs.sum())
        remaining = a - placed
        w_use = min(max(total // lm, 1), remaining) if total > 0 else 0
        if w_use <= 0:
            break
        flat_base = np.zeros(n_tiles, np.int64)
        flat_base[1:] = np.cumsum(cnts)[:-1]

        # sweep 2: per-window partial winners of every tile, brought to the
        # host together, then merged by the flat planner's rule
        parts = []
        ent = cache.ensure(0)
        for t in range(n_tiles):
            cur = ent
            if t + 1 < n_tiles:
                ent = cache.ensure(t + 1)
            cache.wait(cur)
            cap_t, usable_t, feas_t, nodes_t = cur["static"]
            used_t, coll_t = cur["dyn"]
            parts.append(window_sweep(
                cap_t, usable_t, feas_t, used_t, coll_t, nodes_t, demand_d, int(group_count),
                lraw, t * tn, offset, int(n_real), int(flat_base[t]), x0, total, w_use, wkey,
                table=cur.get("table")))
        parts = _to_host(parts, pinned)
        for _, t_score, t_rank, t_node, _ in parts:
            _devprof.count_d2h(t_score.nbytes + t_rank.nbytes + t_node.nbytes + 16)

        g_score = np.full(w_use, NEG_INF, np.float32)
        g_rank = np.full(w_use, _BIG, np.int64)
        g_node = np.full(w_use, -1, np.int64)
        last = -1
        for bases, t_score, t_rank, t_node, t_last in parts:
            last = max(last, int(t_last))
            # two partial blocks per tile (the straddle groups); the merge
            # is associative, so folding them in one by one is exact
            for blk in (0, 1):
                w_base = int(bases[blk])
                if w_base >= _BIG:
                    continue
                lo = blk * tn
                w_ids = w_base + np.arange(tn, dtype=np.int64)
                b_node = t_node[lo:lo + tn]
                sel = (b_node != -1) & (w_ids < w_use)
                if not sel.any():
                    continue
                wi = w_ids[sel]
                sc = t_score[lo:lo + tn][sel]
                rk = t_rank[lo:lo + tn][sel]
                nd = b_node[sel]
                better = (sc > g_score[wi]) | ((sc == g_score[wi]) & (rk < g_rank[wi]))
                wi = wi[better]
                g_score[wi] = sc[better]
                g_rank[wi] = rk[better]
                g_node[wi] = nd[better]

        # apply: window w's winner takes alloc slot placed + w; the winners
        # are distinct ring positions, so the vectorised update is exact
        win_nodes = g_node
        placements[placed + np.arange(w_use)] = win_nodes.astype(np.int32)
        qpos = inv[win_nodes]
        used_r[qpos] += demand_np[None, :]
        coll_r[qpos] += 1
        cache.mark_dirty(np.unique(qpos // tn))

        ring_exhausted = total < w_use * lraw
        consumed = n_real if ring_exhausted else last + 1
        offset = (offset + max(consumed, 0)) % n_real
        placed += w_use

    _devprof.count_rounds("paged", rounds, a, mesh is not None)
    stats = cache.stats()
    stats.update({"rounds": rounds, "tiles": n_tiles, "tile_nodes": tn, "placed": placed,
                  "n_pad": n_pad})
    return placements, rounds, stats


def _to_host(parts: list, pinned: bool) -> list:
    """The tiles' sweep-2 outputs as numpy: on the card, copied behind the
    sweep into one pinned buffer per output and synchronised once."""
    if not pinned:
        return [tuple(x.numpy() for x in p) for p in parts]
    slabs = [torch.empty((len(parts), *x.shape), dtype=x.dtype, pin_memory=True)
             for x in parts[0]]
    for t, p in enumerate(parts):
        for slab, x in zip(slabs, p):
            slab[t].copy_(x, non_blocking=True)
    torch.cuda.current_stream(parts[0][0].device).synchronize()
    return list(zip(*(slab.numpy() for slab in slabs)))


# ---------------------------------------------------------------------------
# the host oracle of this route: the windowed planner in numpy float32, op
# for op (the bit-stable _pow10 included)
# ---------------------------------------------------------------------------

def _pow10_np(x):
    """``kernel._pow10`` in numpy float32: every op is exact or correctly
    rounded, so the bits match the planners'."""
    x = np.clip(x.astype(np.float32), np.float32(-45.2), np.float32(45.2))
    c = np.float32(4097.0) * x
    x_hi = c - (c - x)
    x_lo = x - x_hi
    y_hi = x_hi * np.float32(_LOG2_10_HI)
    y_lo = x_hi * np.float32(_LOG2_10_LO) + x_lo * np.float32(_LOG2_10)
    n = np.round(y_hi + y_lo)
    f = (y_hi - n) + y_lo
    p = np.float32(1.535336188319500e-4)
    p = p * f + np.float32(1.339887440266574e-3)
    p = p * f + np.float32(9.618437357674640e-3)
    p = p * f + np.float32(5.550332471162809e-2)
    p = p * f + np.float32(2.402264791363012e-1)
    p = p * f + np.float32(6.931472028550421e-1)
    p = p * f + np.float32(1.0)
    n_i = n.astype(np.int32)
    n1 = np.clip(n_i, -126, 127)
    n2 = np.clip(n_i - n1, -126, 127)

    def two_pow(e):
        return ((e + 127) << 23).astype(np.int32).view(np.float32)

    return p * two_pow(n1) * two_pow(n2)


def _binpack_np(free_cpu, free_mem):
    total = _pow10_np(free_cpu) + _pow10_np(free_mem)
    return np.clip(np.float32(20.0) - total, np.float32(0.0), np.float32(18.0)) / np.float32(18.0)


def plan_windowed_np(capacity, usable, feasible, perm, demand, group_count, limit, n_allocs,
                     used0, collisions0, n_real: int, a_pad: int):
    """Host-numpy windowed placement, the oracle the paged planner is held
    against; returns ``(placements i32[a_pad], rounds)``."""
    capacity = np.asarray(capacity, dtype=np.int32)
    usable = np.asarray(usable, dtype=np.float32)
    feasible = np.asarray(feasible, dtype=bool)
    perm = np.asarray(perm, dtype=np.int64)
    demand = np.asarray(demand, dtype=np.int32)
    used = np.asarray(used0, dtype=np.int32).copy()
    coll = np.asarray(collisions0, dtype=np.int32).copy()
    n0 = capacity.shape[0]
    positions = np.arange(n0, dtype=np.int64)
    in_ring = positions < n_real
    a = int(n_allocs)
    lraw = int(limit)
    lm = max(lraw, 1)
    gcf = np.float32(int(group_count))

    placements = np.full(a_pad, -1, np.int32)
    offset = 0
    placed = 0
    rounds = 0
    while placed < a:
        rounds += 1
        fit_nodes = feasible & np.all(used + demand[None, :] <= capacity, axis=1)
        util = used + demand[None, :]
        free_cpu = np.float32(1.0) - util[:, 0].astype(np.float32) / usable[:, 0]
        free_mem = np.float32(1.0) - util[:, 1].astype(np.float32) / usable[:, 1]
        binpack = _binpack_np(free_cpu, free_mem)
        anti_present = coll > 0
        anti = np.where(
            anti_present, -(coll.astype(np.float32) + np.float32(1.0)) / gcf, np.float32(0.0),
        ).astype(np.float32)
        final = (binpack + anti) / (np.float32(1.0) + anti_present.astype(np.float32))

        fit_p = fit_nodes[perm] & in_ring
        score_p = final[perm]
        total = int(fit_p.sum())
        xc = np.cumsum(fit_p.astype(np.int64))
        xex = xc - fit_p
        x_off = xex[offset]
        feas_rank = np.where(positions >= offset, xex - x_off, total - x_off + xex)
        remaining = a - placed
        w_use = min(max(total // lm, 1), remaining) if total > 0 else 0
        if w_use <= 0:
            break
        window = feas_rank // lm
        active = fit_p & (window < w_use)
        act = np.nonzero(active)[0]
        w = window[act]
        sc = score_p[act]
        rk = feas_rank[act]
        order = np.lexsort((rk, -sc.astype(np.float64), w))
        ws = w[order]
        first = np.ones(len(ws), bool)
        first[1:] = ws[1:] != ws[:-1]
        win_pos = act[order][first]
        win_w = ws[first]
        win_nodes = perm[win_pos]
        used[win_nodes] += demand[None, :]
        coll[win_nodes] += 1
        placements[placed + win_w] = win_nodes.astype(np.int32)

        rot_rank = np.where(positions >= offset, positions - offset, n_real - offset + positions)
        consumed_window = fit_p & (feas_rank < w_use * lraw)
        last = int(rot_rank[consumed_window].max()) if consumed_window.any() else -1
        ring_exhausted = total < w_use * lraw
        consumed = n_real if ring_exhausted else last + 1
        offset = (offset + max(consumed, 0)) % n_real
        placed += w_use
    return placements, rounds
