"""Multi-eval kernel batching for the eval-broker drain.

Counterpart of ``nomad_tpu/tpu/drain.py``. Each eval of a drain batch
runs its scheduler bookkeeping on its own thread; its placement scan
parks at a :class:`KernelBatchCollector`, and the last thread to arrive
fuses every parked scan into ONE multi-eval exact scan (``kernel.plan_batch``
with a ring permutation and cursor per eval over one shared capacity
plane) and computes every eval's usage base (``used_bases``) on the same
stream, with no host sync between the two. Each eval gets its placement
slice and its base back as device tensors; the consumer's ``.cpu()`` is
the sync point.

The fused scan threads capacity through the evals in priority order, so
the batch's plans never oversubscribe one another.

With the wavefront stanza on (``wavefront.enabled()``) the fused batch
runs the wavefront planner in the scan's place, as the JAX collector does;
the usage bases read its placements the same way.

The inputs are the numpy records that cross the JAX package's own
host/device boundary: ``DrainPrep`` per eval (what the port's
``batch_sched._prepare_drain`` builds, as the JAX scheduler's does) and
the shared node planes (``SharedCluster.from_snapshot`` builds them from
a state snapshot; with the server's ``ColumnarMirror`` they alias the
store's committed planes and the batch reads the mirror's device planes).
The batch records the JAX collector's spans (``drain.park``,
``drain.build``, ``drain.kernel_dispatch``, with the device ledger's
tags and a ``recompile`` flag when a planner launched at a new shape in
its window) and metrics, and counts a batch over the paging budget that
uploads its host planes (``tpu.drain_paged_fallback``). The device
ledger counts the batch's host upload and, when its first eval takes its
slices back, the batch's placements and bases device to host (the JAX
collector counts them at its first consumer's sync).

Under an active mesh (``shard.active_mesh(n_real)``, the JAX collector's
gate) the batch pads the node axis to a mesh multiple, reads the mirror's
row-sharded planes (or places its host planes with ``shard.batch_specs``),
runs the sharded exact scan over the fused batch, or with the wavefront
stanza on the sharded wavefront (``shard.wavefront_specs()`` is the same
placement), and the sharded usage bases on the same stream; each eval's
base comes back as row slabs.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import metrics, resolve_device
from ..core.overload import DeadlineExceeded
from ..debug import devprof as _devprof
from ..trace import tracer
from . import kernel, shard, wavefront
from .columnar import R_COLS, ColumnarCluster, GroupPlanes
from .problems import bucket

logger = logging.getLogger("nomad_tpu_torch.tpu.drain")

#: stats of the most recent drain batch; ``planner`` is ``exact`` or
#: ``wavefront`` and ``rounds`` its round count (the lane count for the
#: scan; a device scalar for the wavefront on the card, read after the
#: batch's consumers synced)
LAST_DRAIN_STATS: dict = {}

#: cumulative drain accounting
DRAIN_COUNTERS = {"batches": 0, "evals": 0}

#: the planners whose new launch shapes flag a batch's dispatch span (the
#: applier's verify launches from another thread and is left out)
_PLANNERS = ("exact", "wavefront")


class SharedCluster:
    """The node-axis planes every eval of a drain batch shares, as numpy:
    ``capacity`` [n,C], ``usable`` [n,2] and the committed usage ``used0``
    [n,C] of the n real nodes. With a ``device_state`` (the server path)
    the batch reads the planes from that device-resident copy instead of
    uploading these. Built ``from_snapshot``, it also carries the ready
    ``nodes`` and their ``ColumnarCluster`` (``cluster``), which the
    ``tpu-batch`` scheduler's drain branch reads, and with a fresh
    ``ColumnarMirror`` the ``mirror`` and the generation ``gen`` whose
    device planes the batch reads."""

    def __init__(self, capacity, usable, used0, device_state=None):
        self.capacity = np.asarray(capacity)
        self.usable = np.asarray(usable)
        self.used0 = np.asarray(used0)
        self.n_real = self.capacity.shape[0]
        self.device_state = device_state
        self.nodes: Optional[list] = None
        self.cluster = None
        self.mirror = None
        self.gen = None

    @classmethod
    def from_snapshot(cls, snapshot, mirror=None) -> "SharedCluster":
        """The planes of a state snapshot, as the JAX package's
        ``SharedCluster(snapshot, mirror)`` builds them. With a ``mirror``
        (the server path) whose committed planes are at this snapshot's
        generation, the planes are the mirror's ``MirrorCluster`` over ALL
        nodes (a node that is not ready never enters a ring) and the batch
        reads the mirror's device planes. Otherwise (no mirror, or a write
        landed since the snapshot): ``ColumnarCluster.shared`` over the
        ready nodes in store order and the snapshot's usage
        ``initial_used``."""
        if mirror is not None:
            view = mirror.sync(snapshot)
            if view is not None:
                shared = cls(view.capacity, view.usable,
                             view.initial_used(snapshot))
                shared.nodes = view.nodes
                shared.cluster = view
                shared.mirror = mirror
                shared.gen = getattr(snapshot, "_gen", snapshot)
                return shared
        nodes = [n for n in snapshot.nodes() if n.ready()]
        cluster = ColumnarCluster.shared(snapshot, nodes)
        used0 = cluster.initial_used(snapshot).astype(np.int64)
        shared = cls(cluster.capacity, cluster.usable, used0)
        shared.nodes = nodes
        shared.cluster = cluster
        return shared


@dataclass
class DrainPrep:
    """One eval's contribution to the fused kernel batch (all arrays are in
    the shared cluster's node-index space)."""

    eval_id: str
    priority: int
    create_index: int
    planes_list: list[GroupPlanes]
    g_index: dict[str, int]
    g_demand: np.ndarray  # i32[Gi,C]
    g_limit: np.ndarray  # i32[Gi]
    gid_real: np.ndarray  # i32[Ai]
    perm_eligible: np.ndarray  # i32[n_elig] shuffled eligible node indices
    collisions0: np.ndarray  # i32[Gi, n_real] same-job alloc counts
    by_dc: dict[str, int]
    #: the eval's wall-clock deadline (unix ns, 0 = none)
    deadline: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "DrainPrep":
        """A prep from a dict of its fields with each group's planes as a
        dict (``problems.drain_problem``'s records)."""
        groups = [GroupPlanes(**g) for g in d["planes_list"]]
        return cls(**{**d, "planes_list": groups})


class _Parked:
    def __init__(self, prep: DrainPrep):
        self.prep = prep
        self.event = threading.Event()
        #: this eval's placement slice and usage base, device tensors
        #: handed back at dispatch
        self.placements = None
        self.used0 = None
        self.error: Optional[BaseException] = None
        #: the eval's drain.park span context, parent of the batch's spans
        self.trace_ctx = None
        #: the batch's device-to-host count, fired by its first eval back
        self.d2h: Optional[_BatchD2H] = None


class _BatchD2H:
    """One batch's placements and bases counted device to host once, by
    whichever of its evals takes its slices back first."""

    def __init__(self, nbytes: int):
        self.nbytes = nbytes
        self._fired = False
        self._lock = threading.Lock()

    def fire(self) -> None:
        with self._lock:
            if self._fired:
                return
            self._fired = True
        _devprof.count_d2h(self.nbytes, calls=2)


# ---------------------------------------------------------------------------
# per-eval usage bases (K9)
# ---------------------------------------------------------------------------

def used_bases_ref(used0, placements, demands, eval_of, E: int, n_real: int):
    """Plain version of the usage bases (JAX ``_used_bases_fn`` → ``bases``):
    ``out[e] = used0 + Σ_{e' < e} delta[e']``, where ``delta[e', n]`` sums
    the demands of the lanes of eval e' placed on node n < ``n_real``;
    i32[E,N,C], int32 adds wrap as JAX's do. A lane whose eval lies
    outside [0, E) adds nothing (the kernel's rule; the collector never
    makes one)."""
    N, C = used0.shape
    valid = (placements >= 0) & (placements < n_real) & (eval_of >= 0) & (eval_of < E)
    rows = torch.where(valid, eval_of, 0).long() * N + placements.clamp(0, N - 1).long()
    contrib = torch.where(valid[:, None], demands, 0)
    delta = torch.zeros((E * N, C), dtype=used0.dtype, device=used0.device)
    delta = delta.index_add_(0, rows, contrib).view(E, N, C)
    shift = torch.cat([torch.zeros_like(delta[:1]), torch.cumsum(delta, 0, dtype=torch.int32)[:-1]])
    return used0[None] + shift


_BASES_SHAPES = dict(used0="NC", placements="A", demands="AC", eval_of="A")
#: how the sharded usage bases take their inputs: the mirror's row slabs,
#: the scan's lanes replicated; the output splits along N (shard.COLS)
_BASES_SPECS = dict(used0=shard.ROWS, placements=shard.REP, demands=shard.REP,
                    eval_of=shard.REP)


def used_bases_sharded_ref(used0, placements, demands, eval_of, E: int, n_real: int):
    """Sharded plain version of the usage bases (JAX ``bases`` on the
    row-sharded ``used``): the unsharded one on the gathered plane, split
    along N into ``[E, N/S, C]`` slabs (a split is a layout: the same
    bits)."""
    full = used_bases_ref(used0.full(), placements, demands, eval_of, E, n_real)
    return shard.split(full, shard.COLS, len(used0.slabs))


def _bases_dims(used0, placements, demands, eval_of) -> tuple:
    """(N, C, A) of what the usage-base kernel takes: int32 planes,
    contiguous, on one device, of shapes [N,C], [A], [A,C] and [A]. One
    combined test; where it fails, the full check names the fault and
    raises."""
    i32 = torch.int32
    if (used0.dtype is placements.dtype is demands.dtype is eval_of.dtype is i32
            and used0.device == placements.device == demands.device == eval_of.device
            and used0.is_contiguous() and placements.is_contiguous()
            and demands.is_contiguous() and eval_of.is_contiguous() and len(used0.shape) == 2
            and placements.shape == eval_of.shape == demands.shape[:1]
            and demands.shape[1:] == used0.shape[1:]):
        return used0.shape[0], used0.shape[1], placements.shape[0]
    d = kernel._check_int32(
        dict(used0=used0, placements=placements, demands=demands, eval_of=eval_of),
        _BASES_SHAPES, used0.device,
    )
    return d["N"], d["C"], d["A"]


def used_bases(used0, placements, demands, eval_of, E: int, n_real: int):
    """Each eval's usage base: ``used0`` plus every earlier eval's granted
    demands; i32[E,N,C]. Checks what the kernel takes on either device; on
    the CPU the plain version, on the card one launch (``csrc/bases.cu``)
    that reads ``placements`` where the scan left them, on the same stream,
    and does not wait for the card. A row-sharded ``used0`` gives the bases
    split along N (``shard.COLS``): on the card one launch over every shard
    (``csrc/mesh_server.cu``), which enters the device ledger as
    sharded."""
    if isinstance(used0, shard.Sharded):
        return _used_bases_mesh(used0, placements, demands, eval_of, E, n_real)
    N, C, A = _bases_dims(used0, placements, demands, eval_of)
    device = used0.device
    if not 0 < n_real <= N:
        raise ValueError(f"n_real {n_real} outside (0, {N}]")
    if device.type == "cpu":
        return used_bases_ref(used0, placements, demands, eval_of, E, n_real)
    from . import _build

    out = used0.new_empty((E, N, C))
    if out.numel() == 0:  # no eval or no column: nothing to write
        return out
    rc = _build.library().ntt_used_bases(used0.data_ptr(), placements.data_ptr(),
                                         demands.data_ptr(), eval_of.data_ptr(), out.data_ptr(),
                                         N, C, A, E, n_real, kernel._stream_ptr(device))
    if rc:
        kernel._launch_status("used_bases", rc)
    kernel.LAUNCHES["used_bases"] += 1
    return out


def _used_bases_mesh(used0, placements, demands, eval_of, E: int, n_real: int):
    device = used0.device
    d = kernel._check_mesh_int32(
        dict(used0=used0, placements=placements, demands=demands, eval_of=eval_of),
        _BASES_SPECS, _BASES_SHAPES, device)
    N, C, A, S = d["N"], d["C"], d["A"], d["S"]
    if not 0 < n_real <= N:
        raise ValueError(f"n_real {n_real} outside (0, {N}]")
    key = f"E{E}N{N}A{A}"
    if device.type == "cpu":
        t0 = time.perf_counter()
        out = used_bases_sharded_ref(used0, placements, demands, eval_of, E, n_real)
    else:
        lib = kernel._library()
        t0 = time.perf_counter()
        out = shard.Sharded(shard.COLS, (t.new_empty((E, N // S, C)) for t in used0.slabs))
        kernel._launch_mesh("mesh_bases", lib.ntt_mesh_bases,
                            [used0, placements, demands, eval_of, out],
                            S, N, C, A, E, n_real, device=device)
    kernel._ledger("used_bases", key, device, t0, sharded=True)
    return out


def _nbytes(x) -> int:
    slabs = x.slabs if isinstance(x, shard.Sharded) else (x,)
    return sum(t.numel() * t.element_size() for t in slabs)


# ---------------------------------------------------------------------------
# batch assembly
# ---------------------------------------------------------------------------

def batch_shape(preps: list, n_real: int, pad_evals: int, mesh=None) -> tuple:
    """Padded (E, G, A, N, V) of a fused batch: the JAX collector's buckets
    with its ``pad_evals`` floors, so partial batches share one shape; the
    node axis a multiple of ``mesh``'s shards (``shard.node_bucket``)."""
    N = shard.node_bucket(n_real, mesh)
    E = bucket(max(len(preps), pad_evals))
    G = bucket(max(sum(len(p.planes_list) for p in preps), pad_evals))
    A = bucket(max(sum(len(p.gid_real) for p in preps), pad_evals * 4))
    V = bucket(
        max(
            max(
                (len(pl.counts0) for p in preps for pl in p.planes_list
                 if pl.counts0 is not None),
                default=1,
            ),
            8,
        )
    )
    return E, G, A, N, V


def assemble(preps: list, n_real: int, shape: tuple):
    """The fused scan's group and alloc planes for ``preps`` in batch order,
    as numpy: (args without capacity/usable, state without used, the
    (first lane, lane count) of each eval)."""
    E, G, A, N, V = shape
    feasible = np.zeros((G, N), dtype=bool)
    affinity = np.zeros((G, N), dtype=np.float32)
    affinity_present = np.zeros((G, N), dtype=bool)
    group_count = np.ones(G, dtype=np.int32)
    group_eval = np.full(G, E - 1, dtype=np.int32)
    node_value = np.full((G, N), -1, dtype=np.int32)
    spread_desired = np.full((G, V), -1.0, dtype=np.float32)
    spread_implicit = np.full(G, -1.0, dtype=np.float32)
    spread_weight_frac = np.zeros(G, dtype=np.float32)
    spread_even = np.zeros(G, dtype=bool)
    spread_active = np.zeros(G, dtype=bool)
    counts0 = np.zeros((G, V), dtype=np.int32)
    present0 = np.zeros((G, V), dtype=bool)
    collisions0 = np.zeros((G, N), dtype=np.int32)
    perm = np.tile(np.arange(N, dtype=np.int32), (E, 1))
    ring = np.zeros(E, dtype=np.int32)

    demands = np.zeros((A, R_COLS), dtype=np.int32)
    groups = np.zeros(A, dtype=np.int32)
    limits = np.zeros(A, dtype=np.int32)
    valid = np.zeros(A, dtype=bool)

    g_off = 0
    a_off = 0
    slices = []
    for e, prep in enumerate(preps):
        # the ring: the eval's eligible nodes, then the rest in id order
        elig_mask = np.ones(N, dtype=bool)
        elig_mask[prep.perm_eligible] = False
        rest = np.flatnonzero(elig_mask).astype(np.int32)
        perm[e] = np.concatenate([prep.perm_eligible, rest])
        ring[e] = len(prep.perm_eligible)
        for gi, planes in enumerate(prep.planes_list):
            g = g_off + gi
            feasible[g, :n_real] = planes.feasible
            affinity[g, :n_real] = planes.affinity
            affinity_present[g, :n_real] = planes.affinity_present
            group_count[g] = planes.count
            group_eval[g] = e
            collisions0[g, :n_real] = prep.collisions0[gi]
            if planes.node_value is not None:
                node_value[g, :n_real] = planes.node_value
                nv = len(planes.counts0)
                counts0[g, :nv] = planes.counts0
                present0[g, :nv] = planes.present0
                spread_desired[g, : len(planes.desired)] = planes.desired
                spread_implicit[g] = planes.implicit
                spread_weight_frac[g] = planes.weight_frac
                spread_even[g] = planes.even
                spread_active[g] = True
        a_len = len(prep.gid_real)
        demands[a_off : a_off + a_len] = prep.g_demand[prep.gid_real]
        groups[a_off : a_off + a_len] = prep.gid_real + g_off
        limits[a_off : a_off + a_len] = prep.g_limit[prep.gid_real]
        valid[a_off : a_off + a_len] = True
        slices.append((a_off, a_len))
        g_off += len(prep.planes_list)
        a_off += a_len

    args = dict(
        feasible=feasible, affinity=affinity, affinity_present=affinity_present,
        group_count=group_count, group_eval=group_eval, node_value=node_value,
        spread_desired=spread_desired, spread_implicit=spread_implicit,
        spread_weight_frac=spread_weight_frac, spread_even=spread_even,
        spread_active=spread_active, perm=perm, ring=ring, demands=demands,
        groups=groups, limits=limits, valid=valid,
    )
    state = dict(
        collisions=collisions0, spread_counts=counts0, spread_present=present0,
        offset=np.zeros(E, dtype=np.int32),
    )
    return args, state, slices


def host_planes(shared: SharedCluster, N: int) -> tuple:
    """(capacity, usable, used) of ``shared`` padded to N rows as the JAX
    collector pads its host upload: pad rows have no capacity, usable 1.0
    and a poisoned usage (2**30)."""
    n_real = shared.n_real
    capacity = np.zeros((N, R_COLS), dtype=np.int32)
    capacity[:n_real] = shared.capacity
    usable = np.ones((N, 2), dtype=np.float32)
    usable[:n_real] = shared.usable
    used0 = np.full((N, R_COLS), 2**30, dtype=np.int32)
    used0[:n_real] = shared.used0
    return capacity, usable, used0


def batch_inputs(planes: tuple, args: dict, state: dict, device, mesh=None) -> tuple:
    """(BatchArgs, BatchState) of the exact scan from the node planes
    (capacity, usable, used: tensors on ``device``, or numpy) and
    ``assemble``'s numpy dicts. With ``mesh``, every leaf placed by
    ``shard.batch_specs`` (the mirror's row slabs as they are)."""
    if mesh is not None:
        aspec, sspec = shard.batch_specs()
        capacity, usable, used = planes
        return (shard.put(kernel.BatchArgs(capacity=capacity, usable=usable, **args), aspec, mesh),
                shard.put(kernel.BatchState(used=used, **state), sspec, mesh))
    dev = resolve_device(device)
    capacity, usable, used = (
        p if isinstance(p, torch.Tensor) else kernel.from_numpy(p, dev) for p in planes
    )
    a = dict(zip(args, kernel.from_numpy(tuple(args.values()), dev)))
    s = dict(zip(state, kernel.from_numpy(tuple(state.values()), dev)))
    return (kernel.BatchArgs(capacity=capacity, usable=usable, **a),
            kernel.BatchState(used=used, **s))


def solo_scan(prep: DrainPrep, planes: tuple, n_real: int, device=None):
    """One eval's exact scan on its own, E = 1: the sequential reference of
    a fused batch. ``planes`` are the (capacity, usable, used) node planes
    padded to the batch's N, tensors or numpy, with ``used`` the eval's
    usage base in the batch; returns the eval's placements."""
    shape = batch_shape([prep], n_real, 1)
    shape = shape[:3] + (planes[0].shape[0],) + shape[4:]
    args, state, ((_, a_len),) = assemble([prep], n_real, shape)
    bargs, init = batch_inputs(planes, args, state, device)
    _, placements = kernel.plan_batch(bargs, init, n_real)
    return placements[:a_len]


def last_kernel_s() -> float:
    """Seconds of the last batch's scan and usage bases: on the card from
    CUDA events recorded around the two launches (this waits for them),
    on the CPU the host time of the two plain calls."""
    events = LAST_DRAIN_STATS["kernel_events"]
    if events is None:
        return LAST_DRAIN_STATS["dispatch_s"]
    start, end = events
    end.synchronize()
    return start.elapsed_time(end) / 1e3


# ---------------------------------------------------------------------------
# the rendezvous
# ---------------------------------------------------------------------------

class KernelBatchCollector:
    """Rendezvous for the evals of one drain batch.

    Each eval's thread either ``submit()``s its prep (blocking until the
    fused batch is dispatched) or ``leave()``s. The last thread to arrive
    runs the batch for everyone, outside the lock. The batch runs on
    ``device``: CUDA unless the caller asks for the CPU, where the plain
    versions run."""

    def __init__(self, shared: SharedCluster, expected: int, timeout: float = 60.0,
                 pad_evals: int = 0, device=None):
        self.shared = shared
        self.device = resolve_device(device)
        ds = shared.device_state
        if ds is not None and ds.device.type != self.device.type:
            raise ValueError(f"device state on {ds.device}, collector on {self.device}")
        self.timeout = timeout
        self._expected = expected
        #: padding floor (the worker's configured drain size): batches of
        #: varying occupancy share one padded shape
        self.pad_evals = max(pad_evals, expected)
        self._lock = threading.Lock()
        self._parked: list[_Parked] = []
        self._consumed: set[str] = set()
        self.invocations = 0
        #: per-node port indexes shared by the batch's evals (the
        #: scheduler's dynamic-port post-pass), under ``net_lock``
        self.net_indexes: dict = {}
        self.net_lock = threading.Lock()

    def consumed(self, eval_id: str) -> bool:
        with self._lock:
            return eval_id in self._consumed

    def leave(self, eval_id: str) -> None:
        """An eval is not taking part. Idempotent per eval."""
        with self._lock:
            if eval_id in self._consumed:
                return
            self._consumed.add(eval_id)
            self._expected -= 1
            batch = self._take_batch_locked()
        self._run_batch(batch)

    def submit(self, prep: DrainPrep) -> tuple:
        """Park this eval's prep; returns (its placements, its usage base
        including every earlier eval's grants), tensors on the device."""
        park = _Parked(prep)
        # opened before parking: the last thread to arrive records the
        # batch's build and dispatch spans under it, so the park's own
        # time is the rendezvous wait
        park_span = tracer.start_span("drain.park")
        park.trace_ctx = park_span.ctx() or tracer.ctx_for_eval(prep.eval_id)
        with self._lock:
            self._consumed.add(prep.eval_id)
            self._parked.append(park)
            batch = self._take_batch_locked()
        try:
            self._run_batch(batch)
            arrived = park.event.wait(self.timeout)
        finally:
            park_span.end()
        if not arrived:
            raise RuntimeError("drain kernel batch timed out")
        if park.error is not None:
            raise park.error
        if park.d2h is not None:
            park.d2h.fire()
        return park.placements, park.used0

    def _take_batch_locked(self) -> Optional[list]:
        """Detach the complete batch under the lock; the caller runs it
        after releasing the lock."""
        if len(self._parked) < self._expected or not self._parked:
            return None
        parked, self._parked = self._parked, []
        self._expected = 0
        return parked

    def _run_batch(self, parked: Optional[list]) -> None:
        if not parked:
            return
        # lanes whose deadline passed while they waited are refused before
        # the build and the device round
        now = time.time_ns()
        expired = [p for p in parked if p.prep.deadline and now >= p.prep.deadline]
        if expired:
            metrics.incr("overload.deadline_exceeded.drain", len(expired))
            for p in expired:
                p.error = DeadlineExceeded(
                    "drain lane refused: deadline exceeded before device dispatch",
                    where="drain",
                )
                p.event.set()
            parked = [p for p in parked if p.error is None]
            if not parked:
                return
        # highest priority first, then submission order: capacity threads
        # through the fused scan the way the serial applier would commit
        parked.sort(key=lambda p: (-p.prep.priority, p.prep.create_index, p.prep.eval_id))
        try:
            self._run(parked)
        except BaseException as e:  # every parked thread raises it
            logger.exception("drain kernel batch failed")
            for p in parked:
                p.error = e
        finally:
            for p in parked:
                p.event.set()

    def _run(self, parked: list) -> None:
        t0 = time.perf_counter()
        shared, dev = self.shared, self.device
        preps = [p.prep for p in parked]
        n_real = shared.n_real
        # the node axis split over the mesh, gated by the cluster's size as
        # the JAX collector gates it; N rounds to a mesh multiple
        mesh = shard.active_mesh(n_real)
        if mesh is not None and mesh.device.type != dev.type:
            raise ValueError(f"the mesh is on {mesh.device}, the collector on {dev}")
        shape = batch_shape(preps, n_real, self.pad_evals, mesh)
        E, G, A, N, V = shape
        ds = shared.device_state
        planes = None
        if ds is not None:
            # planes already on the device, used kept current by
            # dirty-row scatters
            if ds.n_pad != N:
                raise ValueError(f"device state has {ds.n_pad} rows, the batch pads to {N}")
            if ds.mesh is not mesh:
                raise ValueError(f"device state over {ds.mesh}, the batch over {mesh}")
            planes = ds.arrays()
        elif shared.mirror is not None:
            # the server path: the mirror's device planes at the batch's
            # generation (None once a write has landed since, or past the
            # paging budget), row-sharded under the mesh
            planes = shared.mirror.device_state(N, shared.gen, mesh=mesh)
        on_device = planes is not None
        if planes is None:
            planes = host_planes(shared, N)
            # over the paging budget the mirror refuses a resident plane;
            # this batch uploads its host planes instead, counted
            from . import paging

            if paging.should_page(N, R_COLS):
                metrics.incr("tpu.drain_paged_fallback")
        args_np, state_np, slices = assemble(preps, n_real, shape)
        eval_of = args_np["group_eval"][args_np["groups"]]
        if mesh is None:
            # the batch's upload: host planes and the assembled tables (the
            # mirror's device planes count zero)
            _devprof.count_tree_h2d((planes, args_np, state_np))
            args, init = batch_inputs(planes, args_np, state_np, dev)
            eval_of = kernel.from_numpy(eval_of, dev)
        else:
            # every leaf placed with its spec through the counted upload;
            # the eval of each lane replicated explicitly, as JAX places it
            args, init = batch_inputs(planes, args_np, state_np, dev, mesh)
            eval_of = shard.put(eval_of, shard.REP, mesh)
        t_build = time.perf_counter()

        events = None
        if dev.type == "cuda":
            events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
            events[0].record()
        n_allocs = sum(a_len for _, a_len in slices)
        cache_before = _devprof.compile_cache_size(_PLANNERS)
        # n_valid: the round ledger charges the batch's rounds against the
        # real placements asked for, not the padded lane count
        if wavefront.enabled():
            planner = "wavefront"
            _, placements, rounds = wavefront.plan_batch_wavefront(args, init, n_real,
                                                                   n_valid=n_allocs)
        else:
            planner = "exact"
            _, placements = kernel.plan_batch(args, init, n_real, n_valid=n_allocs)
            rounds = A  # one scan step per lane
        # same stream, no sync: the bases read the planner's output in place
        bases = used_bases(init.used, placements, args.demands, eval_of, E, n_real)
        if events is not None:
            events[1].record()
        t_disp = time.perf_counter()
        cache_after = _devprof.compile_cache_size(_PLANNERS)

        d2h = _BatchD2H(_nbytes(placements) + _nbytes(bases))
        for e, (park, (a_start, a_len)) in enumerate(zip(parked, slices)):
            park.placements = placements[a_start : a_start + a_len]
            # under a mesh an eval's base is its plane of every shard's slab
            park.used0 = (shard.Sharded(shard.ROWS, (t[e] for t in bases.slabs))
                          if isinstance(bases, shard.Sharded) else bases[e])
            park.d2h = d2h

        # the batch's shared stages, recorded into every eval's tree
        # under its drain.park span
        dispatch_tags = {
            "batch_evals": len(parked),
            "padded": f"E{E}xG{G}xA{A}xN{N}xV{V}",
            "mirror": shared.mirror is not None,
            "planner": planner,
        }
        if planner == "exact":
            # the scan runs one round per alloc lane: the convoy size
            # reads span-locally (the wavefront's rounds are a device
            # scalar, read by the ledger once the card is done)
            dispatch_tags["collective_rounds"] = A
            dispatch_tags["placements"] = n_allocs
        if mesh is not None:
            # the shard topology, so a trace tells a sharded dispatch (and
            # its width) from an unsharded one
            dispatch_tags.update(shard.shard_tags(mesh))
        # the launch's ledger entry (no cost figures exist for a
        # hand-written kernel, so this adds none)
        dispatch_tags.update(_devprof.dispatch_tags(planner))
        # a planner that launched at a new shape in this window paid its
        # first-launch cost here
        recompiled = cache_after > cache_before
        if recompiled:
            dispatch_tags["jit_cache_delta"] = cache_after - cache_before
        for park in parked:
            tracer.record_span("drain.build", park.trace_ctx, t0, t_build,
                               tags={"batch_evals": len(parked)})
            tracer.record_span("drain.kernel_dispatch", park.trace_ctx, t_build, t_disp,
                               tags=dispatch_tags,
                               flags=("recompile",) if recompiled else ())

        self.invocations += 1
        DRAIN_COUNTERS["batches"] += 1
        DRAIN_COUNTERS["evals"] += len(parked)
        LAST_DRAIN_STATS.update(
            n_evals=len(parked),
            n_allocs=n_allocs,
            planner=planner,
            rounds=rounds,
            n_nodes=n_real,
            build_s=t_build - t0,
            dispatch_s=t_disp - t_build,
            kernel_events=events,
            device_state=on_device,
            mirror=shared.mirror is not None,
            padded=shape,
            shards=shard.mesh_size(mesh),
        )
        metrics.sample("drain.batch_build", t_build - t0)

