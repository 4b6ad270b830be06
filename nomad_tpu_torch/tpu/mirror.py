"""Committed-plane columnar view of cluster state, and its device planes.

The port's copy of ``nomad_tpu/tpu/mirror.py``. The dense capacity/used
planes live in the state store itself (``state.planes.CommittedPlanes``),
patched by the same write transaction that swaps the MVCC tables, so the
planes are exact by construction: ``planes.gen is snapshot._gen`` is the
whole freshness test.

- :class:`MirrorCluster` — a ColumnarCluster whose usage plane, exotic
  counts and alloc records ALIAS the committed planes;
- :class:`DeviceState` — the planes on the device, uploaded once per
  node-axis epoch through the device ledger's counted upload
  (``devprof.device_put``) and kept current by the dirty-row scatter
  (``csrc/scatter.cu`` on the card), whose rows and values upload counted
  too, fed from the store's in-commit track/untrack through
  ``register_sink``;
- :class:`ColumnarMirror` — the adapter the server builds: ``sync`` /
  ``device_state`` / ``verify_handles`` / ``locked_cluster`` / ``stats``,
  with the paging budget gate and its counters.

Under a mesh (``tpu/shard.py``) the planes are split by node rows into
the mesh's slabs, uploaded once through ``shard.put``, and the dirty-row
scatter writes new slabs, each row on the shard that owns it
(``csrc/mesh_server.cu`` on the card); a cached state for another mesh is
rebuilt, never reshared.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..debug import devprof as _devprof
from ..state.planes import exotic_flag, usage_vec  # noqa: F401 — canonical
# definitions live in the state layer with the planes; re-exported here
# as in the JAX package
from . import kernel, shard
from .columnar import R_COLS, ColumnarCluster

logger = logging.getLogger("nomad_tpu_torch.tpu.mirror")


class MirrorCluster(ColumnarCluster):
    """A ColumnarCluster whose usage plane and collision counts alias the
    store's committed planes. Built over ALL nodes in the state (not just
    ready ones) so per-eval eligibility is a ring permutation, never a
    node-axis change; a node status flap is an object swap the store
    already performed in the shared ``nodes`` list.

    The fast paths serve only the exact generation the planes are
    committed at; any other generation falls back to the base class's
    scan-the-table implementations, so a stale reader can never observe a
    half-applied write transaction."""

    def __init__(self, planes):
        super().__init__(planes.nodes)
        self._planes = planes
        self._epoch = planes.epoch
        self._mirror_lock = planes.lock
        # alias, don't copy: the store's write transactions patch these
        # in-commit, and this view sees the result the moment the planes
        # are restamped
        self.index = planes.index
        # nta: ignore[plane-mutation-outside-commit] WHY: read-only
        # aliasing, not mutation — the next four bind the committed
        # arrays/tables into this view so fast paths index them with
        # zero copies; nothing here ever writes through the alias
        #: reserved + Σ live-alloc contributions per row (int64, [N, R])
        self.mirror_used = planes.used
        #: live allocs per row carrying ports/devices (dimensions the
        #: dense planes can't verify): the plan applier's device verify
        #: degrades these rows to the exact host check
        # nta: ignore[plane-mutation-outside-commit] WHY: read-only alias
        self.exotic_live = planes.exotic_live
        #: alloc id → (node_id, usage vec, job_id, task_group, exotic)
        # nta: ignore[plane-mutation-outside-commit] WHY: read-only alias
        self._alloc_rec = planes.alloc_rec
        #: (job_id, task_group) → {node_id: live alloc count}
        # nta: ignore[plane-mutation-outside-commit] WHY: read-only alias
        self._job_counts = planes.job_counts

    @property
    def _synced_gen(self):
        """The generation this view is exact for: the planes' committed
        generation while the node axis it was derived over is current,
        else None (the adapter builds a fresh view on the next sync)."""
        p = self._planes
        return p.gen if p.epoch == self._epoch else None

    # -- committed-plane fast paths -------------------------------------
    def initial_used(self, state, plan=None) -> np.ndarray:
        gen = getattr(state, "_gen", state)
        with self._mirror_lock:
            if gen is self._synced_gen:
                used = self.mirror_used.copy()
                if plan is not None:
                    for node_id, stops in plan.node_update.items():
                        row = self.index.get(node_id)
                        if row is None:
                            continue
                        for a in stops:
                            rec = self._alloc_rec.get(a.id)
                            if rec is not None and rec[0] == node_id:
                                used[row] -= np.asarray(
                                    rec[1], dtype=np.int64
                                )
                return used
        # stale generation: the O(total allocs) rescan runs OUTSIDE the
        # lock — a reader one generation behind must not serialize the
        # store's write transactions behind a full table scan
        return super().initial_used(state, plan)

    def collision_counts(self, state, job_id: str, tg_name: str) -> np.ndarray:
        gen = getattr(state, "_gen", state)
        with self._mirror_lock:
            if gen is self._synced_gen:
                counts = np.zeros(len(self.nodes), dtype=np.int32)
                for node_id, c in self._job_counts.get(
                    (job_id, tg_name), {}
                ).items():
                    row = self.index.get(node_id)
                    if row is not None:
                        counts[row] = c
                return counts
        return super().collision_counts(state, job_id, tg_name)




def scatter_rows_sharded_ref(used, rows, vals):
    """Sharded plain version of the dirty-row scatter (JAX
    ``_scatter_fn(mesh)``): the unsharded one on the gathered plane, split
    by rows as ``used`` is (a split is a layout: the same bits)."""
    return shard.split_like(scatter_rows_ref(used.full(), rows, vals), used)


def scatter_rows_ref(used, rows, vals):
    """Plain version of the dirty-row scatter (JAX ``_scatter_fn(None)``):
    a NEW plane equal to ``used`` with ``out[rows[i]] = vals[i]``. Among
    lanes on one row the lowest lane wins (JAX leaves the order of
    duplicate writes open; its callers' duplicates carry one value). A
    lane whose row lies outside [0, N) writes nothing."""
    N, R = used.shape[0], rows.shape[0]
    out = used.clone()
    ok = (rows >= 0) & (rows < N)
    at = torch.where(ok, rows, 0).long()
    lane = torch.arange(R, device=rows.device)
    first = torch.full((N,), R, dtype=torch.int64, device=rows.device).scatter_reduce(
        0, at[ok], lane[ok], "amin"
    )
    keep = ok & (first[at] == lane)
    out[at[keep]] = vals[keep]
    return out


_SCATTER_SHAPES = dict(used="NC", rows="R", vals="RC")
_SCATTER_SPECS = dict(used=shard.ROWS, rows=shard.REP, vals=shard.REP)


def scatter_rows(used, rows, vals):
    """``used`` with ``rows`` set to ``vals``, in a new tensor: ``used``,
    which an earlier kernel may still be reading, is never written. On the
    card it is one launch (``csrc/scatter.cu``) and one allocation. A
    row-sharded ``used`` gives new row slabs: on the card one launch over
    every shard (``csrc/mesh_server.cu``), which enters the device ledger
    as sharded."""
    if isinstance(used, shard.Sharded):
        return _scatter_rows_mesh(used, rows, vals)
    device = used.device
    if device.type == "cpu":
        return scatter_rows_ref(used, rows, vals)
    from . import _build

    d = kernel._check_int32(dict(used=used, rows=rows, vals=vals), _SCATTER_SHAPES, device)
    out = torch.empty_like(used)
    kernel._launch(
        "scatter_rows",
        _build.library().ntt_scatter_rows,
        kernel._ptr(used), kernel._ptr(rows), kernel._ptr(vals), kernel._ptr(out),
        d["N"], d["C"], d["R"],
        kernel._stream(device),
    )
    return out


def _scatter_rows_mesh(used, rows, vals):
    device = used.device
    d = kernel._check_mesh_int32(dict(used=used, rows=rows, vals=vals), _SCATTER_SPECS,
                                 _SCATTER_SHAPES, device)
    N, C, R, S = d["N"], d["C"], d["R"], d["S"]
    key = f"N{N}R{R}"
    if device.type == "cpu":
        t0 = time.perf_counter()
        out = scatter_rows_sharded_ref(used, rows, vals)
    else:
        lib = kernel._library()
        t0 = time.perf_counter()
        out = shard.Sharded(shard.ROWS, (torch.empty_like(t) for t in used.slabs))
        kernel._launch_mesh("mesh_scatter", lib.ntt_mesh_scatter, [used, rows, vals, out],
                            S, N, C, R, device=device)
    kernel._ledger("scatter_rows", key, device, t0, sharded=True)
    return out


def dirty_lanes(rows, used_host) -> tuple:
    """The scatter's (rows, values) lanes for dirty ``rows`` of the host
    plane ``used_host``, as numpy: padded to the row bucket with row 0 and
    row 0's own value, values clipped to the device plane's [0, 2**30]."""
    rows = np.asarray(rows, dtype=np.int32)
    if rows.min() < 0 or rows.max() >= len(used_host):
        raise ValueError(f"dirty row outside [0, {len(used_host)})")
    padded = np.zeros(DeviceState._row_bucket(len(rows)), dtype=np.int32)
    padded[: len(rows)] = rows
    return padded, np.clip(used_host[padded], 0, 2**30).astype(np.int32)


class DeviceState:
    """The node planes of one (epoch, padded N) on the device: capacity and
    usable uploaded once, and a ``used`` plane kept current by scattering
    just the dirty rows. A refresh COPIES rather than updates in place:
    a drain batch hands ``used`` to kernels that may still be reading it
    when the next refresh comes, so a plane once handed out is never
    written. With ``mesh`` the three planes are split by node rows over
    it (``shard.Sharded`` slabs on the mesh's device), and a refresh
    scatters into new slabs."""

    #: dirty-row counts are bucketed, as the JAX package buckets them to
    #: bound its compiled scatter shapes
    _ROW_BUCKETS = (8, 64, 512, 4096)

    def __init__(self, epoch: int, n_pad: int, capacity, usable, used, device=None,
                 mesh=None):
        dev = resolve_device(device)
        if mesh is not None and mesh.device.type != dev.type:
            raise ValueError(f"a mesh on {mesh.device} for planes on {dev}")
        n = capacity.shape[0]
        #: the mesh the planes are row-sharded over (None: one plane each);
        #: a batch reads only a state whose mesh is its own
        self.mesh = mesh
        self.epoch = epoch
        self.n_pad = n_pad
        cap = np.zeros((n_pad, R_COLS), dtype=np.int32)
        cap[:n] = np.clip(capacity, 0, 2**31 - 1)
        usa = np.ones((n_pad, 2), dtype=np.float32)
        usa[:n] = usable
        use = np.full((n_pad, R_COLS), 2**30, dtype=np.int32)
        use[:n] = np.clip(used, 0, 2**30)
        if mesh is not None:
            self.capacity, self.usable, self.used = shard.put(
                (cap, usa, use), (shard.ROWS,) * 3, mesh)
        else:
            self.capacity, self.usable, self.used = (
                _devprof.device_put(a, dev) for a in (cap, usa, use)
            )
        #: bytes of the upload, and of the refreshes since, as the device
        #: ledger counts them
        self.upload_bytes = cap.nbytes + usa.nbytes + use.nbytes
        self.refresh_bytes = 0
        #: dirty rows since the last refresh; the caller adds to it
        self.pending: set[int] = set()

    @property
    def device(self) -> torch.device:
        return self.used.device

    @staticmethod
    def _row_bucket(n: int) -> int:
        for b in DeviceState._ROW_BUCKETS:
            if n <= b:
                return b
        return ((n + 4095) // 4096) * 4096

    def refresh(self, used_host: np.ndarray) -> None:
        """Push the pending dirty rows of ``used_host`` to the device as one
        scatter into a new ``used`` plane."""
        if not self.pending:
            return
        rows = np.fromiter(self.pending, dtype=np.int32, count=len(self.pending))
        padded, vals = dirty_lanes(rows, used_host)
        self.pending.clear()
        self.refresh_bytes += padded.nbytes + vals.nbytes
        if self.mesh is not None:
            # the dirty rows and values replicate explicitly, as the JAX
            # refresh places them
            lanes = shard.put((padded, vals), (shard.REP, shard.REP), self.mesh)
        else:
            lanes = (_devprof.device_put(padded, self.device),
                     _devprof.device_put(vals, self.device))
        self.used = scatter_rows(self.used, *lanes)

    def arrays(self):
        """(capacity, usable, used) on the device. A later refresh makes a
        NEW used plane, so a tensor handed out here never changes."""
        return self.capacity, self.usable, self.used


class ColumnarMirror:
    """The committed-plane columnar view for one server: an adapter over
    ``state.planes`` that builds the MirrorCluster view per node-axis
    epoch and owns the device-resident plane cache."""

    def __init__(self, state, device=None):
        # ``device`` holds the DeviceState planes: CUDA unless the caller
        # passes "cpu" (nomad_tpu_torch.resolve_device)
        self.device = resolve_device(device)
        self._state = state
        self._planes = state.planes
        self._lock = self._planes.lock
        self._closed = False
        self._cluster: Optional[MirrorCluster] = None
        self._device: dict[int, DeviceState] = {}
        self.counters = {
            "hits": 0,
            "rebuilds": 0,  # structurally zero — kept as the gate metric
            "stale": 0,
            "view_refreshes": 0,
            "over_budget": 0,
            # the port's device-plane counters: full uploads, dirty-row
            # refreshes (one scatter launch each) and the rows they carry,
            # and the bytes each kind moved host to device
            "uploads": 0,
            "refreshes": 0,
            "rows_scattered": 0,
            "upload_bytes": 0,
            "refresh_bytes": 0,
            "rebuild_reasons": {},
        }

    # ------------------------------------------------------------------
    def _ensure_cluster(self) -> MirrorCluster:
        """The MirrorCluster view for the planes' current node axis,
        re-derived (static planes only: capacity/usable/single_nic — the
        usage state is aliased, never copied) when the axis epoch moved.
        Caller holds the plane lock."""
        cluster = self._cluster
        if cluster is None or cluster._epoch != self._planes.epoch:
            from .. import metrics

            cluster = MirrorCluster(self._planes)
            self._cluster = cluster
            # retire device planes for the dead axis; their pending-row
            # sinks die with them
            for ds in self._device.values():
                self._planes.unregister_sink(ds.pending)
            self._device.clear()
            self.counters["view_refreshes"] += 1
            metrics.incr("tpu.mirror_view_refresh")
        return cluster

    def sync(self, snapshot) -> Optional[MirrorCluster]:
        """The MirrorCluster view of exactly ``snapshot``, or None when
        the committed planes are at a different generation (a write
        landed between the caller's snapshot and this sync — the caller
        builds a one-off legacy cluster instead; counted stale)."""
        from .. import metrics

        gen = getattr(snapshot, "_gen", snapshot)
        with self._lock:
            if self._closed:
                return None
            if self._planes.gen is not gen:
                self.counters["stale"] += 1
                metrics.incr("tpu.mirror_stale")
                return None
            cluster = self._ensure_cluster()
            self.counters["hits"] += 1
            metrics.incr("tpu.mirror_hit")
            return cluster

    # ------------------------------------------------------------------
    # device-resident kernel state
    # ------------------------------------------------------------------
    def device_state(self, n_pad: int, gen, mesh=None) -> Optional[tuple]:
        """Device tensors (capacity, usable, used) for the node plane
        padded to ``n_pad``, valid for state generation ``gen``; None when
        the committed planes are at a different generation (caller falls
        back to a host transfer of its own snapshot arrays). The dirty
        rows are read and cleared under the plane lock, which the store's
        in-commit marking also holds, so no row marked between the read
        and the clear is lost. With ``mesh`` the planes are split by rows
        over it; a cached state for another mesh is rebuilt, never
        reshared."""
        # Budget gate: when the paging stanza says a full n_pad-row
        # resident mirror would blow the device budget, refuse to build
        # one — the caller degrades to its host-plane path (counted) and
        # the over-budget axis is the paged dispatch's job.
        from . import paging as _paging

        if _paging.should_page(n_pad, R_COLS):
            from .. import metrics

            with self._lock:
                self.counters["over_budget"] += 1
            metrics.incr("tpu.mirror_over_budget")
            return None
        with self._lock:
            planes = self._planes
            if self._closed or planes.gen is not gen:
                return None
            cluster = self._ensure_cluster()
            ds = self._device.get(n_pad)
            if ds is not None and (ds.epoch != planes.epoch or ds.mesh is not mesh):
                planes.unregister_sink(ds.pending)
                ds = None
            if ds is None:
                ds = DeviceState(
                    planes.epoch, n_pad, cluster.capacity,
                    cluster.usable, planes.used, device=self.device, mesh=mesh,
                )
                self.counters["uploads"] += 1
                self.counters["upload_bytes"] += ds.upload_bytes
                self._device[n_pad] = ds
                # from here on the store's in-commit track/untrack marks
                # dirty rows straight into this DeviceState
                planes.register_sink(ds.pending)
            else:
                n = len(ds.pending)
                before = ds.refresh_bytes
                ds.refresh(planes.used)
                if n:
                    self.counters["refreshes"] += 1
                    self.counters["rows_scattered"] += n
                    self.counters["refresh_bytes"] += ds.refresh_bytes - before
            return ds.arrays()

    # ------------------------------------------------------------------
    # plan-applier dense device verify (core/plan_apply.py)
    # ------------------------------------------------------------------
    def verify_handles(self, snapshot, n_pad: int, mesh=None):
        """The plan applier's device-verify view of ``snapshot``: the
        committed-plane cluster and ``(capacity, usable, used)`` device
        refs at exactly that generation, or None when the planes have
        already committed PAST the snapshot (the applier then degrades to
        the host oracle, counted in tpu.mirror_stale /
        plan.verify_device_degrade). ``n_pad`` and ``mesh`` must be what
        the drain batches pass (the MIN_NODES-gated active mesh): the
        DeviceState cache is keyed by n_pad, so a mismatch between the two
        consumers would rebuild the full planes on every alternation."""
        cluster = self.sync(snapshot)
        if cluster is None:
            return None
        gen = getattr(snapshot, "_gen", snapshot)
        arrays = self.device_state(n_pad, gen, mesh=mesh)
        if arrays is None:
            return None
        return cluster, arrays, gen

    def locked_cluster(self, gen):
        """Context manager yielding the MirrorCluster while the planes
        are still committed at ``gen`` (else None), with the plane lock
        held: the applier's per-plan host-side gather (rows, node
        objects, exotic counts, alloc-rec vectors) reads a consistent
        plane set even if a write transaction is concurrently patching
        the store forward."""
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            with self._lock:
                cluster = self._cluster
                if (
                    self._closed
                    or cluster is None
                    or cluster._synced_gen is not gen
                ):
                    yield None
                else:
                    yield cluster

        return _ctx()

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            planes = self._planes
            out = dict(self.counters)
            out["rebuild_reasons"] = dict(self.counters["rebuild_reasons"])
            out["applied_index"] = planes.version
            out["epoch"] = planes.epoch
            out["nodes"] = len(planes.nodes)
            out["tracked_allocs"] = len(planes.alloc_rec)
            return out

    def close(self):
        with self._lock:
            self._closed = True
            for ds in self._device.values():
                self._planes.unregister_sink(ds.pending)
            self._device.clear()
            self._cluster = None
