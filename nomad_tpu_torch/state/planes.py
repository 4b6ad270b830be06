"""Committed dense planes: the columnar capacity/used state, versioned by
the raft index and patched by the SAME write transaction that swaps the
MVCC tables.

History: the dense planes used to live outside the commit path, in
``tpu/mirror.py``, re-derived from the EventBroker stream the FSM published
*after* each apply — which minted an entire failure class (lost-gap, index
skew, severed subscription, checksum mismatch) and the rebuild machinery to
mitigate it. :class:`CommittedPlanes` deletes that class by construction:

- every ``StateStore`` write method patches the planes *before* publishing
  the new generation, under the store's write mutex;
- ``StateStore._publish`` stamps the planes with the new ``Generation``
  identity and raft index inside the same critical section that swaps the
  table pointer, so plane freshness IS generation identity (``planes.gen
  is snapshot._gen``) — no frames, no waits, no skew;
- snapshot persist/restore carries the planes blob alongside the tables,
  restore installs it (falling back to a cold rebuild for old snapshots),
  and ``build_blob``'s cold rebuild is the canonical byte-identity oracle
  the crash-recovery storm compares against.

The mutation protocol is invalidate-then-commit: the first plane patch of
a write transaction clears ``gen`` (readers at any generation fall back to
the scan paths — they can never observe a half-applied patch set), and the
transaction's ``_publish`` restamps it once the tables and planes are both
whole. Node-axis changes (join/leave/re-register) defer the O(N + A) axis
rebuild to commit time via ``_axis_dirty``, because the rebuild needs the
not-yet-published generation.

Writes to the plane arrays outside this module and ``state/store.py`` are
flagged by the ``plane-mutation-outside-commit`` analysis rule.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

#: dense resource columns: cpu MHz, memory MB, disk MB, network mbits
#: (bandwidth is the AssignNetwork dimension the kernel CAN model densely;
#: ports stay a host post-pass, SURVEY §7). THE definition —
#: ``tpu/columnar.py`` re-exports it.
R_COLS = 4

#: node rows per dirty-versioning tile — the granularity at which the
#: paged planner (tpu/paging.py) re-uploads committed state, so the
#: write path stamps at the same granularity the H2D stream pages at.
#: Module-level (not imported from tpu/) so state/ stays jax-free;
#: ``paging.configure`` pushes its resolved ``tile_rows`` here and each
#: plane instance latches the value at axis-rebuild time (stamps stay
#: self-consistent within an epoch even if the knob moves).
TILE_ROWS = 65536


def node_capacity_row(node) -> tuple:
    """One node's dense capacity row. Single definition shared by the
    committed planes and ``ColumnarCluster`` so the two can never disagree
    on what a column means."""
    res = node.node_resources
    return (
        res.cpu.cpu_shares,
        res.memory.memory_mb,
        res.disk.disk_mb,
        # AvailBandwidth: device-backed links only (network.go:72)
        sum(net.mbits for net in res.networks if net.device),
    )


def node_reserved_row(node) -> tuple:
    """One node's dense reserved row (no reserved network column: the
    reference reserves cpu/memory/disk only)."""
    rr = node.reserved_resources
    if rr is None:
        return (0, 0, 0, 0)
    return (rr.cpu.cpu_shares, rr.memory.memory_mb, rr.disk.disk_mb, 0)


def exotic_flag(alloc) -> bool:
    """Whether the alloc carries ports/bandwidth networks or devices —
    dimensions the dense planes can't verify exactly. THE single
    definition: the FSM stamps it into every Alloc event (``Exotic``),
    the committed planes count it per node row (``exotic_live``), and the
    plan applier's host dense path (core/plan_apply.py ``_alloc_exotic``)
    delegates here, so device verify and host verify can never disagree
    on which allocs force the exact per-node check."""
    resources = alloc.allocated_resources
    if resources is None:
        return False
    if resources.shared.networks:
        return True
    for tr in resources.tasks.values():
        if tr.networks or tr.devices:
            return True
    return False


def usage_vec(alloc) -> Optional[tuple]:
    """The (cpu, memory_mb, disk_mb, mbits) contribution of one alloc —
    exactly ``ColumnarCluster.sum_alloc_usage`` restricted to one element,
    so committed-plane patches and full rebuilds can never disagree on the
    math."""
    if alloc.allocated_resources is None:
        return None
    c = alloc.comparable_cached()
    bw = 0
    res = alloc.allocated_resources
    for tr in res.tasks.values():
        for net in tr.networks:
            bw += net.mbits
    for net in res.shared.networks:
        bw += net.mbits
    return (
        c.flattened.cpu.cpu_shares,
        c.flattened.memory.memory_mb,
        c.shared.disk_mb,
        bw,
    )


class CommittedPlanes:
    """The dense node-axis planes owned by one :class:`StateStore`.

    ``used`` INCLUDES the per-node reserved baseline (it is initialized to
    the reserved rows at every axis rebuild, then accumulates live-alloc
    usage vectors), so the mirror adapter can alias it directly as
    ``MirrorCluster.mirror_used`` — O(1) row reads for the plan applier,
    zero copies for the device scatter path.

    Locking: ``lock`` guards every field; the store's write mutex
    serializes mutators, so the lock only arbitrates mutator-vs-reader.
    Order: ``StateStore._write_mutex`` → ``lock`` and
    ``StateStore._cond`` → ``lock`` (commit runs inside publish); nothing
    takes ``lock`` and then a store lock.
    """

    def __init__(self):
        self.lock = threading.RLock()
        #: committed node axis — the adapter's MirrorCluster aliases this
        #: list, so a status-flap object swap propagates without a rebuild
        self.nodes: list = []
        self.index: dict[str, int] = {}
        #: reserved baseline + Σ live-alloc contributions (int64, [N, R])
        self.used = np.zeros((0, R_COLS), dtype=np.int64)
        #: live allocs per row carrying ports/devices (dimensions the
        #: dense planes can't verify): the plan applier's device verify
        #: degrades these rows to the exact host check
        self.exotic_live = np.zeros(0, dtype=np.int32)
        #: alloc id → (node_id, usage vec, job_id, task_group, exotic)
        self.alloc_rec: dict[str, tuple] = {}
        #: (job_id, task_group) → {node_id: live alloc count}
        self.job_counts: dict[tuple, dict] = {}
        #: bumped whenever the node axis changes (device planes re-upload,
        #: adapter view refresh)
        self.epoch = 0
        #: raft index the planes were last committed at
        self.version = 0
        #: per-tile raft-index stamps (tile t covers node rows
        #: [t·tile_rows, (t+1)·tile_rows)); committed by the same write
        #: transaction as ``version``, so "which tiles changed since
        #: index V" is one vectorized compare for the pager
        self.tile_version = np.zeros(0, dtype=np.int64)
        #: tile granularity latched at the last axis rebuild
        self.tile_rows = TILE_ROWS
        self._dirty_tiles: set[int] = set()
        #: the Generation these planes exactly equal; None while a write
        #: transaction is mid-patch (readers fall back to scan paths)
        self.gen = None
        self._axis_dirty = True
        self._pending_restore: Optional[dict] = None
        #: dirty-row sinks (DeviceState.pending sets) fed by track/untrack
        self._sinks: list[set] = []
        # low-rate divergence audit state (debug/flight sampling)
        self._audit_at = 0.0
        self._last_audit: Optional[dict] = None

    # -- write-transaction patch API (store holds _write_mutex) ---------
    def invalidate_axis(self) -> None:
        """A node joined, left, or re-registered (resources/attributes may
        have changed): every node-axis plane rebuilds from the committed
        generation at publish time."""
        with self.lock:
            self.gen = None
            self._axis_dirty = True

    def swap_node(self, node) -> None:
        """Status/drain/eligibility flap: same resources, same attributes —
        swap the object so identity reads stay current, leave every dense
        plane untouched."""
        with self.lock:
            self.gen = None
            row = self.index.get(node.id)
            if row is not None and not self._axis_dirty:
                self.nodes[row] = node

    def apply_alloc(self, alloc) -> None:
        """One alloc transition inside a write transaction: retire the
        previous version's contribution (keyed by id), add the new one if
        it is live."""
        with self.lock:
            self.gen = None
            self._untrack(alloc.id)
            if not alloc.terminal_status():
                self._track(alloc)

    def remove_alloc(self, alloc_id: str) -> None:
        """An alloc left the table entirely (eval GC)."""
        with self.lock:
            self.gen = None
            self._untrack(alloc_id)

    def _track(self, alloc) -> None:
        row = self.index.get(alloc.node_id)
        if row is None:
            return
        vec = usage_vec(alloc)
        if vec is None:
            # allocated_resources=None contributes nothing to ``used``
            # (sum_alloc_usage skips it) but MUST still count for same-job
            # collisions — collision_counts counts every non-terminal
            # matching alloc regardless of resources
            vec = (0, 0, 0, 0)
        exotic = exotic_flag(alloc)
        self.used[row] += np.asarray(vec, dtype=np.int64)
        if exotic:
            self.exotic_live[row] += 1
        self.alloc_rec[alloc.id] = (
            alloc.node_id, vec, alloc.job_id, alloc.task_group, exotic,
        )
        jc = self.job_counts.setdefault((alloc.job_id, alloc.task_group), {})
        jc[alloc.node_id] = jc.get(alloc.node_id, 0) + 1
        self._mark_dirty(row)

    def _untrack(self, alloc_id: str) -> None:
        rec = self.alloc_rec.pop(alloc_id, None)
        if rec is None:
            return
        node_id, vec, job_id, tg, exotic = rec
        jc = self.job_counts.get((job_id, tg))
        if jc is not None:
            c = jc.get(node_id, 0) - 1
            if c > 0:
                jc[node_id] = c
            else:
                jc.pop(node_id, None)
                if not jc:
                    self.job_counts.pop((job_id, tg), None)
        row = self.index.get(node_id)
        if row is None:
            return
        self.used[row] -= np.asarray(vec, dtype=np.int64)
        if exotic:
            self.exotic_live[row] -= 1
        self._mark_dirty(row)

    def _mark_dirty(self, row: int) -> None:
        for sink in self._sinks:
            sink.add(int(row))
        self._dirty_tiles.add(int(row) // self.tile_rows)

    # -- commit (runs inside StateStore._publish) -----------------------
    def commit(self, gen, index: int) -> None:
        """Stamp the planes as exactly equal to ``gen`` at raft ``index``,
        performing any deferred axis rebuild / staged restore first. Runs
        inside the same critical section that published ``gen``."""
        with self.lock:
            if self._pending_restore is not None:
                blob, self._pending_restore = self._pending_restore, None
                if not self._install(gen, blob):
                    self._rebuild_axis(gen)
            elif self._axis_dirty:
                self._rebuild_axis(gen)
            n_tiles = max(1, -(-len(self.nodes) // self.tile_rows))
            if len(self.tile_version) != n_tiles:
                # fresh axis (rebuild/install reset the stamps): every
                # tile is new at this index
                self.tile_version = np.full(n_tiles, int(index),
                                            dtype=np.int64)
            elif self._dirty_tiles:
                rows = np.fromiter(
                    (t for t in self._dirty_tiles if t < n_tiles),
                    dtype=np.int64,
                )
                self.tile_version[rows] = int(index)
            self._dirty_tiles.clear()
            self.gen = gen
            self.version = index

    def _rebuild_axis(self, gen) -> None:
        """Cold O(N + A) rebuild from ``gen`` — the same math as
        :meth:`build_blob`, kept cheap and in-place. When the only change
        is nodes appended behind the committed axis (a node's first
        registration), only their rows are added: the planes come out as
        the rebuild makes them, without its O(N) pass over every node."""
        nodes = list(gen.nodes.values())
        n_old = len(self.nodes)
        if (
            self._pending_restore is None
            and len(self.index) == n_old < len(nodes)
            and all(a is b for a, b in zip(nodes, self.nodes))
        ):
            added = nodes[n_old:]
            index = dict(self.index)
            for i, n in enumerate(added, n_old):
                index[n.id] = i
            self.nodes = nodes
            self.index = index
            self.used = np.concatenate([self.used, np.array(
                [node_reserved_row(n) for n in added], dtype=np.int64,
            ).reshape(len(added), R_COLS)])
            self.exotic_live = np.concatenate(
                [self.exotic_live, np.zeros(len(added), dtype=np.int32)])
            new_ids = {n.id for n in added}
            for alloc in gen.allocs.values():
                if alloc.node_id in new_ids and not alloc.terminal_status():
                    self._track(alloc)
        else:
            self.nodes = nodes
            self.index = {n.id: i for i, n in enumerate(nodes)}
            self.used = np.array(
                [node_reserved_row(n) for n in nodes], dtype=np.int64,
            ).reshape(len(nodes), R_COLS)
            self.exotic_live = np.zeros(len(nodes), dtype=np.int32)
            self.alloc_rec = {}
            self.job_counts = {}
            for alloc in gen.allocs.values():
                if not alloc.terminal_status():
                    self._track(alloc)
        self.epoch += 1
        self._axis_dirty = False
        # fresh axis: relatch the tile granularity and drop the stamps
        # (commit() restamps every tile of the new axis at its index)
        self.tile_rows = max(1, int(TILE_ROWS))
        self.tile_version = np.zeros(0, dtype=np.int64)
        self._dirty_tiles = set()
        # device sinks belong to the previous axis; their DeviceStates are
        # discarded by the adapter's epoch check
        self._sinks = []

    # -- tile dirty-version readers (the pager's re-upload gate) --------
    def dirty_tiles_since(self, version: int) -> list:
        """Tile indices whose rows changed after raft ``version`` — the
        set a device-resident pager must re-upload to reach the current
        commit. A caller holding stamps from a different ``epoch`` must
        discard them and treat every tile as dirty (the axis itself
        moved); compare :attr:`epoch` before trusting this."""
        with self.lock:
            if len(self.tile_version) == 0:
                return []
            return np.nonzero(self.tile_version > int(version))[0].tolist()

    def tile_stamps(self) -> tuple:
        """``(epoch, tile_rows, tile_version copy)`` under the lock —
        one consistent read for observability and the pager."""
        with self.lock:
            return self.epoch, self.tile_rows, self.tile_version.copy()

    # -- device sink registry (adapter holds self.lock) -----------------
    def register_sink(self, sink: set) -> None:
        with self.lock:
            self._sinks.append(sink)

    def unregister_sink(self, sink: set) -> None:
        with self.lock:
            try:
                self._sinks.remove(sink)
            except ValueError:
                pass

    # -- persist / restore ----------------------------------------------
    @staticmethod
    def build_blob(gen, version: Optional[int] = None) -> dict:
        """Canonical cold-rebuild serialization of the planes for ``gen``:
        a pure function of table content (sorted keys, plain python ints),
        so ``persist_for`` of a correctly-maintained live plane is
        byte-identical — THE oracle the crash-recovery storm checks."""
        nodes = list(gen.nodes.values())
        index = {n.id: i for i, n in enumerate(nodes)}
        used = np.array(
            [node_reserved_row(n) for n in nodes], dtype=np.int64,
        ).reshape(len(nodes), R_COLS)
        exotic_live = np.zeros(len(nodes), dtype=np.int32)
        alloc_rec: dict[str, tuple] = {}
        job_counts: dict[tuple, dict] = {}
        for alloc in gen.allocs.values():
            if alloc.terminal_status():
                continue
            row = index.get(alloc.node_id)
            if row is None:
                continue
            vec = usage_vec(alloc)
            if vec is None:
                vec = (0, 0, 0, 0)
            exotic = exotic_flag(alloc)
            used[row] += np.asarray(vec, dtype=np.int64)
            if exotic:
                exotic_live[row] += 1
            alloc_rec[alloc.id] = (
                alloc.node_id, vec, alloc.job_id, alloc.task_group, exotic,
            )
            jc = job_counts.setdefault((alloc.job_id, alloc.task_group), {})
            jc[alloc.node_id] = jc.get(alloc.node_id, 0) + 1
        return CommittedPlanes._canonical_blob(
            gen.index if version is None else version,
            nodes, used, exotic_live, alloc_rec, job_counts,
        )

    @staticmethod
    def _canonical_blob(version, nodes, used, exotic_live, alloc_rec,
                        job_counts) -> dict:
        return {
            "version": int(version),
            "node_ids": [n.id for n in nodes],
            "used": [[int(v) for v in row] for row in used],
            "exotic_live": [int(v) for v in exotic_live],
            "alloc_rec": {
                aid: [rec[0], [int(v) for v in rec[1]], rec[2], rec[3],
                      bool(rec[4])]
                for aid, rec in sorted(alloc_rec.items())
            },
            "job_counts": [
                [jid, tg, sorted(counts.items())]
                for (jid, tg), counts in sorted(job_counts.items())
            ],
        }

    def persist_for(self, gen) -> dict:
        """The planes blob for ``gen``: the live arrays when they are
        committed at exactly that generation, else a cold rebuild (a
        persist racing a write transaction must still serialize a
        consistent world)."""
        with self.lock:
            if self.gen is gen and not self._axis_dirty:
                return self._canonical_blob(
                    self.version, self.nodes, self.used, self.exotic_live,
                    self.alloc_rec, self.job_counts,
                )
        return self.build_blob(gen)

    def stage_restore(self, blob: Optional[dict]) -> None:
        """Queue a snapshot's planes blob for installation at the next
        commit (the restore's own ``_publish``). ``None`` — an old
        snapshot without planes — degrades to a cold rebuild."""
        with self.lock:
            self.gen = None
            if blob is not None:
                self._pending_restore = dict(blob)
            else:
                self._pending_restore = None
                self._axis_dirty = True

    def _install(self, gen, blob: dict) -> bool:
        """Install a persisted planes blob against the restored ``gen``;
        returns False (caller cold-rebuilds) when the blob does not match
        the restored node axis."""
        nodes = list(gen.nodes.values())
        if blob.get("node_ids") != [n.id for n in nodes]:
            return False
        n = len(nodes)
        used = np.asarray(blob["used"], dtype=np.int64).reshape(n, R_COLS)
        exotic = np.asarray(blob["exotic_live"], dtype=np.int32).reshape(n)
        self.nodes = nodes
        self.index = {node.id: i for i, node in enumerate(nodes)}
        self.used = used
        self.exotic_live = exotic
        self.alloc_rec = {
            aid: (rec[0], tuple(rec[1]), rec[2], rec[3], bool(rec[4]))
            for aid, rec in blob["alloc_rec"].items()
        }
        self.job_counts = {
            (jid, tg): {nid: int(c) for nid, c in counts}
            for jid, tg, counts in blob["job_counts"]
        }
        self.epoch += 1
        self._axis_dirty = False
        self.tile_rows = max(1, int(TILE_ROWS))
        self.tile_version = np.zeros(0, dtype=np.int64)
        self._dirty_tiles = set()
        self._sinks = []
        return True

    # -- divergence audit (debug/flight + watchdog) ---------------------
    def audit(self, gen) -> dict:
        """Compare the live planes against a cold rebuild of ``gen`` —
        divergence is impossible by construction, which is exactly why it
        is audited: a nonzero row count means a write path bypassed the
        commit protocol, and the watchdog trips a debug bundle on it."""
        live = self.persist_for(gen)
        cold = self.build_blob(gen, version=live["version"])
        rows = sum(
            1 for a, b in zip(live["used"], cold["used"]) if a != b
        ) + sum(
            1 for a, b in zip(live["exotic_live"], cold["exotic_live"])
            if a != b
        )
        recs = 0 if live["alloc_rec"] == cold["alloc_rec"] else 1
        counts = 0 if live["job_counts"] == cold["job_counts"] else 1
        axis = 0 if live["node_ids"] == cold["node_ids"] else 1
        return {
            "rows": rows + axis,
            "recs": recs + counts,
            "version": live["version"],
        }

    def audit_sample(self, gen, min_interval_s: float = 30.0):
        """Rate-limited :meth:`audit` for the flight sampler: the O(N + A)
        cold rebuild runs at most once per ``min_interval_s``; in between,
        the last verdict is re-served."""
        now = time.monotonic()
        with self.lock:
            if (
                self._last_audit is not None
                and now - self._audit_at < min_interval_s
            ):
                return self._last_audit
            if self.gen is not gen:
                # mid-write or stale reader: nothing consistent to compare
                return self._last_audit
        verdict = self.audit(gen)
        with self.lock:
            self._audit_at = now
            self._last_audit = verdict
        return verdict
