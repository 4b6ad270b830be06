"""Cluster-invariant checker: the end-of-scenario oracle every chaos test
runs against the final state snapshot.

The invariants are the ones the reference's design guarantees across any
fault schedule (eval_broker at-least-once + plan-applier optimistic
concurrency + raft):

1. no allocation is placed twice — at most one non-terminal alloc per
   (namespace, job, alloc name);
2. no node is over-committed — ``AllocsFit`` holds for every node's
   live allocs (cpu/mem/disk superset, ports, devices);
3. every non-blocked evaluation reached a terminal state (nothing stuck
   ``pending`` once the cluster quiesced);
4. state indexes are monotonic and consistent — every object's
   create_index ≤ modify_index ≤ latest_index, and no table index
   exceeds the store's latest index.
"""

from __future__ import annotations

import random

from ..structs.funcs import allocs_fit


def check_cluster_invariants(state) -> list[str]:
    """Run every invariant against ``state`` (a StateReader — a live
    store or a snapshot); returns human-readable violations (empty =
    healthy). Call only after the scenario quiesced: in-flight evals are
    legitimately ``pending`` while workers still run."""
    violations: list[str] = []

    # 1. no alloc placed twice
    live_by_name: dict[tuple, list] = {}
    for a in state.allocs():
        if a.terminal_status():
            continue
        live_by_name.setdefault((a.namespace, a.job_id, a.name), []).append(a)
    for (ns, job_id, name), group in live_by_name.items():
        if len(group) > 1:
            violations.append(
                f"alloc placed twice: {len(group)} live allocs named "
                f"{name!r} for {ns}/{job_id}: {sorted(a.id for a in group)}"
            )

    # 2. no node over-committed vs AllocsFit
    for node in state.nodes():
        allocs = state.allocs_by_node_terminal(node.id, False)
        if not allocs:
            continue
        fit, dimension, _ = allocs_fit(node, allocs, None, True)
        if not fit:
            violations.append(
                f"node {node.id} over-committed: {dimension} "
                f"({len(allocs)} live allocs)"
            )

    # 3. every non-blocked eval reached a terminal state
    for ev in state.evals():
        if not ev.terminal_status() and not ev.should_block():
            violations.append(
                f"eval {ev.id} ({ev.type}, job {ev.job_id}) stuck in "
                f"status {ev.status!r}"
            )

    # 4. index monotonicity
    latest = state.latest_index()
    for table, idx in state._gen.table_indexes.items():
        if idx > latest:
            violations.append(
                f"table {table} index {idx} exceeds latest index {latest}"
            )
    for kind, objects in (
        ("node", state.nodes()),
        ("eval", state.evals()),
        ("alloc", state.allocs()),
        ("job", state.jobs()),
    ):
        for obj in objects:
            if obj.create_index > obj.modify_index:
                violations.append(
                    f"{kind} {obj.id if hasattr(obj, 'id') else obj}: "
                    f"create_index {obj.create_index} > modify_index "
                    f"{obj.modify_index}"
                )
            if obj.modify_index > latest:
                violations.append(
                    f"{kind} {getattr(obj, 'id', obj)}: modify_index "
                    f"{obj.modify_index} exceeds latest index {latest}"
                )
    return violations


def assert_cluster_invariants(state):
    violations = check_cluster_invariants(state)
    assert not violations, "cluster invariants violated:\n" + "\n".join(
        violations
    )


def check_federation_invariants(
    region_states: dict,
    oracle: Optional[list] = None,
    acl_authoritative: Optional[str] = None,
) -> list[str]:
    """The cross-region oracle for federated chaos runs, called after
    every region quiesced and partitions healed.

    ``region_states`` maps region name → StateReader (a live store or a
    snapshot; any server of the region — state is raft-replicated).
    Checks, on top of a per-region :func:`check_cluster_invariants`
    sweep (violations prefixed ``[region]``):

    - **job-home uniqueness** (no lost or double-committed placements
      across regions): for every ``oracle`` entry
      ``{"namespace", "job_id", "region"}`` — one per cross-region
      forwarded submit whose op was acknowledged — the job exists in its
      TARGET region and in no other. A forward that was acked but landed
      nowhere is a lost submit; one that landed in two raft domains is a
      double commit (the federation analog of "alloc placed twice").
      Entries carrying ``may_complete`` (batch jobs, which force-GC may
      legitimately reap once dead) are exempt from the lost-check only —
      double-commit always applies, since GC removes but never adds;
    - **ACL convergence**: with ``acl_authoritative`` set, every other
      region's policy table (name → rules) and global-token accessor set
      equals the authoritative region's — replication converged, with
      no stale extras left behind.
    """
    violations: list[str] = []
    for region, state in sorted(region_states.items()):
        for v in check_cluster_invariants(state):
            violations.append(f"[{region}] {v}")

    for entry in oracle or ():
        ns = entry.get("namespace", "default")
        job_id = entry["job_id"]
        home = entry["region"]
        present = sorted(
            region
            for region, state in region_states.items()
            if state.job_by_id(ns, job_id) is not None
        )
        if home not in present and not entry.get("may_complete"):
            violations.append(
                f"lost cross-region submit: job {ns}/{job_id} acked for "
                f"region {home!r} but absent there (present in {present})"
            )
        extras = [r for r in present if r != home]
        if extras:
            violations.append(
                f"double-committed cross-region submit: job {ns}/{job_id} "
                f"homed in {home!r} also present in {extras}"
            )

    if acl_authoritative is not None and acl_authoritative in region_states:
        auth_state = region_states[acl_authoritative]
        auth_policies = {
            p.name: p.rules for p in auth_state.acl_policies()
        }
        auth_globals = {
            t.accessor_id for t in auth_state.acl_tokens() if t.global_token
        }
        for region, state in sorted(region_states.items()):
            if region == acl_authoritative:
                continue
            policies = {p.name: p.rules for p in state.acl_policies()}
            if policies != auth_policies:
                missing = sorted(set(auth_policies) - set(policies))
                extra = sorted(set(policies) - set(auth_policies))
                drifted = sorted(
                    n
                    for n in set(policies) & set(auth_policies)
                    if policies[n] != auth_policies[n]
                )
                violations.append(
                    f"[{region}] acl policies diverged from "
                    f"{acl_authoritative!r}: missing={missing} "
                    f"extra={extra} drifted={drifted}"
                )
            globals_ = {
                t.accessor_id for t in state.acl_tokens() if t.global_token
            }
            if globals_ != auth_globals:
                violations.append(
                    f"[{region}] global acl tokens diverged from "
                    f"{acl_authoritative!r}: missing="
                    f"{sorted(auth_globals - globals_)} "
                    f"extra={sorted(globals_ - auth_globals)}"
                )
    return violations


class IncrementalInvariantChecker:
    """The same invariants, cheap enough to run *mid-storm*.

    A full :func:`check_cluster_invariants` sweep runs ``allocs_fit``
    against every node and rebuilds the duplicate-name map from scratch —
    serializing a large server for seconds per check. This checker keys
    its work off the raft index instead: each :meth:`check` takes one
    immutable snapshot, skips wholesale any table whose table index did
    not advance past the previous sweep, filters the tables that did to
    the objects whose ``modify_index`` advanced (plus allocs deleted
    since, found by key-set difference), and re-verifies exactly the
    state those changes can have perturbed. The filter itself is one
    O(table) dict iteration per *changed* table — the store has no
    modify-index-ordered iterator — so what this buys is skipping the
    expensive work (``allocs_fit``, group rebuilds, per-object index
    checks), not the raw table walk of a mid-storm allocs table:

    - duplicate-placement groups are maintained incrementally (alloc id →
      name-key membership) and only touched groups re-checked;
    - ``allocs_fit`` runs only on nodes whose alloc set or node object
      changed, capped per sweep by ``max_fit_nodes`` with a seeded sample
      (skipped nodes are *counted* in ``sampled_out``, and a node left
      over-committed stays dirty until a later sweep clears it — coverage
      degrades visibly, never silently);
    - index monotonicity is checked on the changed objects only;
    - the "every non-blocked eval terminal" clause only applies to a
      quiesced cluster, so it runs when ``quiesced=True`` (the final
      sweep) — exactly the contract of the full checker's docstring.

    On a quiesced cluster a trailing ``check(quiesced=True)`` after the
    last write makes the accumulated ``violations`` equal to what one
    full check would report — pinned by tests/test_loadgen.py.
    """

    def __init__(self, state, max_fit_nodes: int = 512, seed: int = 0):
        self.state = state
        self.max_fit_nodes = max_fit_nodes
        self._rng = random.Random(seed)
        self._last_index = -1
        #: alloc id -> (namespace, job_id, name) for every LIVE alloc seen
        self._live_key: dict[str, tuple] = {}
        #: name-key -> set of live alloc ids
        self._groups: dict[tuple, set] = {}
        #: every alloc id currently in the table (for deletion detection)
        self._known_ids: set = set()
        #: alloc id -> node_id (so deletions dirty the right node)
        self._node_of: dict[str, str] = {}
        #: nodes needing an allocs_fit pass (carried across sweeps when
        #: the per-sweep cap defers them)
        self._dirty_nodes: set = set()
        #: the subset of ``_dirty_nodes`` already counted in
        #: ``sampled_out`` — a node deferred across k sweeps counts once,
        #: not k times
        self._deferred: set = set()
        self.sweeps = 0
        self.objects_scanned = 0
        self.fit_checks = 0
        self.sampled_out = 0
        #: distinct violations, in discovery order
        # nta: ignore[unbounded-cache] WHY: the checker is run-scoped
        # and the distinct-violation list IS its deliverable
        self.violations: list[str] = []
        # nta: ignore[unbounded-cache] WHY: dedup set over the
        # run-scoped deliverable above
        self._seen_violations: set = set()

    # ------------------------------------------------------------------
    def _add(self, violation: str):
        if violation not in self._seen_violations:
            self._seen_violations.add(violation)
            self.violations.append(violation)

    def check(self, quiesced: bool = False) -> list[str]:
        """One incremental sweep; returns the NEW violations it found."""
        snap = self.state.snapshot()
        found_at = len(self.violations)
        latest = snap.latest_index()
        if latest == self._last_index and not quiesced and not self._dirty_nodes:
            return []
        self.sweeps += 1
        since = self._last_index

        # ---- table indexes never exceed the store's latest index
        for table, idx in snap._gen.table_indexes.items():
            if idx > latest:
                self._add(
                    f"table {table} index {idx} exceeds latest index {latest}"
                )

        table_indexes = snap._gen.table_indexes
        # upserts AND deletes bump a table's index (store._bump), so a
        # table whose index hasn't advanced needs no walk at all
        allocs_changed = table_indexes.get("allocs", 0) > since

        # ---- deleted allocs: leave their groups, dirty their nodes
        gone_ids = (
            self._known_ids - snap._gen.allocs.keys() if allocs_changed else ()
        )
        for gone in gone_ids:
            self._known_ids.discard(gone)
            node = self._node_of.pop(gone, None)
            if node is not None:
                self._dirty_nodes.add(node)
            key = self._live_key.pop(gone, None)
            if key is not None:
                group = self._groups.get(key)
                if group is not None:
                    group.discard(gone)
                    if not group:
                        del self._groups[key]

        # ---- changed allocs: update group membership + dirty nodes
        touched_groups: set = set()
        for a in snap.allocs() if allocs_changed else ():
            if a.modify_index <= since:
                continue
            self.objects_scanned += 1
            self._index_check("alloc", a, latest)
            self._known_ids.add(a.id)
            self._node_of[a.id] = a.node_id
            self._dirty_nodes.add(a.node_id)
            key = (a.namespace, a.job_id, a.name)
            old_key = self._live_key.get(a.id)
            live = not a.terminal_status()
            if old_key is not None and (not live or old_key != key):
                group = self._groups.get(old_key)
                if group is not None:
                    group.discard(a.id)
                    if not group:
                        del self._groups[old_key]
                del self._live_key[a.id]
            if live:
                self._live_key[a.id] = key
                self._groups.setdefault(key, set()).add(a.id)
                touched_groups.add(key)

        for key in touched_groups:
            group = self._groups.get(key, ())
            if len(group) > 1:
                ns, job_id, name = key
                self._add(
                    f"alloc placed twice: {len(group)} live allocs named "
                    f"{name!r} for {ns}/{job_id}: {sorted(group)}"
                )

        # ---- changed nodes are dirty too (drain/eligibility/capacity)
        nodes_changed = table_indexes.get("nodes", 0) > since
        for node in snap.nodes() if nodes_changed else ():
            if node.modify_index > since:
                self.objects_scanned += 1
                self._index_check("node", node, latest)
                self._dirty_nodes.add(node.id)

        # ---- allocs_fit over dirty nodes, sampled under the per-sweep cap
        dirty = self._dirty_nodes
        if not quiesced and len(dirty) > self.max_fit_nodes:
            picked = set(
                self._rng.sample(sorted(dirty), self.max_fit_nodes)
            )
            deferred = dirty - picked  # carried to later sweeps, not dropped
            self.sampled_out += len(deferred - self._deferred)
            self._deferred = deferred
            self._dirty_nodes = deferred
            dirty = picked
        else:
            self._dirty_nodes = set()
            self._deferred = set()
        for node_id in dirty:
            node = snap.node_by_id(node_id)
            if node is None:
                continue
            allocs = snap.allocs_by_node_terminal(node_id, False)
            if not allocs:
                continue
            self.fit_checks += 1
            fit, dimension, _ = allocs_fit(node, allocs, None, True)
            if not fit:
                self._add(
                    f"node {node_id} over-committed: {dimension} "
                    f"({len(allocs)} live allocs)"
                )

        # ---- changed evals: index checks always; terminal-state only at
        # quiesce (in-flight evals are legitimately pending mid-storm —
        # and the quiesced sweep must walk ALL evals, changed or not)
        evals_changed = quiesced or table_indexes.get("evals", 0) > since
        for ev in snap.evals() if evals_changed else ():
            if ev.modify_index > since:
                self.objects_scanned += 1
                self._index_check("eval", ev, latest)
            if quiesced and not ev.terminal_status() and not ev.should_block():
                self._add(
                    f"eval {ev.id} ({ev.type}, job {ev.job_id}) stuck in "
                    f"status {ev.status!r}"
                )
        jobs_changed = table_indexes.get("jobs", 0) > since
        for job in snap.jobs() if jobs_changed else ():
            if job.modify_index > since:
                self.objects_scanned += 1
                self._index_check("job", job, latest)

        self._last_index = latest
        return self.violations[found_at:]

    def _index_check(self, kind: str, obj, latest: int):
        if obj.create_index > obj.modify_index:
            self._add(
                f"{kind} {getattr(obj, 'id', obj)}: create_index "
                f"{obj.create_index} > modify_index {obj.modify_index}"
            )
        if obj.modify_index > latest:
            self._add(
                f"{kind} {getattr(obj, 'id', obj)}: modify_index "
                f"{obj.modify_index} exceeds latest index {latest}"
            )

    def stats(self) -> dict:
        return {
            "sweeps": self.sweeps,
            "objects_scanned": self.objects_scanned,
            "fit_checks": self.fit_checks,
            "sampled_out": self.sampled_out,
            "violations": len(self.violations),
        }
