"""Critical-path attribution over retained traces.

Aggregates the span trees the store kept into a per-stage attribution of
``eval.e2e``: for each trace, wall time is attributed to the DEEPEST span
covering each instant along the critical path (a parent's time not
covered by any child is the parent's own — e.g. the part of
``plan.submit`` that is neither queue wait nor verify nor commit), then
totals are aggregated across all retained traces and across the slowest
tail separately. The report names the bottleneck stage — reproducing the
ROADMAP item 2 finding (plan submit/queue-wait dominating eval e2e p99
while ``plan.evaluate`` stays ~1–2ms → the serialized applier) from
retained traces alone, no hand-assembled stage splits.
"""

from __future__ import annotations

from typing import Optional

#: stages owned by the plan applier's QUEUE/serialization: when one of
#: these is the bottleneck, the verdict names the applier (ROADMAP
#: item 1's knee). plan.commit / plan.commit_barrier moved out when the
#: applier pipelined: commits now overlap verification, so a
#: commit-dominated tail is raft consensus latency (fsync/replication —
#: the worker legitimately waits for its entry to land), not the
#: applier convoying plans behind one loop
APPLIER_STAGES = frozenset({"plan.submit", "plan.queue_wait"})

#: consensus-round stages: a tail these own is commit latency, named as
#: such so operators chase raft (fsync, replication, batch fold), not
#: the applier loop
CONSENSUS_STAGES = frozenset({"plan.commit", "plan.commit_barrier"})

#: device-dispatch stages: a tail these own spent its time in (or
#: waiting on) the placement kernel. On a sharded run whose dispatch
#: spans carry per-placement collective rounds, the verdict names the
#: CROSS-SHARD COLLECTIVE CONVOY — ROADMAP item 2's bottleneck, read
#: from retained traces + the devprof round counter instead of guessed
DEVICE_STAGES = frozenset(
    {"drain.kernel_dispatch", "eval.plan_kernel", "drain.materialize"}
)
#: root-ish spans never named as a bottleneck "stage" (they ARE the e2e)
ROOT_NAMES = frozenset({"eval.e2e", "job.submit"})
#: stages whose wall time is COVERED ELSEWHERE in the tree and must not
#: enter the critical-path totals (their instants would be attributed
#: twice): drain.device_compute overlaps the host-side materialization
#: by design (double-buffering); fsm.apply_plan runs INSIDE the
#: plan.commit window (the commit waits on the apply); mirror.patch
#: lands after the root closed entirely (a late span at the next drain
#: batch's sync). All three are reported separately, not silently
#: dropped — hidden-by-overlap time is still the number to watch when
#: the overlap stops hiding it.
PARALLEL_STAGES = frozenset(
    {"drain.device_compute", "fsm.apply_plan", "mirror.patch"}
)


def build_tree(record: dict) -> tuple[list[dict], dict]:
    """(roots, children_by_span_id) for one trace record. A span whose
    parent is not in the record is a root — a connected trace has
    exactly one."""
    spans = record.get("spans") or []
    by_id = {s["span_id"]: s for s in spans}
    children: dict[str, list] = {}
    roots = []
    for s in spans:
        parent = s.get("parent_id")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    for kids in children.values():
        kids.sort(key=lambda s: s.get("start") or 0.0)
    return roots, children


def orphan_count(record: dict) -> int:
    """Spans not reachable from the trace's single true root (0 for a
    fully connected tree). Used by the chaos assertions."""
    roots, _ = build_tree(record)
    return max(0, len(roots) - 1)


def _attribute_span(span: dict, children: dict, acc: dict, par: dict):
    """Walk one span: child-covered intervals attribute to the children
    (recursively); uncovered remainder is the span's own. PARALLEL
    stages accumulate into ``par`` and do NOT advance the cursor — their
    wall time is covered by the host-side siblings they overlap."""
    start = span.get("start") or 0.0
    dur = (span.get("duration_ms") or 0.0) / 1e3
    end = start + dur
    cursor = start
    own = 0.0
    for child in children.get(span["span_id"], ()):
        if child["name"] in PARALLEL_STAGES:
            # full duration, no recursion: the parallel branch is a
            # leaf-shaped hardware-time report, not part of the path
            par[child["name"]] = (
                par.get(child["name"], 0.0)
                + (child.get("duration_ms") or 0.0) / 1e3
            )
            continue
        c0 = child.get("start") or 0.0
        c1 = c0 + (child.get("duration_ms") or 0.0) / 1e3
        if c0 > cursor:
            own += min(c0, end) - cursor
        _attribute_span(child, children, acc, par)
        cursor = max(cursor, min(c1, end))
    if end > cursor:
        own += end - cursor
    if own > 0:
        acc[span["name"]] = acc.get(span["name"], 0.0) + own


def attribute_trace(record: dict) -> tuple[dict, dict]:
    """(critical-path stage seconds, parallel-stage seconds) for one
    trace."""
    roots, children = build_tree(record)
    acc: dict[str, float] = {}
    par: dict[str, float] = {}
    for root in roots:
        _attribute_span(root, children, acc, par)
    return acc, par


def _mesh_dispatch_stats(records: list[dict]) -> dict:
    """Collective-round accounting from SHARDED dispatch spans: any span
    tagged ``shards > 1`` (drain.kernel_dispatch / eval.plan_kernel /
    drain.device_compute carry the topology), summing the
    ``collective_rounds`` / ``placements`` tags the exact-scan dispatch
    stamps. ``rounds_per_placement`` is None when no sharded span
    carried the counter (e.g. every sharded dispatch rode the runs
    planner, whose rounds resolve in devprof, not span tags)."""
    spans = rounds = placements = shards = wavefront = 0
    for r in records:
        for s in r.get("spans") or ():
            tags = s.get("tags") or {}
            try:
                width = int(tags.get("shards") or 1)
            except (TypeError, ValueError):
                continue
            if width <= 1:
                continue
            spans += 1
            shards = max(shards, width)
            rounds += int(tags.get("collective_rounds") or 0)
            placements += int(tags.get("placements") or 0)
            # wavefront dispatches stamp MEASURED rounds (a device
            # scalar read at the materialize sync) instead of the
            # one-per-lane static count — their presence is what turns
            # the convoy verdict into the amortized reading below
            if "wavefront" in (
                str(tags.get("planner") or ""), str(tags.get("mode") or "")
            ):
                wavefront += 1
    return {
        "sharded_spans": spans,
        "shards": shards,
        "rounds": rounds,
        "placements": placements,
        "wavefront_spans": wavefront,
        "rounds_per_placement": (
            round(rounds / placements, 4) if placements else None
        ),
    }


def _devprof_rounds_per_placement():
    """The device profiler's global collective-round ratio — the
    fallback when sharded spans exist but none carried the counter
    tags. None when devprof is off or dark."""
    try:
        from ..debug import devprof

        return devprof.summary().get("collective_rounds_per_placement")
    except Exception:
        return None


def _stage_table(per_trace: list[dict]) -> dict:
    totals: dict[str, float] = {}
    for acc in per_trace:
        for name, sec in acc.items():
            totals[name] = totals.get(name, 0.0) + sec
    grand = sum(totals.values()) or 1.0
    return {
        name: {
            "seconds": round(sec, 6),
            "share": round(sec / grand, 4),
        }
        for name, sec in sorted(totals.items(), key=lambda e: -e[1])
    }


def attribute(records: list[dict], tail_pct: float = 0.99) -> dict:
    """Aggregate critical-path attribution across retained traces.

    Returns ``{traces, stages, tail: {threshold_ms, traces, stages},
    bottleneck, verdict}`` where ``tail`` covers the traces at or above
    the ``tail_pct`` duration quantile (≥1 trace), ``bottleneck`` is the
    dominant non-root stage of the tail, and ``verdict`` is the
    one-line human reading of it."""
    records = [r for r in records if r.get("spans")]
    if not records:
        return {
            "traces": 0, "stages": {}, "parallel": {}, "tail": {},
            "mesh": _mesh_dispatch_stats(()), "bottleneck": None,
            "verdict": "no retained traces",
        }
    per_trace = [(r, *attribute_trace(r)) for r in records]
    durations = sorted(r.get("duration_ms") or 0.0 for r in records)
    idx = min(len(durations) - 1, int(len(durations) * tail_pct))
    threshold = durations[idx]
    tail = [
        acc for r, acc, _ in per_trace
        if (r.get("duration_ms") or 0.0) >= threshold
    ]
    all_stages = _stage_table([acc for _, acc, _ in per_trace])
    tail_stages = _stage_table(tail)
    parallel_totals: dict[str, float] = {}
    for _, _, par in per_trace:
        for name, sec in par.items():
            parallel_totals[name] = parallel_totals.get(name, 0.0) + sec

    bottleneck = None
    for name in tail_stages:
        if name not in ROOT_NAMES:
            bottleneck = name
            break
    if bottleneck is None and tail_stages:
        bottleneck = next(iter(tail_stages))

    # the mesh-comm verdict (ROADMAP item 2): device stages dominate —
    # either the bottleneck is a dispatch stage, or the overlap-hidden
    # drain.device_compute outweighs every stage on the path — AND the
    # sharded dispatch spans (or the devprof round counter) show the
    # fill loop issuing ~one collective round per placement
    mesh = _mesh_dispatch_stats(records)
    top_stage_s = max(
        (row["seconds"] for name, row in tail_stages.items()
         if name not in ROOT_NAMES),
        default=0.0,
    )
    device_dominant = bottleneck in DEVICE_STAGES or (
        parallel_totals.get("drain.device_compute", 0.0) > top_stage_s
    )
    rpp = mesh["rounds_per_placement"]
    if rpp is None and mesh["sharded_spans"]:
        rpp = _devprof_rounds_per_placement()
    mesh["effective_rounds_per_placement"] = rpp
    convoy = (
        device_dominant
        and mesh["sharded_spans"] > 0
        and rpp is not None
        and rpp >= 0.5
    )

    if convoy:
        verdict = (
            "cross-shard collective convoy: device dispatch dominates "
            f"the p{int(tail_pct * 100)} tail and sharded dispatches "
            f"issued {rpp} collective rounds per placement over a "
            f"{mesh['shards']}-way mesh — the sequential fill loop pays "
            "one cross-mesh reduction per placement; batch conflict-free "
            "placements into wavefronts (ROADMAP item 2)"
        )
    elif (
        device_dominant
        and mesh["sharded_spans"] > 0
        and mesh.get("wavefront_spans", 0) > 0
        and rpp is not None
    ):
        # the negative of the convoy: wavefront dispatches present and
        # the MEASURED rounds-per-placement sits under the convoy
        # threshold — the mesh cost is amortized, look elsewhere
        verdict = (
            "device dispatch dominates but the wavefront planner "
            f"amortizes the mesh: {rpp} collective rounds per placement "
            f"over a {mesh['shards']}-way mesh "
            f"({mesh['wavefront_spans']} wavefront dispatch spans) — "
            "not a convoy; per-shard compute or host "
            "build/materialize is the next knee"
        )
    elif bottleneck in APPLIER_STAGES:
        verdict = (
            f"serialized plan applier: '{bottleneck}' owns "
            f"{tail_stages[bottleneck]['share'] * 100:.0f}% of the "
            f"p{int(tail_pct * 100)} tail (plan submit/queue-wait "
            "dominate while verification stays flat)"
        )
    elif bottleneck in CONSENSUS_STAGES:
        verdict = (
            f"consensus commit latency: '{bottleneck}' owns "
            f"{tail_stages[bottleneck]['share'] * 100:.0f}% of the "
            f"p{int(tail_pct * 100)} tail (the pipelined applier keeps "
            "verifying while entries commit; tune raft/fold, not the "
            "applier)"
        )
    elif bottleneck is not None:
        verdict = (
            f"'{bottleneck}' owns "
            f"{tail_stages[bottleneck]['share'] * 100:.0f}% of the "
            f"p{int(tail_pct * 100)} tail"
        )
    else:
        verdict = "no attributable stages"
    return {
        "traces": len(records),
        "stages": all_stages,
        # hardware time hidden by the double-buffer overlap: NOT in the
        # path totals (its instants are attributed to the host spans
        # covering the sync), reported so the overlap's headroom is
        # visible when it stops hiding the device
        "parallel": {
            name: round(sec, 6)
            for name, sec in sorted(parallel_totals.items())
        },
        "tail": {
            "threshold_ms": round(threshold, 3),
            "traces": len(tail),
            "stages": tail_stages,
        },
        # sharded dispatch accounting (the mesh-comm verdict's inputs,
        # kept visible even when the verdict names something else)
        "mesh": mesh,
        "bottleneck": bottleneck,
        "verdict": verdict,
    }


def format_report(report: dict, limit: int = 12) -> str:
    """Human-readable critical-path table (the CLI surface)."""
    lines = [
        f"retained traces: {report.get('traces', 0)}",
        f"verdict: {report.get('verdict', '')}",
        "",
        f"{'stage':<28} {'share':>7} {'seconds':>10}   "
        f"{'tail share':>10}",
    ]
    stages = report.get("stages") or {}
    tail_stages = (report.get("tail") or {}).get("stages") or {}
    for i, (name, row) in enumerate(stages.items()):
        if i >= limit:
            break
        tail_row = tail_stages.get(name)
        tail_share = (
            f"{tail_row['share'] * 100:.1f}%" if tail_row else "-"
        )
        lines.append(
            f"{name:<28} {row['share'] * 100:>6.1f}% "
            f"{row['seconds']:>10.4f}   {tail_share:>10}"
        )
    parallel = report.get("parallel") or {}
    if parallel:
        lines.append("")
        for name, sec in parallel.items():
            lines.append(
                f"{name:<28} (parallel, overlap-hidden) {sec:>10.4f}s"
            )
    return "\n".join(lines)
