"""Named storm scenarios.

- ``smoke`` — the tier-1 gate: a ~30s seeded mixed storm (submit / scale
  / update / flap / drain / dispatch / GC) against a mid-size cluster on
  the pure-python scheduler path, cheap enough to run in every suite;
- ``soak`` — the production-scale churn soak (ROADMAP item 3): ramp a
  10K-node fleet over the RPC surface, preload ~1M allocations through
  real job registrations on the tpu-batch scheduler, then sustain
  minutes of mixed churn. ``slow``-marked / CLI-only.

Scale knobs are env-overridable (``SOAK_NODES``, ``SOAK_ALLOCS``,
``SOAK_CHURN_S``) so the same scenario definition runs on the driver
bench box and on a laptop; the artifact records what actually ran.
"""

from __future__ import annotations

import os

from .grammar import Phase, Scenario


def smoke(nodes: int = 48, churn_s: float = 16.0) -> Scenario:
    """~30s storm: every op kind fires, the fleet flaps and drains under
    a floor, and the run must end with zero invariant violations."""
    common = {
        "node_fleet": nodes,
        "job_slots": 48,
        "job_floor": 3,
        "ready_floor": max(4, nodes // 3),
        "count_range": (1, 4),
        "cpu_choices": (50, 100, 250),
        "memory_choices": (32, 64, 128),
        "job_categories": {"svc": 2.0, "bat": 1.0},
        "dispatch_slots": 2,
        "dispatch_fanout": (1, 3),
        "drain_deadline_s": (2.0, 8.0),
    }
    return Scenario(
        name="smoke",
        description="tier-1 mixed churn storm (~30s, mid-size cluster)",
        n_workers=2,
        server_config={
            "seed": 42,
            "heartbeat_ttl": 3600.0,
            "nack_timeout": 5.0,
            "initial_nack_delay": 0.1,
            "subsequent_nack_delay": 0.5,
        },
        phases=[
            # single-kind uniform ramps place an exact op count, so the
            # whole fleet is registered before the churn starts
            Phase(
                name="ramp_nodes",
                duration=3.0,
                rate=nodes / 3.0,
                uniform=True,
                mix={"node.register": 1.0},
                params=common,
            ),
            Phase(
                name="ramp_jobs",
                duration=3.0,
                rate=16.0 / 3.0,
                uniform=True,
                mix={"job.submit": 1.0},
                params=common,
            ),
            Phase(
                name="ramp_dsp",
                duration=1.0,
                rate=2.0,
                uniform=True,
                mix={"job.dispatch_register": 1.0},
                params=common,
            ),
            Phase(
                name="churn",
                duration=churn_s,
                rate=10.0,
                mix={
                    "job.submit": 2.0,
                    "job.scale": 3.0,
                    "job.update": 2.0,
                    "job.stop": 1.0,
                    "job.dispatch": 1.0,
                    "job.evaluate": 0.5,
                    "node.down": 0.8,
                    "node.up": 1.0,
                    "node.drain": 0.6,
                    "node.drain_off": 0.8,
                    "system.gc": 0.3,
                },
                params=common,
            ),
            Phase(
                name="wind_down",
                duration=6.0,
                rate=5.0,
                mix={
                    "job.stop": 2.0,
                    "node.up": 2.0,
                    "node.drain_off": 2.0,
                    "system.gc": 0.3,
                },
                params=common,
            ),
        ],
        quiesce_timeout=60.0,
        sample_interval=0.5,
        invariants_every=4,
        probes=2,
        slos={
            "max_invariant_violations": 0,
            "max_op_failure_rate": 0.02,
            "max_shed_rate": 0.0,
            # post-ramp slope on a mid-size cluster: allocator arena noise
            # only; a real leak class shows up far above this
            "max_rss_tail_slope_mb_per_min": 120.0,
            "max_subscriber_lag": 50_000,
        },
    )


def soak() -> Scenario:
    """The million-object churn soak over the real server path."""
    nodes = int(os.environ.get("SOAK_NODES", "10000"))
    target_allocs = int(os.environ.get("SOAK_ALLOCS", "1000000"))
    churn_s = float(os.environ.get("SOAK_CHURN_S", "180"))
    # fat batch jobs carry the bulk (few evals, large placements); svc
    # jobs carry the rolling-deploy churn; both live across the storm
    bat_count = max(1000, target_allocs // 100)
    bat_slots = max(1, round(target_allocs * 0.98 / bat_count))
    svc_slots = 40
    svc_count = max(1, round(target_allocs * 0.02 / svc_slots))
    common = {
        "node_fleet": nodes,
        "ready_floor": max(16, nodes * 3 // 4),
        "job_floor": bat_slots // 2,
        "drain_deadline_s": (5.0, 30.0),
        "dispatch_slots": 4,
        "dispatch_fanout": (2, 8),
    }
    node_ramp_rate = float(os.environ.get("SOAK_NODE_RATE", "120"))
    preload_rate = float(os.environ.get("SOAK_PRELOAD_RATE", "0.5"))
    return Scenario(
        name="soak",
        description=(
            f"sustained churn at ~{target_allocs} allocs x {nodes} nodes "
            "over the real RPC/HTTP surface"
        ),
        n_workers=int(os.environ.get("SOAK_WORKERS", "2")),
        server_config={
            "seed": 42,
            "heartbeat_ttl": 86400.0,
            "default_scheduler": "tpu-batch",
            "batch_drain": 8,
            "plan_apply_batch": 8,
            "nack_timeout": 120.0,
            "event_broker": {"event_buffer_size": 16384},
        },
        phases=[
            Phase(
                name="node_ramp",
                duration=nodes / node_ramp_rate,
                rate=node_ramp_rate,
                uniform=True,
                mix={"node.register": 1.0},
                params=common,
            ),
            Phase(
                name="preload",
                duration=(bat_slots + svc_slots) / preload_rate,
                rate=preload_rate,
                uniform=True,
                mix={"job.submit": 1.0},
                params={
                    **common,
                    "job_slots": bat_slots + svc_slots,
                    "job_categories": {
                        "bat": float(bat_slots),
                        "svc": float(svc_slots),
                    },
                    "count_range_by_category": {
                        "bat": (bat_count * 3 // 4, bat_count),
                        "svc": (max(1, svc_count // 2), svc_count),
                    },
                    "cpu_choices": (50, 100),
                    "memory_choices": (32, 64),
                },
            ),
            Phase(
                name="preload_dsp",
                duration=4.0,
                rate=1.0,
                uniform=True,
                mix={"job.dispatch_register": 1.0},
                params=common,
            ),
            Phase(
                name="churn",
                duration=churn_s,
                rate=float(os.environ.get("SOAK_CHURN_RATE", "1.2")),
                mix={
                    "job.scale": 2.5,
                    "job.update": 1.5,
                    "job.submit": 0.5,
                    "job.stop": 0.4,
                    "job.dispatch": 1.0,
                    "job.evaluate": 0.4,
                    "node.down": 0.8,
                    "node.up": 1.0,
                    "node.drain": 0.5,
                    "node.drain_off": 0.7,
                    "system.gc": 0.1,
                },
                params={
                    **common,
                    "job_slots": bat_slots + svc_slots,
                    # churn-phase submits are svc-sized, not preload-sized
                    "job_categories": {"svc": 1.0},
                    "count_range": (10, 50),
                    # ~1-5% per scale op: hundreds of allocs churned per
                    # op against the fat preload jobs
                    "scale_frac": 0.05,
                    "cpu_choices": (50, 100),
                    "memory_choices": (32, 64),
                },
            ),
            Phase(
                name="wind_down",
                duration=20.0,
                rate=1.0,
                mix={
                    "node.up": 2.0,
                    "node.drain_off": 2.0,
                    "system.gc": 0.5,
                },
                params=common,
            ),
        ],
        quiesce_timeout=float(os.environ.get("SOAK_QUIESCE_S", "600")),
        sample_interval=2.0,
        invariants_every=5,
        probes=3,
        slos={
            "max_invariant_violations": 0,
            "max_op_failure_rate": 0.02,
            "max_shed_rate": 0.01,
            # churn-window growth ceiling: the table COW churns gigabytes
            # of transient garbage at this scale; a LEAK shows as a
            # sustained slope, transient garbage as sawtooth around flat
            "max_rss_tail_slope_mb_per_min": 600.0,
            "max_subscriber_lag": 500_000,
        },
    )


_SCENARIOS = {
    "smoke": smoke,
    "soak": soak,
}


def list_scenarios() -> list[str]:
    return sorted(_SCENARIOS)


def get_scenario(name: str, **kwargs) -> Scenario:
    try:
        builder = _SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; have {list_scenarios()}"
        ) from None
    return builder(**kwargs)
