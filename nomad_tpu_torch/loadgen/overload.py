"""Scored overload storm: drive one live server PAST saturation through
the real RPC/HTTP surface and grade the overload control plane
(core/overload.py — admission control, deadline propagation, retry
budgets, brownout degradation) on what it promised:

- **goodput holds past the knee** — the burst stage pushes 3-5x the
  capacity stage's offered rate; completed work per second (the
  ``worker.evals_processed.*`` delta, not accepted submissions) must not
  drop below the capacity stage's. Without admission control this curve
  is metastable: queues grow, every request waits behind doomed work,
  goodput collapses;
- **every op is accounted** — fired == ok + client-backlog shed +
  server shed + deadline_exceeded + expected + failed, with REAL
  failures pinned to zero. Shed work fails fast with a 429/``overloaded``
  error; expired work fails terminal ``deadline_exceeded`` naming the
  refusing stage. Nothing vanishes;
- **admitted work keeps its latency budget** — p99 round-trip of ops the
  server chose to accept during the burst, graded against a budget (the
  whole point of shedding is that admitted work stays fast);
- **recovery is prompt** — once the burst stops, load must fall back
  under the brownout exit threshold with every degraded knob restored
  within the SLO window, and a low-rate probe stage must then complete
  cleanly.

Three sequential stages against ONE server (the controller's hysteresis
is the subject under test, so the server must live through the whole
arc): ``capacity`` (fleet ramp + offered load the cluster absorbs),
``burst`` (OVERLOAD_BURST_X times that), ``recovery`` (a light probe
after the cooldown wait). Stage job-id spaces are prefix-scoped so a
burst submit can never collide with a capacity job.

Run via ``scripts/overload.sh`` (env knobs OVERLOAD_CAP_RATE /
OVERLOAD_BURST_X / OVERLOAD_BURST_S / OVERLOAD_DEPTH_LIMIT /
OVERLOAD_DEADLINE_S) or ``python -m nomad_tpu_torch.loadgen --overload``;
bench.py embeds it as the env-gated ``overload`` section.

The port's copy of ``nomad_tpu/loadgen/overload.py``: the server runs its
device tier on ``device``, the CUDA card unless the caller passes
``"cpu"``.
"""

from __future__ import annotations

import json
import logging
import os
import time

from .driver import StormDriver
from .grammar import Phase, Scenario, compile_stream
from .score import grade

logger = logging.getLogger("nomad_tpu.loadgen.overload")


def _evals_processed() -> int:
    """Completed-work counter: evals fully processed by the scheduler
    workers — THE goodput numerator (accepted-but-queued work doesn't
    count; that is exactly the lie metastable systems tell)."""
    from .. import metrics

    counters = metrics.snapshot()["counters"]
    return int(
        sum(
            v
            for k, v in counters.items()
            if k.startswith("worker.evals_processed.")
        )
    )


def _stage(name: str, phases: list, server_config: dict) -> Scenario:
    return Scenario(
        name=name,
        description=f"overload storm stage: {name}",
        phases=phases,
        n_workers=2,
        server_config=server_config,
    )


def _drive(
    agent, http, scenario: Scenario, seed: int, prefix: str,
    driver_workers: int, deadline_s: float = 0.0,
) -> dict:
    """Run one stage's stream against the live cluster; returns the
    stage ledger (driver buckets + goodput + admitted-op latency)."""
    stream = compile_stream(scenario, seed)
    driver = StormDriver(
        stream,
        rpc_servers=[agent.address],
        http_address=http.address,
        workers=driver_workers,
        job_prefix=prefix,
        deadline_s=deadline_s,
    )
    ev0 = _evals_processed()
    t0 = time.monotonic()
    rep = driver.run()
    wall = max(time.monotonic() - t0, 1e-9)
    goodput_eps = (_evals_processed() - ev0) / wall
    ok_lat = sorted(
        r.t_done - r.t_start for r in driver.results if r.ok
    )
    p99_ms = (
        ok_lat[min(len(ok_lat) - 1, int(len(ok_lat) * 0.99))] * 1000.0
        if ok_lat
        else 0.0
    )
    d = rep.to_dict()
    accounted = (
        d["ok"] + d["shed"] + d["server_shed"] + d["dl_exceeded"]
        + d["expected_miss"] + d["failed"]
    )
    return {
        "stage": scenario.name,
        "wall_s": round(wall, 2),
        "goodput_eps": round(goodput_eps, 2),
        "ok_p99_ms": round(p99_ms, 1),
        "unaccounted": d["fired"] - accounted,
        "driver": d,
    }


def run_overload(
    seed: int = 1,
    out: str | None = None,
    driver_workers: int = 8,
    slos: dict | None = None,
    device=None,
) -> dict:
    """Boot a live server with the overload stanza, run the three-stage
    storm, and score the control plane. Returns the report dict (also
    written to ``out`` when given); grading is the caller's verdict. The
    server runs on ``device`` (CUDA unless ``"cpu"``), refused before
    any thread starts when CUDA is missing."""
    from .. import resolve_device
    from ..agent import ServerAgent
    from ..api.http import HTTPServer
    from ..testing.invariants import check_cluster_invariants
    from .runner import wait_quiescent

    device = resolve_device(device)
    nodes = int(os.environ.get("OVERLOAD_NODES", "32"))
    cap_rate = float(os.environ.get("OVERLOAD_CAP_RATE", "20"))
    burst_x = float(os.environ.get("OVERLOAD_BURST_X", "4"))
    cap_s = float(os.environ.get("OVERLOAD_CAP_S", "12"))
    burst_s = float(os.environ.get("OVERLOAD_BURST_S", "15"))
    deadline_s = float(os.environ.get("OVERLOAD_DEADLINE_S", "8"))
    recovery_slo_s = float(os.environ.get("OVERLOAD_RECOVERY_SLO_S", "30"))

    server_config = {
        "seed": 42,
        "heartbeat_ttl": 3600.0,
        "nack_timeout": 30.0,
        # the brownout ladder is driven at flight-recorder cadence; a
        # fast tick keeps enter/exit transitions inside the stage walls
        "debug": {"flight_interval": 0.25},
        "overload": {
            # sized so the burst stage crosses the knee within seconds:
            # load = broker backlog / depth_limit, and the burst offers
            # burst_x * cap_rate evals/s against two workers
            "depth_limit": int(os.environ.get("OVERLOAD_DEPTH_LIMIT", "160")),
            "queue_wait_budget_ms": 2000.0,
            "default_deadline_s": deadline_s,
            "load_cache_s": 0.2,
            "shed_batch": 0.8,
            "shed_service": 0.95,
            "retry_after_s": 1.0,
            "brownout": {
                "enter": 0.9,
                "exit": 0.6,
                "enter_streak": 2,
                "exit_streak": 3,
            },
        },
    }
    common = {
        "node_fleet": nodes,
        "job_slots": 4096,
        "job_floor": 3,
        "ready_floor": max(4, nodes // 3),
        "count_range": (1, 3),
        "cpu_choices": (50, 100),
        "memory_choices": (32, 64),
        # real priority classes so shedding is priority-AWARE on the
        # wire, not just in unit tests: batch (30) sheds first, service
        # (70) holds to 0.95, system (95) is never shed
        "job_categories": {"svc": 2.0, "bat": 2.0, "sys": 0.3},
        "priority_by_category": {"bat": 30, "svc": 70, "sys": 95},
    }

    capacity = _stage(
        "overload_capacity",
        [
            Phase(
                name="ramp_nodes", duration=3.0, rate=nodes / 3.0,
                uniform=True, mix={"node.register": 1.0}, params=common,
            ),
            Phase(
                name="offered", duration=cap_s, rate=cap_rate,
                mix={"job.submit": 3.0, "job.stop": 1.0}, params=common,
            ),
        ],
        server_config,
    )
    burst = _stage(
        "overload_burst",
        [
            Phase(
                name="burst", duration=burst_s, rate=cap_rate * burst_x,
                mix={"job.submit": 4.0, "job.stop": 1.0}, params=common,
            ),
        ],
        server_config,
    )
    recovery = _stage(
        "overload_recovery",
        [
            Phase(
                name="probe", duration=8.0, rate=4.0,
                mix={"job.submit": 1.0}, params=common,
            ),
        ],
        server_config,
    )

    agent = ServerAgent("ldg-overload", config=server_config, device=device)
    http = None
    try:
        agent.start(num_workers=2, wait_for_leader=10.0)
        http = HTTPServer(agent.server, port=0)
        http.start()
        ov = agent.server.overload

        logger.info("stage capacity: %.0f ops/s for %.0fs", cap_rate, cap_s)
        cap = _drive(
            agent, http, capacity, seed, "ldgcap", driver_workers,
        )
        logger.info(
            "stage burst: %.0f ops/s for %.0fs (%.1fx capacity)",
            cap_rate * burst_x, burst_s, burst_x,
        )
        bur = _drive(
            agent, http, burst, seed, "ldgburst", driver_workers,
            deadline_s=deadline_s,
        )
        max_level = ov.brownout.peak_level if ov.brownout is not None else 0

        # recovery clock: burst traffic has stopped; the backlog must
        # drain (expired work refused loudly at dequeue, live work
        # completed) until load re-crosses the brownout EXIT threshold
        # with every degraded knob restored
        exit_thresh = float(
            server_config["overload"]["brownout"]["exit"]
        )
        t_rec = time.monotonic()
        recovered = False
        while time.monotonic() - t_rec < recovery_slo_s + 5.0:
            level = ov.brownout.level if ov.brownout is not None else 0
            if ov.admission.load() < exit_thresh and level == 0:
                recovered = True
                break
            time.sleep(0.25)
        recovery_s = time.monotonic() - t_rec

        rec = _drive(
            agent, http, recovery, seed, "ldgrec", driver_workers,
        )

        quiesced = wait_quiescent(
            agent.server,
            float(os.environ.get("OVERLOAD_QUIESCE_S", "90")),
        )
        violations = check_cluster_invariants(agent.server.state)

        stages = {"capacity": cap, "burst": bur, "recovery": rec}
        goodput_drop = max(
            0.0,
            1.0 - bur["goodput_eps"] / max(cap["goodput_eps"], 1e-9),
        )
        report = {
            "scenario": "overload",
            "seed": seed,
            "stages": stages,
            "config": {
                "nodes": nodes,
                "cap_rate": cap_rate,
                "burst_x": burst_x,
                "cap_s": cap_s,
                "burst_s": burst_s,
                "overload": server_config["overload"],
            },
            "overload_goodput_cap_eps": cap["goodput_eps"],
            "overload_goodput_eps": bur["goodput_eps"],
            "overload_goodput_drop": round(goodput_drop, 4),
            "overload_shed_frac": round(
                bur["driver"]["server_shed"]
                / max(bur["driver"]["fired"], 1),
                4,
            ),
            "overload_dl_exceeded": ov.deadline_exceeded_total(),
            "overload_dl_exceeded_by_stage": dict(
                ov.deadline_exceeded
            ),
            "overload_recovery_s": round(recovery_s, 2),
            "overload_recovered": recovered,
            "overload_admitted_p99_ms": bur["ok_p99_ms"],
            "overload_failed": sum(
                s["driver"]["failed"] for s in stages.values()
            ),
            "overload_unaccounted": sum(
                s["unaccounted"] for s in stages.values()
            ),
            "brownout_max_level": max_level,
            "overload_stats": ov.stats(),
            "invariants": {
                "violations": len(violations),
                "sweeps": 1,
                "violation_log": violations[:20],
            },
            "watchdog": (
                agent.server.watchdog.stats()
                if agent.server.watchdog is not None
                else None
            ),
            "quiesced": quiesced,
            "errors": sum(
                (s["driver"]["errors"] for s in stages.values()), []
            )[:10],
        }
        report["slo"] = grade(
            report,
            slos
            if slos is not None
            else {
                "max_invariant_violations": 0,
                "max_overload_goodput_drop": float(
                    os.environ.get("OVERLOAD_GOODPUT_DROP_SLO", "0.10")
                ),
                "max_overload_unaccounted": 0,
                "max_overload_failed": 0,
                "max_overload_recovery_s": recovery_slo_s,
                "max_overload_admitted_p99_ms": float(
                    os.environ.get("OVERLOAD_ADMITTED_P99_SLO_MS", "5000")
                ),
            },
        )
        # a run that saturated without ever shedding or browning out
        # proved nothing: pin that the storm actually crossed the knee
        slo = report["slo"]
        crossed = (
            bur["driver"]["server_shed"] > 0 or max_level > 0
            or report["overload_dl_exceeded"] > 0
        )
        slo["checks"]["saturation_reached"] = {
            "target": True, "actual": crossed, "pass": crossed,
        }
        slo["checks"]["quiesced"] = {
            "target": True, "actual": quiesced, "pass": quiesced,
        }
        for ok in (crossed, quiesced):
            slo["passed" if ok else "failed"] += 1
        slo["score"] = round(
            slo["passed"] / (slo["passed"] + slo["failed"]), 3
        )
        if out:
            with open(out, "w", encoding="utf-8") as f:
                json.dump(report, f, indent=1)
                # the artifact's own trailing summary (the same
                # log-tail-survival line stdout gets): a truncated copy
                # that still has its last line still has the verdict
                f.write("\n" + summary_line(report) + "\n")
        return report
    finally:
        if http is not None:
            http.stop()
        agent.stop()


def run_overload_from_env(seed: int, out: str | None = None,
                          driver_workers: int = 8, device=None) -> dict:
    """The one env-knob entry shared by ``scripts/overload.sh`` (via
    ``python -m nomad_tpu_torch.loadgen --overload``) and bench.py's
    ``overload`` section — all knobs already read from env inside
    run_overload, so this is just the naming symmetry with the other
    storm planes."""
    return run_overload(
        seed=seed, out=out, driver_workers=driver_workers, device=device
    )


def summary_line(report: dict) -> str:
    """The trailing OVERLOAD_SUMMARY line (log-tail-survival contract)."""
    slo = report["slo"]
    parts = [
        f"overload_goodput_eps={report['overload_goodput_eps']}",
        f"overload_goodput_cap_eps={report['overload_goodput_cap_eps']}",
        f"overload_shed_frac={report['overload_shed_frac']}",
        f"overload_dl_exceeded={report['overload_dl_exceeded']}",
        f"overload_recovery_s={report['overload_recovery_s']}",
        f"overload_admitted_p99_ms={report['overload_admitted_p99_ms']}",
        f"brownout_max_level={report['brownout_max_level']}",
        f"failed={report['overload_failed']}",
        f"unaccounted={report['overload_unaccounted']}",
        f"invariant_violations={report['invariants']['violations']}",
        f"slo={slo['passed']}/{slo['passed'] + slo['failed']}",
        f"score={slo['score']}",
    ]
    return "OVERLOAD_SUMMARY " + " ".join(parts)
