"""Hosts one storm end-to-end: boot a real server agent (RPC listener +
HTTP surface), compile the scenario's op stream, drive it open-loop,
wait for quiescence, and hand back the scored report.

The cluster is in-process (the same shape every bench and chaos test
uses) but the storm only ever talks to it over the network surface —
msgpack RPC sockets and HTTP — so the soak measures the production
ingress path, not internal method calls.

The port's copy of ``nomad_tpu/loadgen/runner.py``: the agent's server
runs its device tier on ``device``, the CUDA card unless the caller
passes ``"cpu"``; there is no fallback to the CPU.
"""

from __future__ import annotations

import logging
import threading
import time

from .driver import StormDriver
from .grammar import Scenario, compile_stream
from .score import Scorekeeper, summary_line, write_report

logger = logging.getLogger("nomad_tpu.loadgen.runner")


def wait_quiescent(server, timeout: float, poll: float = 0.25) -> bool:
    """True once every eval is terminal-or-blocked and the plan queue has
    drained (the precondition for the final full-strength invariant
    sweep)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        planner = getattr(server, "planner", None)
        depth = planner.queue.depth() if planner is not None else 0
        if depth == 0 and all(
            ev.terminal_status() or ev.should_block()
            for ev in server.state.evals()
        ):
            return True
        time.sleep(poll)
    return False


def run_scenario(
    scenario: Scenario,
    seed: int,
    out: str | None = None,
    time_scale: float = 1.0,
    driver_workers: int = 8,
    abort: threading.Event | None = None,
    inspect=None,
    device=None,
) -> dict:
    """Run one storm; returns the scored report dict (also written to
    ``out`` when given). Raises nothing on SLO failure — grading is the
    caller's verdict (CLI exits nonzero, tests assert). The server runs on
    ``device`` (CUDA unless ``"cpu"``), which is resolved, and refused
    when CUDA is missing, before any thread starts."""
    from .. import resolve_device
    from ..agent import ServerAgent
    from ..api.http import HTTPServer

    device = resolve_device(device)

    stream = compile_stream(scenario, seed)
    logger.info(
        "compiled %s seed=%d: %d ops over %.1fs (digest %s)",
        scenario.name, seed, len(stream.ops), stream.duration(),
        stream.digest()[:12],
    )

    agent = ServerAgent(
        f"ldg-{scenario.name}", config=dict(scenario.server_config),
        device=device,
    )
    http = None
    scorekeeper = None
    try:
        agent.start(num_workers=scenario.n_workers, wait_for_leader=10.0)
        http = HTTPServer(agent.server, port=0)
        http.start()

        scorekeeper = Scorekeeper(
            agent.server,
            http_address=http.address,
            interval=scenario.sample_interval,
            invariants_every=scenario.invariants_every,
            probes=scenario.probes,
            seed=seed,
        )
        driver = StormDriver(
            stream,
            rpc_servers=[agent.address],
            http_address=http.address,
            workers=driver_workers,
            time_scale=time_scale,
        )
        scorekeeper.start()
        scorekeeper.mark("storm_start")
        driver_report = driver.run(abort=abort)
        scorekeeper.mark("storm_end")

        quiesced = wait_quiescent(agent.server, scenario.quiesce_timeout)
        scorekeeper.mark("quiesced" if quiesced else "quiesce_timeout")
        scorekeeper.stop()
        scorekeeper.final_check(quiesced=quiesced)

        report = scorekeeper.report(scenario, seed, stream, driver_report)
        report["quiesced"] = quiesced
        # a cluster that cannot quiesce failed the soak no matter what
        # the samples say. The check is graded on EVERY run (not only on
        # failure) so the scorecard denominator — and therefore
        # soak_slo_score / slo=N/M — stays comparable across runs of the
        # same scenario
        slo = report["slo"]
        slo["checks"]["quiesced"] = {
            "target": True, "actual": quiesced, "pass": quiesced,
        }
        slo["passed" if quiesced else "failed"] += 1
        slo["score"] = round(
            slo["passed"] / (slo["passed"] + slo["failed"]), 3
        )
        if inspect is not None:
            # post-storm, pre-teardown hook: tests reach into the live
            # server here (leak-map boundedness, final full-sweep oracle)
            inspect(agent.server, report)
        if out:
            write_report(report, out)
        return report
    finally:
        if scorekeeper is not None:
            scorekeeper.stop()
        if http is not None:
            http.stop()
        agent.stop()


__all__ = ["run_scenario", "wait_quiescent", "summary_line"]
