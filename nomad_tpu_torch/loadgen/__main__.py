"""CLI: ``python -m nomad_tpu_torch.loadgen --scenario soak --seed 1``.

Exit status: 0 when every SLO check passed, 1 otherwise (the soak is a
gate, not a demo). ``--print-stream`` dumps the compiled op stream and
exits — two runs with the same seed must print byte-identical output,
which is the cheap way to eyeball the determinism contract.

The port's copy of ``nomad_tpu/loadgen/__main__.py``. ``--device`` (default
``cuda``, as the agent's ``-device``) is where the servers' device tier
runs, for every storm: ``--federation`` runs the federated storm
(``federation.run_federation_from_env``) with the JAX CLI's ``FED_*`` env
knobs and defaults.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m nomad_tpu_torch.loadgen",
        description="churn-soak load plane over the real server surface",
    )
    parser.add_argument("--scenario", default="smoke")
    parser.add_argument(
        "--fanout", action="store_true",
        help="run the event-plane fan-out bench instead of a storm "
        "scenario (env knobs FANOUT_SUBS / FANOUT_TOPICS / STORM_S; "
        "see scripts/fanout.sh)",
    )
    parser.add_argument(
        "--overload", action="store_true",
        help="run the scored overload storm (capacity / burst / recovery "
        "stages past saturation; env knobs OVERLOAD_CAP_RATE / "
        "OVERLOAD_BURST_X / OVERLOAD_BURST_S / OVERLOAD_DEPTH_LIMIT / "
        "OVERLOAD_DEADLINE_S; see scripts/overload.sh)",
    )
    parser.add_argument(
        "--federation", action="store_true",
        help="run the multi-region federated storm (partition, "
        "failover, rolling restart as scored chaos phases; env knobs "
        "FED_PROFILE / FED_REGIONS / FED_SERVERS / FED_NODES / "
        "FED_CHURN_S / FED_CROSS_P; see scripts/federation.sh)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="where the server's device tier runs: cuda (the default; "
        "raises without a card) or cpu (the kernels' plain versions)",
    )
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument(
        "--duration", type=float, default=None,
        help="override the churn phase length in seconds (soak scenario "
        "honors SOAK_CHURN_S too)",
    )
    parser.add_argument(
        "--out", default=None, help="write the scored JSON artifact here"
    )
    parser.add_argument(
        "--time-scale", type=float, default=1.0,
        help=">1 stretches the schedule, <1 compresses it",
    )
    parser.add_argument("--driver-workers", type=int, default=8)
    parser.add_argument(
        "--print-stream", action="store_true",
        help="compile and dump the op stream, then exit",
    )
    parser.add_argument(
        "--list", action="store_true", help="list scenarios and exit"
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    from . import compile_stream, get_scenario, list_scenarios

    if args.list:
        for name in list_scenarios():
            print(name)
        return 0

    import logging

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )

    if args.fanout:
        from .fanout import run_fanout_from_env
        from .fanout import summary_line as fanout_summary

        report = run_fanout_from_env(
            args.seed, out=args.out, driver_workers=args.driver_workers,
            device=args.device,
        )
        print(json.dumps(report["slo"], indent=1))
        print(fanout_summary(report))
        return 0 if report["slo"]["failed"] == 0 else 1

    if args.overload:
        from .overload import run_overload_from_env
        from .overload import summary_line as overload_summary

        report = run_overload_from_env(
            args.seed, out=args.out, driver_workers=args.driver_workers,
            device=args.device,
        )
        print(json.dumps(report["slo"], indent=1))
        print(overload_summary(report))
        return 0 if report["slo"]["failed"] == 0 else 1

    if args.federation:
        from .federation import run_federation_from_env
        from .federation import summary_line as fed_summary

        report = run_federation_from_env(
            args.seed, out=args.out, time_scale=args.time_scale,
            device=args.device,
        )
        print(json.dumps(report["slo"], indent=1))
        print(fed_summary(report))
        return 0 if report["slo"]["failed"] == 0 else 1

    scenario = get_scenario(args.scenario)
    if args.duration is not None:
        # churn_s only ever feeds this one phase (scenarios.py), so the
        # direct patch is the whole override — no env mutation
        for phase in scenario.phases:
            if phase.name == "churn":
                phase.duration = args.duration

    if args.print_stream:
        sys.stdout.buffer.write(compile_stream(scenario, args.seed).encode())
        return 0

    from .runner import run_scenario, summary_line

    report = run_scenario(
        scenario,
        args.seed,
        out=args.out,
        time_scale=args.time_scale,
        driver_workers=args.driver_workers,
        device=args.device,
    )
    # the artifact carries the full timeline; stdout gets the grading and
    # the one summary line that must survive a truncated log tail
    print(json.dumps(report["slo"], indent=1))
    print(summary_line(report))
    return 0 if report["slo"]["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
