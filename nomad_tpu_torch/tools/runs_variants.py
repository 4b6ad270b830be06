#!/usr/bin/env python3
"""Time the run planner (csrc/runs.cu) against variants that each take one
of its design choices away, on one CUDA card.

    python3 nomad_tpu_torch/tools/runs_variants.py

Each variant is the committed runs.cu with one exact text replacement:

- ``cluster_8``: a cluster of 8 blocks instead of 16, so a block owns
  twice the positions (two a thread at the headline, round records in
  global memory);
- ``sorted_path``: every round takes the sorted path (three more cluster
  barriers and a block sort), instead of exchanging the first-accepted
  lanes at barrier 2 and resolving them in every block;
- ``ranks_general``: the tie ranks of the many-class path (a compacted
  list of the tied positions, per-class totals in tagged global slots)
  instead of ballots with the totals riding barrier 1;
- ``records_global``: the round records in global memory, one a position,
  instead of registers (``cluster_8`` minus this variant is what the
  cluster's size alone costs).

The committed source and each variant compile alone (nvcc with the
library's flags, all at once) into their own shared library under
build/nomad_tpu_torch/runs_variants/. They are timed in turns (committed,
then each variant, then back in reverse order) through
``kernel.plan_batch_runs`` on chip_smoke.py's headline eval (10,000 nodes,
50,000 allocs spread over 4 values) and on a sweep-heavy one (12,000
identical nodes, 30,000 allocs spread over 4 values: its sweeps accept
more than a block's positions): CUDA events, median of 5 calls after a
warm-up each turn. Every variant must give the committed kernel's
placements and rounds. Prints the card's name and power limit, then one
JSON line of microseconds per round by variant and shape.
"""

import json
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nomad_tpu_torch.tools import variants  # noqa: E402
from nomad_tpu_torch.tpu import _build, kernel, planner, problems  # noqa: E402

#: variant name -> (committed text, replacement), each found exactly once
VARIANTS = {
    "cluster_8": ("constexpr int RUNS_CLUSTER = 16;", "constexpr int RUNS_CLUSTER = 8;"),
    "sorted_path": ("      const bool overflow = __any_sync(FULL_MASK, h.n0 > SLOTS);\n",
                    "      const bool overflow = true;\n"),
    "ranks_general": ("  L.rank_small = V + 1 <= RANK_SMALL;", "  L.rank_small = false;"),
    "records_global": ("  L.reg = L.layers <= 1;", "  L.reg = false;"),
}
OUT = ROOT / "build" / "nomad_tpu_torch" / "runs_variants"
ENTRY_POINTS = ("ntt_runs", "ntt_runs_scratch")


def build_all() -> dict:
    """name -> loaded library of the committed kernel and of each variant."""
    swaps = {name: [swap] for name, swap in VARIANTS.items()}
    return variants.build("runs_variants", "runs.cu", swaps, ENTRY_POINTS, OUT)


def shapes(dev):
    """(name, args, init, a_pad) of the two shapes."""
    cluster = problems.build_cluster(chip_smoke.NODES, chip_smoke.ALLOCS,
                                     n_values=chip_smoke.VALUES, seed=0)
    p = planner.pad_planes(problems.eval_planes(*problems.exact_problem(cluster, spread=True)))
    out = [("headline", *planner.runs_inputs(p, dev), p["demands"].shape[0])]
    c = problems.build_cluster(12_000, 30_000, seed=43)
    c["feasible"][:] = True
    c["capacity"][:] = [16000, 32768, 100 * 1024, 1000]
    c["usable"][:] = [15900, 32512]
    args, init = problems.runs_problem(c, affinity=False, spread=True)
    out.append(("sweep-heavy", kernel.from_numpy(args, dev), kernel.from_numpy(init, dev),
                problems.bucket(30_000)))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("runs_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = build_all()
    names = list(libs)
    turns = names + names[::-1]
    report = {}
    for shape, args, init, a_pad in shapes(dev):
        results, us = {}, {}
        for name in turns:
            with mock.patch.object(_build, "library", lambda lib=libs[name]: lib):
                ms, out = chip_smoke.cuda_ms(lambda: kernel.plan_batch_runs(args, init, a_pad),
                                             samples=5)
            rounds = int(out[1])
            us.setdefault(name, []).append(ms * 1e3 / rounds)
            results.setdefault(name, out)
        p0, r0 = results["committed"]
        for name in VARIANTS:
            p1, r1 = results[name]
            if chip_smoke.max_abs_err([(p0, p1)]) or int(r0) != int(r1):
                raise SystemExit(f"runs_variants: {shape}: {name} placed differently")
        report[shape] = {name: dict(us_per_round=us[name]) for name in names}
        report[shape]["rounds"] = int(r0)
        print(f"{shape} ({int(r0)} rounds): us a round by variant "
              + ", ".join(f"{n} {us[n]}" for n in names), flush=True)
    print(chip_smoke.card_line())
    print(json.dumps({"runs_variants": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
