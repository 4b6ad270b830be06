#!/usr/bin/env python3
"""Time the exact-scan kernel (csrc/exact_scan.cu) against variants that
each take one of its design choices away, on one CUDA card.

    python3 nomad_tpu_torch/tools/scan_variants.py

Each variant is the committed exact_scan.cu with one exact text
replacement:

- ``cluster8``: a cluster of 8 blocks (the portable size) instead of 16;
- ``immediate_write``: block 0 writes each placement right after the
  step's candidates barrier, and a third cluster barrier orders it before
  the next step, instead of writing it after the next step's first-chunk
  barrier while every reader adds it;
- ``single_chunk``: every step walks chunks of 16 x 1,024 positions from
  its first, instead of a first chunk of 4,096 where the limit is small.

The committed source and each variant compile alone (nvcc with the
library's flags, all at once) into their own shared library under
build/nomad_tpu_torch/variants/. They are timed in turns (committed, then
each variant, then back in reverse order) through ``kernel.plan_batch`` at
chip_smoke.py's multi-tenant shape (10,000 nodes, 8,192 allocs in 8
groups, full-ring limits) and its drain-bench batch (32 evals of
bench_drain's job mix on 10,000 nodes, 90 lanes of 128, limit 14): CUDA
events, median of 5 calls after a warm-up each turn. Every variant must
give the committed kernel's placements and state. Prints the card's name
and power limit, then one JSON line of microseconds per valid lane's step
by variant and shape, with the ring positions each kernel walked a step.
"""

import json
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nomad_tpu_torch.tools import variants  # noqa: E402
from nomad_tpu_torch.tpu import _build, drain, kernel, planner, problems  # noqa: E402

#: variant name -> (committed text, replacement), each found exactly once
VARIANTS = {
    "cluster8": ("constexpr int SCAN_CLUSTER = 16;", "constexpr int SCAN_CLUSTER = 8;"),
    "immediate_write": (
        "    pend = Pending{best_node, g, i, active};\n",
        "    if (placer && best_node >= 0) write_placement(P, Pending{best_node, g, i, active});\n"
        "    cluster.sync();\n"),
    "single_chunk": ("return limit + MAX_SKIP <= 64 ? SMALL_CHUNK : CHUNK;", "return CHUNK;"),
}
OUT = ROOT / "build" / "nomad_tpu_torch" / "variants"


def build_all() -> dict:
    """name -> loaded library of the committed kernel and of each variant."""
    swaps = {name: [swap] for name, swap in VARIANTS.items()}
    return variants.build("scan_variants", "exact_scan.cu", swaps, ("ntt_exact_scan",), OUT)


def shapes(dev):
    """(name, args, state, n_real) of the two shapes."""
    tenants = problems.eval_planes(*problems.wavefront_problem(
        problems.build_cluster(chip_smoke.NODES, chip_smoke.EXACT_ALLOCS,
                               n_values=chip_smoke.VALUES, seed=1),
        n_groups=chip_smoke.EXACT_GROUPS))
    p = planner.pad_planes(tenants)
    out = [("multi-tenant", *planner.exact_inputs(p, dev), p["n_real"])]
    n = chip_smoke.NODES
    cluster = problems.build_cluster(n, 1, n_values=chip_smoke.VALUES, seed=20)
    shared, bench = problems.drain_problem(cluster, chip_smoke.DRAIN_EVALS, "drain-bench",
                                           seed=21)
    order = [drain.DrainPrep.from_dict(d) for d in chip_smoke.batch_order(bench)]
    shape = drain.batch_shape(order, n, chip_smoke.DRAIN_EVALS)
    args, state, _ = drain.assemble(order, n, shape)
    k = shape[3] - n
    planes = (np.concatenate([shared["capacity"], np.zeros((k, 4), np.int32)]),
              np.concatenate([shared["usable"], np.ones((k, 2), np.float32)]),
              np.concatenate([shared["used0"], np.full((k, 4), 2**30, np.int32)]))
    out.append(("drain-bench", *drain.batch_inputs(planes, args, state, dev), n))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = build_all()
    names = list(libs)
    turns = names + names[::-1]
    report = {}
    for shape, args, state, n_real in shapes(dev):
        lanes = int(args.valid.sum())
        results, walked, us = {}, {}, {}
        for name in turns:
            with mock.patch.object(_build, "library", lambda lib=libs[name]: lib):
                ms, out = chip_smoke.cuda_ms(lambda: kernel.plan_batch(args, state, n_real),
                                             samples=5)
                if name not in walked:
                    w = torch.zeros(1, dtype=torch.int64, device=dev)
                    kernel.plan_batch(args, state, n_real, walked=w)
                    walked[name] = int(w.item()) / lanes
            us.setdefault(name, []).append(ms * 1e3 / lanes)
            results.setdefault(name, out)
        (s0, p0) = results["committed"]
        for name in VARIANTS:
            s1, p1 = results[name]
            if chip_smoke.max_abs_err([(p0, p1), *zip(s0, s1)]):
                raise SystemExit(f"scan_variants: {shape}: {name} placed differently")
        report[shape] = {name: dict(us_per_step=us[name], walked_per_step=walked[name])
                         for name in names}
        print(f"{shape} ({lanes} lanes): us a step by variant "
              + ", ".join(f"{n} {v['us_per_step']} (walks {v['walked_per_step']:.1f})"
                          for n, v in report[shape].items()), flush=True)
    print(chip_smoke.card_line())
    print(json.dumps({"exact_scan_variants": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
