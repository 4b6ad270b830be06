#!/usr/bin/env python3
"""Time the wavefront kernel (csrc/wavefront.cu) against variants that each
take one of its design choices away, on one CUDA card.

    python3 nomad_tpu_torch/tools/wavefront_variants.py

Each variant is the committed wavefront.cu with one exact text
replacement:

- ``cluster_half``: clusters of half the blocks the card could give each
  lane (Q / 2, at least 1), so each lane walks twice the chunks;
- ``no_stop``: every lane walks its whole ring, instead of stopping after
  the chunk in which its limit window fills;
- ``serial_fold``: block 0's thread 0 folds every committed lane, one
  after another, instead of each lane's cluster folding its own.

The committed source and each variant compile alone (nvcc with the
library's flags, all at once) into their own shared library under
build/nomad_tpu_torch/wavefront_variants/. They are timed in turns
(committed, then each variant, then back in reverse order) through
``wavefront.plan_batch_wavefront`` at W = 32, M = 1 on chip_smoke.py's
multi-tenant eval (10,000 nodes, 8,192 allocs in 8 groups, full-ring
limits) and its two drain batches (32 evals on 10,000 nodes: drain-bench,
90 lanes of 128 with limit 14, and drain-tenant, 4,096 lanes): CUDA
events, median of 5 calls after a warm-up each turn. Every variant must
give the committed kernel's placements, state and rounds. Prints the
card's name and power limit, then one JSON line of microseconds per round
by variant and shape, with the ring positions each kernel's committed
lanes walked a round.
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
from nomad_tpu_torch.tpu import _build, drain, planner, problems, wavefront  # noqa: E402

#: variant name -> (committed text, replacement), each found exactly once
VARIANTS = {
    "cluster_half": ("      s->q = q;\n", "      s->q = q > 1 ? q / 2 : 1;\n"),
    "no_stop": ("      if (full) break;  // no later position is returned, deferred or replayed\n",
                ""),
    "serial_fold": (
        "    for (int k = cid; k < count; k += ncl)\n"
        "      if (rank == 0 && tid == 0) fold_lane(P, i, k, S);\n",
        "    for (int k = 0; k < count; ++k)\n"
        "      if (blockIdx.x == 0 && tid == 0) fold_lane(P, i, k, S);\n"),
}
OUT = ROOT / "build" / "nomad_tpu_torch" / "wavefront_variants"
ENTRY_POINTS = ("ntt_wavefront", "ntt_wavefront_shape")


def build_all() -> dict:
    """name -> loaded library of the committed kernel and of each variant."""
    swaps = {name: [swap] for name, swap in VARIANTS.items()}
    return variants.build("wavefront_variants", "wavefront.cu", swaps, ENTRY_POINTS, OUT,
                          errors=False)


def shapes(dev):
    """(name, args, state, n_real) of the three shapes."""
    tenants = problems.eval_planes(*problems.wavefront_problem(
        problems.build_cluster(chip_smoke.NODES, chip_smoke.EXACT_ALLOCS,
                               n_values=chip_smoke.VALUES, seed=1),
        n_groups=chip_smoke.EXACT_GROUPS))
    p = planner.pad_planes(tenants)
    out = [("multi-tenant", *planner.exact_inputs(p, dev), p["n_real"])]
    n = chip_smoke.NODES
    cluster = problems.build_cluster(n, 1, n_values=chip_smoke.VALUES, seed=20)
    for label, seed in (("drain-bench", 21), ("drain-tenant", 22)):
        shared, preps = problems.drain_problem(cluster, chip_smoke.DRAIN_EVALS, label, seed=seed)
        order = [drain.DrainPrep.from_dict(d) for d in chip_smoke.batch_order(preps)]
        shape = drain.batch_shape(order, n, chip_smoke.DRAIN_EVALS)
        args, state, _ = drain.assemble(order, n, shape)
        k = shape[3] - n
        planes = (np.concatenate([shared["capacity"], np.zeros((k, 4), np.int32)]),
                  np.concatenate([shared["usable"], np.ones((k, 2), np.float32)]),
                  np.concatenate([shared["used0"], np.full((k, 4), 2**30, np.int32)]))
        out.append((label, *drain.batch_inputs(planes, args, state, dev), n))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("wavefront_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = build_all()
    names = list(libs)
    turns = names + names[::-1]
    wavefront.configure(max_round=chip_smoke.WAVEFRONT_W, contention_top_m=chip_smoke.WAVEFRONT_M)
    report = {}
    for shape, args, state, n_real in shapes(dev):
        results, walked, us, launch = {}, {}, {}, {}
        for name in turns:
            with mock.patch.object(_build, "library", lambda lib=libs[name]: lib):
                ms, out = chip_smoke.cuda_ms(
                    lambda: wavefront.plan_batch_wavefront(args, state, n_real), samples=5)
                rounds = int(out[2])
                if name not in walked:
                    w = torch.zeros(1, dtype=torch.int64, device=dev)
                    wavefront.plan_batch_wavefront(args, state, n_real, walked=w)
                    walked[name] = int(w.item()) / rounds
                    launch[name] = wavefront.cluster_shape(
                        wavefront.window_for(int(args.demands.shape[0])),
                        int(state.spread_counts.shape[1]), wavefront.contention_top_m(), dev)[:2]
            us.setdefault(name, []).append(ms * 1e3 / rounds)
            results.setdefault(name, out)
        s0, p0, r0 = results["committed"]
        for name in VARIANTS:
            s1, p1, r1 = results[name]
            if chip_smoke.max_abs_err([(p0, p1), *zip(s0, s1)]) or int(r0) != int(r1):
                raise SystemExit(f"wavefront_variants: {shape}: {name} placed differently")
        report[shape] = {name: dict(us_per_round=us[name], walked_per_round=walked[name],
                                    q=launch[name][0], clusters=launch[name][1])
                         for name in names}
        report[shape]["rounds"] = int(r0)
        print(f"{shape} ({int(r0)} rounds): us a round by variant "
              + ", ".join(f"{n} {report[shape][n]['us_per_round']} "
                          f"(walks {report[shape][n]['walked_per_round']:.1f})" for n in names),
              flush=True)
    wavefront.reset()
    print(chip_smoke.card_line())
    print(json.dumps({"wavefront_variants": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
