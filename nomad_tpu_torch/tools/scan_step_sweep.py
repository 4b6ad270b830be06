#!/usr/bin/env python3
"""Where an exact-scan step's time goes: the kernel's time per step against
the ring's length and the step's limit, on one CUDA card.

    python3 nomad_tpu_torch/tools/scan_step_sweep.py

Each problem is one group of 2,048 identical allocs over an N-node ring of
roomy nodes, all feasible (``problems.build_cluster``'s planes with every
node feasible and capacity to spare), no spread unless noted. With a
full-ring limit a step walks and scores all N positions, in chunks of the
cluster's 16 x 1,024; with limit 1 it stops after its first chunk (4,096
positions) whatever N is. Each time is ``kernel.plan_batch`` between CUDA
events (median of 3 after a warm-up) over the 2,048 steps, and the ring
positions the kernel counts itself walking a step. Prints the card's name
and power limit, then one JSON line of microseconds per step.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nomad_tpu_torch.tpu import kernel, problems  # noqa: E402

STEPS = 2048
RINGS = (32, 1024, 4096, 16384, 16385, 32768, 65536)


def problem(n: int, limit: int | None, spread: bool, dev):
    c = problems.build_cluster(n, STEPS, seed=5)
    c["feasible"][:] = True
    c["capacity"][:] = [10**6, 10**7, 10**7, 10**6]
    c["usable"][:] = [10**6, 10**7]
    args, init = problems.exact_problem(c, spread=spread)
    if limit is not None:
        args["limits"] = np.full_like(args["limits"], limit)
    return kernel.from_numpy(args, dev), kernel.from_numpy(init, dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_step_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rows = []
    cases = [(n, None, False) for n in RINGS] + [(n, 1, False) for n in RINGS]
    cases += [(n, None, True) for n in (1024, 16384)]
    for n, limit, spread in cases:
        args, init = problem(n, limit, spread, dev)
        ms, (_, placements) = chip_smoke.cuda_ms(lambda: kernel.plan_batch(args, init, n))
        if int((placements >= 0).sum()) != STEPS:
            raise SystemExit(f"scan_step_sweep: N={n} placed {int((placements >= 0).sum())}")
        walked = torch.zeros(1, dtype=torch.int64, device=dev)
        kernel.plan_batch(args, init, n, walked=walked)
        rows.append(dict(ring=n, limit="ring" if limit is None else limit, spread=spread,
                         walked_per_step=int(walked.item()) / STEPS,
                         us_per_step=ms * 1e3 / STEPS))
        print(f"N={n} limit={rows[-1]['limit']} spread={spread}: "
              f"{rows[-1]['us_per_step']:.3f} us a step", flush=True)
    print(chip_smoke.card_line())
    print(json.dumps({"exact_scan_step_us": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
