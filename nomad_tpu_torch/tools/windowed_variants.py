#!/usr/bin/env python3
"""Time the windowed planner (csrc/windowed.cu) against variants that each
take one of its design choices away, on one CUDA card.

    python3 nomad_tpu_torch/tools/windowed_variants.py

Each variant is the committed windowed.cu with one exact text replacement:

- ``cluster_8``: a cluster of 8 blocks instead of 16, so a block owns
  twice the positions (two a thread at the cell);
- ``threads_1024``: blocks of 1,024 threads whatever the ring, instead of
  as many as the block's positions need (640 at the cell: 399 of 1,024
  threads would own no position);
- ``state_global``: the positions' rows, fit and score in a global record a
  position, read every round, instead of registers.

The committed source and each variant compile alone (nvcc with the
library's flags, all at once) into their own shared library under
build/nomad_tpu_torch/windowed_variants/. They are timed in turns
(committed, then each variant, then back in reverse order) through
``kernel.plan_batch_windowed`` at chip_smoke.py's windowed cell (10,000
nodes, 50,000 allocs, limit 10), at its mid size (4,000 nodes, 8,192
allocs, limit 10) and at 20,000 nodes and 60,000 allocs, limit 10 (two
positions a thread in registers): CUDA events around 5 calls queued back
to back, the median of 3 after a warm-up each turn, the timed calls without
the wrapper's permutation check (windowed_round_sweep.kernel_ms).
Every variant must give the committed kernel's placements and rounds.
Prints the card's name and power limit, then one JSON line of microseconds
per round by variant and shape.
"""

import json
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nomad_tpu_torch.tools import variants, windowed_round_sweep  # noqa: E402
from nomad_tpu_torch.tpu import _build, kernel, planner, problems  # noqa: E402

#: variant name -> (committed text, replacement), each found exactly once
VARIANTS = {
    "cluster_8": ("constexpr int WIN_CLUSTER = 16;", "constexpr int WIN_CLUSTER = 8;"),
    "threads_1024": ("  L.threads = min(THREADS, max(32, ((L.per + L.k - 1) / L.k + 31) / 32 * 32));",
                     "  L.threads = THREADS;"),
    "state_global": ("  L.reg = L.k <= REG_MAX_POS && C <= REG_MAX_COLS;", "  L.reg = false;"),
}
OUT = ROOT / "build" / "nomad_tpu_torch" / "windowed_variants"
ENTRY_POINTS = ("ntt_windowed", "ntt_windowed_scratch", "ntt_windowed_shape")


def build_all() -> dict:
    """name -> loaded library of the committed kernel and of each variant."""
    swaps = {name: [swap] for name, swap in VARIANTS.items()}
    return variants.build("windowed_variants", "windowed.cu", swaps, ENTRY_POINTS, OUT)


def shapes(dev):
    """(name, args, used, coll, n_real, a_pad) of the shapes."""
    mods = dict(chip_smoke=chip_smoke, problems=problems, planner=planner, kernel=kernel)
    _, args, used, coll, n_real, A = windowed_round_sweep.cell(mods, dev)
    c = problems.build_cluster(20_000, 60_000, seed=15)
    wide = kernel.from_numpy(problems.window_problem(c, limit=chip_smoke.LIMIT), dev)
    return [("cell", args, used, coll, n_real, A),
            ("mid", *windowed_round_sweep.mid(mods, dev)),
            ("two_a_thread", *wide, 20_000, problems.bucket(60_000))]


def main() -> int:
    if not torch.cuda.is_available():
        print("windowed_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = build_all()
    names = list(libs)
    turns = names + names[::-1]
    report = {}
    for shape, args, used, coll, n_real, a_pad in shapes(dev):
        results, us, layouts = {}, {}, {}
        for name in turns:
            with mock.patch.object(_build, "library", lambda lib=libs[name]: lib):
                ms, out = windowed_round_sweep.kernel_ms(
                    lambda: kernel.plan_batch_windowed(args, used, coll, n_real, a_pad), kernel)
                layouts[name] = kernel.windowed_shape(args.capacity.shape[0],
                                                      args.capacity.shape[1], n_real)
            rounds = int(out[1])
            us.setdefault(name, []).append(ms * 1e3 / rounds)
            results.setdefault(name, out)
        p0, r0 = results["committed"]
        for name in VARIANTS:
            p1, r1 = results[name]
            if chip_smoke.max_abs_err([(p0, p1)]) or int(r0) != int(r1):
                raise SystemExit(f"windowed_variants: {shape}: {name} placed differently")
        report[shape] = {name: dict(us_per_round=us[name], layout=layouts[name]) for name in names}
        report[shape]["rounds"] = int(r0)
        print(f"{shape} ({int(r0)} rounds): us a round by variant "
              + ", ".join(f"{n} {us[n]}" for n in names), flush=True)
    print(chip_smoke.card_line())
    print(json.dumps({"windowed_variants": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
