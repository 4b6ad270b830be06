#!/usr/bin/env python3
"""Time the tile count (csrc/paging.cu ``tile_count_kernel``) against
variants of its grid and against cut-down copies, on one CUDA card, at the
paged eval's tile shape.

    python3 nomad_tpu_torch/tools/tile_count_variants.py

Grid variants, each of which must count as the plain version does:

- ``rows_4``, ``rows_8``: 4 or 8 rows a thread instead of 2, so a
  65,536-row tile takes 64 or 32 blocks instead of 128 (fewer ticket
  atomics on one word, more loads in flight a thread).

Cut-down copies, which read what a part of the work costs:

- ``no_loads``: the rows' fit taken from the row index instead of the
  capacity, used and feasible planes (the reductions, the ticket and the
  write stay);
- ``empty``, ``rows_8_empty``: every block returns at its first
  instruction, the floor of a launch of the committed grid and of the
  32-block one.

Each copy compiles alone (``variants.build``) under
build/nomad_tpu_torch/tile_count_variants/ and is called through ctypes as
the paged drive's launcher calls it, on a 65,536-row tile of 4 columns (one
16-byte load a row and plane) and of 5 columns (the general path), in
turns (each copy, then back in reverse order). Time: the device time by
torch.profiler over 50 calls (chip_smoke.device_us). Prints the card's name
and power limit, then one JSON line of device microseconds by copy and
shape.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nomad_tpu_torch.tools import variants  # noqa: E402
from nomad_tpu_torch.tpu import paging  # noqa: E402

OUT = ROOT / "build" / "nomad_tpu_torch" / "tile_count_variants"
ROWS_4 = ("constexpr int TC_ROWS = 2;", "constexpr int TC_ROWS = 4;")
ROWS_8 = ("constexpr int TC_ROWS = 2;", "constexpr int TC_ROWS = 8;")
EMPTY = ("  int d[4] = {0, 0, 0, 0};\n", "  if (T > 0) return;\n  int d[4] = {0, 0, 0, 0};\n")
#: copy name -> [(committed text, replacement)], each found exactly once
VARIANTS = {
    "rows_4": [ROWS_4],
    "rows_8": [ROWS_8],
    "no_loads": [
        ("      f[r] = q < T ? __ldg(feas + q) : 0;\n",
         "      f[r] = q < T ? (unsigned char)(q & 1) : 0;\n"),
        ("      if (ROWS4 && q < T) {\n", "      if (false) {\n"),
        ("      if (ROWS4)\n        fit = fit && u4[r].x",
         "      if (true) {\n      } else if (ROWS4)\n        fit = fit && u4[r].x"),
    ],
    "empty": [EMPTY],
    "rows_8_empty": [ROWS_8, EMPTY],
}
#: the copies that must give the plain version's counts
GRIDS = ("committed", "rows_4", "rows_8")
T_ROWS = 65_536


def tile(C: int, dev):
    """(cap, feas, used, demand) of a T_ROWS-row tile, made from a seed."""
    rng = np.random.default_rng(C)
    cap = rng.integers(8, 64, size=(T_ROWS, C)).astype(np.int32)
    used = (cap * rng.uniform(0.5, 1.1, size=(T_ROWS, C))).astype(np.int32)
    feas = rng.random(T_ROWS) < 0.9
    demand = rng.integers(1, 4, size=C).astype(np.int32)
    return tuple(torch.from_numpy(x).to(dev) for x in (cap, feas, used, demand))


def main() -> int:
    if not torch.cuda.is_available():
        print("tile_count_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = variants.build("tile_count_variants", "paging.cu", VARIANTS, ("ntt_tile_count",), OUT)
    names = list(libs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ticket = torch.zeros(1, dtype=torch.int64, device=dev)
    out = torch.empty(2, dtype=torch.int32, device=dev)
    t0, offset, n_real = 0, T_ROWS // 2, T_ROWS - T_ROWS // 8
    report = {}
    for C in (4, 5):
        cap, feas, used, demand = tile(C, dev)
        want = paging.tile_count_ref(cap, feas, used, demand, t0, offset, n_real).cpu()
        us = {}
        for name in names + names[::-1]:
            def call(fn=libs[name].ntt_tile_count):
                rc = fn(cap.data_ptr(), feas.data_ptr(), used.data_ptr(), demand.data_ptr(),
                        out.data_ptr(), ticket.data_ptr(), T_ROWS, C, t0, offset, n_real, stream)
                if rc:
                    raise SystemExit(f"tile_count_variants: {name}: launch status {rc}")
                return out

            out.fill_(-7)
            call()
            torch.cuda.synchronize()
            if name in GRIDS and not torch.equal(out.cpu(), want):
                raise SystemExit(f"tile_count_variants: {name} miscounted")
            ticket.zero_()  # the cut-down copies need not clear it
            us.setdefault(name, []).append(chip_smoke.device_us(call, calls=50))
            ticket.zero_()
        report[f"T={T_ROWS} C={C}"] = us
        print(f"T={T_ROWS} C={C}: device us by copy " + ", ".join(
            f"{n} {us[n]}" for n in names), flush=True)
    print(chip_smoke.card_line())
    print(json.dumps({"tile_count_variants": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
