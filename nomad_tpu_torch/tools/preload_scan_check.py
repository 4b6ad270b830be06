#!/usr/bin/env python3
"""Hold one of the server run's large fused scans: the first fused drain
batch of chip_smoke.py phase 7's preload (ROADMAP C3), on one CUDA card.

    python3 nomad_tpu_torch/tools/preload_scan_check.py

Runs phase 7's server run with its preload at 8 batch jobs
(``chip_smoke.server_run`` at ``PRELOAD``, ``chip_smoke.SERVER`` with the
8 jobs phase 7 ran until phase 9 came: the port's ``Server`` on the card
over 10,000 mock nodes, 8 batch jobs of 7,500-10,000 allocs registered
before two drain workers start, then the system and service jobs) and
records the inputs
and output of the run's first exact-scan launch, which is the preload's
first fused batch. Then it holds that call:

1. against the scan's plain version (``kernel.plan_batch_ref``) on the
   same inputs on the card: the placements and the final state (usage,
   collisions, spread counts, cursors) must be equal, bit for bit;
2. against the port's float64 oracle (``tpu/exact_np.py``), run eval by
   eval over each eval's ring from its cursor with the usage threaded
   through the evals in lane order: the placements' parity and the final
   usage. The oracle scores in float64 where the kernels score in float32,
   so a near tie may break the other way (chip_smoke.py phase 4 asks
   parity of at least 0.99 of it), and after a first differing lane the
   two runs go on from different usage; that lane is printed.

Prints the card's name and power limit, then one JSON line. Exits 1 when
the kernel differs from its plain version.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nomad_tpu_torch.tpu import exact_np, kernel  # noqa: E402

#: the server run's size: phase 7's, with its preload of 8 batch jobs
PRELOAD = dict(chip_smoke.SERVER, batch_jobs=8)


def record_first_scan(dev, size: dict = PRELOAD) -> tuple:
    """(args, init, n_real, kernel state, kernel placements) of the first
    exact-scan launch of phase 7's server run at ``size``, cloned on the
    launching stream, and the run's findings."""
    first = []
    real = kernel.plan_batch

    def plan_batch(args, init, n_real, *rest, **kw):
        out = real(args, init, n_real, *rest, **kw)
        if not first:
            first.append((chip_smoke._snapshot(args), chip_smoke._snapshot(init), n_real,
                          chip_smoke._snapshot(out)))
        return out

    node_docs = [n.to_dict() for n in chip_smoke.sched_nodes(size["nodes"], size["dcs"])]
    jobs = chip_smoke.server_jobs(size)
    with chip_smoke.mock.patch.object(kernel, "plan_batch", plan_batch):
        run = chip_smoke.server_run(dev, size, node_docs, jobs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if not first:
        chip_smoke.fail("the server run launched no exact scan")
    args, init, n_real, (state, placements) = first[0]
    return args, init, n_real, state, placements, run


def oracle(args, init) -> tuple:
    """The float64 oracle's placements over the batch, eval by eval, and the
    usage they leave. Each eval's lanes are contiguous; its ring is its
    first ``ring`` shuffled positions, rotated to start at its cursor."""
    a = {k: v.cpu().numpy() for k, v in args._asdict().items()}
    s = {k: v.cpu().numpy() for k, v in init._asdict().items()}
    valid = np.flatnonzero(a["valid"])
    lane_eval = a["group_eval"][a["groups"][valid]]
    starts = np.flatnonzero(np.diff(lane_eval, prepend=-1))
    if len(set(lane_eval[starts].tolist())) != len(starts):
        chip_smoke.fail("an eval's lanes are not contiguous in the batch")
    used = s["used"].astype(np.int64)
    placements = np.full(a["demands"].shape[0], -1, np.int64)
    for k, start in enumerate(starts):
        lanes = valid[start: starts[k + 1] if k + 1 < len(starts) else len(valid)]
        e = int(lane_eval[start])
        ring = np.roll(a["perm"][e][: a["ring"][e]], -int(s["offset"][e])).astype(np.int64)
        gs = np.unique(a["groups"][lanes])
        local = {int(g): i for i, g in enumerate(gs)}
        got = exact_np.plan_exact_np(
            a["capacity"][ring].astype(np.int64), a["usable"][ring].astype(np.float64),
            a["feasible"][gs][:, ring], a["affinity"][gs][:, ring].astype(np.float64),
            a["affinity_present"][gs][:, ring], a["group_count"][gs].astype(np.int64),
            a["node_value"][gs][:, ring].astype(np.int64),
            a["spread_desired"][gs].astype(np.float64),
            a["spread_implicit"][gs].astype(np.float64),
            a["spread_weight_frac"][gs].astype(np.float64), a["spread_even"][gs],
            a["spread_active"][gs], np.arange(len(ring)),
            a["demands"][lanes].astype(np.int64),
            np.array([local[int(g)] for g in a["groups"][lanes]], np.int64),
            a["limits"][lanes].astype(np.int64), used[ring],
            s["collisions"][gs][:, ring].astype(np.int64),
            s["spread_counts"][gs].astype(np.int64), s["spread_present"][gs])
        placed = got >= 0
        nodes = np.where(placed, ring[np.maximum(got, 0)], -1)
        placements[lanes] = nodes
        np.add.at(used, nodes[placed], a["demands"][lanes][placed].astype(np.int64))
    return placements, used


def main() -> int:
    if not torch.cuda.is_available():
        print("preload_scan_check: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    t0 = time.perf_counter()
    args, init, n_real, state, placements, run = record_first_scan(dev)
    out = dict(run_s=time.perf_counter() - t0, lanes=int(args.demands.shape[0]),
               real_lanes=int(args.valid.sum()), evals=int(args.ring.shape[0]),
               groups=int(args.groups.max()) + 1, nodes=int(n_real),
               placed=int((placements >= 0).sum()), register_s=run["register_s"],
               batch_wall_s=run["batch_wall_s"])
    print(f"recorded the first fused batch: {out}", flush=True)

    # 1. the plain version on the card, bit for bit
    t0 = time.perf_counter()
    want_state, want = kernel.plan_batch_ref(args, init, n_real)
    torch.cuda.synchronize()
    out["plain_s"] = time.perf_counter() - t0
    out["plain_max_abs_err"] = chip_smoke.max_abs_err([(placements, want),
                                                        *zip(state, want_state)])
    diff = torch.nonzero(placements != want).flatten()
    out["plain_first_diff"] = None if not len(diff) else dict(
        lane=int(diff[0]), kernel=int(placements[diff[0]]), plain=int(want[diff[0]]))
    print(f"plain version: max abs err {out['plain_max_abs_err']} over placements and final "
          f"state in {out['plain_s']:.1f} s", flush=True)

    # 2. the float64 oracle
    t0 = time.perf_counter()
    got = placements.cpu().numpy().astype(np.int64)
    ref, ref_used = oracle(args, init)
    out["oracle_s"] = time.perf_counter() - t0
    valid = args.valid.cpu().numpy()
    out["oracle_parity"] = float((got[valid] == ref[valid]).mean())
    out["oracle_used_equal"] = bool(np.array_equal(ref_used, state.used.cpu().numpy()))
    lanes = np.flatnonzero(valid & (got != ref))
    out["oracle_first_diff"] = None if not len(lanes) else dict(
        lane=int(lanes[0]), eval=int(args.group_eval[args.groups[lanes[0]]]),
        kernel=int(got[lanes[0]]), oracle=int(ref[lanes[0]]), differing=int(len(lanes)))
    print(f"float64 oracle: parity {out['oracle_parity']:.6f}, final usage equal "
          f"{out['oracle_used_equal']}, first differing lane {out['oracle_first_diff']} "
          f"({out['oracle_s']:.1f} s)", flush=True)
    print(card)
    print(json.dumps(out))
    return 1 if out["plain_max_abs_err"] else 0


if __name__ == "__main__":
    sys.exit(main())
