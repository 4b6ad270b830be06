#!/usr/bin/env python3
"""Where a windowed-planner round's time goes, on one CUDA card: the
windowed planner's (csrc/windowed.cu) time per round at chip_smoke.py's
windowed cell, a split of the round by clock64 stamps, the same at a sweep
over the limit, the kernel at mid size and at the paged eval's 1,000,000
positions, and ``planner.plan_eval`` end to end at the cell.

    python3 nomad_tpu_torch/tools/windowed_round_sweep.py [--tree DIR]

``--tree`` names another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` under ``build/``): its
``nomad_tpu_torch`` package and its ``csrc/windowed.cu`` are the ones timed.
The default is this checkout.

Shapes (chip_smoke.py's): the cell, 10,000 nodes (10,240 padded) and
50,000 allocs of one group with limit 10, through ``planner.window_inputs``
and ``kernel.plan_batch_windowed``, and the same planes at limits 1, 3,
30 and 100; mid size, 4,000 nodes (4,096 padded), 8,192 allocs, limit 10;
the paged eval's planes (1,000,000 nodes, 100,000 allocs, limit 8) through
the flat kernel. A time is CUDA events around 5 wrapper calls queued back
to back, over 5 (the median of 3 after a warm-up), which leaves out the
wrapper's host time where the kernel outlasts it: the timed calls skip the
wrapper's checks that wait for the card (its permutation check; the
one-block design's index check), which the warm-up call makes; us a round
is that over the rounds. At the cell the tool also reads the wrapper call's device time
with this checkout's ``chip_smoke.device_us``, whichever tree is timed, so
that two trees are read by one rule.

The split: the tool compiles the tree's kernel sources a second time, with
``NTT_STAMP`` defined, under build/nomad_tpu_torch/windowed_stamped/.
Block 0's thread 0 reads ``clock64()`` at the round's boundaries and adds
each span to one of five buckets: counts and scan; barrier 1 (the wait and
the blocks' counts); ranks, bids and end windows; barrier 2; resolve and
place. A kernel with no stamp points of its own (the one-block design) gets
them inserted at its phases' boundaries; it has no barriers, so those two
buckets read 0. Each bucket is reported as a share of the stamped rounds
and as microseconds of the unstamped round. The stamped run's placements
must be the unstamped run's.

Prints the card's name and power limit, then one JSON line.
"""

import argparse
import contextlib
import ctypes
import importlib
import json
import shutil
import sys
import time
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "nomad_tpu_torch" / "windowed_stamped"

SPANS = ("counts and scan", "barrier 1", "ranks, bids and end windows", "barrier 2",
         "resolve and place")
SWEEP_LIMITS = (1, 3, 10, 30, 100)
#: the windowed wrapper's checks that wait for the card: this tree's
#: permutation check, the one-block design's index check
SYNCING_CHECKS = ("_check_perm", "_check_index")

#: clock64 stamps of block 0's thread 0, kept in registers and added to a
#: device array when the kernel ends
STAMP_PRELUDE = r"""
__device__ unsigned long long ntt_stamp_sum[5];
#define NTT_STAMP_DECL unsigned long long ntt_t_[5] = {0, 0, 0, 0, 0}, ntt_last_ = 0
#define NTT_STAMP(k) do { if (blockIdx.x == 0 && threadIdx.x == 0) { \
    const unsigned long long t_ = clock64(); \
    if ((k) > 0) ntt_t_[(k) - 1] += t_ - ntt_last_; \
    ntt_last_ = t_; } } while (0)
#define NTT_STAMP_FLUSH do { if (blockIdx.x == 0 && threadIdx.x == 0) \
    for (int k_ = 0; k_ < 5; ++k_) ntt_stamp_sum[k_] += ntt_t_[k_]; } while (0)
"""
STAMP_READER = r"""
extern "C" int ntt_stamps_take(void* spans) {
  cudaError_t err = cudaMemcpyFromSymbol(spans, ntt_stamp_sum, sizeof(ntt_stamp_sum));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[5] = {};
  return (int)cudaMemcpyToSymbol(ntt_stamp_sum, zero, sizeof(ntt_stamp_sum));
}
"""
#: the one-block design's phase boundaries: (its text, with the stamps)
PARENT_STAMPS = [
    ("  int offset = 0, placed = 0, rounds = 0;\n",
     "  NTT_STAMP_DECL;\n  int offset = 0, placed = 0, rounds = 0;\n"),
    ("  while (placed < n_allocs) {\n", "  while (placed < n_allocs) {\n    NTT_STAMP(0);\n"),
    ("    block_scan<2, 20>(cnt, excl, tot);\n",
     "    block_scan<2, 20>(cnt, excl, tot);\n    NTT_STAMP(1);\n    NTT_STAMP(2);\n"),
    ("    // each window's winner places the alloc numbered placed + window\n",
     "    NTT_STAMP(3);\n    NTT_STAMP(4);\n"
     "    // each window's winner places the alloc numbered placed + window\n"),
    ("    placed += w_use;\n  }\n", "    placed += w_use;\n    NTT_STAMP(5);\n  }\n"
     "  NTT_STAMP_FLUSH;\n"),
]


def load_tree(tree: Path):
    """The tree's nomad_tpu_torch modules and chip_smoke (imported from ``tree``)."""
    sys.path.insert(0, str(tree))
    for name in [m for m in sys.modules if m.split(".")[0] in ("nomad_tpu_torch", "chip_smoke")]:
        del sys.modules[name]
    mods = {name: importlib.import_module(f"nomad_tpu_torch.tpu.{name}")
            for name in ("_build", "kernel", "planner", "problems")}
    mods["chip_smoke"] = importlib.import_module("chip_smoke")
    return mods


#: tree -> its stamped library, built once a process
_STAMPED = {}


def stamped_library(b, tree: Path):
    """The tree's kernels built with the stamps on, loaded; sets ``b`` (the
    tree's _build module) to it."""
    d = OUT / ("tree" if tree == ROOT else "other")
    if tree in _STAMPED:
        b.CSRC, b.BUILD_ROOT, b._LIB = d / "csrc", d / "lib", _STAMPED[tree]
        return _STAMPED[tree]
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(tree / "nomad_tpu_torch" / "tpu" / "csrc", d / "csrc")
    src = (d / "csrc" / "windowed.cu").read_text()
    if "NTT_STAMP(" not in src:
        for old, new in PARENT_STAMPS:
            if src.count(old) != 1:
                raise SystemExit(f"windowed_round_sweep: a phase boundary is not in windowed.cu "
                                 f"once: {old!r}")
            src = src.replace(old, new)
    (d / "csrc" / "windowed.cu").write_text(STAMP_PRELUDE + src + STAMP_READER)
    b.CSRC, b.BUILD_ROOT, b._LIB = d / "csrc", d / "lib", None
    lib = _STAMPED[tree] = b.library()
    lib.ntt_stamps_take.argtypes = [ctypes.c_void_p]
    return lib


def kernel_ms(fn, k) -> tuple:
    """(ms per call of ``fn`` queued back to back, by CUDA events: the
    kernel's time without its wrapper's host time; result). The first call
    runs the wrapper's checks; the timed calls skip those of ``k`` (the
    tree's kernel module) that wait for the card, which would hold the
    host back between calls: SYNCING_CHECKS."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    with contextlib.ExitStack() as stack:
        for name in SYNCING_CHECKS:
            if hasattr(k, name):
                stack.enter_context(mock.patch.object(k, name, lambda *args: None))
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            for _ in range(5):
                out = fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 5)
    return sorted(times)[1], out


def split_report(b, k, args, used, coll, n_real, A, tree: Path = ROOT) -> dict:
    """The windowed planner at (args, used, coll, n_real, A): ms a call by
    CUDA events around calls queued back to back, rounds, us a round and
    its split by the stamped build's buckets. ``b`` and ``k`` are the
    tree's _build and kernel modules; ``b`` is set back to its own library
    after."""

    def run():
        return k.plan_batch_windowed(args, used, coll, n_real, A)

    ms, (placements, rounds) = kernel_ms(run, k)
    rounds = int(rounds)
    want = placements.cpu()
    saved = b.CSRC, b.BUILD_ROOT, b._LIB
    try:
        stamps = stamped_library(b, tree)
        spans = (ctypes.c_ulonglong * len(SPANS))()
        run()  # builds and warms the stamped kernel
        torch.cuda.synchronize()
        stamps.ntt_stamps_take(spans)  # clear what the warm-up added
        got, got_rounds = run()
        torch.cuda.synchronize()
        if stamps.ntt_stamps_take(spans):
            raise SystemExit("windowed_round_sweep: the stamps cannot be read")
    finally:
        b.CSRC, b.BUILD_ROOT, b._LIB = saved
    if not torch.equal(got.cpu(), want) or int(got_rounds) != rounds:
        raise SystemExit("windowed_round_sweep: the stamped kernel placed differently")
    total = sum(spans) or 1
    us = ms * 1e3 / rounds
    return dict(
        shape=f"N={args.capacity.shape[0]} n_real={n_real} A={A} L={int(args.limit)}",
        ms=ms, rounds=rounds, us_per_round=us, cycles_per_round=sum(spans) / rounds,
        split_us={s: v / total * us for s, v in zip(SPANS, spans)},
        share={s: v / total for s, v in zip(SPANS, spans)},
    )


def cell(mods, dev):
    """(planes, args, used, coll, n_real, A) of chip_smoke.py's windowed cell."""
    cs, p_, pl = mods["chip_smoke"], mods["problems"], mods["planner"]
    cluster = p_.build_cluster(cs.NODES, cs.ALLOCS, n_values=cs.VALUES, seed=0)
    planes = p_.eval_planes(*p_.exact_problem(cluster, spread=False))
    planes["limits"][:] = cs.LIMIT
    p = pl.pad_planes(planes)
    return (planes, *pl.window_inputs(p, dev), p["n_real"], p["demands"].shape[0])


def mid(mods, dev):
    """(args, used, coll, n_real, A) of chip_smoke.py's mid-size check."""
    cs, p_, k = mods["chip_smoke"], mods["problems"], mods["kernel"]
    c = p_.pad_cluster(p_.build_cluster(4000, 8192, seed=12), 4096)
    args, used, coll = p_.window_problem(c, limit=cs.LIMIT)
    return (k.from_numpy(args, dev), *k.from_numpy((used, coll), dev), 4000, 8192)


def million(mods, dev):
    """(args, used, coll, n_real, A) of the paged eval's planes, flat."""
    cs, p_, pl = mods["chip_smoke"], mods["problems"], mods["planner"]
    paged = p_.paged_eval_planes(p_.paged_case(cs.PAGED_SEED, cs.PAGED_NODES, cs.PAGED_ALLOCS))
    p = pl.pad_planes(paged)
    return (*pl.window_inputs(p, dev), p["n_real"], p["demands"].shape[0])


def plan_eval_samples(pl, planes, dev, n: int = 3) -> list:
    """(e2e ms, kernel ms) of ``n`` plan_eval calls after a warm-up."""
    pl.plan_eval(planes, dev)
    out = []
    for _ in range(n):
        t = time.perf_counter()
        _, stats = pl.plan_eval(planes, dev)
        out.append(((time.perf_counter() - t) * 1e3, stats["kernel_s"] * 1e3))
    return out


def tree_report(mods, tree: Path, dev, device_us) -> dict:
    b, k, pl = mods["_build"], mods["kernel"], mods["planner"]
    planes, args, used, coll, n_real, A = cell(mods, dev)
    report = dict(cell=split_report(b, k, args, used, coll, n_real, A, tree))
    report["cell"]["device_us"] = device_us(lambda: k.plan_batch_windowed(args, used, coll,
                                                                          n_real, A))
    report["plan_eval_ms"] = plan_eval_samples(pl, planes, dev)
    sweep = {}
    for L in SWEEP_LIMITS:
        a = args._replace(limit=torch.tensor(L, dtype=torch.int32, device=dev))
        sweep[L] = split_report(b, k, a, used, coll, n_real, A, tree)
    report["limit_sweep"] = sweep
    for name, shape in (("mid", mid), ("million", million)):
        a, u, c, n, a_pad = shape(mods, dev)
        ms, (_, rounds) = kernel_ms(lambda: k.plan_batch_windowed(a, u, c, n, a_pad), k)
        report[name] = dict(ms=ms, rounds=int(rounds),
                            shape=f"N={a.capacity.shape[0]} n_real={n} A={a_pad} L={int(a.limit)}")
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    tree = ap.parse_args().tree.resolve()
    if not torch.cuda.is_available():
        print("windowed_round_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # this checkout's device time, whichever tree is timed

    mods = load_tree(tree)
    report = dict(tree=str(tree) if tree != ROOT else ".",
                  **tree_report(mods, tree, dev, chip_smoke.device_us))
    c = report["cell"]
    print(f"{report['tree']}: cell {c['rounds']} rounds, {c['ms']:.4f} ms, "
          f"{c['us_per_round']:.3f} us a round, device us {c['device_us']}; split " + ", ".join(
              f"{s} {v:.3f}" for s, v in c["split_us"].items()), flush=True)
    print("plan_eval at the cell (e2e ms, kernel ms): " + ", ".join(
        f"({e:.2f}, {k:.2f})" for e, k in report["plan_eval_ms"]))
    for L, r in report["limit_sweep"].items():
        print(f"L={L}: {r['rounds']} rounds, {r['ms']:.4f} ms, {r['us_per_round']:.3f} us a round; "
              + ", ".join(f"{s} {v:.3f}" for s, v in r["split_us"].items()))
    for name in ("mid", "million"):
        r = report[name]
        print(f"{name} ({r['shape']}): {r['ms']:.4f} ms, {r['rounds']} rounds")
    print(mods["chip_smoke"].card_line())
    print(json.dumps({"windowed_round_us": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
