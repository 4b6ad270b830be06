#!/usr/bin/env python3
"""Where a run-planner round's time goes, on one CUDA card: the run
planner's time per round at the headline eval, a split of the round by
clock64 stamps, and the kinds of rounds it runs.

    python3 nomad_tpu_torch/tools/runs_round_sweep.py [--tree DIR]

``--tree`` names another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` under ``build/``): its
``nomad_tpu_torch`` package and its ``csrc/runs.cu`` are the ones timed.
The default is this checkout.

The eval is chip_smoke.py's headline: 10,000 nodes (10,240 padded) and
50,000 allocs of one group spread over 4 values, through
``planner.runs_inputs`` and ``kernel.plan_batch_runs``. The time is the
kernel between CUDA events (median of 3 after a warm-up) over its rounds.

The split: the tool compiles the tree's kernel sources a second time, with
``NTT_STAMP`` defined, under build/nomad_tpu_torch/runs_stamped/. Block 0's
thread 0 reads ``clock64()`` at the round's boundaries and adds each span
to one of six buckets: score and scan; winner and runner-ups; class ranks;
keys, guard and accept; sort (a sweep's merged order); place or fill. A
kernel with no stamp points of its own (the one-block design) gets them
inserted at its phases' boundaries. Each bucket is reported as a share of
the stamped rounds and as microseconds of the unstamped round. The same
build counts the sweep and fill rounds, the accepted lanes a sweep orders
(``n_acc``, in power-of-two buckets) and the placements the fill runs
take. The stamped run's placements must be the unstamped run's.

Prints the card's name and power limit, then one JSON line.
"""

import argparse
import ctypes
import importlib
import json
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "nomad_tpu_torch" / "runs_stamped"

SPANS = ("score and scan", "winner and runner-ups", "class ranks", "keys, guard and accept",
         "sort", "place or fill")
#: counters: sweep rounds, fill rounds, lanes the sweeps accepted, lanes
#: they placed, placements of the fill runs, then n_acc by power of two
#: (bucket k holds 2^k <= n_acc < 2^(k+1))
N_COUNTS = 5 + 20

#: clock64 stamps and round counters of block 0's thread 0, kept in
#: registers and added to device arrays when the kernel ends
STAMP_PRELUDE = r"""
__device__ unsigned long long ntt_stamp_sum[6];
__device__ unsigned long long ntt_count_sum[25];
#define NTT_STAMP_DECL unsigned long long ntt_t_[6] = {0, 0, 0, 0, 0, 0}, ntt_last_ = 0
#define NTT_STAMP(k) do { if (blockIdx.x == 0 && threadIdx.x == 0) { \
    const unsigned long long t_ = clock64(); \
    if ((k) > 0) ntt_t_[(k) - 1] += t_ - ntt_last_; \
    ntt_last_ = t_; } } while (0)
#define NTT_COUNT_SWEEP(n_acc, take) do { if (blockIdx.x == 0 && threadIdx.x == 0) { \
    atomicAdd(&ntt_count_sum[0], 1ull); atomicAdd(&ntt_count_sum[2], (unsigned long long)(n_acc)); \
    atomicAdd(&ntt_count_sum[3], (unsigned long long)(take)); \
    atomicAdd(&ntt_count_sum[5 + min(31 - __clz((int)(n_acc)), 19)], 1ull); } } while (0)
#define NTT_COUNT_FILL(run) do { if (blockIdx.x == 0 && threadIdx.x == 0) { \
    atomicAdd(&ntt_count_sum[1], 1ull); \
    atomicAdd(&ntt_count_sum[4], (unsigned long long)(run)); } } while (0)
#define NTT_STAMP_FLUSH do { if (blockIdx.x == 0 && threadIdx.x == 0) \
    for (int k_ = 0; k_ < 6; ++k_) ntt_stamp_sum[k_] += ntt_t_[k_]; } while (0)
"""
STAMP_READER = r"""
extern "C" int ntt_stamps_take(void* spans, void* counts) {
  cudaError_t err = cudaMemcpyFromSymbol(spans, ntt_stamp_sum, sizeof(ntt_stamp_sum));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(counts, ntt_count_sum, sizeof(ntt_count_sum));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[25] = {};
  err = cudaMemcpyToSymbol(ntt_stamp_sum, zero, sizeof(ntt_stamp_sum));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(ntt_count_sum, zero, sizeof(ntt_count_sum));
}
"""
#: the one-block design's phase boundaries: (its text, with the stamps)
PARENT_STAMPS = [
    ("  __shared__ int s_count;\n", "  __shared__ int s_count;\n  NTT_STAMP_DECL;\n"),
    ("  while (placed < n_allocs) {\n", "  while (placed < n_allocs) {\n    NTT_STAMP(0);\n"),
    ("    // B: the first MAX_SKIP", "    NTT_STAMP(1);\n    // B: the first MAX_SKIP"),
    ("    int n_acc = 0;\n", "    NTT_STAMP(2);\n    int n_acc = 0;\n"),
    ("      // D: sweep keys and the first acceptance\n",
     "      NTT_STAMP(3);\n      // D: sweep keys and the first acceptance\n"),
    ("    if (n_acc > 1) {\n", "    NTT_STAMP(4);\n    if (n_acc > 1) {\n"),
    ("      const int take = min(remaining, n_acc);\n",
     "      NTT_STAMP(5);\n      const int take = min(remaining, n_acc);\n"),
    ("      placed += take;\n    } else {\n",
     "      placed += take;\n      NTT_STAMP(6);\n      NTT_COUNT_SWEEP(n_acc, take);\n"
     "    } else {\n      NTT_STAMP(5);\n"),
    ("      placed += run;\n    }\n  }\n",
     "      placed += run;\n      NTT_STAMP(6);\n      NTT_COUNT_FILL(run);\n    }\n  }\n"
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


def stamped_library(b, tree: Path):
    """The tree's kernels built with the stamps on, loaded; sets ``b`` (the
    tree's _build module) to it."""
    d = OUT / ("tree" if tree == ROOT else "other")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(tree / "nomad_tpu_torch" / "tpu" / "csrc", d / "csrc")
    src = (d / "csrc" / "runs.cu").read_text()
    if "NTT_STAMP(" not in src:
        for old, new in PARENT_STAMPS:
            if src.count(old) != 1:
                raise SystemExit(f"runs_round_sweep: a phase boundary is not in runs.cu once: "
                                 f"{old!r}")
            src = src.replace(old, new)
    (d / "csrc" / "runs.cu").write_text(STAMP_PRELUDE + src + STAMP_READER)
    b.CSRC, b.BUILD_ROOT, b._LIB = d / "csrc", d / "lib", None
    lib = b.library()
    lib.ntt_stamps_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def split_report(b, k, cuda_ms, args, init, A, tree: Path = ROOT) -> dict:
    """The run planner at (args, init, A): ms by CUDA events, rounds, us a
    round, its split by the stamped build's buckets, and the round counts.
    ``b`` and ``k`` are the tree's _build and kernel modules; ``b`` is set
    back to its own library after."""

    def run():
        return k.plan_batch_runs(args, init, A)

    ms, (placements, rounds) = cuda_ms(run)
    rounds = int(rounds)
    want = placements.cpu()
    saved = b.CSRC, b.BUILD_ROOT, b._LIB
    try:
        stamps = stamped_library(b, tree)
        spans = (ctypes.c_ulonglong * len(SPANS))()
        counts = (ctypes.c_ulonglong * N_COUNTS)()
        run()  # builds and warms the stamped kernel
        torch.cuda.synchronize()
        stamps.ntt_stamps_take(spans, counts)  # clear what the warm-up added
        got, got_rounds = run()
        torch.cuda.synchronize()
        if stamps.ntt_stamps_take(spans, counts):
            raise SystemExit("runs_round_sweep: the stamps cannot be read")
    finally:
        b.CSRC, b.BUILD_ROOT, b._LIB = saved
    if not torch.equal(got.cpu(), want) or int(got_rounds) != rounds:
        raise SystemExit("runs_round_sweep: the stamped kernel placed differently")
    total = sum(spans)
    us = ms * 1e3 / rounds
    return dict(
        shape=f"N={args.capacity.shape[0]} A={A} V={init[2].shape[0]}",
        ms=ms, rounds=rounds, us_per_round=us, cycles_per_round=total / rounds,
        split_us={s: v / total * us for s, v in zip(SPANS, spans)},
        share={s: v / total for s, v in zip(SPANS, spans)},
        sweep_rounds=int(counts[0]), fill_rounds=int(counts[1]),
        sweep_accepted=int(counts[2]), sweep_placed=int(counts[3]), fill_placed=int(counts[4]),
        n_acc_pow2={f"{1 << b}-{(1 << (b + 1)) - 1}": int(counts[5 + b])
                    for b in range(20) if counts[5 + b]},
    )


def headline(mods, dev):
    cs, p_, pl = mods["chip_smoke"], mods["problems"], mods["planner"]
    cluster = p_.build_cluster(cs.NODES, cs.ALLOCS, n_values=cs.VALUES, seed=0)
    p = pl.pad_planes(p_.eval_planes(*p_.exact_problem(cluster, spread=True)))
    args, init = pl.runs_inputs(p, dev)
    return args, init, p["demands"].shape[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    tree = ap.parse_args().tree.resolve()
    if not torch.cuda.is_available():
        print("runs_round_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    mods = load_tree(tree)
    k, cs = mods["kernel"], mods["chip_smoke"]
    args, init, A = headline(mods, dev)
    report = dict(tree=str(tree.relative_to(ROOT)) if tree != ROOT else ".",
                  **split_report(mods["_build"], k, cs.cuda_ms, args, init, A, tree))
    rounds, ms, us = report["rounds"], report["ms"], report["us_per_round"]
    sweeps, fills = report["sweep_rounds"], report["fill_rounds"]
    print(f"{report['tree']}: {rounds} rounds ({sweeps} sweeps, {fills} fills), {ms:.3f} ms, "
          f"{us:.3f} us a round; split " + ", ".join(
              f"{s} {v:.3f}" for s, v in report["split_us"].items()), flush=True)
    print(cs.card_line())
    print(json.dumps({"runs_round_us": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
