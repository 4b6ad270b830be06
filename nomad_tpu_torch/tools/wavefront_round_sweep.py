#!/usr/bin/env python3
"""Where a wavefront round's time goes: the wavefront kernel's time per
round against the ring's length and the lanes' limit, and a split of the
round by clock64 stamps, on one CUDA card.

    python3 nomad_tpu_torch/tools/wavefront_round_sweep.py [--tree DIR]

``--tree`` names another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` under ``build/``): its
``nomad_tpu_torch`` package and its ``csrc/wavefront.cu`` are the ones
timed. The default is this checkout.

Each problem is one group of 256 identical allocs over an N-node ring of
roomy nodes, all feasible (``problems.build_cluster``'s planes with every
node feasible and capacity to spare), no spread. Every lane of a window
shares its group's feasible set with every earlier lane, so every round
commits one lane and the rounds equal the lanes. The window is W = 32
lanes and each lane offers M = 1 candidate to the conflict test. Limits:
1, 14 (a drain batch's ceil(log2 ring) at 10,000 nodes) and the whole
ring. Each time is ``wavefront.plan_batch_wavefront`` between CUDA events
(median of 3 after a warm-up) over the 256 rounds.

The split: the tool compiles the tree's kernel sources a second time, with
``NTT_STAMP`` defined, under build/nomad_tpu_torch/stamped/. Block 0's
thread 0 reads ``clock64()`` at the round's start, after its selection,
after the first grid barrier, after the commit and after the second grid
barrier, and sums the four spans over the rounds. A kernel that has no
stamp points of its own (the one-block design of the parent commit) gets
them inserted at its round's four boundaries. Each span is reported as a
share of the stamped round and as microseconds of the unstamped round.

Before the sweep the tool checks that the runtime takes a launch with both
a cluster dimension and the cooperative attribute: a kernel of one
``grid.sync()`` and one ``cluster.sync()`` per iteration, launched with
``cudaLaunchKernelEx`` for cluster sizes 1 to 16 at the most clusters the
card co-schedules (``cudaOccupancyMaxActiveClusters``) and at 32, timed per
iteration.

Prints the card's name and power limit, then one JSON line.
"""

import argparse
import ctypes
import importlib
import inspect
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]

LANES = 256
RINGS = (32, 1024, 4096, 16384, 65536)
LIMITS = (1, 14, None)
W, M = 32, 1
OUT = ROOT / "build" / "nomad_tpu_torch"

#: clock64 stamps of block 0's thread 0, kept in registers and added to a
#: device array when the kernel ends
STAMP_PRELUDE = r"""
__device__ unsigned long long ntt_stamp_sum[4];
#define NTT_STAMP_DECL unsigned long long ntt_t_[4] = {0, 0, 0, 0}, ntt_last_ = 0
#define NTT_STAMP(k) do { if (blockIdx.x == 0 && threadIdx.x == 0) { \
    const unsigned long long t_ = clock64(); \
    if ((k) > 0) ntt_t_[(k) - 1] += t_ - ntt_last_; \
    ntt_last_ = t_; } } while (0)
#define NTT_STAMP_FLUSH do { if (blockIdx.x == 0 && threadIdx.x == 0) \
    for (int k_ = 0; k_ < 4; ++k_) ntt_stamp_sum[k_] += ntt_t_[k_]; } while (0)
"""
STAMP_READER = r"""
extern "C" int ntt_stamps_take(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, ntt_stamp_sum, sizeof(ntt_stamp_sum));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[4] = {0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(ntt_stamp_sum, zero, sizeof(zero));
}
"""
#: the one-block design's round boundaries: (its text, with the stamps)
PARENT_STAMPS = [
    ("  cg::grid_group grid = cg::this_grid();\n",
     "  cg::grid_group grid = cg::this_grid();\n  NTT_STAMP_DECL;\n"),
    ("    if (i >= stop) break;\n", "    if (i >= stop) break;\n    NTT_STAMP(0);\n"),
    ("      select_lane(P, i + k, k);\n    }\n    grid.sync();\n",
     "      select_lane(P, i + k, k);\n    }\n    NTT_STAMP(1);\n    grid.sync();\n"
     "    NTT_STAMP(2);\n"),
    ("    if (blockIdx.x == 0) commit_round(P, i);\n    grid.sync();\n  }\n",
     "    if (blockIdx.x == 0) commit_round(P, i);\n    NTT_STAMP(3);\n    grid.sync();\n"
     "    NTT_STAMP(4);\n  }\n  NTT_STAMP_FLUSH;\n"),
]
SPANS = ("selection", "grid barrier 1", "commit", "grid barrier 2")

PROBE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void __launch_bounds__(1024) probe_kernel(int* out, int iters) {
  for (int i = 0; i < iters; ++i) {
    cg::this_grid().sync();
    cg::this_cluster().sync();
  }
  if (threadIdx.x == 0) atomicAdd(out, 1);
}

static cudaLaunchConfig_t config(int q, int clusters, cudaLaunchAttribute* attr, void* stream) {
  cudaLaunchConfig_t cfg = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.gridDim = dim3(q * clusters);
  cfg.blockDim = dim3(1024);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

extern "C" int probe_clusters(int q, void* out) {
  cudaError_t err = cudaFuncSetAttribute(probe_kernel,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = config(q, 1, attr, nullptr);
  cfg.numAttrs = 1;  // the occupancy query takes the cluster dimension alone
  return (int)cudaOccupancyMaxActiveClusters((int*)out, probe_kernel, &cfg);
}

extern "C" int probe_launch(int q, int clusters, int iters, void* out, void* stream) {
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = config(q, clusters, attr, stream);
  cudaError_t err = cudaLaunchKernelEx(&cfg, probe_kernel, (int*)out, iters);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* probe_error(int code) { return cudaGetErrorString((cudaError_t)code); }
"""


def load_tree(tree: Path):
    """The tree's nomad_tpu_torch modules (imported from ``tree``)."""
    sys.path.insert(0, str(tree))
    for name in [m for m in sys.modules if m.split(".")[0] in ("nomad_tpu_torch", "chip_smoke")]:
        del sys.modules[name]
    mods = {name: importlib.import_module(f"nomad_tpu_torch.tpu.{name}")
            for name in ("_build", "kernel", "problems", "wavefront")}
    mods["chip_smoke"] = importlib.import_module("chip_smoke")
    return mods


def nvcc_shared(nvcc, flags, sources, out: Path) -> None:
    cmd = [nvcc, *flags, "-shared", "-o", str(out), *map(str, sources)]
    run = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if run.returncode != 0:
        raise SystemExit(f"wavefront_round_sweep: nvcc failed:\n{run.stdout}")


def probe(b, dev) -> list:
    """Each cluster size: the clusters the card co-schedules, and whether a
    cooperative launch of that many (and of 32) runs its grid and cluster
    barriers; microseconds per iteration of one of each."""
    d = OUT / "probe"
    d.mkdir(parents=True, exist_ok=True)
    (d / "probe.cu").write_text(PROBE)
    flags = [f for f in b.NVCC_FLAGS if f != "-v" and f != "-Xptxas"]
    nvcc_shared(b.nvcc(), flags, [d / "probe.cu"], d / "probe.so")
    lib = ctypes.CDLL(str(d / "probe.so"))
    lib.probe_clusters.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.probe_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.probe_error.argtypes = [ctypes.c_int]
    lib.probe_error.restype = ctypes.c_char_p
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    rows = []
    for q in (1, 2, 4, 8, 16):
        fit = ctypes.c_int(0)
        rc = lib.probe_clusters(q, ctypes.byref(fit))
        row = dict(cluster=q, max_active_clusters=fit.value, occupancy_rc=rc, launches=[])
        for clusters in sorted({fit.value, 32}):
            if rc or clusters < 1:
                continue
            out = torch.zeros(1, dtype=torch.int32, device=dev)
            iters = 1000
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            lrc = lib.probe_launch(q, clusters, iters, ctypes.c_void_p(out.data_ptr()), stream)
            end.record()
            torch.cuda.synchronize()
            ok = lrc == 0 and int(out.item()) == q * clusters
            row["launches"].append(dict(
                clusters=clusters, rc=lrc, error=lib.probe_error(lrc).decode() if lrc else None,
                ran=ok, us_per_iteration=start.elapsed_time(end) * 1e3 / iters if ok else None))
        rows.append(row)
        print(f"cluster {q}: {row}", flush=True)
    return rows


def stamped_library(mods, tree: Path):
    """The tree's kernels built with the stamps on, loaded; sets the tree's
    _build to it."""
    b = mods["_build"]
    src = tree / "nomad_tpu_torch" / "tpu" / "csrc"
    d = OUT / "stamped" / ("parent" if tree != ROOT else "tree")
    shutil.rmtree(d, ignore_errors=True)
    (d / "csrc").mkdir(parents=True)
    for f in src.iterdir():
        shutil.copy(f, d / "csrc")
    wf = (d / "csrc" / "wavefront.cu").read_text()
    if "NTT_STAMP(" not in wf:
        for old, new in PARENT_STAMPS:
            if wf.count(old) != 1:
                raise SystemExit("wavefront_round_sweep: a round boundary of the kernel is not "
                                 "in wavefront.cu once")
            wf = wf.replace(old, new)
    (d / "csrc" / "wavefront.cu").write_text(STAMP_PRELUDE + wf + STAMP_READER)
    b.CSRC, b.BUILD_ROOT, b._LIB = d / "csrc", d / "lib", None
    lib = b.library()
    lib.ntt_stamps_take.argtypes = [ctypes.c_void_p]
    return lib


def problem(mods, n: int, limit, dev):
    p, k = mods["problems"], mods["kernel"]
    c = p.build_cluster(n, LANES, seed=5)
    c["feasible"][:] = True
    c["capacity"][:] = [10**6, 10**7, 10**7, 10**6]
    c["usable"][:] = [10**6, 10**7]
    args, init = p.exact_problem(c, spread=False)
    if limit is not None:
        args["limits"] = np.full_like(args["limits"], limit)
    return k.from_numpy(args, dev), k.from_numpy(init, dev)


def sweep(mods, dev, stamps=None) -> list:
    wf, cs = mods["wavefront"], mods["chip_smoke"]
    wf.configure(max_round=W, contention_top_m=M)
    counts = "walked" in inspect.signature(wf.plan_batch_wavefront).parameters
    rows = []
    for n in RINGS:
        for limit in LIMITS:
            args, init = problem(mods, n, limit, dev)
            ms, (_, placements, rounds) = cs.cuda_ms(
                lambda: wf.plan_batch_wavefront(args, init, n))
            rounds = int(rounds)
            if int((placements >= 0).sum()) != LANES or rounds != LANES:
                raise SystemExit(f"wavefront_round_sweep: N={n} placed "
                                 f"{int((placements >= 0).sum())} in {rounds} rounds")
            row = dict(ring=n, limit="ring" if limit is None else limit,
                       us_per_round=ms * 1e3 / rounds)
            if counts:
                walked = torch.zeros(1, dtype=torch.int64, device=dev)
                wf.plan_batch_wavefront(args, init, n, walked=walked)
                row["walked_per_round"] = int(walked.item()) / rounds
            if stamps is not None:
                spans = (ctypes.c_ulonglong * 4)()
                stamps.ntt_stamps_take(spans)  # clear what the timing calls added
                wf.plan_batch_wavefront(args, init, n)
                torch.cuda.synchronize()
                if stamps.ntt_stamps_take(spans):
                    raise SystemExit("wavefront_round_sweep: the stamps cannot be read")
                total = sum(spans)
                row["cycles_per_round"] = total / rounds
                row["share"] = {s: v / total for s, v in zip(SPANS, spans)}
            rows.append(row)
            print(f"N={n} limit={row['limit']}: {row['us_per_round']:.3f} us a round"
                  + (f", {row['walked_per_round']:.0f} walked" if counts else "")
                  + (f", shares {row['share']}" if stamps is not None else ""), flush=True)
    wf.reset()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    tree = ap.parse_args().tree.resolve()
    if not torch.cuda.is_available():
        print("wavefront_round_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    mods = load_tree(tree)
    report = dict(tree=str(tree.relative_to(ROOT)) if tree != ROOT else ".",
                  probe=probe(mods["_build"], dev))
    plain = sweep(mods, dev)
    stamps = stamped_library(mods, tree)
    stamped = sweep(mods, dev, stamps)
    for row, st in zip(plain, stamped):
        row["stamped_us_per_round"] = st["us_per_round"]
        row["cycles_per_round"] = st["cycles_per_round"]
        row["split_us"] = {s: share * row["us_per_round"] for s, share in st["share"].items()}
    report["rounds"] = plain
    print(mods["chip_smoke"].card_line())
    print(json.dumps({"wavefront_round_us": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
