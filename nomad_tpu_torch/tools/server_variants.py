#!/usr/bin/env python3
"""Time the usage bases (csrc/bases.cu) and the dense verify
(csrc/verify.cu) against variants that each take one design choice away,
on one CUDA card.

    python3 nomad_tpu_torch/tools/server_variants.py

Variants of the usage bases (each must give the plain version's bases):

- ``three_ops``: three device operations a call (a memset of the output, a
  scatter of every lane's demands with global atomicAdd, a prefix of one
  thread per value over the planes in place: the design before one
  launch) in place of the shared-memory deltas;
- ``units_16b``: every thread of the walk owns four ints of the slice
  (16-byte loads and stores; the planes here are aligned) in place of one;
- ``fixed_w128``: 128 ints a block (32 nodes at 4 columns, 320 blocks)
  in place of the plane split evenly over the SMs (312 ints, 132 blocks);
- ``no_list``: each thread adds its own lanes' demands as it finds them in
  place of listing them for one thread a lane;
- ``demands_early``: a listed lane loads its demands (up to 8 columns)
  with its eval, before it knows the eval lies in the chunk, in place of
  after.

Variants of the dense verify (each must give the plain version's
verdicts):

- ``one_block``: one block owns every row where their sums fit its shared
  memory (at 10,240 rows) in place of at least 16 blocks;
- ``deltas_late``: a lane's deltas are loaded after the first barrier in
  place of with its row, before it, and held in registers;
- ``planes_4b``: the lanes' deltas and rows of both planes read an int at
  a time (the path for other column counts) in place of 16 bytes.

Shapes: the usage bases at E 32 over 10,240 nodes of 4 columns with the
drain-tenant batch's 4,096 lanes and the drain-bench batch's 128 (90
placed), the verify at R 4,096 (1,057 rows) and R 512 (300 rows) on a
10,240-row plane; lanes made from a seed. Each copy compiles alone
(``variants.build``) under build/nomad_tpu_torch/server_variants/ and is
called through ctypes as the wrappers call it, in turns (each copy, then
back in reverse order). Time: the device time by torch.profiler over 50
calls (chip_smoke.device_us). Prints the card's name and power limit, then
one JSON line of device microseconds by kernel, shape and copy.
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
from nomad_tpu_torch.tpu import _build, drain, kernel  # noqa: E402

OUT = ROOT / "build" / "nomad_tpu_torch" / "server_variants"
N, C, E = 10_240, 4, 32

#: the usage bases as three device operations (the design before one launch)
THREE_OPS = r"""#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void bases_scatter(const int* __restrict__ placements, const int* __restrict__ demands,
                              const int* __restrict__ eval_of, int* out, int N, int C, int A,
                              int E, int n_real) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= (long long)A * C) return;
  const int a = (int)(idx / C), c = (int)(idx % C);
  const int p = placements[a], e = eval_of[a];
  if (p < 0 || p >= n_real || e < 0 || e >= E) return;
  atomicAdd(out + ((size_t)e * N + p) * C + c, demands[(size_t)a * C + c]);
}

__global__ void bases_prefix(const int* __restrict__ used0, int* out, int N, int C, int E) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const size_t plane = (size_t)N * C;
  if (idx >= (long long)plane) return;
  unsigned acc = (unsigned)used0[idx];
  for (int e = 0; e < E; ++e) {
    int* slot = out + e * plane + idx;
    const unsigned delta = (unsigned)*slot;
    *slot = (int)acc;
    acc += delta;
  }
}

int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int ntt_used_bases(void* used0, void* placements, void* demands, void* eval_of,
                              void* out, int N, int C, int A, int E, int n_real, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)E * N * C * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if ((long long)A * C > 0) {
    bases_scatter<<<blocks((long long)A * C), kThreads, 0, s>>>(
        (const int*)placements, (const int*)demands, (const int*)eval_of, (int*)out, N, C, A, E,
        n_real);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  bases_prefix<<<blocks((long long)N * C), kThreads, 0, s>>>((const int*)used0, (int*)out, N, C, E);
  return (int)cudaGetLastError();
}
"""
BASES_VARIANTS = {
    "three_ops": [(None, THREE_OPS)],  # the whole source
    "units_16b": [
        ("""  const bool own = tid < ints;  // this thread's int of the slice
  unsigned acc = own ? (unsigned)__ldg(used0 + lo + tid) : 0u;
""", """  const bool own = 4 * tid < ints;
  uint4 acc = own ? __ldg(reinterpret_cast<const uint4*>(used0 + lo) + tid)
                  : make_uint4(0u, 0u, 0u, 0u);
"""),
        ("""      int* o = out + (long long)e0 * plane + lo + tid;
      for (int k = 0; k < ec; ++k) {
        o[(long long)k * plane] = (int)acc;
        acc += delta[k * W + tid];
      }
""", """      uint4* o = reinterpret_cast<uint4*>(out + (long long)e0 * plane + lo) + tid;
      for (int k = 0; k < ec; ++k) {
        o[(long long)k * (plane / 4)] = acc;
        const uint4 d = reinterpret_cast<const uint4*>(delta + k * W)[tid];
        acc.x += d.x;
        acc.y += d.y;
        acc.z += d.z;
        acc.w += d.w;
      }
""")],
    "fixed_w128": [("""  long long w = (plane + sms - 1) / sms;
  w = min((long long)kMaxWidth, (w + 3) / 4 * 4);
""", """  long long w = 128;
""")],
    "no_list": [("""      const int s = atomicAdd(&listed, 1);
      if (s < kList) {
        list_a[s] = a;
        list_p[s] = p;
      }
""", """      add_lane(delta, demands, eval_of, a, p, C, lo, W, 0, min(ec_max, E));
""")],
}
BASES_VARIANTS["demands_early"] = [
    ("""  const int e = __ldg(eval_of + a);
  if (e < e0 || e >= e0 + ec) return;
  const int* dem = demands + (size_t)a * C;
  unsigned* d = delta + (size_t)(e - e0) * W + (first - lo);
  for (int c = c0; c < c1; ++c) {
    const unsigned x = (unsigned)__ldg(dem + c);
    if (x) atomicAdd(d + c, x);
  }
""", """  const int* dem = demands + (size_t)a * C;
  unsigned x[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = c0 + c < c1 ? (unsigned)__ldg(dem + c0 + c) : 0u;
  const int e = __ldg(eval_of + a);
  if (e < e0 || e >= e0 + ec) return;
  unsigned* d = delta + (size_t)(e - e0) * W + (first + c0 - lo);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    if (x[c]) atomicAdd(d + c, x[c]);
  for (int c = c0 + 8; c < c1; ++c) {
    const unsigned y = (unsigned)__ldg(dem + c);
    if (y) atomicAdd(d + (c - c0), y);
  }
""")]
VERIFY_VARIANTS = {
    "planes_4b": [("  if (C == 4 && (bits & 15) == 0)\n", "  if (C == 4 && (bits & 15) == 0 && false)\n")],
    "one_block": [("constexpr int kMinBlocks = 16;\n", "constexpr int kMinBlocks = 1;\n")],
    "deltas_late": [
        ("""    if (C4 && (unsigned)row[j] - (unsigned)lo < span)
      d[j] = __ldg(reinterpret_cast<const int4*>(P.deltas) + tid + j * kThreads);
""", ""),
        ("""    if (r < span) add_deltas<C4>(P, tid + j * kThreads, d[j], sums + (size_t)r * P.C);
""", """    if (r < span)
      add_deltas<C4>(P, tid + j * kThreads,
                     C4 ? __ldg(reinterpret_cast<const int4*>(P.deltas) + tid + j * kThreads) : d[j],
                     sums + (size_t)r * P.C);
""")],
}


def bases_lanes(A: int, placed: int, dev):
    """(used0, placements, demands, eval_of) of A lanes over E evals, the
    first ``placed`` of them on real nodes (10,000 of the 10,240)."""
    rng = np.random.default_rng(A)
    used0 = rng.integers(0, 10**5, (N, C)).astype(np.int32)
    used0[10_000:] = 2**30
    placements = np.full(A, -1, np.int32)
    placements[:placed] = rng.integers(0, 10_000, placed)
    eval_of = np.sort(rng.integers(0, E, A)).astype(np.int32)
    demands = rng.integers(0, 900, (A, C)).astype(np.int32)
    return tuple(torch.from_numpy(x).to(dev) for x in (used0, placements, demands, eval_of))


def verify_lanes(R: int, k: int, dev):
    """(capacity, used, rows, deltas): k distinct rows with their deltas,
    then pad lanes on row 0 with a delta of 0."""
    rng = np.random.default_rng(R)
    capacity = rng.integers(1000, 9000, (N, C)).astype(np.int32)
    used = (capacity - rng.integers(0, 700, (N, C))).astype(np.int32)
    rows = np.zeros(R, np.int32)
    rows[:k] = rng.choice(10_000, k, replace=False)
    deltas = np.zeros((R, C), np.int32)
    deltas[:k] = rng.integers(0, 400, (k, C))
    return tuple(torch.from_numpy(x).to(dev) for x in (capacity, used, rows, deltas))


def turns(libs: dict, call, check) -> dict:
    """name -> [device us of each turn], in turns (each copy, then back in
    reverse order); ``check(name, out)`` after a copy's first call."""
    names = list(libs)
    us = {}
    for name in names + names[::-1]:
        fn = call(libs[name])
        out = fn()
        torch.cuda.synchronize()
        check(name, out)
        us.setdefault(name, []).append(chip_smoke.device_us(fn, calls=50))
    return us


def main() -> int:
    if not torch.cuda.is_available():
        print("server_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    committed = (_build.CSRC / "bases.cu").read_text()
    bases_variants = {name: [(committed if old is None else old, new) for old, new in swaps]
                      for name, swaps in BASES_VARIANTS.items()}
    bases_libs = variants.build("server_variants", "bases.cu", bases_variants,
                                ("ntt_used_bases",), OUT / "bases", errors=False)
    verify_libs = variants.build("server_variants", "verify.cu", VERIFY_VARIANTS,
                                 ("ntt_verify_rows",), OUT / "verify", errors=False)
    stream = torch.cuda.current_stream(dev).cuda_stream
    report = {}
    for label, A, placed in (("drain-tenant", 4096, 3_900), ("drain-bench", 128, 90)):
        used0, placements, demands, eval_of = bases_lanes(A, placed, dev)
        want = drain.used_bases_ref(used0, placements, demands, eval_of, E, 10_000).cpu()
        out = torch.empty((E, N, C), dtype=torch.int32, device=dev)

        def call(lib):
            def fn():
                rc = lib.ntt_used_bases(used0.data_ptr(), placements.data_ptr(),
                                        demands.data_ptr(), eval_of.data_ptr(), out.data_ptr(),
                                        N, C, A, E, 10_000, stream)
                if rc:
                    raise SystemExit(f"server_variants: used_bases launch status {rc}")
                return out
            return fn

        def check(name, got):
            if not torch.equal(got.cpu(), want):
                raise SystemExit(f"server_variants: used_bases {name} differs from the plain "
                                 f"version at {label}")

        us = turns(bases_libs, call, check)
        report[f"used_bases E={E} N={N} A={A} ({label})"] = us
        print(f"used_bases {label} (A={A}): device us by copy "
              + ", ".join(f"{n} {v}" for n, v in us.items()), flush=True)
    for R, k in ((4096, 1_057), (512, 300)):
        capacity, used, rows, deltas = verify_lanes(R, k, dev)
        want = kernel.verify_rows_ref(capacity, used, rows, deltas).cpu()
        fits = torch.empty(R, dtype=torch.bool, device=dev)

        def call(lib):
            def fn():
                rc = lib.ntt_verify_rows(capacity.data_ptr(), used.data_ptr(), rows.data_ptr(),
                                         deltas.data_ptr(), fits.data_ptr(), N, C, R, stream)
                if rc:
                    raise SystemExit(f"server_variants: verify_rows launch status {rc}")
                return fits
            return fn

        def check(name, got):
            if not torch.equal(got.cpu(), want):
                raise SystemExit(f"server_variants: verify_rows {name} differs from the plain "
                                 f"version at R={R}")

        us = turns(verify_libs, call, check)
        report[f"verify_rows N={N} R={R} ({k} rows)"] = us
        print(f"verify_rows R={R}: device us by copy "
              + ", ".join(f"{n} {v}" for n, v in us.items()), flush=True)
    print(chip_smoke.card_line())
    print(json.dumps({"server_variants": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
