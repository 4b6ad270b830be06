// The plan applier's dense verify.
//
// Replaces nomad_tpu/tpu/kernel.py _verify_rows_jit (:1061): for each
// lane i, all over columns c of
//   used[rows[i], c] + sum of deltas[j, c] over lanes j on rows[i]
//     <= capacity[rows[i], c]
// with used left as it is. Deltas may be negative (stops, preemptions);
// int32 adds wrap, as JAX's do.
//
// What bounds it on the card: bytes, and few of them (the touched rows
// of two planes plus the lanes: about 0.3 MB at R=4,096); at that size
// the three launches' fixed cost dominates. Design: per-row sums in a
// scratch plane, touching only the rows the plan touches: zero those
// rows, atomicAdd every lane's deltas into them (integer atomics are
// exact and order-free, so the verdicts are bit-identical to the plain
// version), then one thread per lane compares. A lane whose row lies
// outside [0, N) adds nothing and fails.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void verify_zero(const int* __restrict__ rows, int* acc, int N, int C, int R) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= (long long)R * C) return;
  const int i = (int)(idx / C), c = (int)(idx % C);
  const int r = rows[i];
  if (r >= 0 && r < N) acc[(size_t)r * C + c] = 0;
}

__global__ void verify_add(const int* __restrict__ rows, const int* __restrict__ deltas, int* acc,
                           int N, int C, int R) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= (long long)R * C) return;
  const int i = (int)(idx / C), c = (int)(idx % C);
  const int r = rows[i];
  if (r >= 0 && r < N) atomicAdd(acc + (size_t)r * C + c, deltas[(size_t)i * C + c]);
}

__global__ void verify_fit(const int* __restrict__ capacity, const int* __restrict__ used,
                           const int* __restrict__ rows, const int* __restrict__ acc,
                           unsigned char* fits, int N, int C, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const int r = rows[i];
  bool ok = r >= 0 && r < N;
  for (int c = 0; ok && c < C; ++c) {
    const size_t at = (size_t)r * C + c;
    const int stacked = (int)((unsigned)used[at] + (unsigned)acc[at]);
    ok = stacked <= capacity[at];
  }
  fits[i] = ok ? 1 : 0;
}

int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int ntt_verify_rows(void* capacity, void* used, void* rows, void* deltas, void* fits,
                               void* acc, int N, int C, int R, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R == 0) return (int)cudaSuccess;
  const long long lanes = (long long)R * C;
  verify_zero<<<blocks(lanes), kThreads, 0, s>>>((const int*)rows, (int*)acc, N, C, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  verify_add<<<blocks(lanes), kThreads, 0, s>>>((const int*)rows, (const int*)deltas, (int*)acc,
                                                N, C, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  verify_fit<<<blocks(R), kThreads, 0, s>>>((const int*)capacity, (const int*)used,
                                            (const int*)rows, (const int*)acc,
                                            (unsigned char*)fits, N, C, R);
  return (int)cudaGetLastError();
}
