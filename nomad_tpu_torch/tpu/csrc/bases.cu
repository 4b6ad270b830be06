// Per-eval usage bases of a fused drain batch.
//
// Replaces nomad_tpu/tpu/drain.py _used_bases_fn -> bases (:181):
// out[e] = used0 + sum over evals e' < e of delta[e'], where delta[e', n]
// sums the demands of the lanes of eval e' placed on node n < n_real.
//
// What bounds it on the card: bytes. It reads used0 [N,C] and the lanes
// and writes E planes of [N,C] (5.2 MB at E=32, N=10,240, C=4); the work
// is one add per output value. Design: zero the output, scatter every
// valid lane's demand into out[eval][node] with integer atomicAdd (exact
// and order-free, so the result is bit-identical to the plain version),
// then one thread per (node, column) walks the eval axis and turns the
// per-eval deltas into the exclusive prefix in place, starting from
// used0. Adds are done on unsigned values: int32 wraps, as JAX's do.
// It reads the scan's placements where the scan left them, on the same
// stream, so the host never waits between the two launches.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void bases_scatter(const int* __restrict__ placements, const int* __restrict__ demands,
                              const int* __restrict__ eval_of, int* out, int N, int C, int A,
                              int E, int n_real) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= (long long)A * C) return;
  const int a = (int)(idx / C), c = (int)(idx % C);
  const int p = placements[a], e = eval_of[a];
  // unplaced lanes (-1), pad nodes and lanes of no eval add nothing
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
  if ((long long)N * C > 0) {
    bases_prefix<<<blocks((long long)N * C), kThreads, 0, s>>>((const int*)used0, (int*)out, N, C,
                                                               E);
  }
  return (int)cudaGetLastError();
}
