// The planners' score primitives, each alone over a whole node axis.
//
// Replaces nomad_tpu/tpu/kernel.py _pow10 (:95) with _binpack (:151),
// _class_boosts (:161), _scores (:203) and _rot_incl (:255). The planners
// (exact_scan.cu, runs.cu, windowed.cu, wavefront.cu, paging.cu) inline
// these device functions (score.cuh, block.cuh) into their rounds; the
// entry points here apply one primitive to one plane, so that its bits and
// its time can be held against the plain version at the main path's
// shapes. Each is one launch:
// - binpack: a grid, one node a thread;
// - class boosts: one block, each thread a share of the classes, the
//   classes' count range in one block reduction;
// - scores: a grid, every block computing the boosts of the group's
//   spread counts in shared memory (warp 0) before its nodes;
// - rotated prefix: one block, contiguous positions a thread and one block
//   scan.
// What bounds them on the card: bytes and launch latency (a few hundred KB
// at 10K nodes); the float contract of score.cuh holds.
#include <cuda_runtime.h>

#include "block.cuh"
#include "score.cuh"

namespace {

using namespace ntt;

constexpr int GRID_THREADS = 256;

__global__ void binpack_kernel(const float* free_cpu, const float* free_mem, float* out, int n) {
  const int i = blockIdx.x * GRID_THREADS + threadIdx.x;
  if (i < n) out[i] = binpack_f32(__ldg(free_cpu + i), __ldg(free_mem + i));
}

struct BoostArgs {
  const int* counts;              // [V]
  const unsigned char* present;   // [V]
  const float* desired;           // [V]
  const float* implicit;          // scalar
  const float* weight_frac;       // scalar
  const unsigned char* even;      // scalar
  const unsigned char* active;    // scalar
  int V;
};

__global__ void __launch_bounds__(THREADS) class_boosts_kernel(BoostArgs B, float* out) {
  const ClassRange r = block_allreduce<0>(
      class_range_part(B.counts, B.present, B.V, -1, threadIdx.x, THREADS), ClassRangeOp());
  for (int c = threadIdx.x; c <= B.V; c += THREADS)
    out[c] = class_boost_at(c, B.counts, B.desired, *B.implicit, *B.weight_frac, *B.even,
                            *B.active, B.V, -1, r);
}

struct ScoreArgs {
  const int* used;                // [N,C]
  const float* usable;            // [N,2]
  const int* collisions;          // [N] the group's row
  const int* group_count;         // scalar
  const float* affinity;          // [N]
  const unsigned char* affinity_present;  // [N]
  const int* node_value;          // [N]
  const int* demand;              // [C]
  BoostArgs boosts;
  int N, C;
};

__global__ void scores_kernel(ScoreArgs S, float* out) {
  extern __shared__ float boosts_s[];  // [V+1]
  const BoostArgs& B = S.boosts;
  const bool active = *B.active;
  if (threadIdx.x < 32)
    class_boosts_warp(B.counts, B.present, B.desired, *B.implicit, *B.weight_frac, *B.even,
                      active, B.V, -1, boosts_s);
  __syncthreads();
  const int i = blockIdx.x * GRID_THREADS + threadIdx.x;
  if (i >= S.N) return;
  const int* u = S.used + (size_t)i * S.C;
  const int v = __ldg(S.node_value + i);
  const bool aff_p = __ldg(S.affinity_present + i);
  out[i] = score_node(free_frac(u[0] + __ldg(S.demand), __ldg(S.usable + 2 * i)),
                      free_frac(u[1] + __ldg(S.demand + 1), __ldg(S.usable + 2 * i + 1)),
                      __ldg(S.collisions + i), __int2float_rn(*S.group_count), aff_p,
                      __ldg(S.affinity + i), active, boosts_s[v >= 0 ? min(v, B.V) : B.V]);
}

__global__ void __launch_bounds__(THREADS) rot_incl_kernel(const unsigned char* x, int offset,
                                                           int* out, int n) {
  const ChunkRange own = chunk_of(n);
  int mine[2] = {0, 0};  // this thread's count, and its count before the offset
  for (int p = own.p0; p < own.p1; ++p) {
    mine[0] += x[p] != 0;
    mine[1] += x[p] != 0 && p < offset;
  }
  int excl[2], total[2];
  block_scan<2, 0>(mine, excl, total);
  // x_off: the count before the offset; total: the whole ring's
  int run = excl[0];
  for (int p = own.p0; p < own.p1; ++p) {
    run += x[p] != 0;
    out[p] = rot_incl(run, total[1], total[0], p, offset);
  }
}

}  // namespace

extern "C" int ntt_binpack(const void* free_cpu, const void* free_mem, void* out, int n,
                           void* stream) {
  if (n < 1) return 0;
  binpack_kernel<<<(n + GRID_THREADS - 1) / GRID_THREADS, GRID_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)free_cpu, (const float*)free_mem, (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int ntt_class_boosts(const void* counts, const void* present, const void* desired,
                                const void* implicit, const void* weight_frac, const void* even,
                                const void* active, void* out, int V, void* stream) {
  const BoostArgs B{(const int*)counts,        (const unsigned char*)present,
                    (const float*)desired,     (const float*)implicit,
                    (const float*)weight_frac, (const unsigned char*)even,
                    (const unsigned char*)active, V};
  class_boosts_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(B, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int ntt_scores(const void* used, const void* usable, const void* collisions,
                          const void* group_count, const void* affinity,
                          const void* affinity_present, const void* node_value,
                          const void* demand, const void* counts, const void* present,
                          const void* desired, const void* implicit, const void* weight_frac,
                          const void* even, const void* active, void* out, int N, int C, int V,
                          void* stream) {
  if (C < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(V + 1) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const ScoreArgs S{(const int*)used,
                    (const float*)usable,
                    (const int*)collisions,
                    (const int*)group_count,
                    (const float*)affinity,
                    (const unsigned char*)affinity_present,
                    (const int*)node_value,
                    (const int*)demand,
                    {(const int*)counts, (const unsigned char*)present, (const float*)desired,
                     (const float*)implicit, (const float*)weight_frac,
                     (const unsigned char*)even, (const unsigned char*)active, V},
                    N,
                    C};
  scores_kernel<<<(N + GRID_THREADS - 1) / GRID_THREADS, GRID_THREADS, smem,
                  (cudaStream_t)stream>>>(S, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int ntt_rot_incl(const void* x, void* out, int offset, int n, void* stream) {
  if (n < 1) return 0;
  rot_incl_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>((const unsigned char*)x, offset,
                                                           (int*)out, n);
  return (int)cudaGetLastError();
}
