// Block-wide scans and reductions for the planner kernels.
//
// The windowed planner runs a node axis in ONE block of THREADS threads:
// thread t holds the contiguous positions [t*chunk, (t+1)*chunk), so a
// prefix over positions is a per-thread running count started at the
// thread's exclusive block prefix. The exact scan, the run planner and the
// wavefront use the same helpers inside each block of their clusters.
//
// Every helper costs one __syncthreads(). Its partials live in a shared
// buffer private to its TAG, and every thread reads the partials itself
// (no broadcast barrier). Two calls with the same TAG must therefore be
// separated by another barrier; each kernel gives every call site its own
// TAG, and call sites that repeat inside a loop sit between other
// barriers.
#pragma once

#include <climits>
#include <cstdint>

namespace ntt {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct ChunkRange {
  int p0, p1;
};

// the contiguous positions of [0, n) this thread owns
__device__ __forceinline__ ChunkRange chunk_of(int n) {
  const int chunk = (n + THREADS - 1) / THREADS;
  const int p0 = min((int)threadIdx.x * chunk, n);
  return {p0, min(p0 + chunk, n)};
}

// Exclusive prefix (over threads, in thread order) and block totals of K
// per-thread counts, in a block of ``nwarps`` warps.
template <int K, int TAG>
__device__ __forceinline__ void block_scan(const int (&x)[K], int (&excl)[K], int (&total)[K],
                                           int nwarps = WARPS) {
  __shared__ int sh[WARPS][K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    incl[k] = x[k];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl[k], d);
      if (lane >= d) incl[k] += y;
    }
    if (lane == 31) sh[warp][k] = incl[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int w = lane < nwarps ? sh[lane][k] : 0;
    int s = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, s, d);
      if (lane >= d) s += y;
    }
    const int warp_excl = __shfl_sync(FULL_MASK, s - w, warp);
    total[k] = __shfl_sync(FULL_MASK, s, 31);
    excl[k] = warp_excl + incl[k] - x[k];
  }
}

__device__ __forceinline__ int shfl_xor(int v, int m) { return __shfl_xor_sync(FULL_MASK, v, m); }
__device__ __forceinline__ float shfl_xor(float v, int m) { return __shfl_xor_sync(FULL_MASK, v, m); }
__device__ __forceinline__ unsigned long long shfl_xor(unsigned long long v, int m) {
  return __shfl_xor_sync(FULL_MASK, v, m);
}

// Winner of a first-strict-max in visit order: the highest score, and
// among equal scores (IEEE equality) the lowest visit rank. ``last`` is
// carried beside it as a plain max (the exact scan's last returned rank).
struct Best {
  float s;
  int visit;
  int pos;
  int last;
};

__device__ __forceinline__ Best best_identity() { return {-__int_as_float(0x7f800000), INT_MAX, -1, -1}; }

__device__ __forceinline__ Best shfl_xor(Best b, int m) {
  return {shfl_xor(b.s, m), shfl_xor(b.visit, m), shfl_xor(b.pos, m), shfl_xor(b.last, m)};
}

struct BestOp {
  __device__ __forceinline__ Best operator()(Best a, Best b) const {
    Best r = (b.s > a.s || (b.s == a.s && b.visit < a.visit)) ? b : a;
    r.last = max(a.last, b.last);
    return r;
  }
};

struct MaxF {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct MinF {
  __device__ __forceinline__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct MaxI {
  __device__ __forceinline__ int operator()(int a, int b) const { return max(a, b); }
};
struct MinI {
  __device__ __forceinline__ int operator()(int a, int b) const { return min(a, b); }
};
struct SumI {
  __device__ __forceinline__ int operator()(int a, int b) const { return a + b; }
};
struct MaxU64 {
  __device__ __forceinline__ unsigned long long operator()(unsigned long long a,
                                                           unsigned long long b) const {
    return a > b ? a : b;
  }
};

// Reduction whose result every thread receives; every thread's ``v`` takes
// part. WARPS is 32, so lane l of each warp folds in warp l's partial.
template <int TAG, class T, class Op>
__device__ __forceinline__ T block_allreduce(T v, Op op) {
  __shared__ T sh[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = op(v, shfl_xor(v, m));
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = sh[lane];
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = op(v, shfl_xor(v, m));
  return v;
}

// Whether used + k*demand fits capacity in every resource column
__device__ __forceinline__ bool fits(const int* used, const int* cap, const int* dem, int k,
                                     int C) {
  for (int c = 0; c < C; ++c)
    if (used[c] + k * dem[c] > cap[c]) return false;
  return true;
}

}  // namespace ntt
