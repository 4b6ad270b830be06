// The two tile sweeps of the paged windowed planner.
//
// Replace nomad_tpu/tpu/paging.py _tile_count_jit (:344) and
// _tile_window_jit (:358). A tile is T rows of the eval's planes in ring
// order (row q is ring position t0 + q).
//
// tile_count: the tile's feasible count and its count before the ring
// offset. What bounds it: bytes (the tile's capacity, used and feasible
// planes, read once; two integers out). Design: a grid of 1024-thread
// blocks, one position per thread and pass, a block reduction and one
// integer atomicAdd per block into the zeroed output.
//
// tile_window: per window that meets the tile, the partial winner (max
// score, then least feasible rank, and its node), in two straddle groups
// (positions at or past the cursor rank low, wrapped positions high, each
// with its own base window), plus the last consumed ring position. What
// bounds it: bytes (the tile's planes in, 3 x (2T+1) segment values out;
// the score is some 100 float operations a row). Design: ONE block of 1024
// threads owns the tile (64 rows a thread at T = 65,536): a block scan gives
// each feasible row its rank, min-reductions give the two base windows
// before any segment index is formed, and each window's winner is one
// 64-bit atomicMax per row on (order(score) << 32 | ~rank), which orders by
// score, then by the least rank, as the JAX segment_max / segment_min pair
// does; the winning row then writes its segment. Segments no row reaches
// keep JAX's fill values (-inf, INT32_MAX, INT32_MIN), and segment 2T, where
// JAX gathers the inactive rows, gets (-1e30, 2^30, -1) when one exists.
#include <cuda_runtime.h>

#include "block.cuh"
#include "score.cuh"

namespace {

using namespace ntt;

constexpr int BIG = 1 << 30;

__device__ __forceinline__ bool tile_fit(const int* cap, const unsigned char* feas,
                                         const int* used, const int* dem, int q, int C, int pos,
                                         int n_real) {
  return pos < n_real && feas[q] && fits(used + (size_t)q * C, cap + (size_t)q * C, dem, 1, C);
}

__global__ void __launch_bounds__(THREADS)
    tile_count_kernel(const int* cap, const unsigned char* feas, const int* used,
                      const int* demand, int* out, int T, int C, int t0, int offset, int n_real) {
  int cnt = 0, before = 0;
  for (int q = blockIdx.x * THREADS + threadIdx.x; q < T; q += gridDim.x * THREADS) {
    const int pos = t0 + q;
    const bool fit = tile_fit(cap, feas, used, demand, q, C, pos, n_real);
    cnt += fit;
    before += fit && pos < offset;
  }
  cnt = block_allreduce<50>(cnt, SumI());
  before = block_allreduce<51>(before, SumI());
  if (threadIdx.x == 0) {
    atomicAdd(out, cnt);
    atomicAdd(out + 1, before);
  }
}

struct WindowParams {
  const int* cap;                 // [T,C]
  const float* usable;            // [T,2]
  const unsigned char* feas;      // [T]
  const int* used;                // [T,C]
  const int* coll;                // [T]
  const int* nodes;               // [T] node id per row
  const int* demand;              // [C]
  int* bases;                     // [2] out: base window of each straddle group
  float* seg_score;               // [2T+1] out
  int* seg_rank;                  // [2T+1] out
  int* seg_node;                  // [2T+1] out
  int* last;                      // [1] out: last consumed ring position
  float* score_s;                 // [T] scratch
  int* rank_s;                    // [T] feasible rank, -1 when not feasible
  unsigned long long* win_s;      // [2T] per-segment best key
  int T, C, group_count, limit, t0, offset, n_real, flat_base, x0, total, w_use;
};

__device__ __forceinline__ unsigned long long bid(float score, int rank) {
  return ((unsigned long long)float_order(score) << 32) | (unsigned long long)(0xffffffffu - (unsigned)rank);
}

__global__ void __launch_bounds__(THREADS) tile_window_kernel(WindowParams P) {
  const int tid = threadIdx.x;
  const int T = P.T, C = P.C;
  const int S = 2 * T + 1;
  const int Lm = max(P.limit, 1);
  const float count_f = __int2float_rn(P.group_count);
  const int* dem = P.demand;
  const ChunkRange own = chunk_of(T);

  for (int q = tid; q < S; q += THREADS) {
    P.seg_score[q] = -__int_as_float(0x7f800000);
    P.seg_rank[q] = INT_MAX;
    P.seg_node[q] = INT_MIN;
  }
  for (int q = tid; q < 2 * T; q += THREADS) P.win_s[q] = 0ull;

  // fit and score per row (binpack + anti-affinity over fired planes)
  int cnt[1] = {0};
  for (int q = own.p0; q < own.p1; ++q) {
    const bool fit = tile_fit(P.cap, P.feas, P.used, dem, q, C, P.t0 + q, P.n_real);
    float sc = 0.0f;
    if (fit) {
      const int* u = P.used + (size_t)q * C;
      const int cl = P.coll[q];
      const bool ap = cl > 0;
      const float bp = binpack_f32(free_frac(u[0] + dem[0], P.usable[2 * q]),
                                   free_frac(u[1] + dem[1], P.usable[2 * q + 1]));
      sc = __fdiv_rn(__fadd_rn(bp, anti_affinity(__int2float_rn(cl), ap, count_f)),
                     ap ? 2.0f : 1.0f);
    }
    P.score_s[q] = sc;
    P.rank_s[q] = fit ? 0 : -1;
    cnt[0] += fit;
  }
  int excl[1], tot[1];
  block_scan<1, 52>(cnt, excl, tot);

  // feasible ranks, the straddle groups' base windows, the watermark
  int lo = BIG, hi = BIG, last = -1, inactive = 0;
  int run = P.flat_base + excl[0];  // exclusive count of feasible rows before q
  for (int q = own.p0; q < own.p1; ++q) {
    if (P.rank_s[q] < 0) {
      ++inactive;
      continue;
    }
    const int pos = P.t0 + q;
    const bool wrapped = pos < P.offset;
    const int rank = wrapped ? P.total - P.x0 + run : run - P.x0;
    ++run;
    P.rank_s[q] = rank;
    if (rank < P.w_use * P.limit)
      last = max(last, wrapped ? P.n_real - P.offset + pos : pos - P.offset);
    const int w = rank / Lm;
    if (w >= P.w_use) {
      ++inactive;
      continue;
    }
    if (wrapped)
      hi = min(hi, w);
    else
      lo = min(lo, w);
  }
  lo = block_allreduce<53>(lo, MinI());
  hi = block_allreduce<54>(hi, MinI());
  last = block_allreduce<55>(last, MaxI());
  inactive = block_allreduce<56>(inactive, SumI());  // also orders the fills before the bids
  if (tid == 0) {
    P.bases[0] = lo;
    P.bases[1] = hi;
    *P.last = last;
    if (inactive > 0) {
      P.seg_score[S - 1] = neg_inf();
      P.seg_rank[S - 1] = BIG;
      P.seg_node[S - 1] = -1;
    }
  }

  // window bids, then each window's winning row writes its segment
  for (int q = own.p0; q < own.p1; ++q) {
    const int rank = P.rank_s[q];
    if (rank < 0 || rank / Lm >= P.w_use) continue;
    const bool wrapped = P.t0 + q < P.offset;
    const int w = rank / Lm;
    const int seg = wrapped ? T + min(max(w - hi, 0), T - 1) : min(max(w - lo, 0), T - 1);
    atomicMax(&P.win_s[seg], bid(P.score_s[q], rank));
  }
  __syncthreads();
  for (int q = own.p0; q < own.p1; ++q) {
    const int rank = P.rank_s[q];
    if (rank < 0 || rank / Lm >= P.w_use) continue;
    const bool wrapped = P.t0 + q < P.offset;
    const int w = rank / Lm;
    const int seg = wrapped ? T + min(max(w - hi, 0), T - 1) : min(max(w - lo, 0), T - 1);
    const float sc = P.score_s[q];
    if (__ldcg(&P.win_s[seg]) != bid(sc, rank)) continue;
    P.seg_score[seg] = sc;
    P.seg_rank[seg] = rank;
    P.seg_node[seg] = P.nodes[q];
  }
}

}  // namespace

extern "C" int ntt_tile_count(const void* cap, const void* feas, const void* used,
                              const void* demand, void* out, int T, int C, int t0, int offset,
                              int n_real, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = max(1, (T + THREADS - 1) / THREADS);
  tile_count_kernel<<<blocks, THREADS, 0, s>>>((const int*)cap, (const unsigned char*)feas,
                                               (const int*)used, (const int*)demand, (int*)out, T,
                                               C, t0, offset, n_real);
  return (int)cudaGetLastError();
}

extern "C" int ntt_tile_window(const void* cap, const void* usable, const void* feas,
                               const void* used, const void* coll, const void* nodes,
                               const void* demand, void* bases, void* seg_score, void* seg_rank,
                               void* seg_node, void* last, void* score_s, void* rank_s,
                               void* win_s, int T, int C, int group_count, int limit, int t0,
                               int offset, int n_real, int flat_base, int x0, int total,
                               int w_use, void* stream) {
  WindowParams P{(const int*)cap,
                 (const float*)usable,
                 (const unsigned char*)feas,
                 (const int*)used,
                 (const int*)coll,
                 (const int*)nodes,
                 (const int*)demand,
                 (int*)bases,
                 (float*)seg_score,
                 (int*)seg_rank,
                 (int*)seg_node,
                 (int*)last,
                 (float*)score_s,
                 (int*)rank_s,
                 (unsigned long long*)win_s,
                 T,
                 C,
                 group_count,
                 limit,
                 t0,
                 offset,
                 n_real,
                 flat_base,
                 x0,
                 total,
                 w_use};
  tile_window_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
