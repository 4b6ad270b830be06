// Rotation-parallel windowed planner (bounded limit L, no affinity/spread).
//
// Replaces nomad_tpu/tpu/kernel.py _plan_batch_windowed_jit (:954). With a
// limit L below the ring size, consecutive Selects consume disjoint
// windows of L feasible ring positions, so each round of the device loop
// cuts the feasible positions (in rotation order from the cursor) into
// windows of L, places one alloc per window on the window's first strict
// max, and advances the cursor past the consumed windows.
//
// What bounds it on the card: the rounds are sequential and each is a
// chain of a block scan, two cluster barriers and an L2 round trip, so the
// kernel is latency-bound; the work a round is some 100 float operations a
// winner.
//
// Design: ONE thread block cluster of WIN_CLUSTER blocks (cudaLaunchKernelEx
// with a cluster dimension), with the rounds inside the kernel. The ring's
// real positions are split evenly and in order across the blocks (625 a
// block at 10,000) and, within a block, in order across its threads, K a
// thread; the block has as many threads as that needs (640 at 10,000).
// ``perm`` is a permutation, so the thread that owns ring position p is
// the only one that reads or writes node perm[p]'s rows. It loads them
// once and keeps them in registers (K = 1 or 2 positions a thread, at
// most REG_MAX_COLS resource columns), with the position's fit and score,
// which change only when the position wins. Past that budget the rows,
// fit and score live in a global record a position (the register path at
// 1,000,000 positions would need 62 a thread).
//
// A round takes two cluster barriers.
// 1. Each block counts its fit positions and those before the cursor (one
//    block scan, which also gives each thread its exclusive prefix) and
//    pushes the two counts into every block's shared memory (cluster.cuh).
//    Barrier 1. Every warp sums the blocks' counts: the round's total, the
//    count before the cursor and the block's exclusive base; so each fit
//    position has its rank in rotation order and its window
//    rank / max(L, 1).
// 2. Each position in a window that places bids with one global atomicMax
//    (a reduction at L2; nothing waits for it) on its window's key,
//    (order(score) << 32 | ~rank), which orders by score and then by the
//    lowest rank, as JAX's segment_max and segment_min of the rank do. The
//    position of rank w_use*L - 1 pushes its rotated rank, the cursor's
//    advance, into every block. Barrier 2.
// 3. Each bidder reads its window's key back from L2; the one whose key it
//    is places the alloc numbered placed + window and updates its state.
// The keys are two buffers of windows, by round parity: a round clears the
// next round's buffer, whose last reads came before its barrier 1.
//
// Integer counts and the max of distinct keys combine in any order, and
// every float is the plain version's operation (score.cuh), so the result
// is bit-identical to plan_batch_windowed_ref.
//
// Measured (PERF.md): nomad_tpu_torch/tools/windowed_round_sweep.py times a
// round and splits it by clock64 stamps (NTT_STAMP, empty unless the tool
// defines it); nomad_tpu_torch/tools/windowed_variants.py times this kernel
// against variants without its mechanisms.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "block.cuh"
#include "cluster.cuh"
#include "score.cuh"

#ifndef NTT_STAMP
#define NTT_STAMP_DECL
#define NTT_STAMP(k)
#define NTT_STAMP_FLUSH
#endif

namespace {

using namespace ntt;

// blocks of the cluster: 16 is a non-portable size (the launch allows it)
constexpr int WIN_CLUSTER = 16;
// resource columns and positions a thread the register path holds
constexpr int REG_MAX_COLS = 6;
constexpr int REG_MAX_POS = 2;
// returned when the card cannot co-schedule the cluster
constexpr int CLUSTER_REFUSED = 0x4e5402;

struct WindowParams {
  const int* capacity;            // [N,C]
  const float* usable;            // [N,2]
  const unsigned char* feasible;  // [N]
  const int* perm;                // [N] node id per ring position
  const int* demand;              // [C]
  const int* group_count;         // scalar
  const int* limit;               // scalar
  const int* n_allocs;            // scalar
  const int* used0;               // [N,C]
  const int* coll0;               // [N]
  int* placements;                // [a_pad] out
  int* rounds;                    // scalar out
  unsigned long long* win_g;      // [2, w_cap] window keys, by round parity
  // global records, a ring position each (past the register budget)
  int* used_s;                    // [n_real, C] the position's node's used row
  int* coll_s;                    // [n_real]
  float* score_s;                 // [n_real]
  int* node_s;                    // [n_real] node id while it fits, else -1
  int C, n_real, a_pad, per, layers, w_cap;
};

// One ring position's state on the register path
struct Pos {
  int used[REG_MAX_COLS];
  int cap[REG_MAX_COLS];
  float us0, us1;
  int coll;
  int node;  // node id while the position fits, else -1
  float score;
};

// binpack + anti-affinity over fired planes, from the used cpu and memory
// after the placement
__device__ __forceinline__ float window_score(int util0, int util1, float us0, float us1,
                                              int coll, float count_f) {
  const bool ap = coll > 0;
  const float bp = binpack_f32(free_frac(util0, us0), free_frac(util1, us1));
  return __fdiv_rn(__fadd_rn(bp, anti_affinity(__int2float_rn(coll), ap, count_f)),
                   ap ? 2.0f : 1.0f);
}

__device__ __forceinline__ float pos_score(const Pos& s, const int* dem, float count_f) {
  return window_score(s.used[0] + dem[0], s.used[1] + dem[1], s.us0, s.us1, s.coll, count_f);
}

__device__ __forceinline__ unsigned long long bid_key(float score, int rank) {
  return ((unsigned long long)float_order(score) << 32) |
         (unsigned long long)(0xffffffffu - (unsigned)rank);
}

// register path: position p's rows, fit and score
__device__ __forceinline__ void load_pos(Pos& s, const WindowParams& P, int p, const int* dem,
                                         float count_f) {
  const int C = P.C;
  const int node = __ldg(P.perm + p);
  bool fit = __ldg(P.feasible + node) != 0;
#pragma unroll
  for (int c = 0; c < REG_MAX_COLS; ++c) {
    s.used[c] = c < C ? __ldg(P.used0 + (size_t)node * C + c) : 0;
    s.cap[c] = c < C ? __ldg(P.capacity + (size_t)node * C + c) : 0;
    fit = fit && s.used[c] + dem[c] <= s.cap[c];
  }
  s.us0 = __ldg(P.usable + 2 * (size_t)node);
  s.us1 = __ldg(P.usable + 2 * (size_t)node + 1);
  s.coll = __ldg(P.coll0 + node);
  s.node = fit ? node : -1;
  s.score = fit ? pos_score(s, dem, count_f) : 0.0f;
}

// register path: the position won; refresh its fit and score
__device__ __forceinline__ void win_pos(Pos& s, const int* dem, float count_f) {
  bool fit = true;
#pragma unroll
  for (int c = 0; c < REG_MAX_COLS; ++c) {
    s.used[c] += dem[c];
    fit = fit && s.used[c] + dem[c] <= s.cap[c];
  }
  s.coll += 1;
  if (!fit) s.node = -1;
  s.score = pos_score(s, dem, count_f);
}

// global path: position p's record from its node's rows (used_s and coll_s
// already hold them)
__device__ void refresh_record(const WindowParams& P, int p, int node, float count_f) {
  const int C = P.C;
  const int* u = P.used_s + (size_t)p * C;
  const bool fit = P.feasible[node] && fits(u, P.capacity + (size_t)node * C, P.demand, 1, C);
  P.node_s[p] = fit ? node : -1;
  P.score_s[p] = fit ? window_score(u[0] + P.demand[0], u[1] + P.demand[1],
                                    P.usable[2 * (size_t)node], P.usable[2 * (size_t)node + 1],
                                    P.coll_s[p], count_f)
                     : 0.0f;
}

// K positions a thread in registers (K = 1, 2), or K = 0: records in
// global memory, P.layers a thread
template <int K>
__global__ void __launch_bounds__(THREADS, 1) windowed_kernel(WindowParams P) {
  constexpr bool REG = K > 0;
  cg::cluster_group cluster = cg::this_cluster();
  NTT_STAMP_DECL;
  const unsigned brank = cluster.block_rank();
  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid & 31;
  const int n_real = P.n_real;
  const int L = __ldg(P.limit);
  const int lm = max(L, 1);
  const int n_allocs = __ldg(P.n_allocs);
  const float count_f = __int2float_rn(__ldg(P.group_count));
  const int layers = REG ? K : P.layers;
  const int bp0 = min((int)brank * P.per, n_real);
  const int bp1 = min(bp0 + P.per, n_real);
  const int q0 = bp0 + tid * layers;  // this thread's positions: [q0, q0 + mine)
  const int mine = max(0, min(layers, bp1 - q0));

  __shared__ int2 cnt_s[WIN_CLUSTER];  // barrier 1: (fit, fit before the cursor)
  __shared__ int wm_s;                 // barrier 2: the cursor's advance - 1
  // the demand, padded with zeros to REG_MAX_COLS (shared memory keeps it
  // out of the register path's registers)
  __shared__ int dem[REG_MAX_COLS];
  if (tid < REG_MAX_COLS) dem[tid] = tid < P.C ? __ldg(P.demand + tid) : 0;
  __syncthreads();

  // -- set-up: placements, the positions' state, the window keys ------------
  const int gtid = (int)brank * nthreads + tid, gstride = WIN_CLUSTER * nthreads;
  for (int k = gtid; k < P.a_pad; k += gstride) P.placements[k] = -1;
  Pos st[REG ? K : 1];
  if constexpr (REG) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      st[j].node = -1;
      if (j < mine) load_pos(st[j], P, q0 + j, dem, count_f);
    }
  } else {
    for (int p = q0; p < q0 + mine; ++p) {
      const int node = __ldg(P.perm + p);
      for (int c = 0; c < P.C; ++c)
        P.used_s[(size_t)p * P.C + c] = __ldg(P.used0 + (size_t)node * P.C + c);
      P.coll_s[p] = __ldg(P.coll0 + node);
      refresh_record(P, p, node, count_f);
    }
  }
  // a round has at most max(n_real / lm, 1) windows
  const int w_max = min(max(n_real / lm, 1), P.w_cap);
  for (int k = gtid; k < 2 * w_max; k += gstride) P.win_g[(k & 1) * P.w_cap + (k >> 1)] = 0ull;

  int offset = 0, placed = 0, rounds = 0, w_prev = 0;
  while (placed < n_allocs) {
    NTT_STAMP(0);
    // 1. counts: fit, and fit before the cursor
    int cnt[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < (REG ? K : layers); ++j) {
      if (j >= mine) break;
      const bool fit = (REG ? st[REG ? j : 0].node : P.node_s[q0 + j]) >= 0;
      cnt[0] += fit;
      cnt[1] += fit && q0 + j < offset;
    }
    int excl[2], tot[2];
    block_scan<2, 70>(cnt, excl, tot, nthreads >> 5);
    cluster_publish(cluster, cnt_s, brank, make_int2(tot[0], tot[1]), WIN_CLUSTER);
    NTT_STAMP(1);
    cluster_arrive();
    cluster_wait();  // barrier 1
    const int2 v = lane < WIN_CLUSTER ? cnt_s[lane] : make_int2(0, 0);
    const int base = __reduce_add_sync(FULL_MASK, lane < (int)brank ? v.x : 0);
    const int total = __reduce_add_sync(FULL_MASK, v.x);
    const int x_off = __reduce_add_sync(FULL_MASK, v.y);
    NTT_STAMP(2);
    const int remaining = n_allocs - placed;
    const int w_avail = total > 0 ? max(total / lm, 1) : 0;
    const int w_use = min(w_avail, remaining);
    rounds += 1;
    if (w_use == 0) break;  // nothing feasible: the progress flag drops
    const int consumed_ranks = w_use * L;
    const bool exhausted = total < consumed_ranks;
    unsigned long long* keys = P.win_g + (size_t)(rounds & 1) * P.w_cap;
    {
      // clear the next round's buffer, last used a round ago (its reads
      // came before barrier 1)
      unsigned long long* next = P.win_g + (size_t)((rounds & 1) ^ 1) * P.w_cap;
      for (int k = gtid; k < w_prev; k += gstride) next[k] = 0ull;
    }

    // 2. ranks and bids; the watermark position pushes the cursor's advance
    int xex = base + excl[0];
#pragma unroll
    for (int j = 0; j < (REG ? K : layers); ++j) {
      if (j >= mine) break;
      const int p = q0 + j;
      if ((REG ? st[REG ? j : 0].node : P.node_s[p]) < 0) continue;
      const bool wrapped = p < offset;
      const int rank = wrapped ? total - x_off + xex : xex - x_off;
      xex += 1;
      const int w = rank / lm;
      if (w < w_use)
        atomicMax(keys + w, bid_key(REG ? st[REG ? j : 0].score : P.score_s[p], rank));
      if (L > 0 && !exhausted && rank == consumed_ranks - 1) {
        const int last = wrapped ? n_real - offset + p : p - offset;
        for (int b = 0; b < WIN_CLUSTER; ++b) *cluster.map_shared_rank(&wm_s, b) = last;
      }
    }
    NTT_STAMP(3);
    cluster_arrive();
    cluster_wait();  // barrier 2
    NTT_STAMP(4);
    const int consumed = exhausted ? n_real : (L > 0 ? wm_s + 1 : 0);

    // 3. each window's winner places the alloc numbered placed + window
    xex = base + excl[0];
#pragma unroll
    for (int j = 0; j < (REG ? K : layers); ++j) {
      if (j >= mine) break;
      const int p = q0 + j;
      const int node = REG ? st[REG ? j : 0].node : P.node_s[p];
      if (node < 0) continue;
      const bool wrapped = p < offset;
      const int rank = wrapped ? total - x_off + xex : xex - x_off;
      xex += 1;
      const int w = rank / lm;
      if (w >= w_use ||
          __ldcg(keys + w) != bid_key(REG ? st[REG ? j : 0].score : P.score_s[p], rank))
        continue;
      if (placed + w < P.a_pad) P.placements[placed + w] = node;
      if constexpr (REG) {
        win_pos(st[REG ? j : 0], dem, count_f);
      } else {
        for (int c = 0; c < P.C; ++c) P.used_s[(size_t)p * P.C + c] += P.demand[c];
        P.coll_s[p] += 1;
        refresh_record(P, p, node, count_f);
      }
    }
    offset = (offset + consumed) % n_real;
    placed += w_use;
    w_prev = w_use;
    NTT_STAMP(5);
  }
  NTT_STAMP_FLUSH;
  if (brank == 0 && tid == 0) *P.rounds = rounds;
  // no block leaves while another may still write its shared memory
  cluster.sync();
}

// Where a launch keeps what: the block's positions and threads, the
// path, the offsets of the global scratch
struct Layout {
  int per, k, threads, layers, w_cap;
  bool reg;
  size_t off_used, off_coll, off_score, off_node, scratch;
};

Layout layout(int C, int n_real) {
  Layout L;
  L.per = (n_real + WIN_CLUSTER - 1) / WIN_CLUSTER;
  L.k = (L.per + THREADS - 1) / THREADS;
  L.threads = min(THREADS, max(32, ((L.per + L.k - 1) / L.k + 31) / 32 * 32));
  L.layers = (L.per + L.threads - 1) / L.threads;
  L.reg = L.k <= REG_MAX_POS && C <= REG_MAX_COLS;
  L.w_cap = n_real;  // a round's windows: at most one a fit position
  size_t off = (size_t)2 * L.w_cap * 8;
  const size_t rec = L.reg ? 0 : (size_t)n_real * 4;
  L.off_used = off;
  off += rec * C;
  L.off_coll = off;
  off += rec;
  L.off_score = off;
  off += rec;
  L.off_node = off;
  off += rec;
  L.scratch = off;
  return L;
}

template <int K>
int launch(const WindowParams& P, int threads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(windowed_kernel<K>,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = WIN_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(WIN_CLUSTER);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the card must hold the whole cluster at once, or the launch is refused
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, windowed_kernel<K>, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return CLUSTER_REFUSED;
  err = cudaLaunchKernelEx(&cfg, windowed_kernel<K>, P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// bytes of global scratch a launch over n_real ring positions and C
// resource columns needs (the window keys, and the records past the
// register path)
extern "C" int ntt_windowed_scratch(void* out, int N, int C, int n_real, void* stream) {
  (void)stream;
  if (C < 2 || n_real < 1 || n_real > N) return (int)cudaErrorInvalidValue;
  *(long long*)out = (long long)layout(C, n_real).scratch;
  return 0;
}

// the launch's shape: blocks, threads a block, positions a thread, and
// whether the positions' state stays in registers (1) or not (0)
extern "C" int ntt_windowed_shape(void* out, int N, int C, int n_real, void* stream) {
  (void)stream;
  if (C < 2 || n_real < 1 || n_real > N) return (int)cudaErrorInvalidValue;
  const Layout L = layout(C, n_real);
  int* o = (int*)out;
  o[0] = WIN_CLUSTER;
  o[1] = L.threads;
  o[2] = L.layers;
  o[3] = L.reg;
  return 0;
}

extern "C" int ntt_windowed(const void* capacity, const void* usable, const void* feasible,
                            const void* perm, const void* demand, const void* group_count,
                            const void* limit, const void* n_allocs, const void* used0,
                            const void* coll0, void* placements, void* rounds, void* scratch,
                            int N, int C, int n_real, int a_pad, void* stream) {
  if (C < 2 || n_real < 1 || n_real > N) return (int)cudaErrorInvalidValue;
  const Layout L = layout(C, n_real);
  unsigned char* s = (unsigned char*)scratch;
  WindowParams P{(const int*)capacity,
                 (const float*)usable,
                 (const unsigned char*)feasible,
                 (const int*)perm,
                 (const int*)demand,
                 (const int*)group_count,
                 (const int*)limit,
                 (const int*)n_allocs,
                 (const int*)used0,
                 (const int*)coll0,
                 (int*)placements,
                 (int*)rounds,
                 (unsigned long long*)s,
                 (int*)(s + L.off_used),
                 (int*)(s + L.off_coll),
                 (float*)(s + L.off_score),
                 (int*)(s + L.off_node),
                 C,
                 n_real,
                 a_pad,
                 L.per,
                 L.layers,
                 L.w_cap};
  cudaStream_t st = (cudaStream_t)stream;
  if (!L.reg) return launch<0>(P, L.threads, st);
  return L.k == 1 ? launch<1>(P, L.threads, st) : launch<2>(P, L.threads, st);
}
