// Run-based full-ring planner (spread/affinity fast path, limit = ring).
//
// Replaces nomad_tpu/tpu/kernel.py _plan_batch_runs_jit (:716). Node-axis
// planes arrive in rotation order. Each round of the device loop scores
// the ring once and places either a SWEEP tie-run (every accepted node of
// the tied top set, in the merged order of keys score - t*delta/num) or a
// FILL run (the winner's closed-form trajectory over up to RUNCAP further
// self-placements, accepted while it stays above the frozen runner-up).
//
// What bounds it on the card: the rounds are sequential and each is a
// chain of reductions over the ring, so the kernel is latency-bound; the
// planes (about 1 MB at 10K nodes) stay in L1 and L2.
//
// Design: ONE thread block cluster of RUNS_CLUSTER blocks of 1024 threads
// (cudaLaunchKernelEx with a cluster dimension), with the rounds inside the
// kernel. The positions are split evenly and in order across the blocks
// (640 a block at 10,240) and, within a block, in order across its warps
// (32 a warp, one a thread, at the headline). A thread alone reads and
// writes its positions' used rows and collisions (in global memory, so L1
// serves them) and keeps their round state (score, plane count, class, tie
// rank, key, flags) in registers, or, where a block holds more than 1024
// positions, in a global record per position. Every
// block keeps its own copy of the spread counts, presence, boosts and key
// decays in a global slice (its SM's L1 serves it), updates it itself from
// what every block knows, and computes the round's boosts from it (warp 0,
// or every thread for more than 31 classes).
//
// A round takes two cluster barriers. Exchanges are pushes into every
// block's shared memory before a barrier (cluster.cuh).
// 1. Each block reduces its positions to one record (fused: the fit count,
//    the best score, how many positions hold it and the first four of them,
//    the largest score below it, and the first MAX_SKIP nonpositive fit
//    positions): each warp's from ballots and warp reductions over its
//    positions, then the warps' records merged in position order by every
//    warp, with one block barrier. It ranks its positions that
//    hold the block's best score within their class (ballots for at most 32
//    classes, else a compacted list; the per-class totals go into the
//    record or a tagged global slot). Barrier 1. Every warp merges the
//    records: the round's best score, the deferred positions, the winner
//    (the first tied position in visit order), both runner-ups (another
//    tied position, else the largest score below), and each class's tie
//    count in the blocks before this one.
// 2. Each tied position's key and first acceptance (key > the non-tied
//    runner-up); an accepted one also scores its own second placement (the
//    guard). Each block pushes its count, its least key and, when it has at
//    most SLOTS of them, the accepted lanes themselves, and computes the
//    winner's fill trajectory (RUNCAP points, one a thread). Barrier 2.
//    After it every block holds every accepted lane: it resolves the guard,
//    the final acceptance and, for a sweep, each placed lane's slot (its
//    rank in the merged order (float_order(-key) << 32 | visit), unique per
//    lane), and places its own lanes; a fill is placed by the winner's
//    block. Each block adds the round's placements to its own spread counts.
// A round in which a block accepted more than SLOTS lanes takes three more
// barriers: the guard's bad key, the counts of the final acceptance (each
// block sorts its accepted lanes in its global slice with a bitonic sort),
// and the hits, which each block adds into every block's counts; a lane's
// slot is its rank in its own block plus, for each other block, a binary
// search in that block's sorted lanes. Even mode has no sweep: barrier 1
// alone.
//
// Integer counts, the max with an index tie-break and the first-k lists
// combine in any order, and every float is the plain version's operation
// (score.cuh), so the result is bit-identical to plan_batch_runs_ref.
//
// Measured (PERF.md): nomad_tpu_torch/tools/runs_round_sweep.py times a
// round and splits it by clock64 stamps (NTT_STAMP, empty unless the tool
// defines it); nomad_tpu_torch/tools/runs_variants.py times this kernel
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
#define NTT_COUNT_SWEEP(n_acc, take)
#define NTT_COUNT_FILL(run)
#endif

namespace {

using namespace ntt;

constexpr int RUNCAP = 512;  // max placements resolved by one fill run
// blocks of the cluster: 16 is a non-portable size (the launch allows it)
constexpr int RUNS_CLUSTER = 16;
// accepted lanes a block pushes to every block; a round with more takes
// the sorted path
constexpr int SLOTS = 64;
// classes (V + 1) whose tie ranks come from ballots and whose per-block
// totals ride barrier 1
constexpr int RANK_SMALL = 32;
// returned when the card cannot co-schedule the cluster
constexpr int CLUSTER_REFUSED = 0x4e5401;

// per-position flag bits
constexpr int F_FIT = 1, F_NP = 2, F_TL = 4, F_ACC0 = 8;

// A position's round state: its score and plane count, class, rank among
// the block's tied positions of its class, sweep key and guard score, and
// (pad) its index among the block's first-accepted lanes
struct Rec {
  float score, num, key, score2;
  int cls, t_in, flags, pad;
};

// The fused reduction of barrier 1 over a set of positions
struct R1 {
  int nfit;     // fit positions
  float s;      // best score (NEG: none)
  int nt;       // positions at s
  int t[4];     // the first four positions at s, ascending (INT_MAX: none)
  float below;  // largest score below s (NEG: none)
  int np[3];    // the first MAX_SKIP nonpositive fit positions (INT_MAX: none)
};

// An accepted lane as barrier 2 exchanges it
struct Entry {
  float key, score2;
  int visit, cls;
};

struct Head {
  int n0;      // lanes the block accepted first
  float kmin;  // their least key
};

struct RunParams {
  const int* capacity;                    // [N,C] rotation order
  const float* usable;                    // [N,2]
  const unsigned char* feasible;          // [N]
  const float* affinity;                  // [N]
  const unsigned char* affinity_present;  // [N]
  const int* group_count;                 // scalar
  const int* node_value;                  // [N]
  const float* spread_desired;            // [V]
  const float* spread_implicit;           // scalar
  const float* spread_weight_frac;        // scalar
  const unsigned char* spread_even;       // scalar
  const unsigned char* spread_active;     // scalar
  const int* perm;                        // [N] node id per rotation position
  const int* demand;                      // [C]
  const int* n_allocs;                    // scalar
  int* used;                              // [N,C] state, updated in place
  int* coll;                              // [N]
  int* counts;                            // [V]
  unsigned char* present;                 // [V]
  int* placements;                        // [a_pad] out
  int* rounds;                            // scalar out
  // global scratch
  unsigned char* cls_g;                   // per block: the class arrays
  unsigned long long* list_g;             // per block: list_cap sort slots
  unsigned long long* tag_g;              // per block: (round << 32 | ties) per class
  Rec* recs_g;                            // [N] round records
  int N, C, V, a_pad, even_mode;
  int per, layers, list_cap;
  size_t cls_bytes;                       // one block's class arrays
  bool rank_small;
  bool rows4;                             // C == 4 and used, capacity 16-byte aligned
};

__device__ __forceinline__ float neg() { return neg_inf(); }

__device__ __forceinline__ R1 r1_identity() {
  R1 r;
  r.nfit = 0;
  r.s = neg();
  r.nt = 0;
  r.below = neg();
#pragma unroll
  for (int k = 0; k < 4; ++k) r.t[k] = INT_MAX;
#pragma unroll
  for (int k = 0; k < 3; ++k) r.np[k] = INT_MAX;
  return r;
}

// float_order's inverse (-0.0 comes back as +0.0)
__device__ __forceinline__ float from_order(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// The first K of the lanes' lists, in lane order: lane l offers the first
// ``cnt`` entries of ``src``; every lane gets the result
template <int K>
__device__ __forceinline__ void gather_first(int cnt, const int (&src)[K], int (&dst)[K]) {
  const int lane = threadIdx.x & 31;
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, incl, d);
    if (lane >= d) incl += y;
  }
  const int excl = incl - cnt;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool own = excl <= k && k < incl;
    int v = INT_MAX;
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (own && k - excl == i) v = src[i];
    const unsigned who = __ballot_sync(FULL_MASK, own);
    dst[k] = who ? __shfl_sync(FULL_MASK, v, __ffs(who) - 1) : INT_MAX;
  }
}

// Merge the records the lanes of a warp hold, lane l the l-th in position
// order (lanes past them the identity); every lane gets the result
__device__ __forceinline__ R1 merge_ordered(const R1& m) {
  R1 r = r1_identity();
  const bool has = m.nfit > 0;
  r.nfit = __reduce_add_sync(FULL_MASK, m.nfit);
  if (r.nfit == 0) return r;
  const unsigned so = __reduce_max_sync(FULL_MASK, has ? float_order(m.s) : 0u);
  r.s = from_order(so);
  const bool tl = has && float_order(m.s) == so;
  r.nt = __reduce_add_sync(FULL_MASK, tl ? m.nt : 0);
  // the largest score below s: a tied lane's own, any other lane's best
  const unsigned bo = __reduce_max_sync(
      FULL_MASK, tl ? (m.below != neg() ? float_order(m.below) : 0u) : has ? float_order(m.s) : 0u);
  r.below = bo ? from_order(bo) : neg();
  gather_first<4>(tl ? min(m.nt, 4) : 0, m.t, r.t);
  gather_first<3>((m.np[0] != INT_MAX) + (m.np[1] != INT_MAX) + (m.np[2] != INT_MAX), m.np, r.np);
  return r;
}

// The guard's bad key and the fill's first refused step, reduced together
struct BadFirst {
  float bad;
  int first;
};
struct BadFirstOp {
  __device__ __forceinline__ BadFirst operator()(BadFirst a, BadFirst b) const {
    return {fmaxf(a.bad, b.bad), min(a.first, b.first)};
  }
};
__device__ __forceinline__ BadFirst shfl_xor(BadFirst v, int m) {
  return {ntt::shfl_xor(v.bad, m), ntt::shfl_xor(v.first, m)};
}

__device__ __forceinline__ int class_of(const int* node_value, int p, int V) {
  const int v = __ldg(node_value + p);
  return v >= 0 ? min(v, V) : V;
}

// One block's copy of the class arrays (its global slice)
struct Classes {
  int* counts;             // [V]
  float* boosts;           // [V+1]
  float* delta;            // [V+1] per-placement key decay
  unsigned char* present;  // [V]
};

__device__ __forceinline__ Classes classes_at(unsigned char* base, int V) {
  const size_t n = (size_t)V + 1;
  Classes c;
  c.counts = reinterpret_cast<int*>(base);
  c.boosts = reinterpret_cast<float*>(base + 4 * n);
  c.delta = reinterpret_cast<float*>(base + 8 * n);
  c.present = base + 12 * n;
  return c;
}

__host__ __device__ __forceinline__ size_t classes_bytes(int V) {
  return ((size_t)(V + 1) * 13 + 15) / 16 * 16;
}

// The round's boosts from this block's counts: warp 0 for at most 31
// classes, else every thread; one or two block barriers
__device__ void block_boosts(const RunParams& P, const Classes& K, float implicit, float wf,
                             bool even, bool active) {
  const int V = P.V, tid = threadIdx.x, lane = tid & 31;
  const float big = f32(0x4e800000u);  // 2**30
  ClassRange mm = {big, -big, 0};
  if (V < 32) {
    if (tid < 32) {
      float cf = 0.0f;
      if (lane < V) {
        cf = __int2float_rn(K.counts[lane]);
        if (K.present[lane]) mm = {cf, cf, 1};
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) mm = ClassRangeOp()(mm, shfl_xor(mm, m));
      const bool any = mm.any != 0;
      if (lane < V)
        K.boosts[lane] = class_boost(cf, __ldg(P.spread_desired + lane), implicit, wf, even, active,
                                     any, any ? mm.mn : 0.0f, any ? mm.mx : 0.0f);
      if (lane == 0) K.boosts[V] = active ? -1.0f : 0.0f;
    }
    __syncthreads();
    return;
  }
  for (int c = tid; c < V; c += THREADS)
    if (K.present[c]) {
      const float cf = __int2float_rn(K.counts[c]);
      mm = ClassRangeOp()(mm, ClassRange{cf, cf, 1});
    }
  mm = block_allreduce<30>(mm, ClassRangeOp());
  const bool any = mm.any != 0;
  for (int c = tid; c < V; c += THREADS)
    K.boosts[c] = class_boost(__int2float_rn(K.counts[c]), __ldg(P.spread_desired + c), implicit,
                              wf, even, active, any, any ? mm.mn : 0.0f, any ? mm.mx : 0.0f);
  if (tid == 0) K.boosts[V] = active ? -1.0f : 0.0f;
  __syncthreads();
}

// Fit, score and plane count of position p for one more placement; a
// 4-column row in one 16-byte load
__device__ __forceinline__ void eval_position(const RunParams& P, int p, const Classes& K,
                                              float count_f, bool active, int4 dem4, Rec& r) {
  const int C = P.C;
  bool fit = __ldg(P.feasible + p);
  int u0, u1;
  if (P.rows4) {
    const int4 u = reinterpret_cast<const int4*>(P.used)[p];
    const int4 cap = __ldg(reinterpret_cast<const int4*>(P.capacity) + p);
    fit = fit && u.x + dem4.x <= cap.x && u.y + dem4.y <= cap.y && u.z + dem4.z <= cap.z &&
          u.w + dem4.w <= cap.w;
    u0 = u.x, u1 = u.y;
  } else {
    const int* u = P.used + (size_t)p * C;
    const int* cap = P.capacity + (size_t)p * C;
    for (int c = 0; c < C; ++c) fit = fit && u[c] + __ldg(P.demand + c) <= __ldg(cap + c);
    u0 = u[0], u1 = u[1];
  }
  r.cls = class_of(P.node_value, p, P.V);
  r.flags = 0;
  r.score = 0.0f;
  r.num = 1.0f;
  if (!fit) return;
  const bool aff_p = __ldg(P.affinity_present + p);
  r.score = score_node(free_frac(u0 + dem4.x, __ldg(P.usable + 2 * p)),
                       free_frac(u1 + dem4.y, __ldg(P.usable + 2 * p + 1)), P.coll[p], count_f,
                       aff_p, aff_p ? __ldg(P.affinity + p) : 0.0f, active, K.boosts[r.cls],
                       &r.num);
  r.flags = F_FIT | (r.score <= 0.0f ? F_NP : 0);
}

// Its score after its own placement (the guard): one more demand, one more
// collision, its class's boost less one key decay
__device__ __forceinline__ float guard_score(const RunParams& P, int p, const Classes& K,
                                             float count_f, bool active, int cls) {
  const int* u = P.used + (size_t)p * P.C;
  const bool aff_p = __ldg(P.affinity_present + p);
  return score_node(free_frac(u[0] + 2 * __ldg(P.demand), __ldg(P.usable + 2 * p)),
                    free_frac(u[1] + 2 * __ldg(P.demand + 1), __ldg(P.usable + 2 * p + 1)),
                    P.coll[p] + 1, count_f, aff_p, aff_p ? __ldg(P.affinity + p) : 0.0f, active,
                    __fsub_rn(K.boosts[cls], K.delta[cls]));
}

__device__ __forceinline__ unsigned long long packed_key(float key, int visit) {
  return ((unsigned long long)float_order(-key) << 32) | (unsigned long long)(unsigned)visit;
}

// entries of ``list`` [0, n) that are below ``x`` (ascending list)
__device__ __forceinline__ int lower_bound(const unsigned long long* list, int n,
                                           unsigned long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Ascending bitonic sort of list[0, n) in place (padded to a power of two
// with ~0); every thread of the block calls
__device__ void block_sort(unsigned long long* list, int n) {
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  for (int k = n + (int)threadIdx.x; k < p2; k += THREADS) list[k] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p2; i += THREADS) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long x = list[i], y = list[ixj];
          if (((i & k) == 0) == (x > y)) {
            list[i] = y;
            list[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Round records: registers where a block holds at most 1024 positions,
// else one global record a position
template <bool REG>
struct Recs;
template <>
struct Recs<true> {
  Rec r;
  __device__ Rec& at(int, bool) { return r; }
};
template <>
struct Recs<false> {
  Rec* g;
  Rec dummy;  // for the threads past the block's positions
  __device__ Rec& at(int p, bool in) { return in ? g[p] : dummy; }
};

// one block an SM: ptxas may give a thread all 64 registers
template <bool REG>
__global__ void __launch_bounds__(THREADS, 1) runs_kernel(RunParams P) {
  cg::cluster_group cluster = cg::this_cluster();
  NTT_STAMP_DECL;
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = P.N, V = P.V, C = P.C;
  const int layers = REG ? 1 : P.layers;
  const int p_begin = (int)rank * P.per;
  const int p_end = min(p_begin + P.per, N);
  const float count_f = __int2float_rn(*P.group_count);
  const bool active = *P.spread_active;
  const bool even = *P.spread_even;
  const float implicit = *P.spread_implicit;
  const float wf = *P.spread_weight_frac;
  const int n_allocs = *P.n_allocs;
  const float NEG = neg();
  // the demand's first columns (all four where rows4)
  const int4 dem4 = make_int4(__ldg(P.demand), __ldg(P.demand + 1),
                              C > 2 ? __ldg(P.demand + 2) : 0, C > 3 ? __ldg(P.demand + 3) : 0);

  // pushed before barrier 1, by round parity
  __shared__ R1 r1_s[2][RUNS_CLUSTER];
  __shared__ int tot_s[2][RUNS_CLUSTER][RANK_SMALL];  // tie counts per class
  // pushed before barrier 2
  __shared__ Head head_s[RUNS_CLUSTER];
  __shared__ Entry ent_s[RUNS_CLUSTER][SLOTS];
  // pushed before the sorted path's barriers
  __shared__ float bad_s[RUNS_CLUSTER];
  __shared__ int nacc_s[RUNS_CLUSTER];
  // the ballot ranks
  __shared__ int wcnt_s[WARPS][RANK_SMALL];
  __shared__ int wpre_s[WARPS][RANK_SMALL];
  __shared__ int carry_s[RANK_SMALL];
  __shared__ int n0_s;
  __shared__ R1 wrec_s[WARPS];  // each warp's record

  auto counts_of = [&](int b) { return classes_at(P.cls_g + (size_t)b * P.cls_bytes, V); };
  auto list_of = [&](int b) { return P.list_g + (size_t)b * P.list_cap; };
  const Classes K = counts_of(rank);
  unsigned long long* list = list_of(rank);

  Recs<REG> recs;
  if constexpr (!REG) recs.g = P.recs_g;
  // warp w owns the block's positions w * 32 * layers, ...: the warps and,
  // within a warp, the layers then the lanes are in position order
  auto pos = [&](int k) { return p_begin + (warp * layers + k) * 32 + lane; };

  // this block's class arrays: the counts and presence, the key decays
  for (int c = tid; c <= V; c += THREADS) {
    if (c < V) {
      K.counts[c] = P.counts[c];
      K.present[c] = P.present[c];
      const float d = __ldg(P.spread_desired + c);
      const float de = d >= 0.0f ? d : implicit;
      const float dl = de >= 0.0f ? __fdiv_rn(wf, fmaxf(de, f32(0x3089705fu))) : 0.0f;
      K.delta[c] = (active && !even) ? dl : 0.0f;
    } else {
      K.delta[V] = 0.0f;
    }
  }
  for (int k = (int)rank * THREADS + tid; k < P.a_pad; k += RUNS_CLUSTER * THREADS)
    P.placements[k] = -1;
  __syncthreads();

  int placed = 0, rounds = 0, par = 0;
  while (placed < n_allocs) {
    NTT_STAMP(0);
    block_boosts(P, K, implicit, wf, even, active);
    if (tid == 0) n0_s = 0;

    // 1. score this block's positions; each warp's record from ballots and
    // warp reductions, then every warp merges the warps' records
    unsigned smax = 0;
    int nfit = 0;
    for (int k = 0; k < layers; ++k) {
      const int p = pos(k);
      Rec& r = recs.at(p, p < p_end);
      r.flags = 0;
      if (p < p_end) eval_position(P, p, K, count_f, active, dem4, r);
      const bool f = r.flags & F_FIT;
      smax = max(smax, __reduce_max_sync(FULL_MASK, f ? float_order(r.score) : 0u));
      nfit += __popc(__ballot_sync(FULL_MASK, f));
    }
    {
      R1 w = r1_identity();
      w.nfit = nfit;
      unsigned below = 0;
      if (nfit) {
        w.s = from_order(smax);
        for (int k = 0; k < layers; ++k) {
          const Rec& r = recs.at(pos(k), pos(k) < p_end);
          const bool f = r.flags & F_FIT;
          const bool tie = f && float_order(r.score) == smax;
          const int base = p_begin + (warp * layers + k) * 32;
          unsigned mt = __ballot_sync(FULL_MASK, tie);
          w.nt += __popc(mt);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (w.t[j] == INT_MAX && mt) {
              w.t[j] = base + __ffs(mt) - 1;
              mt &= mt - 1;
            }
          unsigned mn = __ballot_sync(FULL_MASK, f && (r.flags & F_NP));
#pragma unroll
          for (int j = 0; j < 3; ++j)
            if (w.np[j] == INT_MAX && mn) {
              w.np[j] = base + __ffs(mn) - 1;
              mn &= mn - 1;
            }
          below = max(below, __reduce_max_sync(FULL_MASK, f && !tie ? float_order(r.score) : 0u));
        }
        w.below = below ? from_order(below) : NEG;
      }
      if (lane == 0) wrec_s[warp] = w;
    }
    __syncthreads();
    const R1 blk = merge_ordered(wrec_s[lane]);
    cluster_publish(cluster, r1_s[par], rank, blk, RUNS_CLUSTER);
    NTT_STAMP(1);

    // the block's positions at its best score, ranked within their class
    const int tag = rounds + 1;
    if (!P.even_mode) {
      for (int k = 0; k < layers; ++k) {
        Rec& r = recs.at(pos(k), pos(k) < p_end);
        if ((r.flags & F_FIT) && r.score == blk.s) r.flags |= F_TL;
      }
      const unsigned lt = (1u << lane) - 1u;
      if (P.rank_small) {
        // lane c keeps the warp's count of class c so far
        int run_c = 0;
        for (int k = 0; k < layers; ++k) {
          Rec& r = recs.at(pos(k), pos(k) < p_end);
          const bool tl = r.flags & F_TL;
          for (int c = 0; c <= V; ++c) {
            const unsigned m = __ballot_sync(FULL_MASK, tl && r.cls == c);
            const int before = __shfl_sync(FULL_MASK, run_c, c);
            if (tl && r.cls == c) r.t_in = before + __popc(m & lt);
            if (lane == c) run_c += __popc(m);
          }
        }
        if (lane <= V) wcnt_s[warp][lane] = run_c;
        __syncthreads();
        if (warp <= V) {
          // class ``warp``'s counts in the warps before each warp, and in all
          const int x = wcnt_s[lane][warp];
          int incl = x;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL_MASK, incl, d);
            if (lane >= d) incl += y;
          }
          wpre_s[lane][warp] = incl - x;
          // each class's total rides barrier 1 (warp c pushes class c)
          const int total = __shfl_sync(FULL_MASK, incl, 31);
          if (lane < RUNS_CLUSTER) *cluster.map_shared_rank(&tot_s[par][rank][warp], lane) = total;
        }
        __syncthreads();
        for (int k = 0; k < layers; ++k) {
          Rec& r = recs.at(pos(k), pos(k) < p_end);
          if (r.flags & F_TL) r.t_in += wpre_s[warp][r.cls];
        }
      } else {
        // many classes: the tied positions compacted in position order,
        // each ranked among the earlier ones of its class; the first of a
        // class writes the class's total, tagged with the round
        int* tl_list = reinterpret_cast<int*>(list);
        int run = 0;  // the warp's tied positions so far
        for (int k = 0; k < layers; ++k) {
          Rec& r = recs.at(pos(k), pos(k) < p_end);
          const bool tl = r.flags & F_TL;
          const unsigned m = __ballot_sync(FULL_MASK, tl);
          if (tl) r.t_in = run + __popc(m & lt);  // its index in the warp, for now
          run += __popc(m);
        }
        if (lane == 0) wcnt_s[warp][0] = run;
        __syncthreads();
        if (warp == 0) {
          const int x = wcnt_s[lane][0];
          int incl = x;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL_MASK, incl, d);
            if (lane >= d) incl += y;
          }
          wpre_s[lane][0] = incl - x;
          if (lane == 31) carry_s[0] = incl;
        }
        __syncthreads();
        for (int k = 0; k < layers; ++k) {
          Rec& r = recs.at(pos(k), pos(k) < p_end);
          if (!(r.flags & F_TL)) continue;
          r.t_in += wpre_s[warp][0];
          tl_list[r.t_in] = r.cls;
        }
        __syncthreads();
        const int n_t = carry_s[0];
        for (int k = 0; k < layers; ++k) {
          Rec& r = recs.at(pos(k), pos(k) < p_end);
          if (!(r.flags & F_TL)) continue;
          int before = 0, total = 0;
          for (int q = 0; q < n_t; ++q) {
            const bool same = tl_list[q] == r.cls;
            total += same;
            before += same && q < r.t_in;
          }
          r.t_in = before;
          if (before == 0)
            P.tag_g[(size_t)rank * (V + 1) + r.cls] =
                ((unsigned long long)tag << 32) | (unsigned)total;
        }
      }
    }
    NTT_STAMP(3);
    cluster.sync();  // barrier 1

    // every warp merges the blocks' records
    const R1 g = merge_ordered(lane < RUNS_CLUSTER ? r1_s[par][lane] : r1_identity());
    rounds += 1;
    if (g.nfit == 0) break;  // nothing fits: the loop's progress flag drops
    const float s = g.s;
    // the winner: the first tied position in visit order; where every fit
    // score is nonpositive the first MAX_SKIP of them are visited last
    int best = g.t[0];
    if (!(s > 0.0f)) {
      bool found = false;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = g.t[k];
        const bool deferred = t == g.np[0] || t == g.np[1] || t == g.np[2];
        if (!found && t != INT_MAX && !deferred) {
          best = t;
          found = true;
        }
      }
    }
    const float r_other = g.nt >= 2 ? s : g.below;
    const float r_nontied = g.below;
    const int remaining = n_allocs - placed;
    NTT_STAMP(2);

    int n_acc = 0, first_bad = RUNCAP;
    if (!P.even_mode) {
      // 2. keys and the first acceptance of the tied positions
      const bool at_best = blk.s == s;
      float kmin = __int_as_float(0x7f800000);
      for (int k = 0; k < layers; ++k) {
        const int p = pos(k);
        const bool in = p < p_end;
        Rec& r = recs.at(p, in);
        bool acc0 = false;
        if (in && at_best && (r.flags & F_TL)) {
          int pre = 0;
          for (int b = 0; b < (int)rank; ++b) {
            if (r1_s[par][b].s != s) continue;
            if (P.rank_small) {
              pre += tot_s[par][b][r.cls];
            } else {
              const unsigned long long t = __ldcg(P.tag_g + (size_t)b * (V + 1) + r.cls);
              pre += (int)(t >> 32) == tag ? (int)(unsigned)t : 0;
            }
          }
          const int t_own = r.t_in + pre;
          r.key = __fsub_rn(r.score, __fdiv_rn(__fmul_rn(__int2float_rn(t_own), K.delta[r.cls]),
                                               r.num));
          acc0 = r.key > r_nontied;
          if (acc0) {
            r.flags |= F_ACC0;
            r.score2 = guard_score(P, p, K, count_f, active, r.cls);
            kmin = fminf(kmin, r.key);
          }
        }
        // an index for each first-accepted lane (any order: the merged
        // order comes from the keys)
        const unsigned m = __ballot_sync(FULL_MASK, acc0);
        int base = 0;
        if (lane == 0 && m) base = atomicAdd(&n0_s, __popc(m));
        base = __shfl_sync(FULL_MASK, base, 0);
        if (acc0) r.pad = base + __popc(m & ((1u << lane) - 1u));
      }
      kmin = block_allreduce<22>(kmin, MinF());
      const int n0 = n0_s;
      if (n0 <= SLOTS) {
        for (int k = 0; k < layers; ++k) {
          const int p = pos(k);
          if (p >= p_end) continue;
          const Rec& r = recs.at(p, true);
          if (!(r.flags & F_ACC0)) continue;
          const bool deferred = p == g.np[0] || p == g.np[1] || p == g.np[2];
          const Entry e = {r.key, r.score2, p + (deferred ? N : 0), r.cls};
          for (int b = 0; b < RUNS_CLUSTER; ++b) *cluster.map_shared_rank(&ent_s[rank][r.pad], b) = e;
        }
      }
      cluster_publish(cluster, head_s, rank, Head{n0, kmin}, RUNS_CLUSTER);
      // the winner's fill trajectory under j further self-placements, every
      // other node frozen; j = 0 is granted. Its block writes the winner's
      // row only after barrier 2, so every block reads it before
      if (tid > 0 && tid < RUNCAP) {
        const int j = tid;
        const int* ub = P.used + (size_t)best * C;
        const int* capb = P.capacity + (size_t)best * C;
        bool ok = j < remaining;
        for (int c = 0; c < C && ok; ++c)
          ok = __ldcg(ub + c) + (j + 1) * __ldg(P.demand + c) <= __ldg(capb + c);
        if (ok) {
          const int cls_b = class_of(P.node_value, best, V);
          const bool affp_b = __ldg(P.affinity_present + best);
          const float aff_b = affp_b ? __ldg(P.affinity + best) : 0.0f;
          const float jf = __int2float_rn(j);
          const float jf1 = __fadd_rn(jf, 1.0f);
          const float fc = __fsub_rn(
              1.0f, __fdiv_rn(__fadd_rn(__int2float_rn(__ldcg(ub)),
                                        __fmul_rn(jf1, __int2float_rn(__ldg(P.demand)))),
                              __ldg(P.usable + 2 * best)));
          const float fm = __fsub_rn(
              1.0f, __fdiv_rn(__fadd_rn(__int2float_rn(__ldcg(ub + 1)),
                                        __fmul_rn(jf1, __int2float_rn(__ldg(P.demand + 1)))),
                              __ldg(P.usable + 2 * best + 1)));
          const float coll_j = __fadd_rn(__int2float_rn(__ldcg(P.coll + best)), jf);
          const bool ap = coll_j > 0.0f;
          const float an = anti_affinity(coll_j, ap, count_f);
          const float sp = __fsub_rn(K.boosts[cls_b], __fmul_rn(jf, K.delta[cls_b]));
          const bool fired = active && sp != 0.0f;
          const float num = __fadd_rn(__fadd_rn(__fadd_rn(1.0f, ap ? 1.0f : 0.0f),
                                                affp_b ? 1.0f : 0.0f),
                                      fired ? 1.0f : 0.0f);
          const float traj = __fdiv_rn(
              __fadd_rn(__fadd_rn(__fadd_rn(binpack_f32(fc, fm), an), aff_b), fired ? sp : 0.0f),
              num);
          ok = traj > r_other;
        }
        if (!ok) first_bad = j;
      }
      cluster.sync();  // barrier 2

      // every block's counts and least keys
      const Head h = lane < RUNS_CLUSTER ? head_s[lane] : Head{0, __int_as_float(0x7f800000)};
      const bool overflow = __any_sync(FULL_MASK, h.n0 > SLOTS);
      kmin = h.kmin;
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) kmin = fminf(kmin, __shfl_xor_sync(FULL_MASK, kmin, m));
      if (!overflow) {
        // every block holds every first-accepted lane: thread i takes lane i
        Entry e = {};
        int src = -1, total0 = 0;
        for (int b = 0; b < RUNS_CLUSTER; ++b) {
          const int n = head_s[b].n0;
          if (src < 0 && tid < total0 + n) {
            src = b;
            e = ent_s[b][tid - total0];
          }
          total0 += n;
        }
        const bool has = src >= 0;
        const BadFirst bf = block_allreduce<23>(
            BadFirst{has && !(e.score2 <= kmin) ? e.key : NEG, first_bad}, BadFirstOp());
        first_bad = bf.first;
        const bool acc = has && e.key > bf.bad;
        n_acc = block_allreduce<24>((int)acc, SumI());
        NTT_STAMP(4);
        if (n_acc > 1) {
          const int take = min(remaining, n_acc);
          if (acc) {
            // its slot: the accepted lanes before it in the merged order
            const unsigned long long me = packed_key(e.key, e.visit);
            int slot = 0;
            for (int b = 0; b < RUNS_CLUSTER; ++b) {
              const int n = head_s[b].n0;
              for (int q = 0; q < n; ++q) {
                const Entry o = ent_s[b][q];
                slot += o.key > bf.bad && packed_key(o.key, o.visit) < me;
              }
            }
            if (slot < take) {
              if (src == (int)rank) {
                const int p = e.visit >= N ? e.visit - N : e.visit;
                if (placed + slot < P.a_pad) P.placements[placed + slot] = __ldg(P.perm + p);
                for (int c = 0; c < C; ++c) P.used[(size_t)p * C + c] += __ldg(P.demand + c);
                P.coll[p] += 1;
              }
              if (active && e.cls < V) {
                atomicAdd(&K.counts[e.cls], 1);
                K.present[e.cls] = 1;
              }
            }
          }
          NTT_STAMP(5);
          NTT_COUNT_SWEEP(n_acc, take);
          placed += take;
        }
      } else {
        // the sorted path: the guard's bad key first
        float bad = NEG;
        for (int k = 0; k < layers; ++k) {
          const int p = pos(k);
          if (p >= p_end) continue;
          const Rec& r = recs.at(p, true);
          if ((r.flags & F_ACC0) && !(r.score2 <= kmin)) bad = fmaxf(bad, r.key);
        }
        const BadFirst bf = block_allreduce<25>(BadFirst{bad, first_bad}, BadFirstOp());
        first_bad = bf.first;
        cluster_publish(cluster, bad_s, rank, bf.bad, RUNS_CLUSTER);
        cluster.sync();
        float bad_key = lane < RUNS_CLUSTER ? bad_s[lane] : NEG;
#pragma unroll
        for (int m = 16; m > 0; m >>= 1)
          bad_key = fmaxf(bad_key, __shfl_xor_sync(FULL_MASK, bad_key, m));
        // this block's accepted lanes, sorted by the merged order
        if (tid == 0) n0_s = 0;
        __syncthreads();
        for (int k = 0; k < layers; ++k) {
          const int p = pos(k);
          const bool in = p < p_end;
          const Rec& r = recs.at(p, in);
          const bool acc = in && (r.flags & F_ACC0) && r.key > bad_key;
          const unsigned m = __ballot_sync(FULL_MASK, acc);
          int base = 0;
          if (lane == 0 && m) base = atomicAdd(&n0_s, __popc(m));
          base = __shfl_sync(FULL_MASK, base, 0);
          if (acc) {
            const bool deferred = p == g.np[0] || p == g.np[1] || p == g.np[2];
            list[base + __popc(m & ((1u << lane) - 1u))] = packed_key(r.key, p + (deferred ? N : 0));
          }
        }
        __syncthreads();
        const int mine_acc = n0_s;
        block_sort(list, mine_acc);
        cluster_publish(cluster, nacc_s, rank, mine_acc, RUNS_CLUSTER);
        cluster.sync();
        int before, total;
        published_prefix_sum(nacc_s, RUNS_CLUSTER, rank, before, total);
        n_acc = total;
        NTT_STAMP(4);
        if (n_acc > 1) {
          const int take = min(remaining, n_acc);
          for (int i = tid; i < mine_acc; i += THREADS) {
            const unsigned long long me = list[i];
            int slot = i;
            for (int b = 0; b < RUNS_CLUSTER; ++b)
              if (b != (int)rank) slot += lower_bound(list_of(b), nacc_s[b], me);
            if (slot >= take) continue;
            const int visit = (int)(unsigned)(me & 0xffffffffull);
            const int p = visit >= N ? visit - N : visit;
            if (placed + slot < P.a_pad) P.placements[placed + slot] = __ldg(P.perm + p);
            for (int c = 0; c < C; ++c) P.used[(size_t)p * C + c] += __ldg(P.demand + c);
            P.coll[p] += 1;
            const int cls = class_of(P.node_value, p, V);
            if (active && cls < V) {
              for (int b = 0; b < RUNS_CLUSTER; ++b) {
                const Classes o = counts_of(b);
                atomicAdd(&o.counts[cls], 1);
                o.present[cls] = 1;
              }
            }
          }
          NTT_STAMP(5);
          NTT_COUNT_SWEEP(n_acc, take);
          placed += take;
        }
        // the hits are in every block's counts; no list is read again
        cluster.sync();
      }
    } else {
      NTT_STAMP(4);
    }

    if (n_acc <= 1) {
      // fill: the winner's run; the winner's block places it
      NTT_STAMP(5);
      const int run = P.even_mode ? min(1, remaining) : min(first_bad, remaining);
      if (best >= p_begin && best < p_end) {
        const int node_b = __ldg(P.perm + best);
        for (int j = tid; j < run; j += THREADS)
          if (placed + j < P.a_pad) P.placements[placed + j] = node_b;
        if (tid == 0) {
          for (int c = 0; c < C; ++c) P.used[(size_t)best * C + c] += run * __ldg(P.demand + c);
          P.coll[best] += run;
        }
      }
      if (tid == 0) {
        const int cls_b = class_of(P.node_value, best, V);
        if (active && cls_b < V) {
          K.counts[cls_b] += run;
          if (run > 0) K.present[cls_b] = 1;
        }
      }
      NTT_COUNT_FILL(run);
      placed += run;
    }
    NTT_STAMP(6);
    par ^= 1;
    __syncthreads();  // the round's state is visible to the block
  }
  NTT_STAMP_FLUSH;
  if (rank == 0) {
    for (int c = tid; c < V; c += THREADS) {
      P.counts[c] = K.counts[c];
      P.present[c] = K.present[c];
    }
    if (tid == 0) *P.rounds = rounds;
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

// Where a launch keeps what: the positions a block owns, the offsets of
// the global scratch
struct Layout {
  int per, layers, list_cap;
  size_t cls_bytes, off_list, off_tag, off_recs, scratch;
  bool rank_small, reg;
};

Layout layout(int N, int V) {
  Layout L;
  L.per = (N + RUNS_CLUSTER - 1) / RUNS_CLUSTER;
  L.layers = (L.per + THREADS - 1) / THREADS;
  L.list_cap = 1;
  while (L.list_cap < L.per) L.list_cap <<= 1;
  L.cls_bytes = classes_bytes(V);
  L.rank_small = V + 1 <= RANK_SMALL;
  L.reg = L.layers <= 1;
  size_t off = (size_t)RUNS_CLUSTER * L.cls_bytes;
  L.off_list = off;
  off += (size_t)RUNS_CLUSTER * L.list_cap * 8;
  L.off_tag = off;
  off += L.rank_small ? 0 : (size_t)RUNS_CLUSTER * (V + 1) * 8;
  L.off_recs = off;
  off += L.reg ? 0 : (size_t)N * sizeof(Rec);
  L.scratch = off;
  return L;
}

template <bool REG>
int launch(const RunParams& P, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(runs_kernel<REG>,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = RUNS_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(RUNS_CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the card must hold the whole cluster at once, or the launch is refused
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, runs_kernel<REG>, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return CLUSTER_REFUSED;
  err = cudaLaunchKernelEx(&cfg, runs_kernel<REG>, P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// bytes of zeroed global scratch a launch over N positions and V classes needs
extern "C" int ntt_runs_scratch(void* out, int N, int C, int V, void* stream) {
  (void)stream;
  if (N < 1 || C < 2 || V < 0) return (int)cudaErrorInvalidValue;
  *(long long*)out = (long long)layout(N, V).scratch;
  return 0;
}

extern "C" int ntt_runs(const void* capacity, const void* usable, const void* feasible,
                        const void* affinity, const void* affinity_present,
                        const void* group_count, const void* node_value,
                        const void* spread_desired, const void* spread_implicit,
                        const void* spread_weight_frac, const void* spread_even,
                        const void* spread_active, const void* perm, const void* demand,
                        const void* n_allocs, void* used, void* coll, void* counts,
                        void* present, void* placements, void* rounds, void* scratch, int N,
                        int C, int V, int a_pad, int even_mode, void* stream) {
  if (N < 1 || C < 2 || V < 0) return (int)cudaErrorInvalidValue;
  const Layout L = layout(N, V);
  unsigned char* s = (unsigned char*)scratch;
  RunParams P{(const int*)capacity,
              (const float*)usable,
              (const unsigned char*)feasible,
              (const float*)affinity,
              (const unsigned char*)affinity_present,
              (const int*)group_count,
              (const int*)node_value,
              (const float*)spread_desired,
              (const float*)spread_implicit,
              (const float*)spread_weight_frac,
              (const unsigned char*)spread_even,
              (const unsigned char*)spread_active,
              (const int*)perm,
              (const int*)demand,
              (const int*)n_allocs,
              (int*)used,
              (int*)coll,
              (int*)counts,
              (unsigned char*)present,
              (int*)placements,
              (int*)rounds,
              s,
              (unsigned long long*)(s + L.off_list),
              (unsigned long long*)(s + L.off_tag),
              (Rec*)(s + L.off_recs),
              N,
              C,
              V,
              a_pad,
              even_mode,
              L.per,
              L.layers,
              L.list_cap,
              L.cls_bytes,
              L.rank_small,
              C == 4 && (((uintptr_t)used | (uintptr_t)capacity) & 15) == 0};
  cudaStream_t st = (cudaStream_t)stream;
  return L.reg ? launch<true>(P, st) : launch<false>(P, st);
}
