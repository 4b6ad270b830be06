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
// chain of block-wide reductions, so the kernel is latency-bound; the
// planes (about 1 MB at 10K nodes) stay in L2. Design: ONE block of 1024
// threads owns the node axis and the while-loop runs inside the kernel (one
// launch per eval, no host round trip per round). The sweep's merged
// order (jnp.lexsort by -key, then visit) is a bitonic sort of the
// accepted lanes only, packed as (order(-key) << 32 | visit) in a scratch
// array; visit is unique per lane, so the packing is the whole lexsort.
#include <cuda_runtime.h>

#include "block.cuh"
#include "score.cuh"

namespace {

using namespace ntt;

constexpr int RUNCAP = 512;  // max placements resolved by one fill run

struct RunParams {
  const int* capacity;                 // [N,C] rotation order
  const float* usable;                 // [N,2]
  const unsigned char* feasible;       // [N]
  const float* affinity;               // [N]
  const unsigned char* affinity_present;  // [N]
  const int* group_count;              // scalar
  const int* node_value;               // [N]
  const float* spread_desired;         // [V]
  const float* spread_implicit;        // scalar
  const float* spread_weight_frac;     // scalar
  const unsigned char* spread_even;    // scalar
  const unsigned char* spread_active;  // scalar
  const int* perm;                     // [N] node id per rotation position
  const int* demand;                   // [C]
  const int* n_allocs;                 // scalar
  int* used;                           // [N,C] state, updated in place
  int* coll;                           // [N]
  int* counts;                         // [V]
  unsigned char* present;              // [V]
  int* placements;                     // [a_pad] out
  int* rounds;                         // scalar out
  float* score_s;                      // [N] scratch
  float* num_s;                        // [N]
  float* key_s;                        // [N]
  int* trank_s;                        // [N]
  unsigned char* flag_s;               // [N]
  unsigned long long* sort_s;          // [pow2 >= N]
  float* boosts_s;                     // [V+1]
  float* delta_s;                      // [V+1]
  int* hits_s;                         // [V+1]
  int N, C, V, a_pad, even_mode;
};

// per-position flag bits
constexpr int F_FIT = 1, F_NONPOS = 2, F_DEFER = 4, F_TIED = 8, F_ACC0 = 16, F_ACC = 32;

__device__ __forceinline__ int class_of(const int* node_value, int p, int V) {
  const int v = node_value[p];
  return v >= 0 ? min(v, V) : V;
}

__global__ void __launch_bounds__(THREADS) runs_kernel(RunParams P) {
  const int tid = threadIdx.x;
  const int N = P.N, C = P.C, V = P.V;
  const ChunkRange own = chunk_of(N);
  const float count_f = __int2float_rn(*P.group_count);
  const bool active = *P.spread_active;
  const bool even = *P.spread_even;
  const float implicit = *P.spread_implicit;
  const float wf = *P.spread_weight_frac;
  const int n_allocs = *P.n_allocs;
  const int* dem = P.demand;
  const float ninf = neg_inf();
  const float pinf = __int_as_float(0x7f800000);
  __shared__ int s_count;

  if (tid == 0) {
    // per-placement key decay of each class under target spread
    for (int c = 0; c < V; ++c) {
      const float de = P.spread_desired[c] >= 0.0f ? P.spread_desired[c] : implicit;
      const float d = de >= 0.0f ? __fdiv_rn(wf, fmaxf(de, f32(0x3089705fu))) : 0.0f;
      P.delta_s[c] = (active && !even) ? d : 0.0f;
    }
    P.delta_s[V] = 0.0f;
  }
  for (int k = tid; k < P.a_pad; k += THREADS) P.placements[k] = -1;

  int placed = 0, rounds = 0;
  while (placed < n_allocs) {
    if (tid == 0)
      class_boosts(P.counts, P.present, P.spread_desired, implicit, wf, even, active, V,
                   P.boosts_s);
    __syncthreads();  // boosts and the previous round's state are visible

    // A: fit and score of every position
    int cnt[2] = {0, 0};  // nonpositive, fit
    for (int p = own.p0; p < own.p1; ++p) {
      const int* u = P.used + (size_t)p * C;
      const bool fit = P.feasible[p] && fits(u, P.capacity + (size_t)p * C, dem, 1, C);
      float sc = 0.0f, num = 1.0f;
      if (fit)
        sc = score_node(free_frac(u[0] + dem[0], P.usable[2 * p]),
                        free_frac(u[1] + dem[1], P.usable[2 * p + 1]), P.coll[p], count_f,
                        P.affinity_present[p], P.affinity[p], active,
                        P.boosts_s[class_of(P.node_value, p, V)], &num);
      const bool nonpos = fit && sc <= 0.0f;
      P.score_s[p] = sc;
      P.num_s[p] = num;
      P.flag_s[p] = (unsigned char)((fit ? F_FIT : 0) | (nonpos ? F_NONPOS : 0));
      cnt[0] += nonpos;
      cnt[1] += fit;
    }
    int excl[2], tot[2];
    block_scan<2, 10>(cnt, excl, tot);
    rounds += 1;
    if (tot[1] == 0) break;  // nothing fits: the loop's progress flag drops

    // B: the first MAX_SKIP nonpositive options are visited last; winner
    Best best = best_identity();
    int run_np = excl[0];
    for (int p = own.p0; p < own.p1; ++p) {
      int f = P.flag_s[p];
      if (!(f & F_FIT)) continue;
      run_np += (f & F_NONPOS) ? 1 : 0;
      const bool deferred = (f & F_NONPOS) && run_np <= MAX_SKIP;
      if (deferred) P.flag_s[p] = (unsigned char)(f | F_DEFER);
      best = BestOp()(best, Best{P.score_s[p], p + (deferred ? N : 0), p, -1});
    }
    best = block_allreduce<11>(best, BestOp());
    const float max_score = best.s;
    const int b = best.pos;
    const int remaining = n_allocs - placed;

    // C: runner-up over every other node, and over the non-tied ones
    float r_other = ninf, r_nontied = ninf;
    for (int p = own.p0; p < own.p1; ++p) {
      const int f = P.flag_s[p];
      if (!(f & F_FIT)) continue;
      const float s = P.score_s[p];
      if (p != b) r_other = fmaxf(r_other, s);
      if (s == max_score)
        P.flag_s[p] = (unsigned char)(f | F_TIED);
      else
        r_nontied = fmaxf(r_nontied, s);
    }
    r_other = block_allreduce<12>(r_other, MaxF());
    r_nontied = block_allreduce<13>(r_nontied, MaxF());

    int n_acc = 0;
    if (!P.even_mode) {
      // rank of each tied node among the tied nodes of its class, in
      // rotation order (t_own), four classes per block scan
      for (int c0 = 0; c0 <= V; c0 += 4) {
        int cc[4] = {0, 0, 0, 0};
        for (int p = own.p0; p < own.p1; ++p) {
          if (!(P.flag_s[p] & F_TIED)) continue;
          const int k = class_of(P.node_value, p, V) - c0;
          if (k >= 0 && k < 4) cc[k] += 1;
        }
        int cex[4], ctot[4];
        block_scan<4, 14>(cc, cex, ctot);
        for (int p = own.p0; p < own.p1; ++p) {
          if (!(P.flag_s[p] & F_TIED)) continue;
          const int k = class_of(P.node_value, p, V) - c0;
          if (k >= 0 && k < 4) P.trank_s[p] = cex[k]++;
        }
        __syncthreads();  // the next chunk reuses the scan's buffer
      }
      // D: sweep keys and the first acceptance
      float key_min0 = pinf;
      for (int p = own.p0; p < own.p1; ++p) {
        const int f = P.flag_s[p];
        if (!(f & F_TIED)) continue;
        const float key = __fsub_rn(
            P.score_s[p],
            __fdiv_rn(__fmul_rn(__int2float_rn(P.trank_s[p]),
                                P.delta_s[class_of(P.node_value, p, V)]),
                      P.num_s[p]));
        P.key_s[p] = key;
        if (key > r_nontied) {
          P.flag_s[p] = (unsigned char)(f | F_ACC0);
          key_min0 = fminf(key_min0, key);
        }
      }
      key_min0 = block_allreduce<15>(key_min0, MinF());
      // E: guard: after its own placement a lane must not outscore the
      // smallest accepted key, or it would be picked again mid-sweep
      float bad_key = ninf;
      for (int p = own.p0; p < own.p1; ++p) {
        if (!(P.flag_s[p] & F_ACC0)) continue;
        const int* u = P.used + (size_t)p * C;
        const int cls = class_of(P.node_value, p, V);
        const float score2 = score_node(
            free_frac(u[0] + 2 * dem[0], P.usable[2 * p]),
            free_frac(u[1] + 2 * dem[1], P.usable[2 * p + 1]), P.coll[p] + 1, count_f,
            P.affinity_present[p], P.affinity[p], active,
            __fsub_rn(P.boosts_s[cls], P.delta_s[cls]));
        if (!(score2 <= key_min0)) bad_key = fmaxf(bad_key, P.key_s[p]);
      }
      bad_key = block_allreduce<16>(bad_key, MaxF());
      // F: final acceptance
      int acc = 0;
      for (int p = own.p0; p < own.p1; ++p) {
        const int f = P.flag_s[p];
        if ((f & F_ACC0) && P.key_s[p] > bad_key) {
          P.flag_s[p] = (unsigned char)(f | F_ACC);
          acc += 1;
        }
      }
      n_acc = block_allreduce<17>(acc, SumI());
    }

    if (n_acc > 1) {
      // sweep: the accepted lanes in merged order, then place a prefix
      if (tid == 0) s_count = 0;
      for (int c = tid; c <= V; c += THREADS) P.hits_s[c] = 0;
      __syncthreads();
      for (int p = own.p0; p < own.p1; ++p) {
        const int f = P.flag_s[p];
        if (!(f & F_ACC)) continue;
        const int slot = atomicAdd(&s_count, 1);
        const unsigned visit = (unsigned)(p + ((f & F_DEFER) ? N : 0));
        P.sort_s[slot] =
            ((unsigned long long)float_order(-P.key_s[p]) << 32) | (unsigned long long)visit;
      }
      int P2 = 1;
      while (P2 < n_acc) P2 <<= 1;
      __syncthreads();
      for (int k = n_acc + tid; k < P2; k += THREADS) P.sort_s[k] = ~0ull;
      __syncthreads();
      for (int k = 2; k <= P2; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int i = tid; i < P2; i += THREADS) {
            const int ixj = i ^ j;
            if (ixj > i) {
              const unsigned long long x = P.sort_s[i], y = P.sort_s[ixj];
              if (((i & k) == 0) == (x > y)) {
                P.sort_s[i] = y;
                P.sort_s[ixj] = x;
              }
            }
          }
          __syncthreads();
        }
      }
      const int take = min(remaining, n_acc);
      for (int r = tid; r < take; r += THREADS) {
        const int visit = (int)(unsigned)(P.sort_s[r] & 0xffffffffull);
        const int p = visit >= N ? visit - N : visit;
        if (placed + r < P.a_pad) P.placements[placed + r] = P.perm[p];
        for (int c = 0; c < C; ++c) P.used[(size_t)p * C + c] += dem[c];
        P.coll[p] += 1;
        const int v = P.node_value[p];
        if (v >= 0 && v < V) atomicAdd(&P.hits_s[v], 1);
      }
      __syncthreads();
      if (tid == 0 && active) {
        for (int c = 0; c < V; ++c) {
          const int hit = __ldcg(&P.hits_s[c]);
          P.counts[c] += hit;
          if (hit > 0) P.present[c] = 1;
        }
      }
      placed += take;
    } else {
      // fill: the winner's trajectory under j further self-placements,
      // with every other node frozen; j = 0 is granted
      const int* ub = P.used + (size_t)b * C;
      const int* capb = P.capacity + (size_t)b * C;
      const float used0_f = __int2float_rn(ub[0]), used1_f = __int2float_rn(ub[1]);
      const float dem0_f = __int2float_rn(dem[0]), dem1_f = __int2float_rn(dem[1]);
      const float coll_bf = __int2float_rn(P.coll[b]);
      const int cls_b = class_of(P.node_value, b, V);
      const float boost_b = P.boosts_s[cls_b], delta_b = P.delta_s[cls_b];
      const bool affp_b = P.affinity_present[b];
      const float aff_b = affp_b ? P.affinity[b] : 0.0f;
      int first_bad = RUNCAP;
      for (int j = tid; j < RUNCAP; j += THREADS) {
        if (j == 0) continue;
        bool ok = false;
        if (!P.even_mode) {
          const float jf = __int2float_rn(j);
          const float jf1 = __fadd_rn(jf, 1.0f);
          const float fc = __fsub_rn(1.0f, __fdiv_rn(__fadd_rn(used0_f, __fmul_rn(jf1, dem0_f)),
                                                     P.usable[2 * b]));
          const float fm = __fsub_rn(1.0f, __fdiv_rn(__fadd_rn(used1_f, __fmul_rn(jf1, dem1_f)),
                                                     P.usable[2 * b + 1]));
          const float coll_j = __fadd_rn(coll_bf, jf);
          const bool ap = coll_j > 0.0f;
          const float an = anti_affinity(coll_j, ap, count_f);
          const float sp = __fsub_rn(boost_b, __fmul_rn(jf, delta_b));
          const bool fired = active && sp != 0.0f;
          const float num = __fadd_rn(__fadd_rn(__fadd_rn(1.0f, ap ? 1.0f : 0.0f),
                                                affp_b ? 1.0f : 0.0f),
                                      fired ? 1.0f : 0.0f);
          const float traj = __fdiv_rn(
              __fadd_rn(__fadd_rn(__fadd_rn(binpack_f32(fc, fm), an), aff_b), fired ? sp : 0.0f),
              num);
          ok = fits(ub, capb, dem, j + 1, C) && traj > r_other && j < remaining;
        }
        if (!ok) first_bad = min(first_bad, j);
      }
      first_bad = block_allreduce<18>(first_bad, MinI());
      const int run = min(first_bad, remaining);
      const int node_b = P.perm[b];
      for (int j = tid; j < run; j += THREADS)
        if (placed + j < P.a_pad) P.placements[placed + j] = node_b;
      if (tid == 0) {
        for (int c = 0; c < C; ++c) P.used[(size_t)b * C + c] += run * dem[c];
        P.coll[b] += run;
        if (active && cls_b < V) {
          P.counts[cls_b] += run;
          if (run > 0) P.present[cls_b] = 1;
        }
      }
      placed += run;
    }
  }
  if (tid == 0) *P.rounds = rounds;
}

}  // namespace

extern "C" int ntt_runs(const void* capacity, const void* usable, const void* feasible,
                        const void* affinity, const void* affinity_present,
                        const void* group_count, const void* node_value,
                        const void* spread_desired, const void* spread_implicit,
                        const void* spread_weight_frac, const void* spread_even,
                        const void* spread_active, const void* perm, const void* demand,
                        const void* n_allocs, void* used, void* coll, void* counts,
                        void* present, void* placements, void* rounds, void* score_s,
                        void* num_s, void* key_s, void* trank_s, void* flag_s, void* sort_s,
                        void* boosts_s, void* delta_s, void* hits_s, int N, int C, int V,
                        int a_pad, int even_mode, void* stream) {
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
              (float*)score_s,
              (float*)num_s,
              (float*)key_s,
              (int*)trank_s,
              (unsigned char*)flag_s,
              (unsigned long long*)sort_s,
              (float*)boosts_s,
              (float*)delta_s,
              (int*)hits_s,
              N,
              C,
              V,
              a_pad,
              even_mode};
  runs_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
