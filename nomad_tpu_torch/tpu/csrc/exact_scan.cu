// Exact sequential placement scan: one step per alloc lane, in one launch.
//
// Replaces nomad_tpu/tpu/kernel.py _plan_batch_jit (:361) and its step
// _step (:265). Each step scores every ring position for the alloc's group
// (score.cuh), opens the limit window with up to MAX_SKIP nonpositive
// options deferred and replayed (select.go:35-67), takes the first strict
// max in visit order, and folds the placement into used / collisions /
// spread counts and the eval's ring cursor before the next step.
//
// What bounds it on the card: the A steps are strictly sequential, so the
// kernel is latency-bound, not bytes- or operations-bound (its planes,
// about 1 MB at 10K nodes, stay in L2). Design: ONE block of 1024 threads
// owns the whole node axis, the loop over steps runs inside the kernel
// (no host round trip per step), and a step costs three block barriers: the
// setup, one packed scan (the fit and nonpositive counts together, which
// gives every rotated count the step needs) and one packed reduction
// (winner and last returned rank together).
//
// The window needs no second scan: the deferred options are the first
// MAX_SKIP nonpositive ones in rotation order, so the rotated count of
// kept options at p is fit_r(p) - min(nonpos_r(p), MAX_SKIP), and the
// number returned is min(kept_total, limit).
#include <cuda_runtime.h>

#include "block.cuh"
#include "score.cuh"

namespace {

using namespace ntt;

struct ExactParams {
  const int* capacity;                 // [N,C]
  const float* usable;                 // [N,2]
  const unsigned char* feasible;       // [G,N]
  const float* affinity;               // [G,N]
  const unsigned char* affinity_present;  // [G,N]
  const int* group_count;              // [G]
  const int* group_eval;               // [G]
  const int* node_value;               // [G,N]
  const float* spread_desired;         // [G,V]
  const float* spread_implicit;        // [G]
  const float* spread_weight_frac;     // [G]
  const unsigned char* spread_even;    // [G]
  const unsigned char* spread_active;  // [G]
  const int* perm;                     // [E,N]
  const int* ring;                     // [E]
  const int* demands;                  // [A,C]
  const int* groups;                   // [A]
  const int* limits;                   // [A]
  const unsigned char* valid;          // [A]
  int* used;                           // [N,C] state, updated in place
  int* collisions;                     // [G,N]
  int* spread_counts;                  // [G,V]
  unsigned char* spread_present;       // [G,V]
  int* offset;                         // [E]
  int* placements;                     // [A] out
  float* score_s;                      // [N] scratch
  unsigned char* flag_s;               // [N] scratch
  float* boosts_s;                     // [V+1] scratch
  int N, C, G, V, E, A;
};

__global__ void __launch_bounds__(THREADS) exact_scan_kernel(ExactParams P) {
  const int tid = threadIdx.x;
  const int N = P.N, C = P.C, V = P.V;
  const ChunkRange own = chunk_of(N);

  for (int i = 0; i < P.A; ++i) {
    // an invalid lane places nothing and leaves the cursor where it is
    if (!P.valid[i]) {
      if (tid == 0) P.placements[i] = -1;
      continue;
    }
    const int g = P.groups[i];
    const int e = P.group_eval[g];
    const int ring = P.ring[e];
    const int limit = P.limits[i];
    const int* dem = P.demands + (size_t)i * C;
    const int* permrow = P.perm + (size_t)e * N;
    const size_t gN = (size_t)g * N;
    const bool active = P.spread_active[g];
    const float count_f = __int2float_rn(P.group_count[g]);
    if (tid == 0)
      class_boosts(P.spread_counts + (size_t)g * V, P.spread_present + (size_t)g * V,
                   P.spread_desired + (size_t)g * V, P.spread_implicit[g],
                   P.spread_weight_frac[g], P.spread_even[g], active, V, P.boosts_s);
    __syncthreads();  // boosts, and the previous step's state, are visible
    const int off = P.offset[e];

    // fit and score per ring position; counts: fit, nonpositive, and both
    // again before the cursor (the rotated counts' offsets)
    int cnt[4] = {0, 0, 0, 0};
    for (int p = own.p0; p < own.p1; ++p) {
      const int node = permrow[p];
      const int* u = P.used + (size_t)node * C;
      const bool fit = p < ring && P.feasible[gN + node] &&
                       fits(u, P.capacity + (size_t)node * C, dem, 1, C);
      float sc = 0.0f;
      if (fit) {
        const int v = P.node_value[gN + node];
        sc = score_node(free_frac(u[0] + dem[0], P.usable[2 * node]),
                        free_frac(u[1] + dem[1], P.usable[2 * node + 1]),
                        P.collisions[gN + node], count_f, P.affinity_present[gN + node],
                        P.affinity[gN + node], active, P.boosts_s[v >= 0 ? min(v, V) : V]);
      }
      const bool nonpos = fit && sc <= 0.0f;
      P.score_s[p] = sc;
      P.flag_s[p] = (unsigned char)(fit | (nonpos << 1));
      cnt[0] += fit;
      cnt[1] += nonpos;
      if (p < off) {
        cnt[2] += fit;
        cnt[3] += nonpos;
      }
    }
    int excl[4], tot[4];
    block_scan<4, 0>(cnt, excl, tot);
    const int tot_fit = tot[0], tot_np = tot[1], xoff_fit = tot[2], xoff_np = tot[3];
    const int kept_total = tot_fit - min(tot_np, MAX_SKIP);
    const int n_returned = max(min(kept_total, limit), 0);
    const int need = max(limit - n_returned, 0);

    // candidates: returned options in rotation order, then the deferred
    // ones replayed when the ring ran out before the limit
    Best best = best_identity();
    int run_fit = excl[0], run_np = excl[1];
    for (int p = own.p0; p < own.p1; ++p) {
      const int f = P.flag_s[p];
      const int fit = f & 1, np = (f >> 1) & 1;
      run_fit += fit;
      run_np += np;
      if (!fit) continue;
      const int fit_r = rot_incl(run_fit, xoff_fit, tot_fit, p, off);
      const int np_r = rot_incl(run_np, xoff_np, tot_np, p, off);
      const bool skipped = np && np_r <= MAX_SKIP;
      const bool returned = !skipped && fit_r - min(np_r, MAX_SKIP) <= limit;
      const bool replay = skipped && np_r <= need;
      const int rot = p >= off ? p - off : ring - off + p;
      if (returned) best.last = max(best.last, rot);
      if (returned || replay) {
        const Best c = {P.score_s[p], rot + (replay ? N : 0), p, best.last};
        best = BestOp()(best, c);
      }
    }
    best = block_allreduce<1>(best, BestOp());

    if (tid == 0) {
      int best_node = -1;
      if (best.visit != INT_MAX) {
        best_node = permrow[best.pos];
        for (int c = 0; c < C; ++c) P.used[(size_t)best_node * C + c] += dem[c];
        P.collisions[gN + best_node] += 1;
        const int v = P.node_value[gN + best_node];
        if (active && v >= 0 && v < V) {
          P.spread_counts[(size_t)g * V + v] += 1;
          P.spread_present[(size_t)g * V + v] = 1;
        }
      }
      P.placements[i] = best_node;
      // StaticIterator.seen: ring positions through the limit-th returned
      // option, or the whole ring
      const int consumed = n_returned >= limit ? best.last + 1 : ring;
      P.offset[e] = (off + consumed) % max(ring, 1);
    }
  }
}

}  // namespace

extern "C" int ntt_exact_scan(const void* capacity, const void* usable, const void* feasible,
                              const void* affinity, const void* affinity_present,
                              const void* group_count, const void* group_eval,
                              const void* node_value, const void* spread_desired,
                              const void* spread_implicit, const void* spread_weight_frac,
                              const void* spread_even, const void* spread_active,
                              const void* perm, const void* ring, const void* demands,
                              const void* groups, const void* limits, const void* valid,
                              void* used, void* collisions, void* spread_counts,
                              void* spread_present, void* offset, void* placements,
                              void* score_s, void* flag_s, void* boosts_s, int N, int C, int G,
                              int V, int E, int A, void* stream) {
  ExactParams P{(const int*)capacity,
                (const float*)usable,
                (const unsigned char*)feasible,
                (const float*)affinity,
                (const unsigned char*)affinity_present,
                (const int*)group_count,
                (const int*)group_eval,
                (const int*)node_value,
                (const float*)spread_desired,
                (const float*)spread_implicit,
                (const float*)spread_weight_frac,
                (const unsigned char*)spread_even,
                (const unsigned char*)spread_active,
                (const int*)perm,
                (const int*)ring,
                (const int*)demands,
                (const int*)groups,
                (const int*)limits,
                (const unsigned char*)valid,
                (int*)used,
                (int*)collisions,
                (int*)spread_counts,
                (unsigned char*)spread_present,
                (int*)offset,
                (int*)placements,
                (float*)score_s,
                (unsigned char*)flag_s,
                (float*)boosts_s,
                N,
                C,
                G,
                V,
                E,
                A};
  exact_scan_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// message for a status the C entry points return (shared by the library)
extern "C" const char* ntt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
