// Wavefront placement: per round, the as-if selections of a window of W
// lanes, then the longest conflict-free prefix committed, in one launch.
//
// Replaces nomad_tpu/tpu/wavefront.py _plan_batch_wavefront_jit (:300), with
// its vmapped selection _select (:217) and the tournament reductions
// _tsum ... _rot_incl_t (:171-206). Each round selects W lanes (i .. i+W-1)
// against the round-start state, exactly as the exact scan's step selects
// (exact_scan.cu: fit, score, limit window with up to MAX_SKIP nonpositive
// options deferred and replayed, first strict max in visit order). Lane j
// is blocked when an earlier lane's top-M candidate node is feasible for
// j's group, or an earlier lane advances the ring cursor of j's eval; the
// lanes before the first blocked one commit (at least one), and their
// winners are folded into used / collisions / spread counts and cursors.
//
// What bounds it on the card: the rounds are sequential, so, like the
// exact scan, it is latency-bound. Its gain over the scan is that a round
// commits up to W lanes for the price of about one step. Design: ONE
// persistent cooperative launch of B <= W blocks of 1024 threads (all
// co-resident, checked before the launch). Block b selects lanes b, b+B,
// ... of the window, one block over the whole node axis per lane, with the
// scan's packed block scan and packed reduction. A grid barrier; then block
// 0 builds the W x W conflict test, commits the prefix and scatters the
// state; a second grid barrier, and the next round. The loop runs inside
// the kernel: no host round trip per round; the round count lands in a
// device int32. Data one block writes and another reads after a barrier
// (state, the lanes' selections, the next lane) are read with __ldcg, from
// L2.
//
// Ties: slot 0 of a lane's candidates is its winner in visit order; slots
// 1..M-1 are the first M-1 of the M best scores, ties to the lower ring
// position (lax.top_k's order), found by M-1 block reductions of
// (order(score) << 32 | ~position) below the previous key.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "block.cuh"
#include "score.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ntt;

struct WaveParams {
  const int* capacity;                    // [N,C]
  const float* usable;                    // [N,2]
  const unsigned char* feasible;          // [G,N]
  const float* affinity;                  // [G,N]
  const unsigned char* affinity_present;  // [G,N]
  const int* group_count;                 // [G]
  const int* group_eval;                  // [G]
  const int* node_value;                  // [G,N]
  const float* spread_desired;            // [G,V]
  const float* spread_implicit;           // [G]
  const float* spread_weight_frac;        // [G]
  const unsigned char* spread_even;       // [G]
  const unsigned char* spread_active;     // [G]
  const int* perm;                        // [E,N]
  const int* ring;                        // [E]
  const int* demands;                     // [A,C]
  const int* groups;                      // [A]
  const int* limits;                      // [A]
  const unsigned char* valid;             // [A]
  int* used;                              // [N,C] state, updated in place
  int* collisions;                        // [G,N]
  int* spread_counts;                     // [G,V]
  unsigned char* spread_present;          // [G,V]
  int* offset;                            // [E]
  int* placements;                        // [A] out, -1 on entry
  int* ctrl;                              // [2]: next lane, rounds; 0 on entry
  int* lane_best;                         // [W] winner node or -1
  int* lane_flags;                        // [W] placed | advances << 1
  int* lane_consumed;                     // [W] ring positions consumed
  int* lane_topn;                         // [W,M] candidate nodes or -1
  float* score_s;                         // [B,N] scratch
  unsigned char* flag_s;                  // [B,N] scratch
  float* boosts_s;                        // [B,V+1] scratch
  int* counts_s;                          // [B,V] scratch
  unsigned char* present_s;               // [B,V] scratch
  int N, C, G, V, E, A, W, M;
};

// position key of the top-M order: higher score first, then lower position
__device__ __forceinline__ unsigned long long top_key(float score, int p) {
  return ((unsigned long long)float_order(score) << 32) | (unsigned long long)(0xffffffffu - (unsigned)p);
}

// One lane's as-if selection against the round-start state, by the whole
// block; writes the lane's winner, flags, consumption and candidates.
__device__ void select_lane(const WaveParams& P, int lane, int k) {
  const int tid = threadIdx.x;
  const int N = P.N, C = P.C, V = P.V, M = P.M;
  const int blk = blockIdx.x;
  float* score_s = P.score_s + (size_t)blk * N;
  unsigned char* flag_s = P.flag_s + (size_t)blk * N;
  float* boosts = P.boosts_s + (size_t)blk * (V + 1);

  if (lane >= P.A || !P.valid[lane]) {  // places nothing, moves no cursor
    if (tid == 0) {
      P.lane_best[k] = -1;
      P.lane_flags[k] = 0;
      P.lane_consumed[k] = 0;
    }
    for (int t = tid; t < M; t += THREADS) P.lane_topn[(size_t)k * M + t] = -1;
    return;
  }
  const int g = P.groups[lane];
  const int e = P.group_eval[g];
  const int ring = P.ring[e];
  const int limit = P.limits[lane];
  const int* dem = P.demands + (size_t)lane * C;
  const int* permrow = P.perm + (size_t)e * N;
  const size_t gN = (size_t)g * N;
  const bool active = P.spread_active[g];
  const float count_f = __int2float_rn(P.group_count[g]);
  const ChunkRange own = chunk_of(N);
  if (tid == 0) {
    int* cnt = P.counts_s + (size_t)blk * V;
    unsigned char* pres = P.present_s + (size_t)blk * V;
    for (int c = 0; c < V; ++c) {
      cnt[c] = __ldcg(P.spread_counts + (size_t)g * V + c);
      pres[c] = __ldcg(P.spread_present + (size_t)g * V + c);
    }
    class_boosts(cnt, pres, P.spread_desired + (size_t)g * V, P.spread_implicit[g],
                 P.spread_weight_frac[g], P.spread_even[g], active, V, boosts);
  }
  __syncthreads();  // boosts are visible
  const int off = __ldcg(P.offset + e);

  int cnt[4] = {0, 0, 0, 0};  // fit, nonpositive, and both before the cursor
  for (int p = own.p0; p < own.p1; ++p) {
    const int node = permrow[p];
    const int* u = P.used + (size_t)node * C;
    bool fit = p < ring && P.feasible[gN + node];
    for (int c = 0; fit && c < C; ++c)
      fit = __ldcg(u + c) + dem[c] <= P.capacity[(size_t)node * C + c];
    float sc = 0.0f;
    if (fit) {
      const int v = P.node_value[gN + node];
      sc = score_node(free_frac(__ldcg(u) + dem[0], P.usable[2 * node]),
                      free_frac(__ldcg(u + 1) + dem[1], P.usable[2 * node + 1]),
                      __ldcg(P.collisions + gN + node), count_f, P.affinity_present[gN + node],
                      P.affinity[gN + node], active, boosts[v >= 0 ? min(v, V) : V]);
    }
    const bool nonpos = fit && sc <= 0.0f;
    score_s[p] = sc;
    flag_s[p] = (unsigned char)(fit | (nonpos << 1));
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

  Best best = best_identity();
  int run_fit = excl[0], run_np = excl[1];
  for (int p = own.p0; p < own.p1; ++p) {
    const int f = flag_s[p];
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
      flag_s[p] = (unsigned char)(f | 4);  // a candidate
      const Best c = {score_s[p], rot + (replay ? N : 0), p, best.last};
      best = BestOp()(best, c);
    }
  }
  best = block_allreduce<1>(best, BestOp());
  const bool found = best.visit != INT_MAX;

  // candidates 1..M-1: the first M-1 keys of the top-M order
  unsigned long long prev = ~0ull;
  for (int t = 0; t + 1 < M; ++t) {
    __syncthreads();  // the previous reduction's partials are read
    unsigned long long kb = 0ull;
    for (int p = own.p0; p < own.p1; ++p) {
      if (!(flag_s[p] & 4)) continue;
      const unsigned long long key = top_key(score_s[p], p);
      if (key < prev && key > kb) kb = key;
    }
    kb = block_allreduce<2>(kb, MaxU64());
    prev = kb;
    if (tid == 0) {
      const int p = (int)(0xffffffffu - (unsigned)(kb & 0xffffffffull));
      P.lane_topn[(size_t)k * M + 1 + t] = found && kb != 0ull ? permrow[p] : -1;
    }
  }
  if (tid == 0) {
    const int best_node = found ? permrow[best.pos] : -1;
    const int consumed = n_returned >= limit ? best.last + 1 : ring;
    const bool advances = consumed % max(ring, 1) != 0;
    P.lane_best[k] = best_node;
    P.lane_flags[k] = (found ? 1 : 0) | (advances ? 2 : 0);
    P.lane_consumed[k] = consumed;
    P.lane_topn[(size_t)k * M] = best_node;
  }
}

// Block 0: the conflict test over the window, the committed prefix, and
// the state scatters of its placed lanes.
__device__ void commit_round(const WaveParams& P, int i) {
  __shared__ int first_block;
  const int tid = threadIdx.x;
  const int N = P.N, C = P.C, V = P.V, W = P.W, M = P.M, A = P.A;
  if (tid == 0) first_block = W;
  __syncthreads();
  // lane j is blocked by an earlier lane a whose candidate node is
  // feasible for j's group, or which advances j's eval's cursor
  for (int q = tid; q < W * W; q += THREADS) {
    const int j = q / W, a = q % W;
    if (a >= j) continue;
    const int gj = P.groups[min(i + j, A - 1)];
    const int flags = __ldcg(P.lane_flags + a);
    bool conf = false;
    if (flags & 2) conf = P.group_eval[P.groups[min(i + a, A - 1)]] == P.group_eval[gj];
    for (int t = 0; t < M && !conf; ++t) {
      const int n = __ldcg(P.lane_topn + (size_t)a * M + t);
      conf = n >= 0 && P.feasible[(size_t)gj * N + n];
    }
    if (conf) atomicMin(&first_block, j);
  }
  __syncthreads();
  const int count = max(first_block, 1);
  for (int k = tid; k < count; k += THREADS) {
    const int lane = i + k;
    if (lane >= A) continue;
    const int best = __ldcg(P.lane_best + k);
    const int flags = __ldcg(P.lane_flags + k);
    P.placements[lane] = best;
    const int g = P.groups[lane];
    if (flags & 1) {
      const int* dem = P.demands + (size_t)lane * C;
      for (int c = 0; c < C; ++c) atomicAdd(P.used + (size_t)best * C + c, dem[c]);
      atomicAdd(P.collisions + (size_t)g * N + best, 1);
      const int v = P.node_value[(size_t)g * N + best];
      if (P.spread_active[g] && v >= 0 && v < V) {
        atomicAdd(P.spread_counts + (size_t)g * V + v, 1);
        P.spread_present[(size_t)g * V + v] = 1;
      }
    }
    // at most one committed lane of an eval advances its cursor
    if (flags & 2) {
      const int e = P.group_eval[g];
      P.offset[e] = (__ldcg(P.offset + e) + __ldcg(P.lane_consumed + k)) % max(P.ring[e], 1);
    }
  }
  if (tid == 0) {
    P.ctrl[0] = i + count;
    P.ctrl[1] += 1;
  }
}

__global__ void __launch_bounds__(THREADS) wavefront_kernel(WaveParams P) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  // lanes after the last valid one place nothing: the drive stops there
  int stop = 0;
  for (int a = tid; a < P.A; a += THREADS)
    if (P.valid[a]) stop = a + 1;
  stop = block_allreduce<3>(stop, MaxI());
  while (true) {
    const int i = __ldcg(P.ctrl);
    if (i >= stop) break;
    for (int k = blockIdx.x; k < P.W; k += gridDim.x) {
      __syncthreads();  // the previous lane's scratch and partials are read
      select_lane(P, i + k, k);
    }
    grid.sync();
    if (blockIdx.x == 0) commit_round(P, i);
    grid.sync();
  }
}

// blocks of the persistent launch: one per lane of the window, at most
// as many as the card holds at once
int grid_blocks(int W, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wavefront_kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks = max(1, min(W, per_sm * sms));
  return 0;
}

}  // namespace

extern "C" int ntt_wavefront_grid(void* blocks, int W, void* stream) {
  (void)stream;
  return grid_blocks(W, (int*)blocks);
}

extern "C" int ntt_wavefront(const void* capacity, const void* usable, const void* feasible,
                             const void* affinity, const void* affinity_present,
                             const void* group_count, const void* group_eval,
                             const void* node_value, const void* spread_desired,
                             const void* spread_implicit, const void* spread_weight_frac,
                             const void* spread_even, const void* spread_active, const void* perm,
                             const void* ring, const void* demands, const void* groups,
                             const void* limits, const void* valid, void* used, void* collisions,
                             void* spread_counts, void* spread_present, void* offset,
                             void* placements, void* ctrl, void* lane_best, void* lane_flags,
                             void* lane_consumed, void* lane_topn, void* score_s, void* flag_s,
                             void* boosts_s, void* counts_s, void* present_s, int N, int C, int G,
                             int V, int E, int A, int W, int M, int B, void* stream) {
  int fits = 0;
  const int rc = grid_blocks(W, &fits);
  if (rc != 0) return rc;
  if (B < 1 || B > fits) return (int)cudaErrorCooperativeLaunchTooLarge;
  WaveParams P{(const int*)capacity,
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
               (int*)ctrl,
               (int*)lane_best,
               (int*)lane_flags,
               (int*)lane_consumed,
               (int*)lane_topn,
               (float*)score_s,
               (unsigned char*)flag_s,
               (float*)boosts_s,
               (int*)counts_s,
               (unsigned char*)present_s,
               N,
               C,
               G,
               V,
               E,
               A,
               W,
               M};
  void* kargs[] = {&P};
  return (int)cudaLaunchCooperativeKernel((const void*)wavefront_kernel, dim3(B), dim3(THREADS),
                                          kargs, 0, (cudaStream_t)stream);
}
