// Exact sequential placement scan: one step per alloc lane, in one launch
// of one thread block cluster.
//
// Replaces nomad_tpu/tpu/kernel.py _plan_batch_jit (:361) and its step
// _step (:265). Each step scores the ring positions of the alloc's eval for
// its group (score.cuh), opens the limit window with up to MAX_SKIP
// nonpositive options deferred and replayed (select.go:35-67), takes the
// first strict max in visit order, and folds the placement into used /
// collisions / spread counts and the eval's ring cursor before the next
// step.
//
// What bounds it on the card: the A steps are strictly sequential, so the
// kernel is bound by the latency of a step, not by bytes or operations (its
// planes, about 1 MB at 10K nodes, stay in L2). A step's latency is its
// dependent loads (cursor, ring position, node planes), its barriers and
// the serial work between them.
//
// Design: ONE cluster of SCAN_CLUSTER blocks of 1024 threads, one block per
// SM, with the loop over steps inside the kernel. A step walks the eval's
// ring from its cursor in chunks of CHUNK = SCAN_CLUSTER x 1024 rotated
// positions, at most one position a thread: a chunk's positions are split
// evenly and in order across the blocks, so a 10,000-node ring gives each
// block 625. A step whose limit is small walks a first chunk of 4,096
// (first_chunk). Per chunk, one packed block scan counts the fit and the
// nonpositive options (the two together in one int), and the blocks swap
// their totals through distributed shared memory after a cluster barrier;
// that gives every position its rotated fit and nonpositive counts, so its
// role (kept and returned, deferred, or past the window) is known. The walk
// stops after the chunk in which the kept options reach the step's limit:
// no later position changes the placement, the carry or the cursor (the
// cursor advances through the limit-th returned option). Only a walk that
// exhausts the ring replays the deferred options, which their threads
// record in every block's shared memory by their nonpositive rank (at
// most MAX_SKIP).
// A full-ring limit costs one chunk at 10K nodes; a limit of 14 one chunk
// of 4,096 however large the ring, unless fewer than 1 in 64 positions fit.
//
// After the walk, each block reduces its candidates (first strict max in
// visit order, plus the last returned rank) and publishes them; after a
// second cluster barrier every warp reduces the cluster's candidates, so
// every thread knows the winner and the eval's new cursor. Exchanges are
// pushes (cluster.cuh): each block stores its totals, its candidates and
// its deferred options into every block's shared memory before the
// barrier, and every warp reads its own block's copy after it; pulling
// from all 32 warps of every block queued at each block's shared memory
// and cost more than the step's scoring. Between the second cluster
// barrier's arrive and its wait every thread loads the next lane's
// read-only inputs (its group, eval, ring, limit and demand), so the next
// step's dependent loads are the ring position and the node's planes (one
// 16-byte load for a 4-column row).
//
// Two cluster barriers a step, not three: the placement is written late.
// Thread 0 of block 0 alone writes it to used, collisions and the spread
// counts in global memory, as atomics whose results are unused (no round
// trip), right after the NEXT step's first-chunk barrier, when every block
// has gathered that chunk. So the next step's first-chunk reads never see
// it (they precede that barrier's arrive, which has release semantics at
// cluster scope, and the write follows its wait, which has acquire
// semantics), and every thread adds it itself: the demand to the winning
// node's used row, one collision where the group is the same, one count to
// its spread class in the boosts. The step's second barrier orders the
// write before every later read; a walk that goes on to a second chunk
// first takes one more cluster barrier. The mutable state is read with
// ld.global.cg from L2, so no SM's L1 holds a stale line. The spread boosts
// (V+1 values) are computed by warp 0 of every block into its own shared
// memory, behind the first chunk's loads. Where V + 1 boosts do not fit a
// block's shared memory (more than SMEM_CLASSES classes), every thread of
// each block reduces a share of the classes to the counts' min and max
// (one block reduction a step) and each position computes its own class's
// boost from them, its count read from L2.
//
// Block 0's thread 0 counts the positions of every chunk walked and, when
// given a counter, adds them to it.
//
// Measured (PERF.md, nomad_tpu_torch/tools/scan_step_sweep.py): a step
// costs a fixed latency of barriers and dependent loads plus the gather and
// scoring of its chunk. nomad_tpu_torch/tools/scan_variants.py times this
// kernel against a cluster of 8, an immediate placement write with a third
// barrier, and no short first chunk: each is slower where it applies.
//
// Integer counts and the max with an index tie-break combine in any order,
// so the result is bit-identical to the one-block scan and the plain
// version.
#include <cuda_runtime.h>

#include "block.cuh"
#include "cluster.cuh"
#include "score.cuh"

namespace {

using namespace ntt;

// blocks of the cluster: 16 is a non-portable size (the launch allows it
// explicitly); it was measured against the portable 8 (PERF.md)
constexpr int SCAN_CLUSTER = 16;
constexpr int CHUNK = SCAN_CLUSTER * THREADS;
// A step whose window holds at most 64 options first walks 4,096
// positions (256 a block): unless fewer than 1 in 64 of them fit, its window
// fills there, and it gathers and scores a quarter of a chunk
constexpr int SMALL_CHUNK = 4096;

__device__ constexpr int first_chunk(int limit) {
  return limit + MAX_SKIP <= 64 ? SMALL_CHUNK : CHUNK;
}
// resource columns the step keeps in registers
constexpr int MAX_C = 6;
// spread classes whose V + 1 boosts every block holds in shared memory
// (192 KB at most of the 227 KB a block of sm_90 may opt into); more take
// each position's boost from the classes' min and max count
constexpr int SMEM_CLASSES = 49152;
// returned by the entry point when the card cannot co-schedule the cluster
constexpr int CLUSTER_REFUSED = 0x4e5400;

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
  long long* walked;                   // [1] or null: += the ring positions walked
  int N, C, G, V, E, A;
  bool rows4;                          // C == 4 and used, capacity 16-byte aligned
};

// One alloc lane's read-only inputs, loaded ahead of its step
struct Lane {
  bool valid, active;
  int g, e, ring, limit;
  float count_f;
  int dem[MAX_C];
};

__device__ __forceinline__ Lane load_lane(const ExactParams& P, int i) {
  Lane L = {};
  L.valid = i < P.A && __ldg(P.valid + i);
  if (!L.valid) return L;
  L.g = __ldg(P.groups + i);
  L.limit = __ldg(P.limits + i);
#pragma unroll
  for (int c = 0; c < MAX_C; ++c)
    L.dem[c] = c < P.C ? __ldg(P.demands + (size_t)i * P.C + c) : 0;
  L.e = __ldg(P.group_eval + L.g);
  L.active = __ldg(P.spread_active + L.g);
  L.count_f = __int2float_rn(__ldg(P.group_count + L.g));
  L.ring = __ldg(P.ring + L.e);
  return L;
}

// A node's used row (from L2: block 0 writes it) and capacity row
__device__ __forceinline__ void load_rows(const ExactParams& P, int node, int (&uv)[MAX_C],
                                          int (&cv)[MAX_C]) {
  const int* u = P.used + (size_t)node * P.C;
  const int* cap = P.capacity + (size_t)node * P.C;
  if (P.rows4) {
    const int4 a = __ldcg(reinterpret_cast<const int4*>(u));
    const int4 b = __ldg(reinterpret_cast<const int4*>(cap));
    uv[0] = a.x, uv[1] = a.y, uv[2] = a.z, uv[3] = a.w;
    cv[0] = b.x, cv[1] = b.y, cv[2] = b.z, cv[3] = b.w;
#pragma unroll
    for (int c = 4; c < MAX_C; ++c) uv[c] = cv[c] = 0;
  } else {
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) {
      uv[c] = c < P.C ? __ldcg(u + c) : 0;
      cv[c] = c < P.C ? __ldg(cap + c) : 0;
    }
  }
}

// The last step's placement, which block 0 writes to global memory only
// after the next step's first gather; until then each reader adds it
struct Pending {
  int node;  // -1: none
  int g, lane;
  bool active;
};

// Block 0's thread 0 writes a placement to the state: atomics whose results
// are unused (no round trip); the next cluster barrier's release orders them
__device__ __forceinline__ void write_placement(const ExactParams& P, const Pending& w) {
  int* ub = P.used + (size_t)w.node * P.C;
  const int* dem = P.demands + (size_t)w.lane * P.C;
  for (int c = 0; c < P.C; ++c) atomicAdd(ub + c, __ldg(dem + c));
  const size_t gn = (size_t)w.g * P.N + w.node;
  atomicAdd(P.collisions + gn, 1);
  const int v = __ldg(P.node_value + gn);
  if (w.active && v >= 0 && v < P.V) {
    const size_t sv = (size_t)w.g * P.V + v;
    atomicAdd(P.spread_counts + sv, 1);
    P.spread_present[sv] = 1;
  }
}

// a deferred option: its score, rotated rank and node
struct Deferred {
  float s;
  int rot;
  int node;
};

// SMEM: the V + 1 boosts fit each block's shared memory
template <bool SMEM>
__global__ void __launch_bounds__(THREADS) exact_scan_kernel(ExactParams P) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5;
  const int N = P.N, C = P.C, V = P.V;
  const bool placer = rank == 0 && tid == 0;

  extern __shared__ float boosts_s[];        // [V+1] this block's copy
  // the slots every block publishes into (cluster.cuh)
  __shared__ int counts_s[2][SCAN_CLUSTER];  // packed chunk totals, by chunk parity
  __shared__ Best best_s[SCAN_CLUSTER];      // each block's candidates
  __shared__ Deferred deferred_s[MAX_SKIP];  // by nonpositive rank

  Pending pend = {-1, 0, 0, false};
  long long walked = 0;  // block 0's thread 0: the positions of every chunk walked
  int known_e = -1, known_off = 0;  // the last step's eval and its new cursor
  Lane next = load_lane(P, 0);
  for (int i = 0; i < P.A; ++i) {
    const Lane L = next;
    // an invalid lane places nothing and leaves the cursor where it is
    if (!L.valid) {
      if (placer) P.placements[i] = -1;
      next = load_lane(P, i + 1);
      continue;
    }
    const int g = L.g, e = L.e, ring = L.ring, limit = L.limit;
    const bool active = L.active;
    const int* permrow = P.perm + (size_t)e * N;
    const size_t gN = (size_t)g * N;
    const int off = e == known_e ? known_off : __ldcg(P.offset + e);

    int run_fit = 0, run_np = 0;  // fit and nonpositive counts of the chunks walked
    int bump = -1;                // the pending placement's class (without SMEM)
    ClassRange range = {};        // the classes' count range (without SMEM)
    bool full = false;            // the window filled: the walk stopped there
    Best best = best_identity();  // this thread's returned options
    // at least one chunk, so that the pending placement is written
    for (int base = 0, len = first_chunk(limit), par = 0; base == 0 || base < ring;
         base += len, len = CHUNK, par ^= 1) {
      // the chunk's positions, split evenly and in order across the blocks
      const int span = max(min(len, ring - base), 0);
      if (placer) walked += span;
      const int per = (span + SCAN_CLUSTER - 1) / SCAN_CLUSTER;
      const int k = (int)rank * per + tid;
      const int r = base + k;  // this thread's rotated rank
      const bool in = tid < per && k < span;
      int p = off + r;
      if (p >= ring) p -= ring;
      // gather the position's node and its planes, every load in flight before
      // any of them is used
      const int node = in ? __ldg(permrow + p) : 0;
      const bool hit = in && node == pend.node;  // the pending placement is not written yet
      int add[MAX_C], uv[MAX_C], cv[MAX_C];
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        add[c] = hit && c < C ? __ldg(P.demands + (size_t)pend.lane * C + c) : 0;
      if (in) load_rows(P, node, uv, cv);
      const bool feas = in && __ldg(P.feasible + gN + node);
      const float us0 = in ? __ldg(P.usable + 2 * node) : 1.0f;
      const float us1 = in ? __ldg(P.usable + 2 * node + 1) : 1.0f;
      const int coll = in ? __ldcg(P.collisions + gN + node) + (hit && pend.g == g) : 0;
      const bool aff_p = in && __ldg(P.affinity_present + gN + node);
      const float aff = in ? __ldg(P.affinity + gN + node) : 0.0f;
      const int v = in ? __ldg(P.node_value + gN + node) : -1;
      if (base == 0 && active) {
        // the boosts of this step's spread counts (plus the pending
        // placement's class), while the loads above are in flight
        if constexpr (SMEM) {
          if (warp == 0) {
            const int bump = pend.node >= 0 && pend.g == g ? __ldg(P.node_value + gN + pend.node)
                                                           : -1;
            class_boosts_warp(P.spread_counts + (size_t)g * V, P.spread_present + (size_t)g * V,
                              P.spread_desired + (size_t)g * V, __ldg(P.spread_implicit + g),
                              __ldg(P.spread_weight_frac + g), __ldg(P.spread_even + g), true, V,
                              bump >= 0 && bump < V ? bump : -1, boosts_s);
          }
          __syncthreads();
        } else {
          const int b = pend.node >= 0 && pend.g == g ? __ldg(P.node_value + gN + pend.node) : -1;
          bump = b >= 0 && b < V ? b : -1;
          range = block_allreduce<2>(class_range_part(P.spread_counts + (size_t)g * V,
                                                      P.spread_present + (size_t)g * V, V, bump,
                                                      tid, THREADS),
                                     ClassRangeOp());
        }
      }
      bool fit = feas;
      int u0 = 0, u1 = 0;
      if (in) {
#pragma unroll
        for (int c = 0; c < MAX_C; ++c) fit &= uv[c] + add[c] + L.dem[c] <= cv[c];
        u0 = uv[0] + add[0];
        u1 = uv[1] + add[1];
      }
      float sc = 0.0f;
      if (fit) {
        const int cls = v >= 0 ? min(v, V) : V;
        float boost = 0.0f;
        if constexpr (SMEM) {
          boost = active ? boosts_s[cls] : 0.0f;
        } else if (active) {
          // past the first chunk the pending placement is in the counts
          boost = class_boost_at(cls, P.spread_counts + (size_t)g * V,
                                 P.spread_desired + (size_t)g * V, __ldg(P.spread_implicit + g),
                                 __ldg(P.spread_weight_frac + g), __ldg(P.spread_even + g), true,
                                 V, base == 0 ? bump : -1, range);
        }
        sc = score_node(free_frac(u0 + L.dem[0], us0), free_frac(u1 + L.dem[1], us1), coll,
                        L.count_f, aff_p, aff, active, boost);
      }
      const bool np = fit && sc <= 0.0f;

      // rotated counts: this block's scan, then the blocks before it
      int x[1] = {((int)fit << 16) | (int)np}, excl[1], tot[1];
      block_scan<1, 0>(x, excl, tot);
      cluster_publish(cluster, counts_s[par], rank, tot[0], SCAN_CLUSTER);
      cluster.sync();
      // every block has gathered the first chunk: the pending placement
      // can land now
      const bool wrote = base == 0 && pend.node >= 0;
      if (wrote) {
        if (placer) write_placement(P, pend);
        pend.node = -1;
      }
      int before, chunk;
      published_prefix_sum(counts_s[par], SCAN_CLUSTER, rank, before, chunk);
      const int fit_r = run_fit + (before >> 16) + (excl[0] >> 16) + fit;
      const int np_r = run_np + (before & 0xffff) + (excl[0] & 0xffff) + np;
      if (fit) {
        if (np && np_r <= MAX_SKIP) {
          for (int k = 0; k < SCAN_CLUSTER; ++k)
            *cluster.map_shared_rank(&deferred_s[np_r - 1], k) = Deferred{sc, r, node};
        } else if (fit_r - min(np_r, MAX_SKIP) <= limit) {
          best = BestOp()(best, Best{sc, r, node, r});
        }
      }
      run_fit += chunk >> 16;
      run_np += chunk & 0xffff;
      if (run_fit - min(run_np, MAX_SKIP) >= limit) {
        full = true;
        break;
      }
      // the walk goes on: the placement must be in memory before the next
      // chunk's gathers
      if (wrote && base + len < ring) cluster.sync();
    }

    best = block_allreduce<1>(best, BestOp());
    cluster_publish(cluster, best_s, rank, best, SCAN_CLUSTER);
    // the candidates of every block; the next lane's read-only inputs load
    // while the barrier completes
    cluster_arrive();
    next = load_lane(P, i + 1);
    cluster_wait();
    // every warp reduces the cluster's candidates from its own block's slots
    Best b = published_best(best_s, SCAN_CLUSTER);
    if (!full) {
      // the ring ran out before the limit: replay the first ``need``
      // deferred options after every returned one
      const int need = limit - (run_fit - min(run_np, MAX_SKIP));
      const int n_def = min(min(run_np, MAX_SKIP), need);
      for (int k = 0; k < n_def; ++k) {
        const Deferred d = deferred_s[k];
        b = BestOp()(b, Best{d.s, d.rot + N, d.node, -1});
      }
    }
    // StaticIterator.seen: ring positions through the limit-th returned
    // option, or the whole ring
    const int consumed = full ? b.last + 1 : ring;
    known_e = e;
    known_off = (off + consumed) % max(ring, 1);
    const int best_node = b.visit != INT_MAX ? b.pos : -1;
    if (placer) {
      P.placements[i] = best_node;
      P.offset[e] = known_off;
    }
    pend = Pending{best_node, g, i, active};
  }
  if (placer && pend.node >= 0) write_placement(P, pend);
  if (placer && P.walked) *P.walked += walked;
  // no block leaves while another may still store into its shared memory
  cluster.sync();
}

template <bool SMEM>
int launch(const ExactParams& P, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (SCAN_CLUSTER > 8)
    err = cudaFuncSetAttribute(exact_scan_kernel<SMEM>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  // the boosts may take more than the default 48 KB of dynamic shared memory
  err = cudaFuncSetAttribute(exact_scan_kernel<SMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SCAN_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(SCAN_CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the card must hold the whole cluster at once, or the launch is refused
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, exact_scan_kernel<SMEM>, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return CLUSTER_REFUSED;
  err = cudaLaunchKernelEx(&cfg, exact_scan_kernel<SMEM>, P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
                              void* walked, int N, int C, int G, int V, int E, int A,
                              void* stream) {
  if (C < 2 || C > MAX_C || V < 0) return (int)cudaErrorInvalidValue;
  const bool boosts_smem = V <= SMEM_CLASSES;
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
                (long long*)walked,
                N,
                C,
                G,
                V,
                E,
                A,
                C == 4 && (((uintptr_t)used | (uintptr_t)capacity) & 15) == 0};
  return boosts_smem ? launch<true>(P, (size_t)(V + 1) * sizeof(float), (cudaStream_t)stream)
                     : launch<false>(P, 0, (cudaStream_t)stream);
}

// message for a status the C entry points return (shared by the library)
extern "C" const char* ntt_error_string(int code) {
  if (code == CLUSTER_REFUSED)
    return "the card cannot co-schedule the exact scan's cluster of blocks";
  if (code == CLUSTER_REFUSED + 1)
    return "the card cannot co-schedule the run planner's cluster of blocks";
  if (code == CLUSTER_REFUSED + 2)
    return "the card cannot co-schedule the windowed planner's cluster of blocks";
  return cudaGetErrorString((cudaError_t)code);
}
