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
// exact scan, it is latency-bound: a round costs its slowest lane's walk,
// two grid barriers and the commit between them. Design: ONE persistent
// launch of W thread block clusters of Q blocks of 1024 threads, both a
// cluster dimension and the cooperative attribute (cudaLaunchKernelEx), so
// that grid.sync() is defined. Q is the largest power of two (at most 16)
// for which the card co-schedules W such clusters
// (cudaOccupancyMaxActiveClusters); where W clusters of one block do not
// fit, as many as fit take the lanes in turn.
//
// Before the first round every lane's read-only inputs (group, eval, ring,
// limit, count, flags) are gathered into two 16-byte records, so that a
// lane's selection and the conflict test start from one load, and a
// cluster loads its next lane while the round's last barrier completes.
//
// A round: cluster c selects lane i + c with the exact scan's walk. It walks
// the eval's ring from the cursor in chunks of Q x 1024 x 4 rotated
// positions (a first chunk of 256 a block where the limit is small), split
// evenly and in order across its blocks and, within a block, in runs of up
// to 4 a thread. A thread loads its positions' nodes and feasibility
// together and a feasible node's planes after them, so an infeasible node
// costs one byte (a multi-tenant group is feasible on about one node in
// eight). One packed block scan per chunk and a push of the block totals
// into every block's shared memory (cluster.cuh) give every position its
// rotated fit and nonpositive counts, and the walk stops after the chunk
// in which the window fills. Only a walk that exhausts the ring replays
// its deferred options. Scores stay in registers: each block
// reduces its candidates (first strict max in visit order, the last
// returned rank and, for M > 1, its best M - 1 keys) and writes them to a
// per-lane slot in global memory, with the deferred options. Grid barrier
// 1. Then every block combines each lane's Q slots (a warp per lane), runs
// the W x W conflict test itself (one pass over its threads) and so knows
// the committed prefix and the next lane; cluster c folds the winner of
// lane i + c, if committed, into the state with atomics (the committed
// winners are distinct nodes: an earlier committed winner is infeasible for
// every later committed lane's group, and integer adds commute) and moves
// its eval's cursor (at most one committed lane of an eval does). Grid
// barrier 2 orders the folds before the next round's reads; no read can
// race a fold with fewer barriers, because every cluster reads the state
// that every other cluster folds. The state is read with ld.global.cg from
// L2. Block 0's thread 0 counts the rounds and, when given a counter, the
// ring positions the committed lanes walked.
//
// Measured (PERF.md): nomad_tpu_torch/tools/wavefront_round_sweep.py times
// a round against the ring and the limit and splits it by clock64 stamps
// (NTT_STAMP, empty unless the tool defines it);
// nomad_tpu_torch/tools/wavefront_variants.py times this kernel against
// half the cluster, no stop at the window and block 0's serial fold.
//
// Ties: slot 0 of a lane's candidates is its winner in visit order; slots
// 1..M-1 are the first M-1 of the M best scores, ties to the lower ring
// position (lax.top_k's order), as keys (order(score) << 32 | ~position).
// A stopped walk has no replays, so no position past it is a candidate.
//
// Paths chosen at launch where a budget ends: more than SMEM_CLASSES spread
// classes take each position's boost from the classes' count range (one
// block reduction a lane, score.cuh) instead of a shared array; more than
// REG_M candidates a lane keep each thread's best M - 1 keys (at most as many
// as it can see in one walk) in a sorted list in global memory, and the
// block takes its best M - 1 from the lists' heads, one reduction each; a
// window whose W x (8 + M) record ints exceed SMEM_INTS keeps each block's
// copy of the records in global memory.
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

// resource columns a lane keeps in registers
constexpr int MAX_C = 6;
// spread classes whose V + 1 boosts live in each block's shared memory
// (shared with the window's lane records after the selection)
constexpr int SMEM_CLASSES = 49152;
// ints of the window's lane records a block keeps in shared memory
constexpr int SMEM_INTS = 49152;
// candidates per lane for the conflict test whose best M - 1 keys a thread
// keeps in registers
constexpr int REG_M = 4;
constexpr int MAX_Q = 16;
// ring positions a thread takes in a full chunk: a chunk is Q x 1024 x UPT
constexpr int UPT = 4;
// a small limit's first chunk: 256 positions a block
constexpr int SMALL_PER_BLOCK = 256;

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
  int* rounds;                            // [1] out
  long long* walked;                      // [1] or null: += the committed lanes' walks
  // each lane's read-only inputs, gathered once before the first round:
  // (group, eval, ring, limit) and (count as float bits, active | valid << 1)
  int4* lane_info;                        // [A, 2]
  // per-lane slots of one round, written before grid barrier 1
  unsigned long long* blk_keys;           // [W, Q, M-1] each block's best keys (0: none)
  int4* blk_best;                         // [W, Q] each block's Best
  int4* lane_meta;                        // [W] valid, deferred to replay (-1: walk stopped),
                                          // walked, the eval's cursor at the round's start
  int4* lane_def;                         // [W, MAX_SKIP] deferred options by nonpositive rank
  int* rec_g;                             // [blocks, W * (8 + M)] records, past SMEM_INTS
  unsigned long long* tkeys_g;            // [blocks * THREADS, lt] key lists, past REG_M
  int N, C, G, V, E, A, W, M;
  int lt;                                 // a thread's key list, past REG_M
  bool rows4;                             // C == 4 and used, capacity 16-byte aligned
  bool boosts_smem, recs_smem;
};

// One alloc lane's read-only inputs, as loaded: a cluster loads its next
// lane before the round's last barrier and reads the fields after it
struct Lane {
  int4 info;  // group, eval, ring, limit
  int4 aux;   // count as float bits, active | valid << 1
  int dem[MAX_C];
  __device__ bool valid() const { return aux.y & 2; }
  __device__ bool active() const { return aux.y & 1; }
  __device__ float count_f() const { return __int_as_float(aux.x); }
};

// From the lanes' gathered inputs (one level of loads); the demand loads
// are independent of them
__device__ __forceinline__ Lane load_lane(const WaveParams& P, int i) {
  Lane L = {};
  if (i >= P.A) return L;
  L.info = __ldcg(P.lane_info + 2 * i);
  L.aux = __ldcg(P.lane_info + 2 * i + 1);
#pragma unroll
  for (int c = 0; c < MAX_C; ++c)
    L.dem[c] = c < P.C ? __ldg(P.demands + (size_t)i * P.C + c) : 0;
  return L;
}

// A node's used row (from L2: other SMs fold into it) and capacity row
__device__ __forceinline__ void load_rows(const WaveParams& P, int node, int (&uv)[MAX_C],
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

// position key of the top-M order: higher score first, then lower position
__device__ __forceinline__ unsigned long long top_key(float score, int p) {
  return ((unsigned long long)float_order(score) << 32) |
         (unsigned long long)(0xffffffffu - (unsigned)p);
}

__device__ __forceinline__ int4 pack(const Best& b) {
  return make_int4(__float_as_int(b.s), b.visit, b.pos, b.last);
}
__device__ __forceinline__ Best unpack(int4 v) { return {__int_as_float(v.x), v.y, v.z, v.w}; }

// The largest of ``keys`` (M - 1 of them, descending) below ``prev``, or 0
__device__ __forceinline__ unsigned long long key_below(const unsigned long long (&keys)[REG_M - 1],
                                                        int m1, unsigned long long prev) {
  unsigned long long k = 0ull;
#pragma unroll
  for (int t = REG_M - 2; t >= 0; --t)
    if (t < m1 && keys[t] < prev) k = keys[t];
  return k;
}

// Cluster-wide selection of lane ``L`` (the window's k-th) against the
// round-start state: every block of the cluster calls it; it writes the
// lane's per-block slots. ``par`` is the parity of the count slots,
// carried from lane to lane of the round, so that a chunk's pushes never
// land in slots a slower block still reads.
template <int Q, bool FAST>
__device__ void select_lane(const WaveParams& P, cg::cluster_group& cluster, unsigned rank,
                            const Lane& L, int k, int& par, int (*counts_s)[Q], float* boosts_s) {
  constexpr int CHUNK = Q * THREADS * UPT;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int N = P.N, V = P.V, m1 = P.M - 1;

  Best best = best_identity();
  unsigned long long keys[REG_M - 1];  // this thread's best candidate keys, descending
#pragma unroll
  for (int t = 0; t < REG_M - 1; ++t) keys[t] = 0ull;
  // past REG_M: this thread's sorted list in global memory, and its length
  const bool reg_keys = FAST || P.M <= REG_M;
  unsigned long long* tk = P.tkeys_g + ((size_t)blockIdx.x * THREADS + tid) * P.lt;
  int tn = 0;
  ClassRange range = {};  // the classes' count range, without shared boosts
  int run_fit = 0, run_np = 0, walked = 0, off = 0;
  bool full = false;  // the window filled: the walk stopped there
  if (L.valid()) {
    const int g = L.info.x, e = L.info.y, ring = L.info.z, limit = L.info.w;
    const bool active = L.active();
    const int* permrow = P.perm + (size_t)e * N;
    const size_t gN = (size_t)g * N;
    off = __ldcg(P.offset + e);
    const int first = limit + MAX_SKIP <= 64 ? Q * SMALL_PER_BLOCK : CHUNK;
    for (int base = 0, len = first; base == 0 || base < ring; base += len, len = CHUNK) {
      // the chunk's positions, split evenly and in order across the blocks,
      // and within a block in runs of ``upt`` a thread
      const int span = max(min(len, ring - base), 0);
      walked += span;
      const int per = (span + Q - 1) / Q;
      const int upt = (per + THREADS - 1) / THREADS;
      const int r0 = base + (int)rank * per + tid * upt;  // this thread's first rotated rank
      const int n_mine = max(min(upt, min(per, span - (int)rank * per) - tid * upt), 0);
      // the positions' nodes and feasibility, all in flight together; a
      // feasible node's planes after them
      int node[UPT];
      bool feas[UPT];
#pragma unroll
      for (int u = 0; u < UPT; ++u) {
        int p = off + r0 + u;
        if (p >= ring) p -= ring;
        node[u] = u < n_mine ? __ldg(permrow + p) : 0;
      }
#pragma unroll
      for (int u = 0; u < UPT; ++u) feas[u] = u < n_mine && __ldg(P.feasible + gN + node[u]);
      if (base == 0 && active) {
        // the boosts of the round's spread counts, behind the loads above
        if (FAST || P.boosts_smem) {
          if (warp == 0)
            class_boosts_warp(P.spread_counts + (size_t)g * V, P.spread_present + (size_t)g * V,
                              P.spread_desired + (size_t)g * V, __ldg(P.spread_implicit + g),
                              __ldg(P.spread_weight_frac + g), __ldg(P.spread_even + g), true, V,
                              -1, boosts_s);
          __syncthreads();
        } else {
          range = block_allreduce<4>(class_range_part(P.spread_counts + (size_t)g * V,
                                                      P.spread_present + (size_t)g * V, V, -1,
                                                      tid, THREADS),
                                     ClassRangeOp());
        }
      }
      float sc[UPT];
      unsigned fit_bits = 0, np_bits = 0;
#pragma unroll
      for (int u = 0; u < UPT; ++u) {
        sc[u] = 0.0f;
        if (!feas[u]) continue;
        const int n = node[u];
        int uv[MAX_C], cv[MAX_C];
        load_rows(P, n, uv, cv);
        const float us0 = __ldg(P.usable + 2 * n), us1 = __ldg(P.usable + 2 * n + 1);
        const int coll = __ldcg(P.collisions + gN + n);
        const bool aff_p = __ldg(P.affinity_present + gN + n);
        const int v = active ? __ldg(P.node_value + gN + n) : -1;
        bool fit = true;
#pragma unroll
        for (int c = 0; c < MAX_C; ++c) fit &= uv[c] + L.dem[c] <= cv[c];
        if (!fit) continue;
        const int cls = v >= 0 ? min(v, V) : V;
        const float boost =
            !active ? 0.0f
            : FAST || P.boosts_smem
                ? boosts_s[cls]
                : class_boost_at(cls, P.spread_counts + (size_t)g * V, P.spread_desired + (size_t)g * V,
                                 __ldg(P.spread_implicit + g), __ldg(P.spread_weight_frac + g),
                                 __ldg(P.spread_even + g), true, V, -1, range);
        sc[u] = score_node(free_frac(uv[0] + L.dem[0], us0), free_frac(uv[1] + L.dem[1], us1),
                           coll, L.count_f(), aff_p, aff_p ? __ldg(P.affinity + gN + n) : 0.0f,
                           active, boost);
        fit_bits |= 1u << u;
        np_bits |= (unsigned)(sc[u] <= 0.0f) << u;
      }

      // rotated counts: this block's scan, then the blocks before it
      int x[1] = {(__popc(fit_bits) << 16) | __popc(np_bits)}, excl[1], tot[1];
      block_scan<1, 0>(x, excl, tot);
      cluster_publish(cluster, counts_s[par], rank, tot[0], Q);
      cluster.sync();
      int before, chunk;
      published_prefix_sum(counts_s[par], Q, rank, before, chunk);
      int fit_r = run_fit + (before >> 16) + (excl[0] >> 16);
      int np_r = run_np + (before & 0xffff) + (excl[0] & 0xffff);
#pragma unroll
      for (int u = 0; u < UPT; ++u) {
        if (!(fit_bits >> u & 1)) continue;
        const bool np = np_bits >> u & 1;
        ++fit_r;
        np_r += np;
        const int r = r0 + u;
        int p = off + r;
        if (p >= ring) p -= ring;
        if (np && np_r <= MAX_SKIP) {
          P.lane_def[k * MAX_SKIP + np_r - 1] = make_int4(__float_as_int(sc[u]), r, node[u], p);
        } else if (fit_r - min(np_r, MAX_SKIP) <= limit) {
          best = BestOp()(best, Best{sc[u], r, node[u], r});
          unsigned long long key = top_key(sc[u], p);
          if (reg_keys) {
#pragma unroll
            for (int t = 0; t < REG_M - 1; ++t) {
              if (t < m1 && key > keys[t]) {
                const unsigned long long y = keys[t];
                keys[t] = key;
                key = y;
              }
            }
          } else if (tn < P.lt || key > tk[tn - 1]) {
            // insert into the descending list, the last one dropped when full
            int at = tn < P.lt ? tn++ : tn - 1;
            while (at > 0 && tk[at - 1] < key) {
              tk[at] = tk[at - 1];
              --at;
            }
            tk[at] = key;
          }
        }
      }
      run_fit += chunk >> 16;
      run_np += chunk & 0xffff;
      par ^= 1;
      full = run_fit - min(run_np, MAX_SKIP) >= limit;
      if (full) break;  // no later position is returned, deferred or replayed
    }
  }
  best = block_allreduce<1>(best, BestOp());
  if (tid == 0) P.blk_best[k * Q + rank] = pack(best);
  // this block's best M - 1 keys, one reduction each (keys are unique:
  // from a list, the thread whose head wins moves past it)
  unsigned long long prev = ~0ull;
  int head = 0;
  for (int t = 0; t < m1; ++t) {
    __syncthreads();  // the previous reduction's partials are read
    const unsigned long long mine =
        reg_keys ? key_below(keys, m1, prev) : head < tn ? tk[head] : 0ull;
    const unsigned long long kb = block_allreduce<2>(mine, MaxU64());
    if (!reg_keys && kb != 0ull && mine == kb) ++head;
    if (tid == 0) P.blk_keys[((size_t)k * Q + rank) * m1 + t] = kb;
    prev = kb;
  }
  if (rank == 0 && tid == 0) {
    const int replays = min(min(run_np, MAX_SKIP), L.info.w - (run_fit - min(run_np, MAX_SKIP)));
    P.lane_meta[k] = make_int4(L.valid(), full ? -1 : max(replays, 0), walked, off);
  }
}

// The window's lanes after grid barrier 1, as every block sees them
struct Window {
  int* node;      // [W] the winner, or -1
  int* flags;     // [W] placed | advances << 1
  int* consumed;  // [W] ring positions consumed
  int* g;         // [W] group
  int* e;         // [W] eval
  int* walked;    // [W] ring positions walked
  int* ring;      // [W] the eval's ring
  int* start;     // [W] the eval's cursor at the round's start
  int* topn;      // [W, M] candidate nodes, or -1
};

// Warp ``warp`` combines its lanes' Q block slots and deferred options into
// the lane's result and candidates, in this block's shared memory. ``pre``
// is lane i + warp's gathered inputs, loaded before grid barrier 1.
template <int Q>
__device__ void combine_lanes(const WaveParams& P, int i, const Window& S, int4 pre) {
  const int l = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int N = P.N, M = P.M, m1 = M - 1;
  for (int k = warp; k < P.W; k += WARPS) {
    const int4 info = k == warp ? pre : __ldcg(P.lane_info + 2 * min(i + k, P.A - 1));
    const int g = info.x, e = info.y, ring = info.z;
    const int4 meta = __ldcg(P.lane_meta + k);
    Best b = l < Q ? unpack(__ldcg(P.blk_best + k * Q + l)) : best_identity();
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) b = BestOp()(b, shfl_xor(b, m));
    // the ring ran out before the limit: replay the first deferred options
    // after every returned one (lanes 0..MAX_SKIP-1 each load one)
    const int4 o = l < meta.y ? __ldcg(P.lane_def + k * MAX_SKIP + l) : int4{};
    for (int d = 0; d < meta.y; ++d) {
      const int4 od = make_int4(__shfl_sync(FULL_MASK, o.x, d), __shfl_sync(FULL_MASK, o.y, d),
                                __shfl_sync(FULL_MASK, o.z, d), 0);
      b = BestOp()(b, Best{__int_as_float(od.x), od.y + N, od.z, -1});
    }
    const bool valid = meta.x != 0;
    const bool place = valid && b.visit != INT_MAX;
    // StaticIterator.seen: ring positions through the limit-th returned
    // option, or the whole ring
    const int consumed = !valid ? 0 : meta.y < 0 ? b.last + 1 : ring;
    const bool advances = valid && consumed % max(ring, 1) != 0;
    const int node = place ? b.pos : -1;
    // candidates 1..M-1: the best keys of the Q blocks and the replays
    unsigned long long prev = ~0ull;
    for (int t = 0; t < m1; ++t) {
      unsigned long long kb = 0ull;
      for (int s = l; s < Q * m1 + max(meta.y, 0); s += 32) {
        unsigned long long key;
        if (s < Q * m1) {
          key = __ldcg(P.blk_keys + (size_t)k * Q * m1 + s);
        } else {
          const int4 o = __ldcg(P.lane_def + k * MAX_SKIP + s - Q * m1);
          key = top_key(__int_as_float(o.x), o.w);
        }
        if (key < prev && key > kb) kb = key;
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) kb = MaxU64()(kb, shfl_xor(kb, m));
      prev = kb;
      if (l == 0) {
        const int p = (int)(0xffffffffu - (unsigned)(kb & 0xffffffffull));
        S.topn[k * M + 1 + t] = place && kb != 0ull ? __ldg(P.perm + (size_t)e * N + p) : -1;
      }
    }
    if (l == 0) {
      S.node[k] = node;
      S.flags[k] = (place ? 1 : 0) | (advances ? 2 : 0);
      S.consumed[k] = consumed;
      S.g[k] = g;
      S.e[k] = e;
      S.walked[k] = meta.z;
      S.ring[k] = ring;
      S.start[k] = meta.w;
      S.topn[k * M] = node;
    }
  }
}

// Fold committed lane ``k`` (lane i + k) into the state: one thread
__device__ void fold_lane(const WaveParams& P, int i, int k, const Window& S) {
  const int lane = i + k;
  if (lane >= P.A) return;
  const int best = S.node[k], flags = S.flags[k], g = S.g[k];
  P.placements[lane] = best;
  if (flags & 1) {
    const int* dem = P.demands + (size_t)lane * P.C;
    for (int c = 0; c < P.C; ++c) atomicAdd(P.used + (size_t)best * P.C + c, __ldg(dem + c));
    atomicAdd(P.collisions + (size_t)g * P.N + best, 1);
    const int v = __ldg(P.node_value + (size_t)g * P.N + best);
    if (__ldg(P.spread_active + g) && v >= 0 && v < P.V) {
      atomicAdd(P.spread_counts + (size_t)g * P.V + v, 1);
      P.spread_present[(size_t)g * P.V + v] = 1;
    }
  }
  // at most one committed lane of an eval advances its cursor
  if (flags & 2) P.offset[S.e[k]] = (S.start[k] + S.consumed[k]) % max(S.ring[k], 1);
}

// FAST: the boosts in shared memory and the keys in registers (at most
// SMEM_CLASSES classes, REG_M candidates), the other paths compiled out
template <int Q, bool FAST>
__global__ void __launch_bounds__(THREADS) wavefront_kernel(WaveParams P) {
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  NTT_STAMP_DECL;
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5;
  const int cid = blockIdx.x / Q, ncl = gridDim.x / Q;  // this cluster, the clusters
  const int W = P.W, M = P.M, A = P.A;

  // the boosts during the selection, the window's lanes after it (or this
  // block's copy of them in global memory)
  extern __shared__ int dyn_s[];
  float* boosts_s = reinterpret_cast<float*>(dyn_s);
  int* rec = P.recs_smem ? dyn_s : P.rec_g + (size_t)blockIdx.x * W * (8 + M);
  const Window S = {rec,         rec + W,     rec + 2 * W, rec + 3 * W, rec + 4 * W,
                    rec + 5 * W, rec + 6 * W, rec + 7 * W, rec + 8 * W};
  __shared__ int counts_s[2][Q];  // packed chunk totals, by chunk parity
  __shared__ int first_block;

  // every lane's read-only inputs in two 16-byte records, so that a lane's
  // selection and the conflict test start from one load; and the lanes
  // after the last valid one, which place nothing: the drive stops there
  int stop = 0;
  for (int a = blockIdx.x * THREADS + tid; a < A; a += gridDim.x * THREADS) {
    const int g = __ldg(P.groups + a), e = __ldg(P.group_eval + g);
    const bool valid = __ldg(P.valid + a);
    P.lane_info[2 * a] = make_int4(g, e, __ldg(P.ring + e), __ldg(P.limits + a));
    P.lane_info[2 * a + 1] = make_int4(__float_as_int(__int2float_rn(__ldg(P.group_count + g))),
                                       (int)__ldg(P.spread_active + g) | (valid ? 2 : 0), 0, 0);
  }
  for (int a = tid; a < A; a += THREADS)
    if (__ldg(P.valid + a)) stop = a + 1;
  stop = block_allreduce<3>(stop, MaxI());
  grid.sync();
  int i = 0, rounds = 0;
  long long walked = 0;
  Lane next = load_lane(P, cid);
  while (i < stop) {
    NTT_STAMP(0);
    int par = 0;
    for (int k = cid; k < W; k += ncl) {
      if (k != cid) {
        __syncthreads();  // the last lane's reduction partials are read
        next = load_lane(P, i + k);
      }
      select_lane<Q, FAST>(P, cluster, rank, next, k, par, counts_s, boosts_s);
    }
    // lane i + warp's inputs for the conflict test, loaded across the barrier
    const int4 pre = warp < W ? __ldcg(P.lane_info + 2 * min(i + warp, A - 1)) : int4{};
    NTT_STAMP(1);
    grid.sync();
    NTT_STAMP(2);
    if (tid == 0) first_block = W;
    combine_lanes<Q>(P, i, S, pre);
    __syncthreads();
    // lane j is blocked by an earlier lane a whose candidate node is
    // feasible for j's group, or which advances j's eval's cursor
    for (int q = tid; q < W * W; q += THREADS) {
      const int j = q / W, a = q % W;
      if (a >= j) continue;
      bool conf = (S.flags[a] & 2) && S.e[a] == S.e[j];
      for (int t = 0; t < M && !conf; ++t) {
        const int n = S.topn[a * M + t];
        conf = n >= 0 && __ldg(P.feasible + (size_t)S.g[j] * P.N + n);
      }
      if (conf) atomicMin(&first_block, j);
    }
    __syncthreads();
    const int count = max(first_block, 1);
    for (int k = cid; k < count; k += ncl)
      if (rank == 0 && tid == 0) fold_lane(P, i, k, S);
    if (blockIdx.x == 0 && tid == 0) {
      if (P.walked)
        for (int k = 0; k < count; ++k) walked += S.walked[k];
      ++rounds;
    }
    i += count;
    // the next round's first lane of this cluster, loaded across the barrier
    next = load_lane(P, i + cid);
    NTT_STAMP(3);
    grid.sync();  // the folds land before any block reads the state again
    NTT_STAMP(4);
  }
  NTT_STAMP_FLUSH;
  if (blockIdx.x == 0 && tid == 0) {
    *P.rounds = rounds;
    if (P.walked) *P.walked += walked;
  }
}

// The cluster size and count of one launch: (Q, clusters, shared bytes),
// where the boosts and records live, each thread's key list, and the
// global scratch it needs past the round's lane slots
struct Shape {
  int q, clusters;
  size_t smem;
  bool boosts_smem, recs_smem, fast;
  int lt;
  size_t rec_ints, key_ints;
};

template <int Q, bool FAST>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[2], int clusters,
                      size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (Q > 8)
    err = cudaFuncSetAttribute(wavefront_kernel<Q, FAST>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wavefront_kernel<Q, FAST>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg = {};
  cfg.gridDim = dim3(Q * clusters);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return err;
}

// clusters of Q blocks the card co-schedules
template <int Q, bool FAST>
cudaError_t max_clusters(size_t smem, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t err = configure<Q, FAST>(cfg, attr, 1, smem, nullptr);
  cfg.numAttrs = 1;  // the query takes the cluster dimension alone
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(n, wavefront_kernel<Q, FAST>, &cfg);
  return err;
}

template <bool FAST>
cudaError_t max_clusters_any(int q, size_t smem, int* n) {
  switch (q) {
    case 16: return max_clusters<16, FAST>(smem, n);
    case 8: return max_clusters<8, FAST>(smem, n);
    case 4: return max_clusters<4, FAST>(smem, n);
    case 2: return max_clusters<2, FAST>(smem, n);
    default: return max_clusters<1, FAST>(smem, n);
  }
}

// The largest Q for which W clusters fit at once; at Q = 1, as many
// clusters as fit (the lanes taken in turn)
int pick_shape(int N, int W, int V, int M, Shape* s) {
  if (N < 1 || W < 1 || M < 1 || V < 0) return (int)cudaErrorInvalidValue;
  s->boosts_smem = V <= SMEM_CLASSES;
  s->recs_smem = (long long)W * (8 + M) <= SMEM_INTS;
  s->smem = (size_t)max(s->boosts_smem ? V + 1 : 0, s->recs_smem ? W * (8 + M) : 0) * sizeof(int);
  s->fast = s->boosts_smem && M <= REG_M;
  for (int q = MAX_Q; q >= 1; q /= 2) {
    int n = 0;
    const cudaError_t err =
        s->fast ? max_clusters_any<true>(q, s->smem, &n) : max_clusters_any<false>(q, s->smem, &n);
    if (err != cudaSuccess) return (int)err;
    if (n >= W || q == 1) {
      if (n < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
      s->q = q;
      s->clusters = min(W, n);
      const size_t blocks = (size_t)q * s->clusters;
      s->rec_ints = s->recs_smem ? 0 : blocks * W * (8 + M);
      // a thread sees at most UPT positions a chunk, and a walk at most one
      // chunk more than the ring's full chunks
      const long long seen = (long long)UPT * (2 + N / (q * THREADS * UPT));
      s->lt = M <= REG_M ? 0 : (int)min((long long)M - 1, seen);
      s->key_ints = blocks * THREADS * s->lt * 2;
      return 0;
    }
  }
  return (int)cudaErrorCooperativeLaunchTooLarge;
}

template <int Q, bool FAST>
int launch(const WaveParams& P, const Shape& s, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t err = configure<Q, FAST>(cfg, attr, s.clusters, s.smem, stream);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, wavefront_kernel<Q, FAST>, P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool FAST>
int launch_any(const WaveParams& P, const Shape& s, cudaStream_t st) {
  switch (s.q) {
    case 16: return launch<16, FAST>(P, s, st);
    case 8: return launch<8, FAST>(P, s, st);
    case 4: return launch<4, FAST>(P, s, st);
    case 2: return launch<2, FAST>(P, s, st);
    default: return launch<1, FAST>(P, s, st);
  }
}

}  // namespace

// ints of the round's per-lane slots
size_t slot_ints(int W, int M) {
  return (size_t)W * MAX_Q * (M - 1) * 2 + (size_t)W * MAX_Q * 4 + (size_t)W * 4 +
         (size_t)W * MAX_SKIP * 4;
}

// (Q, clusters, ints of scratch) of a launch over N nodes for a window of W
// lanes with M candidates over V spread classes; the scratch holds the
// round's per-lane slots and, past the shared-memory budgets, the blocks'
// records and the threads' key lists
extern "C" int ntt_wavefront_shape(void* out, int N, int W, int V, int M, void* stream) {
  (void)stream;
  Shape s;
  const int rc = pick_shape(N, W, V, M, &s);
  if (rc != 0) return rc;
  ((long long*)out)[0] = s.q;
  ((long long*)out)[1] = s.clusters;
  ((long long*)out)[2] = (long long)(slot_ints(W, M) + s.rec_ints + s.key_ints);
  return 0;
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
                             void* placements, void* rounds, void* walked, void* lane_info,
                             void* scratch, int N, int C, int G, int V, int E, int A, int W, int M,
                             void* stream) {
  if (C < 2 || C > MAX_C) return (int)cudaErrorInvalidValue;
  Shape s;
  const int rc = pick_shape(N, W, V, M, &s);
  if (rc != 0) return rc;
  // the slots: 8-byte keys first, then 16-byte records; then the threads'
  // key lists and the blocks' window records
  unsigned long long* keys = (unsigned long long*)scratch;
  int4* blk_best = (int4*)(keys + (size_t)W * MAX_Q * (M - 1));
  int4* lane_meta = blk_best + (size_t)W * MAX_Q;
  int4* lane_def = lane_meta + W;
  unsigned long long* tkeys = (unsigned long long*)((int*)scratch + slot_ints(W, M));
  int* rec_g = (int*)scratch + slot_ints(W, M) + s.key_ints;
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
               (int*)rounds,
               (long long*)walked,
               (int4*)lane_info,
               keys,
               blk_best,
               lane_meta,
               lane_def,
               rec_g,
               tkeys,
               N,
               C,
               G,
               V,
               E,
               A,
               W,
               M,
               s.lt,
               C == 4 && (((uintptr_t)used | (uintptr_t)capacity) & 15) == 0,
               s.boosts_smem,
               s.recs_smem};
  return s.fast ? launch_any<true>(P, s, (cudaStream_t)stream)
                : launch_any<false>(P, s, (cudaStream_t)stream);
}
