// The three flat planners over a node axis split into S shards on one card.
//
// Replaces the sharded dispatch of nomad_tpu/tpu/kernel.py: the exact scan
// (_step :265, _plan_batch_jit :361) over shard.batch_specs(), the run
// planner (_plan_batch_runs_jit :716) over shard.run_specs() and the
// windowed planner (_plan_batch_windowed_jit :954) over
// shard.window_specs(), which the JAX package runs as the same programs
// under NamedSharding(P("nodes")) with GSPMD's collectives. Here the
// collectives are written by hand (mesh.cuh).
//
// Design: each planner is ONE cooperative launch (cudaLaunchCooperativeKernel)
// of S * Q blocks of 1024 threads, with its steps or rounds inside the
// kernel. Shard s's Q blocks own its slab's rows (and, for the exact scan
// and the windowed planner, the same range of ring positions) in order.
// A step or round is a chain of phases separated by grid barriers:
//
// - the exact scan (K5s), three barriers a step: (A) each block fits and
//   scores its own node rows into a global row plane; (B) each block reads
//   its ring positions' fit and score across the slabs (the gather GSPMD
//   does for final[perm]) and publishes its fit counts (all, and before
//   the cursor) and its first three nonpositive options in rotation order;
//   (C) each block ranks its positions along the ring (block scans rebased
//   by the exclusive scan of the earlier blocks' counts), marks returned
//   and replayed options and publishes its best candidate; then every
//   block folds the candidates (the cross-shard argmax on score, smallest
//   visit order first), and the owner of the winner's row adds its usage;
// - the run planner (K6s), positions in rotation order: the fit count, best
//   score and first nonpositive options; the first tied position in visit
//   order, the runner-ups and each class's tied counts; then, for a sweep,
//   the least accepted key, the guard's bad key, the accepted count, the
//   accepted lanes compacted into one global list and each lane's slot by
//   its rank in that list, and the class hits; a fill run is computed by
//   the winner's block and its length read by all. A tied position's rank
//   in its class is its class's tied positions in the earlier blocks (each
//   block's per-class counts, exchanged through global memory), chunks and
//   warps (a warp's positions grouped by class with __match_any_sync), so
//   it takes any number of spread classes;
// - the windowed planner (K7s), four barriers a round: rows scored, the
//   fit counts, the window keys by global atomicMax on (score, first feasible
//   rank) and the last consumed rank, then each window's winner scatters its
//   usage into the row's slab;
// - the wavefront drive (K11s, nomad_tpu/tpu/wavefront.py:300 under
//   shard.wavefront_specs()) is K5s's step with the wavefront's round rule
//   on top (mesh_exact_kernel<true>). A lane that no earlier lane of its
//   round blocks selects against the round-start state exactly what it
//   selects against the state the earlier lanes of the round leave (their
//   candidates are infeasible for its group and they leave its cursor
//   alone), so the kernel commits each lane as it selects it, in lane
//   order, and counts the rounds by the conflict rule: before its step a
//   lane is tested against the round's records (each earlier lane's eval,
//   whether it moved that eval's cursor, and its M candidate nodes, read
//   through feasible[g, node] on the shard that owns the node's column); a
//   blocked lane, or a lane past a full window of W, opens the next round.
//   The M - 1 extra candidates of a placed lane are M - 1 more folds of
//   (score, smallest ring position) over the lane's candidate positions,
//   each below the one before, as lax.top_k takes them. Every block keeps
//   its own copy of the round's records. The placements, the final state
//   and the rounds are the plain version's; the lanes of a round are not
//   scored side by side, so a round costs its lanes' steps.
//
// Every block keeps its own copy of the replicated state (spread counts,
// presence, ring cursors) and applies each update itself; block 0's copy is
// written out at the end. Integer counts and max/min folds combine in any
// order, and every float is the plain version's operation (score.cuh), so
// the result is bit-identical to the sharded and unsharded plain versions.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "block.cuh"
#include "mesh.cuh"
#include "score.cuh"

namespace {

using namespace ntt;

constexpr int MAXC = 8;         // resource columns kept in registers
constexpr int RUNCAP = 512;     // max placements resolved by one fill run
constexpr int WHICH_EXACT = 0, WHICH_RUNS = 1, WHICH_WINDOWED = 2, WHICH_WAVEFRONT = 3;

__host__ __device__ inline size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

// a bump allocator over the scratch buffer (host: sizes; device: pointers)
struct Carve {
  char* base;
  size_t at;
  template <class T>
  __host__ __device__ T* take(size_t n) {
    T* p = reinterpret_cast<T*>(base + at);
    at = align_up(at + n * sizeof(T));
    return p;
  }
};

__device__ __forceinline__ int rot_rank(int p, int off, int ring) {
  return p >= off ? p - off : ring - off + p;
}

// ===========================================================================
// K5s: the exact scan
// ===========================================================================

struct ExactP {
  Slabs<const int> capacity;                    // rows [R, C]
  Slabs<const float> usable;                    // rows [R, 2]
  Slabs<const unsigned char> feasible;          // cols [G, R]
  Slabs<const float> affinity;                  // cols [G, R]
  Slabs<const unsigned char> affinity_present;  // cols [G, R]
  const int* group_count;                       // [G]
  const int* group_eval;                        // [G]
  Slabs<const int> node_value;                  // cols [G, R]
  const float* spread_desired;                  // [G, V]
  const float* spread_implicit;                 // [G]
  const float* spread_weight_frac;              // [G]
  const unsigned char* spread_even;             // [G]
  const unsigned char* spread_active;           // [G]
  Slabs<const int> perm;                        // cols [E, R]
  const int* ring;                              // [E]
  const int* demands;                           // [A, C]
  const int* groups;                            // [A]
  const int* limits;                            // [A]
  const unsigned char* valid;                   // [A]
  Slabs<int> used;                              // rows [R, C], updated in place
  Slabs<int> collisions;                        // cols [G, R], updated in place
  int* spread_counts;                           // [G, V] in and out
  unsigned char* spread_present;                // [G, V] in and out
  int* offset;                                  // [E] in and out
  int* placements;                              // [A]
  int* rounds;                                  // [1] the wavefront's rounds (K11s)
  char* scratch;
  int S, Q, N, C, G, V, E, A;
  int W, M;                                     // the wavefront's window and top M (K11s)
};

// the fit counts and first nonpositive options of a block's positions
struct ExactP1 {
  int nfit, nbelow;
  Min3 np;
};
struct ExactP1Op {
  __device__ __forceinline__ ExactP1 operator()(ExactP1 a, ExactP1 b) const {
    return {a.nfit + b.nfit, a.nbelow + b.nbelow, Min3Op()(a.np, b.np)};
  }
};

struct ExactScratch {
  unsigned char* fit;  // [N] this step's fit per node row
  float* score;        // [N] this step's score per node row
  int* counts;         // [blocks][G*V] each block's spread counts
  unsigned char* present;
  int* offset;         // [blocks][E] each block's ring cursors
  ExactP1* p1;         // [blocks]
  Best* p2;            // [blocks]
  // K11s only (``record`` ints a lane of the round, 0 for K5s)
  unsigned char* cand;  // [N] this step's candidates per ring position
  Best* p3;             // [blocks] the extra candidates' folds, beside p2
  int* rec;             // [blocks][W * record] each block's records of the round
};

__host__ __device__ inline ExactScratch exact_scratch(char* base, int N, int G, int V, int E,
                                                      int blocks, int round_ints, size_t* bytes) {
  Carve c{base, 0};
  ExactScratch s;
  s.fit = c.take<unsigned char>(N);
  s.score = c.take<float>(N);
  s.counts = c.take<int>((size_t)blocks * G * V);
  s.present = c.take<unsigned char>((size_t)blocks * G * V);
  s.offset = c.take<int>((size_t)blocks * E);
  s.p1 = c.take<ExactP1>(blocks);
  s.p2 = c.take<Best>(blocks);
  s.cand = c.take<unsigned char>(round_ints ? N : 0);
  s.p3 = c.take<Best>(round_ints ? blocks : 0);
  s.rec = c.take<int>((size_t)blocks * round_ints);
  if (bytes) *bytes = c.at;
  return s;
}

// K5s (WAVE false) and K11s (WAVE true): one lane a step, in lane order
template <bool WAVE>
__global__ void __launch_bounds__(THREADS, 1) mesh_exact_kernel(const ExactP P) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int N = P.N, C = P.C, V = P.V, GV = P.G * P.V;
  const MeshGeo m = mesh_geo(P.S, P.Q, N);
  const int R = m.R;
  // a record of the round: the lane's eval, whether it moved the eval's
  // cursor, its M candidate nodes (-1: none)
  const int REC = WAVE ? 2 + P.M : 0;
  const ExactScratch X = exact_scratch(P.scratch, N, P.G, V, P.E, gridDim.x, P.W * REC, nullptr);
  int* my_rec = X.rec + (size_t)blockIdx.x * P.W * REC;
  // the wavefront stops at the last valid lane; n_round lanes of the
  // current round are recorded
  int stop = P.A, n_round = 0, rounds = 0;
  if (WAVE) {
    int last = 0;
    for (int k = tid; k < P.A; k += THREADS)
      if (__ldg(P.valid + k)) last = k + 1;
    stop = block_fold<5>(last, MaxI());
  }
  int* my_counts = X.counts + (size_t)blockIdx.x * GV;
  unsigned char* my_present = X.present + (size_t)blockIdx.x * GV;
  int* my_offset = X.offset + (size_t)blockIdx.x * P.E;
  for (int k = tid; k < GV; k += THREADS) {
    my_counts[k] = P.spread_counts[k];
    my_present[k] = P.spread_present[k];
  }
  for (int k = tid; k < P.E; k += THREADS) my_offset[k] = P.offset[k];
  grid.sync();  // every block has read the replicated inputs before block 0 writes them

  for (int i = 0; i < P.A; ++i) {
    if (WAVE && i >= stop) {
      if (blockIdx.x == 0 && tid == 0) P.placements[i] = -1;
      continue;  // past the last valid lane: no round reaches it
    }
    if (WAVE) {
      // the round rule: a full window, or an earlier lane of the round
      // whose candidates are feasible for this lane's group or that moved
      // this lane's eval's cursor, opens the next round
      const int g = __ldg(P.groups + i);
      const int e = __ldg(P.group_eval + g);
      bool blocked = n_round == P.W;
      for (int k = tid; k < n_round * P.M && !blocked; k += THREADS) {
        const int* r = my_rec + (k / P.M) * REC;
        const int node = r[2 + k % P.M];
        blocked = (k % P.M == 0 && r[1] && r[0] == e) ||
                  (node >= 0 && *col_at(P.feasible, g, node, R));
      }
      if (__syncthreads_or(blocked) || i == 0) {
        ++rounds;
        n_round = 0;
      }
      if (!__ldg(P.valid + i)) {
        if (blockIdx.x == 0 && tid == 0) P.placements[i] = -1;
        if (tid == 0) {
          int* r = my_rec + n_round * REC;
          r[0] = e;
          r[1] = 0;
          for (int k = 0; k < P.M; ++k) r[2 + k] = -1;
        }
        ++n_round;
        __syncthreads();
        continue;
      }
    }
    if (!__ldg(P.valid + i)) {
      if (blockIdx.x == 0 && tid == 0) P.placements[i] = -1;
      continue;  // places nothing, cursor unchanged
    }
    const int g = __ldg(P.groups + i);
    const int e = __ldg(P.group_eval + g);
    const int ring = __ldg(P.ring + e);
    const int limit = __ldg(P.limits + i);
    const int off = my_offset[e];
    int dem[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) dem[c] = c < C ? __ldg(P.demands + (size_t)i * C + c) : 0;
    const bool active = __ldg(P.spread_active + g);
    const float count_f = __int2float_rn(__ldg(P.group_count + g));
    const int* counts_g = my_counts + (size_t)g * V;
    const unsigned char* present_g = my_present + (size_t)g * V;

    // (A) fit and score of this block's node rows
    ClassRange range = {0.0f, 0.0f, 0};
    if (active) {
      range = class_range_part(counts_g, present_g, V, -1, tid, THREADS);
      range = block_fold<1>(range, ClassRangeOp());
    }
    for (int n = m.b0 + tid; n < m.b1; n += THREADS) {
      const int* cap = row_at(P.capacity, n, C, 0, R);
      const int* u = row_at(P.used, n, C, 0, R);
      bool fit = *col_at(P.feasible, g, n, R);
      int u0 = 0, u1 = 0;
      for (int c = 0; c < C; ++c) {
        const int uc = __ldcg(u + c);
        if (c == 0) u0 = uc;
        if (c == 1) u1 = uc;
        fit = fit && uc + dem[c] <= __ldg(cap + c);
      }
      const float* us = row_at(P.usable, n, 2, 0, R);
      const bool ap = *col_at(P.affinity_present, g, n, R);
      const int v = *col_at(P.node_value, g, n, R);
      const float boost = class_boost_at(
          v >= 0 ? v : V, counts_g, P.spread_desired + (size_t)g * V,
          __ldg(P.spread_implicit + g), __ldg(P.spread_weight_frac + g),
          __ldg(P.spread_even + g), active, V, -1, range);
      X.score[n] = score_node(free_frac(u0 + dem[0], __ldg(us)),
                              free_frac(u1 + dem[1], __ldg(us + 1)),
                              __ldcg(col_at(P.collisions, g, n, R)), count_f, ap,
                              ap ? *col_at(P.affinity, g, n, R) : 0.0f, active, boost);
      X.fit[n] = fit;
    }
    grid.sync();

    // (B) this block's ring positions: fit counts and first nonpositive
    // options in rotation order
    ExactP1 p1 = {0, 0, min3_none()};
    for (int p = m.b0 + tid; p < m.b1 && p < ring; p += THREADS) {
      const int node = __ldg(col_at(P.perm, e, p, R));
      if (__ldcg(X.fit + node)) {
        ++p1.nfit;
        p1.nbelow += p < off;
        if (__ldcg(X.score + node) <= 0.0f) p1.np = min3_insert(p1.np, rot_rank(p, off, ring));
      }
    }
    p1 = block_fold<2>(p1, ExactP1Op());
    publish(grid, X.p1, p1);
    int total_fit = 0, fit_before = 0, below = 0;
    Min3 skip = min3_none();
    for (int b = 0; b < (int)gridDim.x; ++b) {
      const ExactP1 x = ldcg_words(X.p1 + b);
      total_fit += x.nfit;
      if (b < (int)blockIdx.x) fit_before += x.nfit;
      below += x.nbelow;
      skip = Min3Op()(skip, x.np);
    }
    const int n_skip = (skip.v[0] != INT_MAX) + (skip.v[1] != INT_MAX) + (skip.v[2] != INT_MAX);
    const int n_returned = max(0, min(limit, total_fit - n_skip));
    const int need = max(limit - n_returned, 0);

    // (C) ring ranks, returned and replayed options, this block's best
    Best best = best_identity();
    int carry = 0;
    for (int base = m.b0; base < m.b1; base += THREADS) {
      const int p = base + tid;
      int node = 0, fit = 0;
      if (p < m.b1 && p < ring) {
        node = __ldg(col_at(P.perm, e, p, R));
        fit = __ldcg(X.fit + node);
      }
      const int incl = fit_before + chunk_incl<3>(fit, carry);
      bool is_cand = false;
      if (fit) {
        const int rr = rot_rank(p, off, ring);
        const int rot_incl = p >= off ? incl - below : total_fit - below + incl;
        const int idx = min3_index(skip, rr);
        const bool returned = idx == 0 && rot_incl - min3_le(skip, rr) <= limit;
        const bool replay = idx > 0 && idx <= need;
        is_cand = returned || replay;
        if (is_cand) {
          const Best cand = {__ldcg(X.score + node), rr + (replay ? N : 0), node,
                             returned ? rr : -1};
          best = BestOp()(best, cand);
        }
      }
      if (WAVE && p < m.b1) X.cand[p] = is_cand;
      __syncthreads();
    }
    best = block_fold<4>(best, BestOp());
    publish(grid, X.p2, best);
    const Best win = fold_slots(X.p2, best_identity(), BestOp());

    // the finish: cursor, usage, spread counts, placement
    const bool placed = win.visit != INT_MAX;
    const int consumed = n_returned >= limit ? win.last + 1 : ring;
    if (placed) {
      const int b = win.pos;
      if (b >= m.b0 && b < m.b1) {
        if (tid < C) *row_at(P.used, b, C, tid, R) += dem[tid];
        if (tid == 0) *col_at(P.collisions, g, b, R) += 1;
      }
      if (active) replicated_bump(my_counts + (size_t)g * V, my_present + (size_t)g * V,
                                  __ldg(col_at(P.node_value, g, b, R)));
    }
    if (tid == 0) my_offset[e] = (off + consumed) % max(ring, 1);
    if (blockIdx.x == 0 && tid == 0) P.placements[i] = placed ? win.pos : -1;
    if (WAVE) {
      // this lane's record: slot 0 the winner, then the first M - 1 of the
      // top M candidates by score, the smaller ring position first
      int* r = my_rec + n_round * REC;
      if (tid == 0) {
        r[0] = e;
        r[1] = consumed % max(ring, 1) != 0;
        r[2] = placed ? win.pos : -1;
        for (int k = 1; k < P.M; ++k) r[2 + k] = -1;
      }
      float prev_s = __int_as_float(0x7f800000);
      int prev_p = -1;
      for (int k = 1; k < P.M && placed; ++k) {
        Best b = best_identity();
        for (int p = m.b0 + tid; p < m.b1; p += THREADS) {
          if (!X.cand[p]) continue;
          const int node = __ldg(col_at(P.perm, e, p, R));
          const float sc = __ldcg(X.score + node);
          if (sc < prev_s || (sc == prev_s && p > prev_p)) b = BestOp()(b, Best{sc, p, node, -1});
        }
        b = block_fold<6>(b, BestOp());
        // two slot arrays in turn: a grid barrier lies between a fold's
        // reads of one and the next write to it
        Best* slots = (k & 1) ? X.p3 : X.p2;
        publish(grid, slots, b);
        const Best t = fold_slots(slots, best_identity(), BestOp());
        if (t.visit == INT_MAX) break;  // no candidate left: the rest stay -1
        if (tid == 0) r[2 + k] = t.pos;
        prev_s = t.s;
        prev_p = t.visit;
      }
      ++n_round;
    }
    __syncthreads();
  }
  if (blockIdx.x == 0) {
    for (int k = tid; k < GV; k += THREADS) {
      P.spread_counts[k] = my_counts[k];
      P.spread_present[k] = my_present[k];
    }
    for (int k = tid; k < P.E; k += THREADS) P.offset[k] = my_offset[k];
    if (WAVE && tid == 0) *P.rounds = rounds;
  }
}

// ===========================================================================
// K6s: the run planner
// ===========================================================================

struct RunsP {
  Slabs<const int> capacity;                    // rows [R, C], rotation order
  Slabs<const float> usable;                    // rows [R, 2]
  Slabs<const unsigned char> feasible;          // lane [R]
  Slabs<const float> affinity;                  // lane
  Slabs<const unsigned char> affinity_present;  // lane
  const int* group_count;                       // scalar
  Slabs<const int> node_value;                  // lane
  const float* spread_desired;                  // [V]
  const float* spread_implicit;                 // scalar
  const float* spread_weight_frac;              // scalar
  const unsigned char* spread_even;             // scalar
  const unsigned char* spread_active;           // scalar
  Slabs<const int> perm;                        // lane
  const int* demand;                            // [C]
  const int* n_allocs;                          // scalar
  Slabs<int> used;                              // rows, updated in place
  Slabs<int> collisions;                        // lane, updated in place
  const int* counts0;                           // [V]
  const unsigned char* present0;                // [V]
  int* placements;                              // [a_pad]
  int* rounds;                                  // scalar
  char* scratch;
  int S, Q, N, C, V, a_pad, even_mode;
};

struct RunsP1 {
  int nfit;
  float best;
  Min3 np;
};
struct RunsP1Op {
  __device__ __forceinline__ RunsP1 operator()(RunsP1 a, RunsP1 b) const {
    return {a.nfit + b.nfit, fmaxf(a.best, b.best), Min3Op()(a.np, b.np)};
  }
};
struct RunsP2 {
  int visit, ntied;
  float nontied;
};
struct RunsP2Op {
  __device__ __forceinline__ RunsP2 operator()(RunsP2 a, RunsP2 b) const {
    return {min(a.visit, b.visit), a.ntied + b.ntied, fmaxf(a.nontied, b.nontied)};
  }
};

struct RunsScratch {
  float* score;           // [N] this round's score per position
  float* num;             // [N] its plane count
  float* key;             // [N] its sweep key
  unsigned char* flags;   // [N] fit, first acceptance
  unsigned long long* list;  // [N] the accepted lanes' merged-order keys
  int* list_pos;          // [N] and their positions
  RunsP1* p1;             // [blocks]
  RunsP2* p2;
  float* p3;              // least first-accepted key
  float* p4;              // the guard's bad key
  int* p5;                // accepted count
  int* run;               // the fill run's length
  // [blocks][V + 1] each: every block's class arrays (class V: the
  // missing value); ties and hits are read across blocks
  int* cnt;               // the block's copy of the spread counts
  unsigned char* pres;    // and presence
  float* boost;           // the round's boosts
  float* delta;           // the key decays
  int* tbase;             // tied positions in the blocks before this one
  int* tcarry;            // and in this block's earlier chunks
  int* ties;              // this block's tied positions
  int* hits;              // this block's sweep placements
};

__host__ __device__ inline RunsScratch runs_scratch(char* base, int N, int V, int blocks,
                                                    size_t* bytes) {
  Carve c{base, 0};
  RunsScratch s;
  const size_t nc = (size_t)blocks * (V + 1);
  s.score = c.take<float>(N);
  s.num = c.take<float>(N);
  s.key = c.take<float>(N);
  s.flags = c.take<unsigned char>(N);
  s.list = c.take<unsigned long long>(N);
  s.list_pos = c.take<int>(N);
  s.p1 = c.take<RunsP1>(blocks);
  s.p2 = c.take<RunsP2>(blocks);
  s.p3 = c.take<float>(blocks);
  s.p4 = c.take<float>(blocks);
  s.p5 = c.take<int>(blocks);
  s.run = c.take<int>(1);
  s.cnt = c.take<int>(nc);
  s.pres = c.take<unsigned char>(nc);
  s.boost = c.take<float>(nc);
  s.delta = c.take<float>(nc);
  s.tbase = c.take<int>(nc);
  s.tcarry = c.take<int>(nc);
  s.ties = c.take<int>(nc);
  s.hits = c.take<int>(nc);
  if (bytes) *bytes = c.at;
  return s;
}

// One block's slices of the class arrays. A block's own threads read what
// its plain stores wrote through L1; what atomics or other blocks wrote
// is read from L2 (__ldcg).
struct RunClasses {
  int* cnt;
  unsigned char* pres;
  float* boost;
  float* delta;
  int* tbase;
  int* tcarry;
  int* ties;
  int* hits;
};

__device__ __forceinline__ RunClasses run_classes(const RunsScratch& X, int b, int V1) {
  const size_t o = (size_t)b * V1;
  return {X.cnt + o,   X.pres + o,   X.boost + o, X.delta + o,
          X.tbase + o, X.tcarry + o, X.ties + o,  X.hits + o};
}

constexpr unsigned char R_FIT = 1, R_ACC0 = 2;

__device__ __forceinline__ int run_class(const RunsP& P, int p, int R) {
  const int v = __ldg(lane_at(P.node_value, p, R));
  return v >= 0 ? v : P.V;
}

// score_at(extra) of the plain version at position p: ``extra`` more
// demands and collisions, the class's boost less ``extra`` key decays
__device__ __forceinline__ float runs_score(const RunsP& P, int p, int R, float count_f,
                                            bool active, float boost, int extra,
                                            float* num) {
  const int* u = row_at(P.used, p, P.C, 0, R);
  const float* us = row_at(P.usable, p, 2, 0, R);
  const bool ap = __ldg(lane_at(P.affinity_present, p, R));
  const int k = 1 + extra;
  return score_node(free_frac(__ldcg(u) + k * __ldg(P.demand), __ldg(us)),
                    free_frac(__ldcg(u + 1) + k * __ldg(P.demand + 1), __ldg(us + 1)),
                    __ldcg(lane_at(P.collisions, p, R)) + extra, count_f, ap,
                    ap ? __ldg(lane_at(P.affinity, p, R)) : 0.0f, active, boost, num);
}

__global__ void __launch_bounds__(THREADS, 1) mesh_runs_kernel(const RunsP P) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int N = P.N, C = P.C, V = P.V, V1 = V + 1;
  const MeshGeo m = mesh_geo(P.S, P.Q, N);
  const int R = m.R;
  const RunsScratch X = runs_scratch(P.scratch, N, V, gridDim.x, nullptr);
  const RunClasses K = run_classes(X, blockIdx.x, V1);
  const bool active = *P.spread_active, even = *P.spread_even;
  const float implicit = *P.spread_implicit, wf = *P.spread_weight_frac;
  const float count_f = __int2float_rn(*P.group_count);
  const int n_allocs = *P.n_allocs;

  // a chunk's tied positions of one class in one warp form a group; its
  // first lane publishes the group's class and size (in lane order)
  __shared__ int gcls[WARPS][32];
  __shared__ int gcnt[WARPS][32];
  __shared__ int ngrp[WARPS];
  __shared__ int n_list;
  // this block's copy of the spread counts and presence, and the classes'
  // key decays
  for (int c = tid; c < V1; c += THREADS) {
    float dl = 0.0f;
    if (c < V) {
      const float d = __ldg(P.spread_desired + c);
      const float de = d >= 0.0f ? d : implicit;
      dl = de >= 0.0f ? __fdiv_rn(wf, fmaxf(de, f32(0x3089705fu))) : 0.0f;
    }
    K.cnt[c] = c < V ? P.counts0[c] : 0;
    K.pres[c] = c < V ? P.present0[c] : 0;
    K.delta[c] = (active && !even) ? dl : 0.0f;
  }
  for (int k = blockIdx.x * THREADS + tid; k < P.a_pad; k += gridDim.x * THREADS)
    P.placements[k] = -1;
  grid.sync();

  int placed = 0, rounds = 0;
  while (placed < n_allocs) {
    ++rounds;
    const int remaining = n_allocs - placed;
    // the round's boosts from this block's counts
    ClassRange range = class_range_part(K.cnt, K.pres, V, -1, tid, THREADS);
    range = block_fold<8>(range, ClassRangeOp());
    for (int c = tid; c < V1; c += THREADS) {
      K.boost[c] = class_boost_at(c, K.cnt, P.spread_desired, implicit, wf, even, active, V, -1,
                                  range);
      K.tcarry[c] = 0;
    }
    if (tid == 0) n_list = 0;
    __syncthreads();

    // (1) fit, score, best score, first nonpositive options
    RunsP1 p1 = {0, neg_inf(), min3_none()};
    for (int p = m.b0 + tid; p < m.b1; p += THREADS) {
      const int* cap = row_at(P.capacity, p, C, 0, R);
      const int* u = row_at(P.used, p, C, 0, R);
      bool fit = __ldg(lane_at(P.feasible, p, R));
      for (int c = 0; c < C; ++c) fit = fit && __ldcg(u + c) + __ldg(P.demand + c) <= __ldg(cap + c);
      float score = 0.0f, num = 1.0f;
      if (fit) {
        score = runs_score(P, p, R, count_f, active, K.boost[run_class(P, p, R)], 0, &num);
        ++p1.nfit;
        p1.best = fmaxf(p1.best, score);
        if (score <= 0.0f) p1.np = min3_insert(p1.np, p);
      }
      X.score[p] = score;
      X.num[p] = num;
      X.flags[p] = fit ? R_FIT : 0;
    }
    p1 = block_fold<1>(p1, RunsP1Op());
    publish(grid, X.p1, p1);
    const RunsP1 g1 = fold_slots(X.p1, RunsP1{0, neg_inf(), min3_none()}, RunsP1Op());
    if (g1.nfit == 0) break;
    const float max_score = g1.best;

    // this block's tied positions of each class, counted afresh: every
    // block has crossed barrier 1, so none still reads last round's
    for (int c = tid; c < V1; c += THREADS) K.ties[c] = 0;
    __syncthreads();

    // (2) the winner (first tied in visit order), runner-ups, tied classes
    RunsP2 h = {INT_MAX, 0, neg_inf()};
    for (int base = m.b0; base < m.b1; base += THREADS) {
      const int p = base + tid;
      bool tied = false;
      int cls = 0;
      if (p < m.b1 && (__ldcg(X.flags + p) & R_FIT)) {
        const float score = __ldcg(X.score + p);
        if (score == max_score) {
          tied = true;
          cls = run_class(P, p, R);
          h.visit = min(h.visit, p + (min3_index(g1.np, p) ? N : 0));
          ++h.ntied;
        } else {
          h.nontied = fmaxf(h.nontied, score);
        }
      }
      const unsigned grp = __match_any_sync(FULL_MASK, tied ? cls : -1);
      if (tied && lane == __ffs(grp) - 1) atomicAdd(K.ties + cls, __popc(grp));
    }
    h = block_fold<2>(h, RunsP2Op());
    publish(grid, X.p2, h);
    const RunsP2 g2 = fold_slots(X.p2, RunsP2{INT_MAX, 0, neg_inf()}, RunsP2Op());
    const int best = g2.visit >= N ? g2.visit - N : g2.visit;
    const float runner_nontied = g2.nontied;
    const float runner_other = g2.ntied >= 2 ? max_score : runner_nontied;

    int n_acc = 0, acc_before = 0;
    if (!even) {
      // each class's tied positions in the blocks before this one
      for (int c = tid; c < V1; c += THREADS) {
        int before = 0;
        for (int b = 0; b < (int)blockIdx.x; ++b) before += __ldcg(X.ties + (size_t)b * V1 + c);
        K.tbase[c] = before;
      }
      __syncthreads();
      // (3) each tied position's rank in its class, its key, first acceptance
      float kmin = __int_as_float(0x7f800000);
      for (int base = m.b0; base < m.b1; base += THREADS) {
        const int p = base + tid;
        bool tied = false;
        int cls = 0;
        float score = 0.0f;
        if (p < m.b1 && (__ldcg(X.flags + p) & R_FIT)) {
          score = __ldcg(X.score + p);
          tied = score == max_score;
          cls = run_class(P, p, R);
        }
        const unsigned grp = __match_any_sync(FULL_MASK, tied ? cls : -1);
        const int lead = __ffs(grp) - 1;
        const bool leader = tied && lane == lead;
        const unsigned leaders = __ballot_sync(FULL_MASK, leader);
        if (leader) {
          gcls[warp][__popc(leaders & lt)] = cls;
          gcnt[warp][__popc(leaders & lt)] = __popc(grp);
        }
        if (lane == 0) ngrp[warp] = __popc(leaders);
        __syncthreads();
        // a group's first rank: its class's tied positions in the earlier
        // blocks, chunks and warps
        int first = 0;
        if (leader) {
          first = K.tbase[cls] + __ldcg(K.tcarry + cls);
          for (int w = 0; w < warp; ++w)
            for (int k = 0; k < ngrp[w]; ++k) first += gcls[w][k] == cls ? gcnt[w][k] : 0;
        }
        first = __shfl_sync(FULL_MASK, first, tied ? lead : lane);
        if (tied) {
          const int t_own = first + __popc(grp & lt);
          const float key = __fsub_rn(
              score, __fdiv_rn(__fmul_rn(__int2float_rn(t_own), K.delta[cls]), __ldcg(X.num + p)));
          X.key[p] = key;
          if (key > runner_nontied) {
            X.flags[p] |= R_ACC0;
            kmin = fminf(kmin, key);
          }
        }
        __syncthreads();
        if (leader) atomicAdd(K.tcarry + cls, __popc(grp));
        __syncthreads();
      }
      kmin = block_fold<3>(kmin, MinF());
      publish(grid, X.p3, kmin);
      const float key_min0 = fold_slots(X.p3, __int_as_float(0x7f800000), MinF());

      // (4) the guard: an accepted lane whose own second placement scores
      // above the least key bounds the acceptance
      float bad = neg_inf();
      for (int p = m.b0 + tid; p < m.b1; p += THREADS) {
        if (!(__ldcg(X.flags + p) & R_ACC0)) continue;
        const int cls = run_class(P, p, R);
        const float score2 = runs_score(P, p, R, count_f, active,
                                        __fsub_rn(K.boost[cls], K.delta[cls]), 1, nullptr);
        if (!(score2 <= key_min0)) bad = fmaxf(bad, __ldcg(X.key + p));
      }
      bad = block_fold<4>(bad, MaxF());
      publish(grid, X.p4, bad);
      const float bad_key = fold_slots(X.p4, neg_inf(), MaxF());

      // (5) the final acceptance count
      int acc = 0;
      for (int p = m.b0 + tid; p < m.b1; p += THREADS) {
        const unsigned char f = __ldcg(X.flags + p);
        if ((f & R_ACC0) && __ldcg(X.key + p) > bad_key) ++acc;
        else if (f & R_ACC0) X.flags[p] = f & ~R_ACC0;
      }
      acc = block_fold<5>(acc, SumI());
      publish(grid, X.p5, acc);
      scan_slots(X.p5, 1, acc_before, n_acc);
    }

    if (n_acc > 1) {
      // (6) a sweep: the accepted lanes into one list, then each lane's
      // slot is its rank in the merged order (key descending, visit
      // ascending; unique per lane)
      const int take = min(remaining, n_acc);
      for (int c = tid; c < V1; c += THREADS) K.hits[c] = 0;
      for (int p = m.b0 + tid; p < m.b1; p += THREADS) {
        if (!(__ldcg(X.flags + p) & R_ACC0)) continue;
        const int k = acc_before + atomicAdd(&n_list, 1);
        const int visit = p + (min3_index(g1.np, p) ? N : 0);
        X.list[k] = ((unsigned long long)float_order(-__ldcg(X.key + p)) << 32) |
                    (unsigned long long)(unsigned)visit;
        X.list_pos[k] = p;
      }
      grid.sync();
      for (int k = acc_before; k < acc_before + n_list; ++k) {
        const unsigned long long mine = __ldcg(X.list + k);
        // every thread counts a share of the list, folded per lane below
        int below = 0;
        for (int j = tid; j < n_acc; j += THREADS) below += __ldcg(X.list + j) < mine;
        below = block_fold<6>(below, SumI());
        if (below < take) {
          const int p = __ldcg(X.list_pos + k);
          if (tid == 0) {
            P.placements[placed + below] = __ldg(lane_at(P.perm, p, R));
            *lane_at(P.collisions, p, R) += 1;
            atomicAdd(K.hits + run_class(P, p, R), 1);
          }
          if (tid < C) *row_at(P.used, p, C, tid, R) += __ldg(P.demand + tid);
        }
        __syncthreads();
      }
      grid.sync();
      for (int c = tid; c < V; c += THREADS) {
        int hit = 0;
        for (int b = 0; b < (int)gridDim.x; ++b) hit += __ldcg(X.hits + (size_t)b * V1 + c);
        if (active && hit > 0) {
          K.cnt[c] += hit;
          K.pres[c] = 1;
        }
      }
      placed += take;
    } else {
      // a fill run: the winner's trajectory under j further
      // self-placements, every other node frozen; j = 0 is granted
      if (best >= m.b0 && best < m.b1) {
        const int cls_b = run_class(P, best, R);
        const int* ub = row_at(P.used, best, C, 0, R);
        const int* capb = row_at(P.capacity, best, C, 0, R);
        const float* usb = row_at(P.usable, best, 2, 0, R);
        int first_bad = RUNCAP;
        if (tid > 0 && tid < RUNCAP) {
          const int j = tid;
          bool ok = !even && j < remaining;
          for (int c = 0; c < C && ok; ++c)
            ok = __ldcg(ub + c) + (j + 1) * __ldg(P.demand + c) <= __ldg(capb + c);
          if (ok) {
            const bool affp_b = __ldg(lane_at(P.affinity_present, best, R));
            const float aff_b = affp_b ? __ldg(lane_at(P.affinity, best, R)) : 0.0f;
            const float jf = __int2float_rn(j);
            const float jf1 = __fadd_rn(jf, 1.0f);
            const float fc = __fsub_rn(
                1.0f, __fdiv_rn(__fadd_rn(__int2float_rn(__ldcg(ub)),
                                          __fmul_rn(jf1, __int2float_rn(__ldg(P.demand)))),
                                __ldg(usb)));
            const float fm = __fsub_rn(
                1.0f, __fdiv_rn(__fadd_rn(__int2float_rn(__ldcg(ub + 1)),
                                          __fmul_rn(jf1, __int2float_rn(__ldg(P.demand + 1)))),
                                __ldg(usb + 1)));
            const float coll_j = __fadd_rn(__int2float_rn(__ldcg(lane_at(P.collisions, best, R))), jf);
            const bool ap = coll_j > 0.0f;
            const float an = anti_affinity(coll_j, ap, count_f);
            const float sp = __fsub_rn(K.boost[cls_b], __fmul_rn(jf, K.delta[cls_b]));
            const bool fired = active && sp != 0.0f;
            const float num = __fadd_rn(__fadd_rn(__fadd_rn(1.0f, ap ? 1.0f : 0.0f),
                                                  affp_b ? 1.0f : 0.0f),
                                        fired ? 1.0f : 0.0f);
            const float traj = __fdiv_rn(
                __fadd_rn(__fadd_rn(__fadd_rn(binpack_f32(fc, fm), an), aff_b), fired ? sp : 0.0f),
                num);
            ok = traj > runner_other;
          }
          if (!ok) first_bad = j;
        }
        first_bad = block_fold<7>(first_bad, MinI());
        const int run = min(first_bad, remaining);
        const int node = __ldg(lane_at(P.perm, best, R));
        for (int k = tid; k < run; k += THREADS) P.placements[placed + k] = node;
        if (tid < C) *row_at(P.used, best, C, tid, R) += run * __ldg(P.demand + tid);
        if (tid == 0) {
          *lane_at(P.collisions, best, R) += run;
          *X.run = run;
        }
      }
      grid.sync();
      const int run = __ldcg(X.run);
      const int cls_b = run_class(P, best, R);
      if (tid == 0 && active && cls_b < V) {
        K.cnt[cls_b] += run;
        K.pres[cls_b] = 1;
      }
      placed += run;
    }
    __syncthreads();
  }
  if (blockIdx.x == 0 && tid == 0) *P.rounds = rounds;
}

// ===========================================================================
// K7s: the windowed planner
// ===========================================================================

struct WinP {
  Slabs<const int> capacity;            // rows [R, C]
  Slabs<const float> usable;            // rows [R, 2]
  Slabs<const unsigned char> feasible;  // lane [R] by node id
  Slabs<const int> perm;                // lane [R] node id at ring position
  const int* demand;                    // [C]
  const int* group_count;               // scalar
  const int* limit;                     // scalar
  const int* n_allocs;                  // scalar
  Slabs<int> used;                      // rows, updated in place
  Slabs<int> collisions;                // lane, updated in place
  int* placements;                      // [a_pad]
  int* rounds;                          // scalar
  char* scratch;
  int S, Q, N, C, n_real, a_pad;
};

struct WinP1 {
  int nfit, nbelow;
};
struct WinP1Op {
  __device__ __forceinline__ WinP1 operator()(WinP1 a, WinP1 b) const {
    return {a.nfit + b.nfit, a.nbelow + b.nbelow};
  }
};

struct WinScratch {
  unsigned char* fit;          // [N] per node row
  float* score;                // [N] per node row
  int* window;                 // [N] per ring position (-1: none)
  unsigned long long* key;     // [N] per ring position
  unsigned long long* wkey;    // [N + 1] per window: the max (score, -rank)
  WinP1* p1;                   // [blocks]
  int* p2;                     // [blocks] last consumed rank
};

__host__ __device__ inline WinScratch win_scratch(char* base, int N, int blocks, size_t* bytes) {
  Carve c{base, 0};
  WinScratch s;
  s.fit = c.take<unsigned char>(N);
  s.score = c.take<float>(N);
  s.window = c.take<int>(N);
  s.key = c.take<unsigned long long>(N);
  s.wkey = c.take<unsigned long long>(N + 1);
  s.p1 = c.take<WinP1>(blocks);
  s.p2 = c.take<int>(blocks);
  if (bytes) *bytes = c.at;
  return s;
}

__global__ void __launch_bounds__(THREADS, 1) mesh_windowed_kernel(const WinP P) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int N = P.N, C = P.C, n_real = P.n_real;
  const MeshGeo m = mesh_geo(P.S, P.Q, N);
  const int R = m.R;
  const WinScratch X = win_scratch(P.scratch, N, gridDim.x, nullptr);
  const int L = *P.limit, L1 = max(L, 1), n_allocs = *P.n_allocs;
  const float count_f = __int2float_rn(*P.group_count);
  int dem[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) dem[c] = c < C ? __ldg(P.demand + c) : 0;
  const int gthreads = gridDim.x * THREADS, gtid = blockIdx.x * THREADS + tid;
  for (int k = gtid; k < P.a_pad; k += gthreads) P.placements[k] = -1;
  for (int k = gtid; k <= N; k += gthreads) X.wkey[k] = 0ull;

  int placed = 0, rounds = 0, offset = 0, prev_w = 0;
  while (placed < n_allocs) {
    ++rounds;
    // (A) fit and score of this block's node rows
    for (int n = m.b0 + tid; n < m.b1; n += THREADS) {
      const int* cap = row_at(P.capacity, n, C, 0, R);
      const int* u = row_at(P.used, n, C, 0, R);
      bool fit = __ldg(lane_at(P.feasible, n, R));
      int u0 = 0, u1 = 0;
      for (int c = 0; c < C; ++c) {
        const int uc = __ldcg(u + c);
        if (c == 0) u0 = uc;
        if (c == 1) u1 = uc;
        fit = fit && uc + dem[c] <= __ldg(cap + c);
      }
      const float* us = row_at(P.usable, n, 2, 0, R);
      const int coll = __ldcg(lane_at(P.collisions, n, R));
      const bool ap = coll > 0;
      const float bp = binpack_f32(free_frac(u0 + dem[0], __ldg(us)),
                                   free_frac(u1 + dem[1], __ldg(us + 1)));
      X.score[n] = __fdiv_rn(__fadd_rn(bp, anti_affinity(__int2float_rn(coll), ap, count_f)),
                             __fadd_rn(1.0f, ap ? 1.0f : 0.0f));
      X.fit[n] = fit;
    }
    grid.sync();

    // (B) fit counts of this block's ring positions; last round's window
    // keys cleared
    for (int k = gtid; k < prev_w; k += gthreads) X.wkey[k] = 0ull;
    WinP1 p1 = {0, 0};
    for (int p = m.b0 + tid; p < m.b1 && p < n_real; p += THREADS) {
      if (__ldcg(X.fit + __ldg(lane_at(P.perm, p, R)))) {
        ++p1.nfit;
        p1.nbelow += p < offset;
      }
    }
    p1 = block_fold<1>(p1, WinP1Op());
    publish(grid, X.p1, p1);
    int total = 0, before = 0, below = 0;
    for (int b = 0; b < (int)gridDim.x; ++b) {
      const WinP1 x = ldcg_words(X.p1 + b);
      total += x.nfit;
      if (b < (int)blockIdx.x) before += x.nfit;
      below += x.nbelow;
    }
    const int remaining = n_allocs - placed;
    const int w_avail = total > 0 ? max(total / L1, 1) : 0;
    const int w_use = min(w_avail, remaining);
    if (w_use == 0) break;

    // (C) each fit position's feasible rank along the ring, its window and
    // key; the window keys by atomicMax; the last consumed rank
    int last = -1, carry = 0;
    for (int base = m.b0; base < m.b1; base += THREADS) {
      const int p = base + tid;
      int node = 0, fit = 0;
      if (p < m.b1 && p < n_real) {
        node = __ldg(lane_at(P.perm, p, R));
        fit = __ldcg(X.fit + node);
      }
      const int incl = before + chunk_incl<2>(fit, carry);
      if (p < m.b1) {
        int w = -1;
        if (fit) {
          const int rank = (p >= offset ? incl - below : total - below + incl) - 1;
          if (rank < w_use * L) last = max(last, rot_rank(p, offset, n_real));
          if (rank / L1 < w_use) {
            w = rank / L1;
            const unsigned long long key =
                ((unsigned long long)float_order(__ldcg(X.score + node)) << 32) |
                (unsigned long long)(unsigned)(0x7fffffff - rank);
            X.key[p] = key;
            atomicMax(X.wkey + w, key);
          }
        }
        X.window[p] = w;
      }
      __syncthreads();
    }
    last = block_fold<3>(last, MaxI());
    publish(grid, X.p2, last);
    last = fold_slots(X.p2, -1, MaxI());
    const int consumed = total < w_use * L ? n_real : last + 1;

    // (D) each window's winner: its usage into its node's row (any slab)
    for (int p = m.b0 + tid; p < m.b1; p += THREADS) {
      const int w = __ldcg(X.window + p);
      if (w < 0 || __ldcg(X.wkey + w) != __ldcg(X.key + p)) continue;
      const int node = __ldg(lane_at(P.perm, p, R));
      int* u = row_at(P.used, node, C, 0, R);
      for (int c = 0; c < C; ++c) u[c] += dem[c];
      *lane_at(P.collisions, node, R) += 1;
      P.placements[placed + w] = node;
    }
    grid.sync();
    offset = (offset + max(consumed, 0)) % n_real;
    placed += w_use;
    prev_w = w_use;
  }
  if (blockIdx.x == 0 && tid == 0) *P.rounds = rounds;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <class K>
cudaError_t max_blocks(K kernel, int* n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  *n = sms * per_sm;
  return err;
}

cudaError_t max_blocks_of(int which, int* n) {
  if (which == WHICH_EXACT) return max_blocks(mesh_exact_kernel<false>, n);
  if (which == WHICH_WAVEFRONT) return max_blocks(mesh_exact_kernel<true>, n);
  if (which == WHICH_RUNS) return max_blocks(mesh_runs_kernel, n);
  return max_blocks(mesh_windowed_kernel, n);
}

template <class Params, class K>
int launch(K kernel, const Params& P, cudaStream_t stream) {
  void* args[] = {const_cast<Params*>(&P)};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(P.S * P.Q),
                                                dim3(THREADS), args, 0, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

}  // namespace

// The launch of planner ``which`` (0 exact, 1 runs, 2 windowed, 3 wavefront)
// over S shards of an N-row axis: out[0] the blocks a shard (Q), out[1] the
// blocks the card co-schedules; *scratch the global scratch bytes, the
// wavefront's for a round of ``round_ints`` record ints (W * (2 + M)). S
// shards that cannot all be co-resident return MESH_REFUSED.
extern "C" int ntt_mesh_shape(int* out, long long* scratch, int which, int S, int N, int G,
                              int V, int E, int round_ints, cudaStream_t) {
  int most = 0;
  cudaError_t err = max_blocks_of(which, &most);
  if (err != cudaSuccess) return (int)err;
  most = min(most, MAX_MESH_BLOCKS);
  out[1] = most;
  if (S < 1 || S > MAX_SHARDS || S > most) return MESH_REFUSED;
  const int R = N / S;
  const int Q = max(1, min((R + THREADS - 1) / THREADS, most / S));
  out[0] = Q;
  size_t bytes = 0;
  if (which == WHICH_EXACT || which == WHICH_WAVEFRONT)
    exact_scratch(nullptr, N, G, V, E, S * Q, which == WHICH_WAVEFRONT ? round_ints : 0, &bytes);
  else if (which == WHICH_RUNS)
    runs_scratch(nullptr, N, V, S * Q, &bytes);
  else
    win_scratch(nullptr, N, S * Q, &bytes);
  *scratch = (long long)bytes;
  return 0;
}

namespace {

// the table's leaves of the exact scan and the wavefront: BatchArgs, then
// BatchState, then the placements
void exact_table(Table& t, ExactP& P) {
  t.slabs(P.capacity);
  t.slabs(P.usable);
  t.slabs(P.feasible);
  t.slabs(P.affinity);
  t.slabs(P.affinity_present);
  t.one(P.group_count);
  t.one(P.group_eval);
  t.slabs(P.node_value);
  t.one(P.spread_desired);
  t.one(P.spread_implicit);
  t.one(P.spread_weight_frac);
  t.one(P.spread_even);
  t.one(P.spread_active);
  t.slabs(P.perm);
  t.one(P.ring);
  t.one(P.demands);
  t.one(P.groups);
  t.one(P.limits);
  t.one(P.valid);
  t.slabs(P.used);
  t.slabs(P.collisions);
  t.one(P.spread_counts);
  t.one(P.spread_present);
  t.one(P.offset);
  t.one(P.placements);
}

}  // namespace

extern "C" int ntt_mesh_exact(const unsigned long long* table, int S, int Q, int N, int C, int G,
                              int V, int E, int A, cudaStream_t stream) {
  ExactP P{};
  Table t{table, 0};
  exact_table(t, P);
  t.one(P.scratch);
  P.S = S, P.Q = Q, P.N = N, P.C = C, P.G = G, P.V = V, P.E = E, P.A = A;
  if (C < 2 || C > MAXC) return (int)cudaErrorInvalidValue;
  return launch(mesh_exact_kernel<false>, P, stream);
}

// K11s: the table of ntt_mesh_exact with the rounds before the scratch
extern "C" int ntt_mesh_wavefront(const unsigned long long* table, int S, int Q, int N, int C,
                                  int G, int V, int E, int A, int W, int M, cudaStream_t stream) {
  ExactP P{};
  Table t{table, 0};
  exact_table(t, P);
  t.one(P.rounds);
  t.one(P.scratch);
  P.S = S, P.Q = Q, P.N = N, P.C = C, P.G = G, P.V = V, P.E = E, P.A = A, P.W = W, P.M = M;
  if (C < 2 || C > MAXC || W < 1 || M < 1) return (int)cudaErrorInvalidValue;
  return launch(mesh_exact_kernel<true>, P, stream);
}

extern "C" int ntt_mesh_runs(const unsigned long long* table, int S, int Q, int N, int C, int V,
                             int a_pad, int even_mode, cudaStream_t stream) {
  RunsP P;
  Table t{table, 0};
  t.slabs(P.capacity);
  t.slabs(P.usable);
  t.slabs(P.feasible);
  t.slabs(P.affinity);
  t.slabs(P.affinity_present);
  t.one(P.group_count);
  t.slabs(P.node_value);
  t.one(P.spread_desired);
  t.one(P.spread_implicit);
  t.one(P.spread_weight_frac);
  t.one(P.spread_even);
  t.one(P.spread_active);
  t.slabs(P.perm);
  t.one(P.demand);
  t.one(P.n_allocs);
  t.slabs(P.used);
  t.slabs(P.collisions);
  t.one(P.counts0);
  t.one(P.present0);
  t.one(P.placements);
  t.one(P.rounds);
  t.one(P.scratch);
  P.S = S, P.Q = Q, P.N = N, P.C = C, P.V = V, P.a_pad = a_pad, P.even_mode = even_mode;
  if (C < 2 || C > MAXC || V < 0) return (int)cudaErrorInvalidValue;
  return launch(mesh_runs_kernel, P, stream);
}

extern "C" int ntt_mesh_windowed(const unsigned long long* table, int S, int Q, int N, int C,
                                 int n_real, int a_pad, cudaStream_t stream) {
  WinP P;
  Table t{table, 0};
  t.slabs(P.capacity);
  t.slabs(P.usable);
  t.slabs(P.feasible);
  t.slabs(P.perm);
  t.one(P.demand);
  t.one(P.group_count);
  t.one(P.limit);
  t.one(P.n_allocs);
  t.slabs(P.used);
  t.slabs(P.collisions);
  t.one(P.placements);
  t.one(P.rounds);
  t.one(P.scratch);
  P.S = S, P.Q = Q, P.N = N, P.C = C, P.n_real = n_real, P.a_pad = a_pad;
  if (C < 2 || C > MAXC) return (int)cudaErrorInvalidValue;
  return launch(mesh_windowed_kernel, P, stream);
}
