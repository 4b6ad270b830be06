// The mesh's collectives: what GSPMD inserts for the JAX package's sharded
// planners (nomad_tpu/tpu/shard.py), written by hand for a node axis split
// into S shards on one card.
//
// A sharded kernel is ONE cooperative launch of S * Q blocks: shard s owns
// the contiguous global rows [s * R, (s + 1) * R) (R = N / S) of every
// sharded plane, held as a tensor of its own (a slab), and its Q blocks
// split those rows evenly and in order, so the blocks are in global row
// order. Every reduction over the node or position axis is a local stage
// (each block reduces its rows inside the block, block_fold) and an S-wide
// finish: each block publishes its partial to its global slot, the grid
// barrier, then every block folds the slots in block order itself (no
// broadcast). Partials written across blocks are read from L2 (__ldcg):
// another SM wrote them and this SM's L1 may hold an older line.
//
// Two calls on the same slots must be separated by another grid barrier;
// every kernel gives each call site its own slots.
#pragma once

#include <cooperative_groups.h>

#include <climits>
#include <cstdint>

#include "block.cuh"

namespace ntt {

namespace cg = cooperative_groups;

constexpr int MAX_SHARDS = 16;
// blocks of one launch: S shards of Q blocks each
constexpr int MAX_MESH_BLOCKS = 256;
// returned when S shards of one block cannot be co-resident on the card
constexpr int MESH_REFUSED = 0x4e5410;

// one sharded leaf: shard s's slab at p[s] (replicated leaves are plain
// pointers)
template <class T>
struct Slabs {
  T* p[MAX_SHARDS];
};

// The pointer table a launch gets: each sharded leaf MAX_SHARDS entries
// (shard s's slab at entry s), each replicated leaf one; read on the host
// into a launch's parameters
struct Table {
  const unsigned long long* t;
  int k;
  template <class T>
  void slabs(Slabs<T>& s) {
    for (int i = 0; i < MAX_SHARDS; ++i) s.p[i] = reinterpret_cast<T*>(t[k++]);
  }
  template <class T>
  void one(T*& p) {
    p = reinterpret_cast<T*>(t[k++]);
  }
};

// This block's place in the mesh: S shards of R rows, Q blocks a shard;
// this block is rank q of shard s and owns the global rows [b0, b1)
struct MeshGeo {
  int S, Q, R, s, q, b0, b1;
};

__device__ __forceinline__ MeshGeo mesh_geo(int S, int Q, int N) {
  MeshGeo g;
  g.S = S;
  g.Q = Q;
  g.R = N / S;
  g.s = blockIdx.x / Q;
  g.q = blockIdx.x % Q;
  const int per = (g.R + Q - 1) / Q;
  g.b0 = g.s * g.R + min(g.q * per, g.R);
  g.b1 = g.s * g.R + min((g.q + 1) * per, g.R);
  return g;
}

// element (n, c) of a row-split [N, k] plane
template <class T>
__device__ __forceinline__ T* row_at(const Slabs<T>& L, int n, int k, int c, int R) {
  const int s = n / R;
  return L.p[s] + (size_t)(n - s * R) * k + c;
}
// element (g, n) of a column-split [G, N] plane
template <class T>
__device__ __forceinline__ T* col_at(const Slabs<T>& L, int g, int n, int R) {
  const int s = n / R;
  return L.p[s] + (size_t)g * R + (n - s * R);
}
// element n of a lane-split [N] plane
template <class T>
__device__ __forceinline__ T* lane_at(const Slabs<T>& L, int n, int R) {
  const int s = n / R;
  return L.p[s] + (n - s * R);
}

// A plain struct through 32-bit words: warp shuffles and L2 reads
template <class T>
union Words {
  T t;
  int w[sizeof(T) / 4];
};

template <class T>
__device__ __forceinline__ T shfl_xor_words(T v, int m) {
  static_assert(sizeof(T) % 4 == 0, "partials are whole 32-bit words");
  Words<T> u;
  u.t = v;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 4); ++i) u.w[i] = __shfl_xor_sync(FULL_MASK, u.w[i], m);
  return u.t;
}

template <class T>
__device__ __forceinline__ T ldcg_words(const T* p) {
  Words<T> u;
  const int* w = reinterpret_cast<const int*>(p);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 4); ++i) u.w[i] = __ldcg(w + i);
  return u.t;
}

// The local stage: ``v`` folded over the block (commutative, associative
// ``op``); every thread receives the result. One block barrier.
template <int TAG, class T, class Op>
__device__ __forceinline__ T block_fold(T v, Op op) {
  __shared__ T sh[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = op(v, shfl_xor_words(v, m));
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = sh[lane];
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = op(v, shfl_xor_words(v, m));
  return v;
}

// Publish this block's partial to its slot and cross the grid barrier
template <class T>
__device__ __forceinline__ void publish(cg::grid_group& grid, T* slots, const T& mine) {
  if (threadIdx.x == 0) slots[blockIdx.x] = mine;
  grid.sync();
}

// The S-wide finish of a commutative fold: every block's slot folded
template <class T, class Op>
__device__ __forceinline__ T fold_slots(const T* slots, T acc, Op op) {
  for (int b = 0; b < (int)gridDim.x; ++b) acc = op(acc, ldcg_words(slots + b));
  return acc;
}

// ---------------------------------------------------------------------------
// the collectives' partials
// ---------------------------------------------------------------------------

// The int32 all-reduce of a count and the exclusive scan of the blocks'
// counts (block order is global row order): ``total`` over every block,
// ``before`` over the blocks ahead of this one
__device__ __forceinline__ void scan_slots(const int* slots, int stride, int& before,
                                           int& total) {
  before = total = 0;
  for (int b = 0; b < (int)gridDim.x; ++b) {
    const int x = __ldcg(slots + (size_t)b * stride);
    if (b < (int)blockIdx.x) before += x;
    total += x;
  }
}

// The cross-shard argmax on (score, visit) is BestOp (block.cuh) over
// block_fold and fold_slots: the highest score, and among equal scores the
// smallest visit order (a global position, unique), with the node it
// names and the largest returned rank beside it.

// The three least values (ascending, INT_MAX: none) of a set of distinct
// ints: the first MAX_SKIP nonpositive options in visit order
struct Min3 {
  int v[3];
};

__device__ __forceinline__ Min3 min3_none() { return {{INT_MAX, INT_MAX, INT_MAX}}; }

__device__ __forceinline__ Min3 min3_insert(Min3 a, int x) {
  if (x < a.v[2]) {
    a.v[2] = x;
    if (a.v[2] < a.v[1]) {
      const int t = a.v[1];
      a.v[1] = a.v[2];
      a.v[2] = t;
    }
    if (a.v[1] < a.v[0]) {
      const int t = a.v[0];
      a.v[0] = a.v[1];
      a.v[1] = t;
    }
  }
  return a;
}

struct Min3Op {
  __device__ __forceinline__ Min3 operator()(Min3 a, Min3 b) const {
#pragma unroll
    for (int i = 0; i < 3; ++i) a = min3_insert(a, b.v[i]);
    return a;
  }
};

// How many of ``m``'s entries are at most ``x``, and whether ``x`` is one
// (its 1-based index, 0: not one)
__device__ __forceinline__ int min3_le(const Min3& m, int x) {
  return (m.v[0] <= x) + (m.v[1] <= x) + (m.v[2] <= x);
}
__device__ __forceinline__ int min3_index(const Min3& m, int x) {
  return m.v[0] == x ? 1 : m.v[1] == x ? 2 : m.v[2] == x ? 3 : 0;
}

// ---------------------------------------------------------------------------
// the replicated state: every block keeps its own copy of the spread
// counts, presence and ring cursors in a global slice, and applies each
// step's update itself from what the finish gave every block, so the
// copies stay equal without another barrier; block 0's copy is the output
// ---------------------------------------------------------------------------

__device__ __forceinline__ void replicated_bump(int* counts, unsigned char* present, int v) {
  if (threadIdx.x == 0 && v >= 0) {
    counts[v] += 1;
    present[v] = 1;
  }
}

// Inclusive prefix of the 0/1 flags of a chunk of THREADS positions (one
// a thread) in thread order, its total, and the chunk's carry updated.
// Callers separate two calls with another block barrier.
template <int TAG>
__device__ __forceinline__ int chunk_incl(int x, int& carry) {
  int xs[1] = {x}, excl[1], tot[1];
  block_scan<1, TAG>(xs, excl, tot);
  const int incl = carry + excl[0] + x;
  carry += tot[0];
  return incl;
}

}  // namespace ntt
