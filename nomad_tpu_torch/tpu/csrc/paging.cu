// The two tile sweeps of the paged windowed planner.
//
// Replace nomad_tpu/tpu/paging.py _tile_count_jit (:344) and
// _tile_window_jit (:358). A tile is T rows of the eval's planes in ring
// order (row q is ring position t0 + q).
//
// tile_count: the tile's feasible count and its count before the ring
// offset. What bounds it: bytes (the tile's capacity, used and feasible
// planes, read once; two integers out). Design: one launch of a grid of
// 256-thread blocks (128 at a 65,536-row tile), TC_ROWS rows a thread with
// all their loads issued before the first is used (a 4-column row is one
// 16-byte load of each plane), a block reduction, and one 64-bit atomicAdd
// a block into a ticket word that carries the block's two counts and a
// ticket of 1 (fields of ``bits`` bits, T < 2^bits, under a ticket field
// wide enough for the grid). The block that draws the last ticket holds
// the grid's sums in the atomic's result: it writes ``out`` and clears
// the word, so ``out`` needs no zeroing and the launch is the call's only
// device operation. The wrapper keeps one zeroed word a stream.
//
// tile_window: per window that meets the tile, the partial winner (max
// score, then least feasible rank, and its node), in two straddle groups
// (positions at or past the cursor rank low, wrapped positions high, each
// with its own base window), plus the last consumed ring position. What
// bounds it: bytes (the tile's planes in, 3 x (2T+1) segment values out;
// the score is some 100 float operations a row). Design: three short
// launches of a grid of 1024-thread blocks, one row a thread, neighbouring
// threads on neighbouring rows (a 4-column row is one 16-byte load):
//   1. score: each row's fit and score, each block's count of fit rows and
//      of fit rows before the cursor; the segments' fill values (JAX's -inf,
//      INT32_MAX, INT32_MIN) and the zeroed bids as grid-stride writes.
//   2. bid: each block sums the counts of the blocks before it (a short
//      loop over at most T/1024 integers), so a block scan gives each row
//      its feasible rank. The base windows need no pass of their own: the
//      tile's wrapped rows (pos < offset) precede its other rows, so the
//      first wrapped feasible row has rank total - x0 + flat_base and the
//      first other one flat_base + before - x0, where ``before`` is the
//      tile's count before the cursor; each base is that rank's window
//      where such a row exists and the window is active. Each active row
//      then bids for its window's segment with one 64-bit atomicMax on
//      (order(score) << 32 | ~rank), which orders by score, then by the
//      least rank, as the JAX segment_max / segment_min pair does; the
//      watermark is a block max and one atomicMax.
//   3. winner: after every bid has landed, the row whose bid won writes
//      its segment's score, rank and node.
// Segment 2T, where JAX gathers the inactive rows, gets (-1e30, 2^30, -1)
// when one exists.
//
// Under a mesh (K12s, K13s: the same programs on tiles placed by
// shard.paged_specs()) a tile's T rows are S slabs of R = T / S rows, each
// a tensor of its own, passed through a pointer table (mesh.cuh). The
// kernels are the ones above, instantiated on a tile whose row q reads
// slab q / R: the grids still run over the tile's global rows in order, so
// the block counts, the exclusive scan of the fit rows across blocks, the
// bases, the segment bids and the watermark cross the slabs as they cross
// blocks, and the outputs are the unsharded sweep's bit for bit.
#include <cuda_runtime.h>

#include "block.cuh"
#include "mesh.cuh"
#include "score.cuh"

namespace {

using namespace ntt;

constexpr int BIG = 1 << 30;

// A tile's planes, one tensor each (the unsharded tile)
struct FlatTile {
  const int* cap;             // [T,C]
  const float* usable;        // [T,2]
  const unsigned char* feas;  // [T]
  const int* nodes;           // [T] node id per row
  const int* used;            // [T,C]
  const int* coll;            // [T]
  __device__ __forceinline__ const int* cap_row(int q, int C) const { return cap + (size_t)q * C; }
  __device__ __forceinline__ const int* used_row(int q, int C) const { return used + (size_t)q * C; }
  __device__ __forceinline__ const float* usable_row(int q) const { return usable + 2 * (size_t)q; }
  __device__ __forceinline__ bool feas_at(int q) const { return __ldg(feas + q); }
  __device__ __forceinline__ int coll_at(int q) const { return coll[q]; }
  __device__ __forceinline__ int node_at(int q) const { return nodes[q]; }
};

// A tile split over a mesh: S slabs of R rows of each plane
struct SlabTile {
  Slabs<const int> cap;
  Slabs<const float> usable;
  Slabs<const unsigned char> feas;
  Slabs<const int> nodes;
  Slabs<const int> used;
  Slabs<const int> coll;
  int R;
  __device__ __forceinline__ const int* cap_row(int q, int C) const { return row_at(cap, q, C, 0, R); }
  __device__ __forceinline__ const int* used_row(int q, int C) const { return row_at(used, q, C, 0, R); }
  __device__ __forceinline__ const float* usable_row(int q) const { return row_at(usable, q, 2, 0, R); }
  __device__ __forceinline__ bool feas_at(int q) const { return __ldg(lane_at(feas, q, R)); }
  __device__ __forceinline__ int coll_at(int q) const { return *lane_at(coll, q, R); }
  __device__ __forceinline__ int node_at(int q) const { return *lane_at(nodes, q, R); }
};

template <class Tile>
__device__ __forceinline__ bool tile_fit(const Tile& tile, const int* dem, int q, int C, int pos,
                                         int n_real) {
  return pos < n_real && tile.feas_at(q) && fits(tile.used_row(q, C), tile.cap_row(q, C), dem, 1, C);
}

constexpr int TC_THREADS = 256;
constexpr int TC_ROWS = 2;

template <class Tile, bool ROWS4>
__global__ void __launch_bounds__(TC_THREADS)
    tile_count_kernel(const Tile tile, const int* demand, int* out, unsigned long long* ticket,
                      int T, int C, int t0, int offset, int n_real, int bits) {
  int d[4] = {0, 0, 0, 0};
  if (ROWS4)
#pragma unroll
    for (int c = 0; c < 4; ++c) d[c] = __ldg(demand + c);
  int cnt = 0, before = 0;
  const int stride = gridDim.x * TC_THREADS * TC_ROWS;
  for (int q0 = blockIdx.x * TC_THREADS * TC_ROWS + threadIdx.x; q0 < T; q0 += stride) {
    unsigned char f[TC_ROWS];
    int4 c4[TC_ROWS], u4[TC_ROWS];
#pragma unroll
    for (int r = 0; r < TC_ROWS; ++r) {
      const int q = q0 + r * TC_THREADS;
      f[r] = q < T ? tile.feas_at(q) : 0;
      if (ROWS4 && q < T) {
        c4[r] = __ldg(reinterpret_cast<const int4*>(tile.cap_row(q, 4)));
        u4[r] = __ldg(reinterpret_cast<const int4*>(tile.used_row(q, 4)));
      }
    }
#pragma unroll
    for (int r = 0; r < TC_ROWS; ++r) {
      const int q = q0 + r * TC_THREADS;
      const int pos = t0 + q;
      bool fit = q < T && pos < n_real && f[r];
      if (ROWS4)
        fit = fit && u4[r].x + d[0] <= c4[r].x && u4[r].y + d[1] <= c4[r].y &&
              u4[r].z + d[2] <= c4[r].z && u4[r].w + d[3] <= c4[r].w;
      else
        fit = fit && fits(tile.used_row(q, C), tile.cap_row(q, C), demand, 1, C);
      cnt += fit;
      before += fit && pos < offset;
    }
  }
  __shared__ int sh[TC_THREADS / 32][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  cnt = __reduce_add_sync(FULL_MASK, cnt);
  before = __reduce_add_sync(FULL_MASK, before);
  if (lane == 0) {
    sh[warp][0] = cnt;
    sh[warp][1] = before;
  }
  __syncthreads();
  if (warp == 0) {
    cnt = __reduce_add_sync(FULL_MASK, lane < TC_THREADS / 32 ? sh[lane][0] : 0);
    before = __reduce_add_sync(FULL_MASK, lane < TC_THREADS / 32 ? sh[lane][1] : 0);
    if (lane == 0) {
      const unsigned long long mine =
          (1ull << (2 * bits)) | ((unsigned long long)before << bits) | (unsigned long long)cnt;
      const unsigned long long old = atomicAdd(ticket, mine);
      if ((old >> (2 * bits)) == gridDim.x - 1) {  // the last block: every count is in
        const unsigned long long sum = old + mine, mask = (1ull << bits) - 1;
        out[0] = (int)(sum & mask);
        out[1] = (int)((sum >> bits) & mask);
        *ticket = 0ull;
      }
    }
  }
}

template <class Tile>
struct WindowParams {
  Tile tile;                      // the tile's planes
  const int* demand;              // [C]
  int* bases;                     // [2] out: base window of each straddle group
  float* seg_score;               // [2T+1] out
  int* seg_rank;                  // [2T+1] out
  int* seg_node;                  // [2T+1] out
  int* last;                      // [1] out: last consumed ring position
  float* score_s;                 // [T] scratch
  int* rank_s;                    // [T] feasible rank, -1 when not feasible
  unsigned long long* win_s;      // [2T] per-segment best key
  int* block_s;                   // [T/1024] per block: fit rows | fit rows before the cursor << 16
  int T, C, group_count, limit, t0, offset, n_real, flat_base, x0, total, w_use;
  bool rows4;                     // C == 4 and both row planes 16-byte aligned
};

__device__ __forceinline__ unsigned long long bid(float score, int rank) {
  return ((unsigned long long)float_order(score) << 32) | (unsigned long long)(0xffffffffu - (unsigned)rank);
}

// row q's fit, and its used cpu and memory (the score's inputs)
template <class Tile>
__device__ __forceinline__ bool window_fit(const WindowParams<Tile>& P, int q, int& u0, int& u1) {
  const int* dem = P.demand;
  if (P.rows4) {
    const int4 c4 = __ldg(reinterpret_cast<const int4*>(P.tile.cap_row(q, 4)));
    const int4 u4 = __ldg(reinterpret_cast<const int4*>(P.tile.used_row(q, 4)));
    u0 = u4.x;
    u1 = u4.y;
    return P.t0 + q < P.n_real && P.tile.feas_at(q) && u4.x + dem[0] <= c4.x &&
           u4.y + dem[1] <= c4.y && u4.z + dem[2] <= c4.z && u4.w + dem[3] <= c4.w;
  }
  const int* u = P.tile.used_row(q, P.C);
  u0 = u[0];
  u1 = u[1];
  return tile_fit(P.tile, dem, q, P.C, P.t0 + q, P.n_real);
}

// the straddle group's segment of window w
__device__ __forceinline__ int window_segment(int T, int w, bool wrapped, int lo, int hi) {
  return wrapped ? T + min(max(w - hi, 0), T - 1) : min(max(w - lo, 0), T - 1);
}

template <class Tile>
__global__ void __launch_bounds__(THREADS) tile_score_kernel(WindowParams<Tile> P) {
  const int T = P.T, S = 2 * T + 1;
  const int q = blockIdx.x * THREADS + threadIdx.x;
  const int stride = gridDim.x * THREADS;
  for (int k = q; k < S; k += stride) {
    P.seg_score[k] = -__int_as_float(0x7f800000);
    P.seg_rank[k] = INT_MAX;
    P.seg_node[k] = INT_MIN;
  }
  for (int k = q; k < 2 * T; k += stride) P.win_s[k] = 0ull;
  if (q == 0) *P.last = -1;

  bool fit = false;
  if (q < T) {
    int u0, u1;
    fit = window_fit(P, q, u0, u1);
    float sc = 0.0f;
    if (fit) {
      // binpack + anti-affinity over fired planes
      const int cl = P.tile.coll_at(q);
      const bool ap = cl > 0;
      const float* us = P.tile.usable_row(q);
      const float bp = binpack_f32(free_frac(u0 + P.demand[0], us[0]),
                                   free_frac(u1 + P.demand[1], us[1]));
      sc = __fdiv_rn(__fadd_rn(bp, anti_affinity(__int2float_rn(cl), ap,
                                                 __int2float_rn(P.group_count))),
                     ap ? 2.0f : 1.0f);
    }
    P.score_s[q] = sc;
    P.rank_s[q] = fit ? 0 : -1;
  }
  const int packed = (int)fit | ((int)(fit && P.t0 + q < P.offset) << 16);
  const int counts = block_allreduce<60>(packed, SumI());
  if (threadIdx.x == 0) P.block_s[blockIdx.x] = counts;
}

template <class Tile>
__global__ void __launch_bounds__(THREADS) tile_bid_kernel(WindowParams<Tile> P) {
  const int T = P.T, tid = threadIdx.x, b = blockIdx.x;
  const int q = b * THREADS + tid;
  const int lm = max(P.limit, 1);

  // the tile's counts, and its fit rows in the blocks before this one
  int before_blocks = 0, cnt = 0, before = 0;
  for (int k = tid; k < (int)gridDim.x; k += THREADS) {
    const int c = P.block_s[k];
    cnt += c & 0xffff;
    before += c >> 16;
    if (k < b) before_blocks += c & 0xffff;
  }
  cnt = block_allreduce<61>(cnt, SumI());
  before = block_allreduce<62>(before, SumI());
  before_blocks = block_allreduce<63>(before_blocks, SumI());
  // base windows in closed form (see the note at the top)
  int lo = BIG, hi = BIG;
  if (before > 0) {
    const int w = (P.total - P.x0 + P.flat_base) / lm;
    if (w < P.w_use) hi = w;
  }
  if (cnt > before) {
    const int w = (P.flat_base + before - P.x0) / lm;
    if (w < P.w_use) lo = w;
  }

  const bool fit = q < T && P.rank_s[q] >= 0;
  int x[1] = {(int)fit}, excl[1], tot[1];
  block_scan<1, 64>(x, excl, tot);
  const int pos = P.t0 + q;
  const bool wrapped = pos < P.offset;
  const int xex = P.flat_base + before_blocks + excl[0];
  const int rank = wrapped ? P.total - P.x0 + xex : xex - P.x0;
  const int w = rank / lm;
  const bool active = fit && w < P.w_use;
  int last = -1;
  if (fit) {
    P.rank_s[q] = rank;
    if (rank < P.w_use * P.limit) last = wrapped ? P.n_real - P.offset + pos : pos - P.offset;
  }
  if (active)
    atomicMax(&P.win_s[window_segment(T, w, wrapped, lo, hi)], bid(P.score_s[q], rank));
  last = block_allreduce<65>(last, MaxI());
  const bool any_inactive = __syncthreads_or(q < T && !active);
  if (tid == 0) {
    if (last >= 0) atomicMax(P.last, last);
    if (any_inactive) {
      P.seg_score[2 * T] = neg_inf();
      P.seg_rank[2 * T] = BIG;
      P.seg_node[2 * T] = -1;
    }
    if (b == 0) {
      P.bases[0] = lo;
      P.bases[1] = hi;
    }
  }
}

template <class Tile>
__global__ void __launch_bounds__(THREADS) tile_winner_kernel(WindowParams<Tile> P) {
  const int T = P.T;
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= T) return;
  const int rank = P.rank_s[q];
  const int w = rank / max(P.limit, 1);
  if (rank < 0 || w >= P.w_use) return;
  const int seg = window_segment(T, w, P.t0 + q < P.offset, P.bases[0], P.bases[1]);
  const float sc = P.score_s[q];
  if (P.win_s[seg] != bid(sc, rank)) return;
  P.seg_score[seg] = sc;
  P.seg_rank[seg] = rank;
  P.seg_node[seg] = P.tile.node_at(q);
}

// count fields of ``bits`` bits (T < 2^bits); the ticket takes the rest
template <class Tile>
int launch_count(const Tile& tile, bool rows4, const int* demand, int* out,
                 unsigned long long* ticket, int T, int C, int t0, int offset, int n_real,
                 cudaStream_t s) {
  int bits = 1;
  while (bits < 31 && (1ll << bits) <= T) ++bits;
  const int ticket_bits = 64 - 2 * bits;
  const int max_blocks = ticket_bits >= 31 ? INT_MAX : (1 << ticket_bits) - 1;
  const int blocks = min(max(1, (T + TC_THREADS * TC_ROWS - 1) / (TC_THREADS * TC_ROWS)),
                         max_blocks);
  auto kernel = rows4 ? tile_count_kernel<Tile, true> : tile_count_kernel<Tile, false>;
  kernel<<<blocks, TC_THREADS, 0, s>>>(tile, demand, out, ticket, T, C, t0, offset, n_real, bits);
  return (int)cudaGetLastError();
}

template <class Tile>
int launch_window(const WindowParams<Tile>& P, cudaStream_t s) {
  const int blocks = (P.T + THREADS - 1) / THREADS;
  tile_score_kernel<Tile><<<blocks, THREADS, 0, s>>>(P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_bid_kernel<Tile><<<blocks, THREADS, 0, s>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_winner_kernel<Tile><<<blocks, THREADS, 0, s>>>(P);
  return (int)cudaGetLastError();
}

// The tile table of K12s and K13s: the six planes' slabs (the static tile,
// then the dynamic one, as shard.paged_specs() lists them); whether the
// rows of every slab of the two row planes load as 16-byte vectors
bool slab_tile(const unsigned long long* table, int S, int T, int C, SlabTile& tile) {
  Table t{table, 0};
  t.slabs(tile.cap);
  t.slabs(tile.usable);
  t.slabs(tile.feas);
  t.slabs(tile.nodes);
  t.slabs(tile.used);
  t.slabs(tile.coll);
  tile.R = T / S;
  bool rows4 = C == 4;
  for (int k = 0; k < S; ++k)
    rows4 = rows4 && (((uintptr_t)tile.cap.p[k] | (uintptr_t)tile.used.p[k]) & 15) == 0;
  return rows4;
}

}  // namespace

extern "C" int ntt_tile_count(const void* cap, const void* feas, const void* used,
                              const void* demand, void* out, void* ticket, int T, int C, int t0,
                              int offset, int n_real, void* stream) {
  if (T < 0 || C < 1) return (int)cudaErrorInvalidValue;
  const FlatTile tile{(const int*)cap, nullptr, (const unsigned char*)feas, nullptr,
                      (const int*)used, nullptr};
  const bool rows4 = C == 4 && (((uintptr_t)cap | (uintptr_t)used) & 15) == 0;
  return launch_count(tile, rows4, (const int*)demand, (int*)out, (unsigned long long*)ticket, T,
                      C, t0, offset, n_real, (cudaStream_t)stream);
}

// K12s: sweep 1 over a tile split into S slabs (``table``: slab_tile's)
extern "C" int ntt_mesh_tile_count(const unsigned long long* table, const void* demand, void* out,
                                   void* ticket, int S, int T, int C, int t0, int offset,
                                   int n_real, void* stream) {
  if (S < 1 || S > MAX_SHARDS || T < 0 || T % S || C < 1) return (int)cudaErrorInvalidValue;
  SlabTile tile;
  const bool rows4 = slab_tile(table, S, T, C, tile);
  return launch_count(tile, rows4, (const int*)demand, (int*)out, (unsigned long long*)ticket, T,
                      C, t0, offset, n_real, (cudaStream_t)stream);
}

extern "C" int ntt_tile_window(const void* cap, const void* usable, const void* feas,
                               const void* used, const void* coll, const void* nodes,
                               const void* demand, void* bases, void* seg_score, void* seg_rank,
                               void* seg_node, void* last, void* score_s, void* rank_s,
                               void* win_s, void* block_s, int T, int C, int group_count,
                               int limit, int t0, int offset, int n_real, int flat_base, int x0,
                               int total, int w_use, void* stream) {
  if (T < 1 || C < 2) return (int)cudaErrorInvalidValue;
  const bool rows4 =
      C == 4 && (((uintptr_t)cap | (uintptr_t)used) & 15) == 0;
  const FlatTile tile{(const int*)cap, (const float*)usable, (const unsigned char*)feas,
                      (const int*)nodes, (const int*)used, (const int*)coll};
  const WindowParams<FlatTile> P{tile, (const int*)demand, (int*)bases, (float*)seg_score,
                                 (int*)seg_rank, (int*)seg_node, (int*)last, (float*)score_s,
                                 (int*)rank_s, (unsigned long long*)win_s, (int*)block_s, T, C,
                                 group_count, limit, t0, offset, n_real, flat_base, x0, total,
                                 w_use, rows4};
  return launch_window(P, (cudaStream_t)stream);
}

// K13s: sweep 2 over a tile split into S slabs (``table``: slab_tile's)
extern "C" int ntt_mesh_tile_window(const unsigned long long* table, const void* demand,
                                    void* bases, void* seg_score, void* seg_rank, void* seg_node,
                                    void* last, void* score_s, void* rank_s, void* win_s,
                                    void* block_s, int S, int T, int C, int group_count,
                                    int limit, int t0, int offset, int n_real, int flat_base,
                                    int x0, int total, int w_use, void* stream) {
  if (S < 1 || S > MAX_SHARDS || T < 1 || T % S || C < 2) return (int)cudaErrorInvalidValue;
  SlabTile tile;
  const bool rows4 = slab_tile(table, S, T, C, tile);
  const WindowParams<SlabTile> P{tile, (const int*)demand, (int*)bases, (float*)seg_score,
                                 (int*)seg_rank, (int*)seg_node, (int*)last, (float*)score_s,
                                 (int*)rank_s, (unsigned long long*)win_s, (int*)block_s, T, C,
                                 group_count, limit, t0, offset, n_real, flat_base, x0, total,
                                 w_use, rows4};
  return launch_window(P, (cudaStream_t)stream);
}
