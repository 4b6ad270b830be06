// The server path's one-shot kernels over a node axis split into S shards
// on one card: the applier's dense verify (K8s), the drain batch's usage
// bases (K9s) and the mirror's dirty-row scatter (K10s).
//
// Replaces the sharded dispatch of nomad_tpu/tpu/kernel.py _verify_rows_jit
// (:1061) on mirror.verify_handles(..., mesh), of nomad_tpu/tpu/drain.py
// bases (:181) on the mirror's row-sharded used plane, and of
// nomad_tpu/tpu/mirror.py _scatter_fn(mesh) (:229), which the JAX package
// runs under NamedSharding(P("nodes", None)) with GSPMD's collectives.
//
// Each is ONE launch over all S shards, its slabs passed in the pointer
// table of the mesh planners (mesh.cuh Table/Slabs: shard s owns the
// contiguous global rows [s * R, (s + 1) * R), R = N / S). Block b of a
// launch belongs to shard b / Q and owns a range of that shard's rows, so
// no block waits for another and no global scratch is used. Every value is
// an int32; adds are on unsigned values (int32 wraps, as JAX's do) and
// integer atomics are exact and order-free, so each result is
// bit-identical to the plain version whatever order the blocks run in.
//
// What bounds them on the card: bytes, and few of them (the planes they
// touch and the lanes), so the launch and its chain of dependent steps
// cost more than the bytes. The designs are the unsharded kernels'
// (verify.cu, bases.cu, scatter.cu) cut to a shard's rows and kept simple:
//
// - K8s (mesh_verify): a block owns ``span`` rows of its shard and keeps
//   their summed deltas in shared memory. It reads every lane's row, adds
//   the deltas of the lanes on its rows, and after a barrier writes the
//   verdict of each such lane (all columns of used + sum <= capacity).
//   Each lane's row is owned by exactly one block of one shard, so writing
//   by ownership is the fit's all-reduce over the shards. A lane whose row
//   lies outside [0, N) adds nothing and fails (block 0 writes it).
// - K9s (mesh_bases): a block owns W ints of its shard's [R, C] plane (one
//   a thread) and writes them in every eval's plane of the shard's
//   [E, R, C] output slab. It adds the demands of the lanes placed on its
//   ints (placements in [0, n_real), evals in [0, E)) into per-eval deltas
//   in shared memory, then each thread walks the evals from used0: it
//   stores its running value into out[e], then adds delta[e]. The
//   exclusive prefix over E is local to a (row, column), so no shard needs
//   another's. Evals past the shared-memory budget go in passes, the
//   running value kept in a register between them.
// - K10s (mesh_scatter): a block owns ROWS consecutive rows of its shard
//   and writes each of them once into the NEW slab, from vals where a lane
//   names the row (the lowest such lane, kept by a shared atomicMin) or
//   from used where none does. Lanes outside [0, N) write nothing.
#include <climits>

#include <cuda_runtime.h>

#include "mesh.cuh"

namespace {

using namespace ntt;

constexpr int kThreads = 256;
// verify: blocks a launch has at least (the lanes' reads spread over SMs)
constexpr int kMinVerifyBlocks = 16;
// shared bytes a block's sums or deltas may take (the default 48 KB limit)
constexpr int kSharedBytes = 40 * 1024;
// bases: ints of a shard's plane a block owns (one a thread)
constexpr int kBaseWidth = kThreads;
// scatter: rows a block owns
constexpr int kScatterRows = 256;

struct VerifyP {
  Slabs<const int> capacity, used;
  const int* rows;
  const int* deltas;
  unsigned char* fits;
  int S, Q, N, C, R, span;
};

__global__ void __launch_bounds__(kThreads) mesh_verify_kernel(const VerifyP P) {
  extern __shared__ unsigned sums[];  // [span][C]
  const int Rs = P.N / P.S;
  const int s = blockIdx.x / P.Q, q = blockIdx.x % P.Q;
  const int first = min(q * P.span, Rs);
  const int lo = s * Rs + first;                                    // global rows [lo, lo + own)
  const unsigned own = (unsigned)(min((q + 1) * P.span, Rs) - first);
  for (int k = threadIdx.x; k < P.span * P.C; k += blockDim.x) sums[k] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < P.R; i += blockDim.x) {
    const unsigned r = (unsigned)__ldg(P.rows + i) - (unsigned)lo;
    if (r >= own) continue;
    for (int c = 0; c < P.C; ++c) {
      const unsigned d = (unsigned)__ldg(P.deltas + (size_t)i * P.C + c);
      if (d) atomicAdd(sums + (size_t)r * P.C + c, d);
    }
  }
  __syncthreads();  // every sum of the block's rows is complete
  const int* cap = P.capacity.p[s] + (size_t)first * P.C;
  const int* used = P.used.p[s] + (size_t)first * P.C;
  for (int i = threadIdx.x; i < P.R; i += blockDim.x) {
    const int row = __ldg(P.rows + i);
    const unsigned r = (unsigned)row - (unsigned)lo;
    if (r < own) {
      bool ok = true;
      for (int c = 0; ok && c < P.C; ++c) {
        const size_t at = (size_t)r * P.C + c;
        ok = (int)((unsigned)__ldg(used + at) + sums[at]) <= __ldg(cap + at);
      }
      P.fits[i] = ok ? 1 : 0;
    } else if (blockIdx.x == 0 && (row < 0 || row >= P.N)) {
      P.fits[i] = 0;
    }
  }
}

struct BasesP {
  Slabs<const int> used0;
  const int* placements;
  const int* demands;
  const int* eval_of;
  Slabs<int> out;
  int S, Q, N, C, A, E, n_real, ec;
};

__global__ void __launch_bounds__(kThreads) mesh_bases_kernel(const BasesP P) {
  extern __shared__ unsigned delta[];  // [ec][kBaseWidth]
  const int Rs = P.N / P.S;
  const int s = blockIdx.x / P.Q, q = blockIdx.x % P.Q;
  const long long plane = (long long)Rs * P.C;  // ints of the shard's [R, C] plane
  const long long lo = (long long)q * kBaseWidth;
  const int w = (int)min((long long)kBaseWidth, plane - lo);  // ints this block owns
  const long long row0 = (long long)s * Rs;                    // the shard's first global row
  const int* u0 = P.used0.p[s];
  int* out = P.out.p[s];
  const int t = threadIdx.x;
  unsigned run = t < w ? (unsigned)__ldg(u0 + lo + t) : 0u;
  for (int e0 = 0; e0 < P.E; e0 += P.ec) {
    const int n_e = min(P.ec, P.E - e0);
    for (int k = t; k < n_e * kBaseWidth; k += blockDim.x) delta[k] = 0u;
    __syncthreads();
    for (int a = t; a < P.A; a += blockDim.x) {
      const int p = __ldg(P.placements + a);
      if (p < 0 || p >= P.n_real) continue;
      const int e = __ldg(P.eval_of + a);
      if (e < e0 || e >= e0 + n_e) continue;
      const long long at = ((long long)p - row0) * P.C;  // the node's first int in the shard
      const int c0 = (int)max(0LL, lo - at), c1 = (int)min((long long)P.C, lo + w - at);
      for (int c = c0; c < c1; ++c)
        atomicAdd(delta + (size_t)(e - e0) * kBaseWidth + (at + c - lo),
                  (unsigned)__ldg(P.demands + (size_t)a * P.C + c));
    }
    __syncthreads();  // every delta of this pass is complete
    if (t < w) {
      for (int e = 0; e < n_e; ++e) {
        out[(size_t)(e0 + e) * plane + lo + t] = (int)run;
        run += delta[(size_t)e * kBaseWidth + t];
      }
    }
    __syncthreads();  // the deltas are read before the next pass zeroes them
  }
}

struct ScatterP {
  Slabs<const int> used;
  const int* rows;
  const int* vals;
  Slabs<int> out;
  int S, Q, N, C, B;
};

__global__ void __launch_bounds__(kThreads) mesh_scatter_kernel(const ScatterP P) {
  __shared__ int first[kScatterRows];  // the lowest lane on each of the block's rows
  const int Rs = P.N / P.S;
  const int s = blockIdx.x / P.Q, q = blockIdx.x % P.Q;
  const int r0 = q * kScatterRows;  // the block's first row in its shard
  const int n_rows = min(kScatterRows, Rs - r0);
  const long long lo = (long long)s * Rs + r0;
  for (int k = threadIdx.x; k < kScatterRows; k += blockDim.x) first[k] = INT_MAX;
  __syncthreads();
  for (int i = threadIdx.x; i < P.B; i += blockDim.x) {
    const long long r = (long long)__ldg(P.rows + i) - lo;  // rows outside [0, N) meet no block
    if (r >= 0 && r < n_rows) atomicMin(first + r, i);
  }
  __syncthreads();
  const size_t base = (size_t)r0 * P.C;
  const int* used = P.used.p[s];
  int* out = P.out.p[s];
  for (int k = threadIdx.x; k < n_rows * P.C; k += blockDim.x) {
    const int lane = first[k / P.C];
    out[base + k] = lane == INT_MAX ? __ldg(used + base + k)
                                    : __ldg(P.vals + (size_t)lane * P.C + k % P.C);
  }
}

// Blocks a shard and rows a block of the verify over S shards of an N-row
// axis of C columns
void verify_shape(int S, int N, int C, int* Q, int* span) {
  const int Rs = N / S;
  const int per_block = kSharedBytes / (C * (int)sizeof(unsigned));
  int q = max((Rs + per_block - 1) / per_block, (kMinVerifyBlocks + S - 1) / S);
  q = max(1, min(q, Rs));
  *span = (Rs + q - 1) / q;
  *Q = (Rs + *span - 1) / *span;
}

bool mesh_ok(int S, int N, int C) { return S >= 1 && S <= MAX_SHARDS && N % S == 0 && C >= 1; }

}  // namespace

extern "C" int ntt_mesh_verify(const unsigned long long* table, int S, int N, int C, int R,
                               cudaStream_t stream) {
  VerifyP P;
  Table t{table, 0};
  t.slabs(P.capacity);
  t.slabs(P.used);
  t.one(P.rows);
  t.one(P.deltas);
  t.one(P.fits);
  if (R <= 0) return (int)cudaSuccess;
  if (!mesh_ok(S, N, C)) return (int)cudaErrorInvalidValue;
  if (N < S) return (int)cudaMemsetAsync(P.fits, 0, R, stream);  // no row: every lane fails
  P.S = S, P.N = N, P.C = C, P.R = R;
  verify_shape(S, N, C, &P.Q, &P.span);
  const size_t smem = (size_t)P.span * C * sizeof(unsigned);
  mesh_verify_kernel<<<S * P.Q, kThreads, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

extern "C" int ntt_mesh_bases(const unsigned long long* table, int S, int N, int C, int A, int E,
                              int n_real, cudaStream_t stream) {
  BasesP P;
  Table t{table, 0};
  t.slabs(P.used0);
  t.one(P.placements);
  t.one(P.demands);
  t.one(P.eval_of);
  t.slabs(P.out);
  if (!mesh_ok(S, N, C)) return (int)cudaErrorInvalidValue;
  const long long plane = (long long)(N / S) * C;
  if (E <= 0 || plane == 0) return (int)cudaSuccess;  // nothing to write
  P.S = S, P.N = N, P.C = C, P.A = A, P.E = E, P.n_real = n_real;
  P.Q = (int)((plane + kBaseWidth - 1) / kBaseWidth);
  P.ec = min(E, kSharedBytes / (kBaseWidth * (int)sizeof(unsigned)));
  const size_t smem = (size_t)P.ec * kBaseWidth * sizeof(unsigned);
  mesh_bases_kernel<<<S * P.Q, kThreads, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

extern "C" int ntt_mesh_scatter(const unsigned long long* table, int S, int N, int C, int B,
                                cudaStream_t stream) {
  ScatterP P;
  Table t{table, 0};
  t.slabs(P.used);
  t.one(P.rows);
  t.one(P.vals);
  t.slabs(P.out);
  if (!mesh_ok(S, N, C)) return (int)cudaErrorInvalidValue;
  const int Rs = N / S;
  if (Rs == 0) return (int)cudaSuccess;  // an empty plane: nothing to write
  P.S = S, P.N = N, P.C = C, P.B = B;
  P.Q = (Rs + kScatterRows - 1) / kScatterRows;
  mesh_scatter_kernel<<<S * P.Q, kThreads, 0, stream>>>(P);
  return (int)cudaGetLastError();
}
