// The plan applier's dense verify.
//
// Replaces nomad_tpu/tpu/kernel.py _verify_rows_jit (:1061): for each
// lane i, all over columns c of
//   used[rows[i], c] + sum of deltas[j, c] over lanes j on rows[i]
//     <= capacity[rows[i], c]
// with used left as it is. Deltas may be negative (stops, preemptions);
// int32 adds wrap, as JAX's do.
//
// What bounds it on the card: bytes, and few of them (the touched rows of
// two planes plus the lanes: about 0.3 MB at R=4,096), but one SM pulls
// them from L2 at a fraction of the card's rate, and the chain of
// dependent steps inside a launch costs more than the bytes. Design: ONE
// launch with no global scratch, over B blocks that never wait for one
// another. Block b owns the rows [b*S, b*S + S) (S = ceil(N / B)) and keeps
// their sums in shared memory, indexed by row. Every block reads every
// lane's row (the rows are 4 bytes a lane; the deltas and the planes are
// 16 a lane and row at C = 4, read only by the row's owner) and:
// - zeroes its sums while the rows load, and loads the deltas of its own
//   lanes (the lanes on its rows);
// - after a barrier, atomicAdds its lanes' nonzero deltas into their rows'
//   sums (integer atomics are exact and order-free, so the verdicts are
//   bit-identical to the plain version);
// - after a second barrier, loads its lanes' rows of both planes and
//   writes their verdicts.
// A lane whose row lies outside [0, N) adds nothing and fails; block 0
// writes its verdict. B is at least 16 (the lanes' bytes spread over 16
// SMs) and as many as the rows' sums need at the block's shared-memory
// limit (N = 10,240 at C = 4: 16 blocks of 640 rows, 10 KB). A thread holds its
// first 4 lanes in registers; R past 4,096 lanes reads the rest again in
// each step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
// lanes a thread holds from its first loads
constexpr int kLanes = 4;
constexpr int kMinBlocks = 16;

struct Params {
  const int* capacity;
  const int* used;
  const int* rows;
  const int* deltas;
  unsigned char* fits;
  int N, C, R;
  int span;  // rows a block owns
};

__device__ __forceinline__ bool fits_col(int used, unsigned sum, int cap) {
  return (int)((unsigned)used + sum) <= cap;
}

// lane i's nonzero deltas into its row's sums; at C = 4 ``d`` holds them
template <bool C4>
__device__ __forceinline__ void add_deltas(const Params& P, int i, const int4& d, unsigned* s) {
  if (C4) {
    if (d.x) atomicAdd(s + 0, (unsigned)d.x);
    if (d.y) atomicAdd(s + 1, (unsigned)d.y);
    if (d.z) atomicAdd(s + 2, (unsigned)d.z);
    if (d.w) atomicAdd(s + 3, (unsigned)d.w);
    return;
  }
  for (int c = 0; c < P.C; ++c) {
    const unsigned x = (unsigned)__ldg(P.deltas + (size_t)i * P.C + c);
    if (x) atomicAdd(s + c, x);
  }
}

// the verdict of a lane on row ``row``, given its row's sums
template <bool C4>
__device__ __forceinline__ bool verdict(const Params& P, int row, const unsigned* s) {
  if (C4) {
    const int4 u = __ldg(reinterpret_cast<const int4*>(P.used) + row);
    const int4 c = __ldg(reinterpret_cast<const int4*>(P.capacity) + row);
    return fits_col(u.x, s[0], c.x) && fits_col(u.y, s[1], c.y) && fits_col(u.z, s[2], c.z) &&
           fits_col(u.w, s[3], c.w);
  }
  bool ok = true;
  for (int c = 0; ok && c < P.C; ++c) {
    const size_t at = (size_t)row * P.C + c;
    ok = fits_col(__ldg(P.used + at), s[c], __ldg(P.capacity + at));
  }
  return ok;
}

template <bool C4>
__global__ void __launch_bounds__(kThreads) verify_kernel(Params P) {
  extern __shared__ __align__(16) unsigned sums[];  // [span][C]
  const int tid = threadIdx.x;
  const int lo = blockIdx.x * P.span;
  const unsigned span = (unsigned)min(P.span, P.N - lo);  // rows this block owns
  const int held = kLanes * kThreads;
  // the first lanes' rows, and the deltas of the block's own
  int row[kLanes];
  int4 d[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int i = tid + j * kThreads;
    row[j] = i < P.R ? __ldg(P.rows + i) : -1;
  }
  if (C4) {
    for (int k = tid; k < P.span; k += kThreads)
      reinterpret_cast<uint4*>(sums)[k] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (int k = tid; k < P.span * P.C; k += kThreads) sums[k] = 0u;
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    d[j] = make_int4(0, 0, 0, 0);
    if (C4 && (unsigned)row[j] - (unsigned)lo < span)
      d[j] = __ldg(reinterpret_cast<const int4*>(P.deltas) + tid + j * kThreads);
  }
  __syncthreads();  // the sums are zero

#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const unsigned r = (unsigned)row[j] - (unsigned)lo;
    if (r < span) add_deltas<C4>(P, tid + j * kThreads, d[j], sums + (size_t)r * P.C);
  }
  for (int i = held + tid; i < P.R; i += kThreads) {
    const unsigned r = (unsigned)__ldg(P.rows + i) - (unsigned)lo;
    if (r >= span) continue;
    const int4 di = C4 ? __ldg(reinterpret_cast<const int4*>(P.deltas) + i) : make_int4(0, 0, 0, 0);
    add_deltas<C4>(P, i, di, sums + (size_t)r * P.C);
  }
  __syncthreads();  // every sum is complete

  // the verdicts of the block's lanes; block 0 also fails the lanes whose
  // row lies outside [0, N)
  const auto judge = [&](int i, int rw) {
    const unsigned r = (unsigned)rw - (unsigned)lo;
    if (r < span)
      P.fits[i] = verdict<C4>(P, rw, sums + (size_t)r * P.C) ? 1 : 0;
    else if (blockIdx.x == 0 && (rw < 0 || rw >= P.N))
      P.fits[i] = 0;
  };
#pragma unroll
  for (int j = 0; j < kLanes; ++j)
    if (tid + j * kThreads < P.R) judge(tid + j * kThreads, row[j]);
  for (int i = held + tid; i < P.R; i += kThreads) judge(i, __ldg(P.rows + i));
}

int smem_limit() {
  static int limit = 0;
  if (limit == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return limit;
}

// Raise the kernels' shared-memory limits, once
cudaError_t set_limits() {
  static cudaError_t done = cudaErrorNotReady;
  if (done == cudaErrorNotReady) {
    const int limit = smem_limit();
    done = cudaFuncSetAttribute(verify_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                limit);
    if (done == cudaSuccess)
      done = cudaFuncSetAttribute(verify_kernel<false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  }
  return done;
}

// Blocks and rows a block for N rows of C columns
int pick_shape(int N, int C, int* blocks, int* span) {
  const cudaError_t err = set_limits();
  if (err != cudaSuccess) return (int)err;
  const long long row_bytes = (long long)C * sizeof(unsigned);
  const long long per_block = smem_limit() / row_bytes;  // rows a block can own
  if (per_block < 1) return (int)cudaErrorInvalidValue;
  long long b = (N + per_block - 1) / per_block;
  if (b < kMinBlocks) b = kMinBlocks;
  if (b > N) b = N;
  *span = (int)((N + b - 1) / b);
  *blocks = (N + *span - 1) / *span;
  return 0;
}

}  // namespace

// The launch's shape for N rows of C columns: out[0] its blocks, out[1]
// the rows a block owns
extern "C" int ntt_verify_shape(void* out, int N, int C, int R, void* stream) {
  (void)R;
  (void)stream;
  if (N < 1 || C < 1) return (int)cudaErrorInvalidValue;
  int* o = (int*)out;
  return pick_shape(N, C, o, o + 1);
}

extern "C" int ntt_verify_rows(void* capacity, void* used, void* rows, void* deltas, void* fits,
                               int N, int C, int R, void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1) return (int)cudaMemsetAsync(fits, 0, R, st);  // no row: every lane fails
  if (C < 1) return (int)cudaErrorInvalidValue;
  int blocks = 0, span = 0;
  const int err = pick_shape(N, C, &blocks, &span);
  if (err) return err;
  const Params P{(const int*)capacity, (const int*)used, (const int*)rows, (const int*)deltas,
                 (unsigned char*)fits, N, C, R, span};
  const size_t smem = (size_t)span * C * sizeof(unsigned);
  // the 16-byte row path: four columns, every plane aligned
  const uintptr_t bits = reinterpret_cast<uintptr_t>(capacity) |
                         reinterpret_cast<uintptr_t>(used) | reinterpret_cast<uintptr_t>(deltas);
  if (C == 4 && (bits & 15) == 0)
    verify_kernel<true><<<blocks, kThreads, smem, st>>>(P);
  else
    verify_kernel<false><<<blocks, kThreads, smem, st>>>(P);
  return (int)cudaGetLastError();
}
