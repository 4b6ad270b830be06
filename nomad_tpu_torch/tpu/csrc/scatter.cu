// Dirty-row set-scatter into a fresh used plane, in one launch.
//
// Replaces nomad_tpu/tpu/mirror.py _scatter_fn (:229-253):
// out = used with out[rows[i]] = vals[i], in a NEW buffer (the retired
// plane may still be read by a kernel launched earlier; it is never
// written). Among lanes on one row the lowest lane wins (the plain version
// keeps the same lane), so duplicate rows are deterministic whatever their
// values; the dirty-row padding repeats row 0 with row 0's own value, so
// real callers' duplicates agree anyway. Rows outside [0, N) write nothing.
//
// What bounds it on the card: bytes, and the plane carries them (2 x N x C
// x 4 B = 328 KB at N = 10,240); the lanes add R x (C + 1) x 4. Design: one
// launch and nothing else on the stream (no copy of the plane, no memset,
// no global scratch). A block owns ROWS consecutive output rows: it reads
// all R lane rows (at most 16 KB at R = 4,096, from L2 after the first
// block), keeps the lowest lane of each of its rows in shared memory with a
// shared atomicMin over a sentinel it set itself, and after one block
// barrier writes each of its rows once, from vals or from used.
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int ROWS = 256;  // output rows a block owns

__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(const int* __restrict__ used, const int* __restrict__ rows,
                        const int* __restrict__ vals, int* __restrict__ out, int N, int C, int R) {
  __shared__ int first[ROWS];  // lowest lane on each of the block's rows
  const int row0 = blockIdx.x * ROWS;
  const int n_rows = min(ROWS, N - row0);
  for (int k = threadIdx.x; k < ROWS; k += kThreads) first[k] = INT_MAX;
  __syncthreads();
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const int r = __ldg(rows + i) - row0;  // rows outside [0, N) fall outside every block
    if (r >= 0 && r < n_rows) atomicMin(first + r, i);
  }
  __syncthreads();
  const size_t base = (size_t)row0 * C;
  for (int k = threadIdx.x; k < n_rows * C; k += kThreads) {
    const int lane = first[k / C];
    out[base + k] =
        lane == INT_MAX ? __ldg(used + base + k) : __ldg(vals + (size_t)lane * C + k % C);
  }
}

}  // namespace

extern "C" int ntt_scatter_rows(void* used, void* rows, void* vals, void* out, int N, int C, int R,
                                void* stream) {
  if (N <= 0 || C <= 0) return (int)cudaSuccess;  // an empty plane: nothing to write
  scatter_rows_kernel<<<(N + ROWS - 1) / ROWS, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)used, (const int*)rows, (const int*)vals, (int*)out, N, C, R);
  return (int)cudaGetLastError();
}
