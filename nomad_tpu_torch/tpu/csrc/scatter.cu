// Dirty-row set-scatter into a fresh used plane.
//
// Replaces nomad_tpu/tpu/mirror.py _scatter_fn (:229-253):
// out = used with out[rows[i]] = vals[i], in a NEW buffer (the retired
// plane may still be read by a kernel launched earlier; it is never
// written).
//
// What bounds it on the card: bytes, and the copy of the plane carries
// them (2 x N x C x 4 B = 328 KB at N=10,240); the scatter itself moves
// R x C values. Design: a device-to-device copy of the plane, then two
// launches that make duplicate rows deterministic whatever the values:
// atomicMin finds the lowest lane on each row, and only that lane writes
// (the plain version keeps the same lane). The dirty-row padding repeats
// row 0 with row 0's own value, so real callers' duplicates agree anyway.
// Rows outside [0, N) write nothing.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void scatter_first(const int* __restrict__ rows, int* first, int N, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const int r = rows[i];
  if (r >= 0 && r < N) atomicMin(first + r, i);
}

__global__ void scatter_write(const int* __restrict__ rows, const int* __restrict__ vals,
                              const int* __restrict__ first, int* out, int N, int C, int R) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= (long long)R * C) return;
  const int i = (int)(idx / C), c = (int)(idx % C);
  const int r = rows[i];
  if (r < 0 || r >= N || first[r] != i) return;
  out[(size_t)r * C + c] = vals[(size_t)i * C + c];
}

int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int ntt_scatter_rows(void* used, void* rows, void* vals, void* out, void* first, int N,
                                int C, int R, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemcpyAsync(out, used, (size_t)N * C * sizeof(int), cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  if (R == 0) return (int)cudaSuccess;
  // 0x7f7f7f7f: above every lane index
  err = cudaMemsetAsync(first, 0x7f, (size_t)N * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  scatter_first<<<blocks(R), kThreads, 0, s>>>((const int*)rows, (int*)first, N, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_write<<<blocks((long long)R * C), kThreads, 0, s>>>(
      (const int*)rows, (const int*)vals, (const int*)first, (int*)out, N, C, R);
  return (int)cudaGetLastError();
}
