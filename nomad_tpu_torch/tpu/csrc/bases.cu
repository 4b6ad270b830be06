// Per-eval usage bases of a fused drain batch.
//
// Replaces nomad_tpu/tpu/drain.py _used_bases_fn -> bases (:181):
// out[e] = used0 + sum over evals e' < e of delta[e'], where delta[e', n]
// sums the demands of the lanes of eval e' placed on node n < n_real.
//
// What bounds it on the card: bytes. It reads used0 [N,C] and the lanes
// and writes E planes of [N,C] (5.2 MB at E=32, N=10,240, C=4); the work
// is one add per output value. At that size the bytes take 1.6 us and a
// launch about 0.9, so what counts is the chain of dependent steps inside
// one launch. Design: ONE launch that writes each output value once (no
// memset, no read-back). A plane is N*C contiguous ints; block b owns W of
// them, [b*W, b*W + W) of every plane: the plane split evenly over the
// SMs, one block of 512 threads each (W = 312: 78 nodes at N = 10,240 and
// C = 4 on 132 SMs; a node's columns may straddle two blocks at other C).
// - Lanes. Every thread loads its share of the placements (16-byte loads,
//   four in flight) before the block's first barrier, and lists the lanes
//   placed on the block's real nodes in shared memory. After the barrier
//   one thread a listed lane loads its eval and, where it lies in the
//   chunk, adds its demands into per-eval deltas in shared memory [E][W]
//   with integer atomicAdd (exact and order-free, so the result is
//   bit-identical to the plain version). A block whose list overflows
//   scans the lanes again for each chunk of evals.
// - Walk. After a second barrier each thread owns one int of the slice
//   (a warp stores 128 contiguous bytes a plane), starts from used0 and
//   walks the evals: it stores its running value into out[e], then adds
//   delta[e].
// W is halved while its E deltas overflow the block's budget (40 KB of the
// default 48 KB: no opt-in); where even W = 4 does not fit, the block
// takes the evals in chunks that do, scanning the lanes again each chunk
// when its list overflowed and keeping its running value in a register
// between them. Adds are on unsigned values: int32 wraps, as JAX's do. It
// reads the scan's placements where the scan left them, on the same
// stream, so the host never waits between the two launches.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
// ints of a plane a block owns: at most one a thread, a multiple of 4
constexpr int kMaxWidth = kThreads;
constexpr int kMinWidth = 4;
// lanes a block lists (more: it scans the lanes again)
constexpr int kList = 512;
// dynamic shared bytes of the deltas; the lists take 4 KB more
constexpr int kDeltaBytes = 40 * 1024;

// Lane a, placed on real node p whose ints meet [lo, lo + W): add its
// demands into the deltas of its eval, when that lies in [e0, e0 + ec).
__device__ __forceinline__ void add_lane(unsigned* delta, const int* __restrict__ demands,
                                         const int* __restrict__ eval_of, int a, int p, int C,
                                         long long lo, int W, int e0, int ec) {
  const long long first = (long long)p * C;
  const int c0 = (int)max(0LL, lo - first), c1 = (int)min((long long)C, lo + W - first);
  const int e = __ldg(eval_of + a);
  if (e < e0 || e >= e0 + ec) return;
  const int* dem = demands + (size_t)a * C;
  unsigned* d = delta + (size_t)(e - e0) * W + (first - lo);
  for (int c = c0; c < c1; ++c) {
    const unsigned x = (unsigned)__ldg(dem + c);
    if (x) atomicAdd(d + c, x);
  }
}

__device__ __forceinline__ void zero_deltas(unsigned* delta, int n4) {
  for (int i = threadIdx.x; i < n4; i += kThreads)
    reinterpret_cast<uint4*>(delta)[i] = make_uint4(0u, 0u, 0u, 0u);
}

__global__ void __launch_bounds__(kThreads)
    bases_kernel(const int* __restrict__ used0, const int* __restrict__ placements,
                 const int* __restrict__ demands, const int* __restrict__ eval_of,
                 int* __restrict__ out, int N, int C, int A, int E, int n_real, int W,
                 int ec_max) {
  extern __shared__ __align__(16) unsigned delta[];  // [ec_max][W]
  __shared__ int list_a[kList], list_p[kList];
  __shared__ int listed;
  const int tid = threadIdx.x;
  const long long plane = (long long)N * C;
  const long long lo = (long long)blockIdx.x * W;
  const int ints = (int)min((long long)W, plane - lo);  // this block's ints of a plane
  // the nodes whose ints meet [lo, lo + ints), cut at the real nodes
  const int n_lo = (int)(lo / C);
  const int n_hi = min((int)((lo + ints + C - 1) / C), n_real);
  const unsigned span = n_hi > n_lo ? (unsigned)(n_hi - n_lo) : 0u;
  const bool own = tid < ints;  // this thread's int of the slice
  unsigned acc = own ? (unsigned)__ldg(used0 + lo + tid) : 0u;

  // the first 4 * kThreads * 4 placements, loaded before the first barrier
  const bool vec = (reinterpret_cast<uintptr_t>(placements) & 15) == 0;
  const int A4 = vec ? A / 4 : 0;
  int4 p4[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = tid + j * kThreads;
    p4[j] = q < A4 ? __ldg(reinterpret_cast<const int4*>(placements) + q)
                   : make_int4(-1, -1, -1, -1);
  }
  if (tid == 0) listed = 0;
  zero_deltas(delta, min(ec_max, E) * W / 4);
  __syncthreads();

  // list the lanes on the block's real nodes
  const auto take = [&](int a, int p) {
    if ((unsigned)p - (unsigned)n_lo < span) {
      const int s = atomicAdd(&listed, 1);
      if (s < kList) {
        list_a[s] = a;
        list_p[s] = p;
      }
    }
  };
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int a = 4 * (tid + j * kThreads);
    take(a, p4[j].x);
    take(a + 1, p4[j].y);
    take(a + 2, p4[j].z);
    take(a + 3, p4[j].w);
  }
  for (int q0 = tid + 4 * kThreads; q0 < A4; q0 += 4 * kThreads) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = q0 + j * kThreads;
      p4[j] = q < A4 ? __ldg(reinterpret_cast<const int4*>(placements) + q)
                     : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = 4 * (q0 + j * kThreads);
      take(a, p4[j].x);
      take(a + 1, p4[j].y);
      take(a + 2, p4[j].z);
      take(a + 3, p4[j].w);
    }
  }
  for (int a = 4 * A4 + tid; a < A; a += kThreads) take(a, __ldg(placements + a));
  __syncthreads();
  const int n_listed = listed;  // past kList: the list is not whole

  for (int e0 = 0; e0 < E; e0 += ec_max) {
    const int ec = min(ec_max, E - e0);
    if (e0 > 0) {
      zero_deltas(delta, ec * W / 4);
      __syncthreads();
    }
    if (n_listed <= kList) {
      for (int i = tid; i < n_listed; i += kThreads)
        add_lane(delta, demands, eval_of, list_a[i], list_p[i], C, lo, W, e0, ec);
    } else {
      for (int a = tid; a < A; a += kThreads) {
        const int p = __ldg(placements + a);
        if ((unsigned)p - (unsigned)n_lo < span)
          add_lane(delta, demands, eval_of, a, p, C, lo, W, e0, ec);
      }
    }
    __syncthreads();
    if (own) {
      int* o = out + (long long)e0 * plane + lo + tid;
      for (int k = 0; k < ec; ++k) {
        o[(long long)k * plane] = (int)acc;
        acc += delta[k * W + tid];
      }
    }
    if (e0 + ec < E) __syncthreads();  // the next chunk zeroes the deltas
  }
}

// (W, evals a chunk) of one launch
struct Shape {
  int W, ec;
};

// W: the plane split evenly over the card's SMs, one block each, rounded
// up to a multiple of 4 ints; halved while E deltas of W ints overflow the
// budget
Shape pick_shape(long long plane, int E) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    sms = max(sms, 1);
  }
  long long w = (plane + sms - 1) / sms;
  w = min((long long)kMaxWidth, (w + 3) / 4 * 4);
  while (w > kMinWidth && (long long)E * w * 4 > kDeltaBytes) w = (w / 2 + 3) / 4 * 4;
  Shape s;
  s.W = (int)w;
  s.ec = (int)min((long long)E, (long long)kDeltaBytes / (s.W * 4));
  return s;
}

}  // namespace

extern "C" int ntt_used_bases(void* used0, void* placements, void* demands, void* eval_of,
                              void* out, int N, int C, int A, int E, int n_real, void* stream) {
  const long long plane = (long long)N * C;
  if (plane <= 0 || E <= 0) return (int)cudaSuccess;  // no output value
  const Shape s = pick_shape(plane, E);
  const int blocks = (int)((plane + s.W - 1) / s.W);
  const size_t smem = (size_t)s.ec * s.W * sizeof(unsigned);
  bases_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)used0, (const int*)placements, (const int*)demands, (const int*)eval_of,
      (int*)out, N, C, A, E, n_real, s.W, s.ec);
  return (int)cudaGetLastError();
}
