// Exchanges across the blocks of one thread block cluster, through
// distributed shared memory, by push: before a cluster barrier each block
// stores its value into its own slot of every block's shared memory (one
// remote store per block, fire and forget); after the barrier (its arrive
// has release and its wait acquire semantics at cluster scope, which orders
// those stores for the readers) every warp reads the slots in its own
// block's shared memory. No remote read waits on another SM, and no block
// barrier broadcasts a result.
#pragma once

#include <cooperative_groups.h>

#include "block.cuh"

namespace ntt {

namespace cg = cooperative_groups;

// The two halves of cluster.sync(): the arrive has release semantics and
// the wait acquire semantics at cluster scope (the PTX defaults). Work
// between them overlaps the barrier, as long as it reads nothing another
// block writes before its arrive.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Store ``v`` in slot ``rank`` of ``slots`` in each of the ``n`` blocks'
// shared memory: threads 0..n-1 of the calling block store one each.
template <class T>
__device__ __forceinline__ void cluster_publish(cg::cluster_group& cluster, T* slots,
                                                unsigned rank, const T& v, int n) {
  if ((int)threadIdx.x < n) *cluster.map_shared_rank(slots + rank, threadIdx.x) = v;
}

// Sum of the published ints over the blocks ranked before ``rank`` and over
// all ``n`` (n <= 32), from this block's slots; every lane of a warp calls.
__device__ __forceinline__ void published_prefix_sum(const int* slots, int n, unsigned rank,
                                                     int& before, int& total) {
  const unsigned lane = threadIdx.x & 31;
  const int x = lane < (unsigned)n ? slots[lane] : 0;
  before = __reduce_add_sync(FULL_MASK, lane < rank ? x : 0);
  total = __reduce_add_sync(FULL_MASK, x);
}

// The first strict max (BestOp) over the published ``Best`` (n <= 32), from
// this block's slots; every lane of a warp calls.
__device__ __forceinline__ Best published_best(const Best* slots, int n) {
  const unsigned lane = threadIdx.x & 31;
  Best v = lane < (unsigned)n ? slots[lane] : best_identity();
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = BestOp()(v, shfl_xor(v, m));
  return v;
}

}  // namespace ntt
