// Score primitives of the placement planners, bit-exact to the JAX package.
//
// Replaces the score helpers of nomad_tpu/tpu/kernel.py: _pow10 (:95),
// _binpack (:151), _class_boosts (:161), the per-node body of _scores
// (:203) and _rot_incl (:255). Every float operation is spelled with a
// correctly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn)
// so no FMA contraction can merge two roundings, whatever nvcc decides;
// the library is also built with --fmad=false and without fast math. The
// planners break ties by exact float equality among hundreds of identical
// nodes, so one ulp anywhere here changes placements.
//
// Constants are float32 bit patterns: the value the JAX code gets from
// jnp.float32(c), or from a Python float meeting a float32 array.
#pragma once

#include <cstdint>

namespace ntt {

constexpr int MAX_SKIP = 3;     // ref stack.go:17

__device__ __forceinline__ float f32(uint32_t bits) { return __int_as_float((int)bits); }

__device__ __forceinline__ float neg_inf() { return f32(0xf149f2cau); }  // -1e30

// 2^e for e in [-126, 127], by exponent-field assembly (exact)
__device__ __forceinline__ float two_pow(int e) { return __int_as_float((e + 127) << 23); }

// Bit-stable float32 10^x: 2^(x*log2 10), the product split Veltkamp-style
// into 12-bit halves so each partial product is exact, a fixed Cephes exp2f
// Horner chain on the fraction, and the exponent applied in two exact steps.
__device__ __forceinline__ float pow10_f32(float x) {
  x = fminf(fmaxf(x, -f32(0x4234cccdu)), f32(0x4234cccdu));  // clip to +-45.2
  const float c = __fmul_rn(f32(0x45800800u), x);              // 4097 * x
  const float x_hi = __fsub_rn(c, __fsub_rn(c, x));
  const float x_lo = __fsub_rn(x, x_hi);
  const float y_hi = __fmul_rn(x_hi, f32(0x4054a000u));        // log2(10) hi
  const float y_lo = __fadd_rn(__fmul_rn(x_hi, f32(0xb9b0f686u)),  // log2(10) lo
                               __fmul_rn(x_lo, f32(0x40549a78u))); // log2(10)
  const float n = rintf(__fadd_rn(y_hi, y_lo));  // jnp.round: half to even
  const float f = __fadd_rn(__fsub_rn(y_hi, n), y_lo);
  float p = f32(0x3920fddeu);
  p = __fadd_rn(__fmul_rn(p, f), f32(0x3aaf9f29u));
  p = __fadd_rn(__fmul_rn(p, f), f32(0x3c1d96a6u));
  p = __fadd_rn(__fmul_rn(p, f), f32(0x3d635774u));
  p = __fadd_rn(__fmul_rn(p, f), f32(0x3e75fdeeu));
  p = __fadd_rn(__fmul_rn(p, f), f32(0x3f317218u));
  p = __fadd_rn(__fmul_rn(p, f), 1.0f);
  const int n_i = (int)n;
  const int n1 = min(max(n_i, -126), 127);
  const int n2 = min(max(n_i - n1, -126), 127);
  return __fmul_rn(__fmul_rn(p, two_pow(n1)), two_pow(n2));
}

// ScoreFit: clip(20 - 10^fcpu - 10^fmem, 0, 18) / 18. XLA rewrites the
// division by the constant 18 as a multiplication by float32(1/18), so
// this multiplies too (a true division differs by one ulp on ~11% of
// inputs).
__device__ __forceinline__ float binpack_f32(float free_cpu, float free_mem) {
  const float total = __fadd_rn(pow10_f32(free_cpu), pow10_f32(free_mem));
  const float t = fminf(fmaxf(__fsub_rn(20.0f, total), 0.0f), 18.0f);
  return __fmul_rn(t, f32(0x3d638e39u));
}

// 1 - util / usable for one resource column
__device__ __forceinline__ float free_frac(int util, float usable) {
  return __fsub_rn(1.0f, __fdiv_rn(__int2float_rn(util), usable));
}

// -(coll + 1) / count when the node already holds one of the group's
// allocs (job anti-affinity, rank.go:509), else 0
__device__ __forceinline__ float anti_affinity(float coll_f, bool present, float count_f) {
  return present ? __fdiv_rn(-__fadd_rn(coll_f, 1.0f), count_f) : 0.0f;
}

// Spread boost per value class, plus the missing-value class at index V
// (spread.go:110-227: target mode boosts (desired - used)/desired weighted,
// even mode boosts below-min classes). One thread computes it.
__device__ inline void class_boosts(const int* counts, const unsigned char* present,
                                    const float* desired, float implicit,
                                    float weight_frac, bool even_flag,
                                    bool active_flag, int V, float* out) {
  const float eps = f32(0x3089705fu);  // 1e-9
  const float big = f32(0x4e800000u);  // 2**30
  bool any_present = false;
  float min_c = big, max_c = -big;
  for (int c = 0; c < V; ++c) {
    if (present[c]) {
      any_present = true;
      const float cf = __int2float_rn(counts[c]);
      min_c = fminf(min_c, cf);
      max_c = fmaxf(max_c, cf);
    }
  }
  const float min_count = any_present ? min_c : 0.0f;
  const float max_count = any_present ? max_c : 0.0f;
  for (int c = 0; c < V; ++c) {
    const float cf = __int2float_rn(counts[c]);
    const float used_count = __fadd_rn(cf, 1.0f);
    const float de = desired[c] >= 0.0f ? desired[c] : implicit;
    const float target =
        de >= 0.0f
            ? __fmul_rn(__fdiv_rn(__fsub_rn(de, used_count), fmaxf(de, eps)), weight_frac)
            : -1.0f;
    float even;
    if (!any_present) {
      even = 0.0f;
    } else if (cf != min_count) {
      even = min_count == 0.0f ? -1.0f
                               : __fdiv_rn(__fsub_rn(min_count, cf), fmaxf(min_count, eps));
    } else if (min_count == max_count) {
      even = -1.0f;
    } else if (min_count == 0.0f) {
      even = 1.0f;
    } else {
      even = __fdiv_rn(__fsub_rn(max_count, min_count), fmaxf(min_count, eps));
    }
    const float per_class = even_flag ? even : target;
    out[c] = active_flag ? per_class : 0.0f;
  }
  out[V] = active_flag ? -1.0f : 0.0f;
}

// Final score of one node for one placement: binpack, anti-affinity,
// affinity and spread, averaged over the planes that fired. ``num_out``
// receives the plane count (the run planner keys its sweep on it).
__device__ __forceinline__ float score_node(float free_cpu, float free_mem, int coll,
                                            float count_f, bool aff_present, float aff,
                                            bool spread_active, float spread_boost,
                                            float* num_out = nullptr) {
  const float bp = binpack_f32(free_cpu, free_mem);
  const bool ap = coll > 0;
  const float an = anti_affinity(__int2float_rn(coll), ap, count_f);
  const bool fired = spread_active && spread_boost != 0.0f;
  const float num = __fadd_rn(__fadd_rn(__fadd_rn(1.0f, ap ? 1.0f : 0.0f),
                                        aff_present ? 1.0f : 0.0f),
                              fired ? 1.0f : 0.0f);
  if (num_out) *num_out = num;
  const float sum = __fadd_rn(__fadd_rn(__fadd_rn(bp, an), aff_present ? aff : 0.0f),
                              fired ? spread_boost : 0.0f);
  return __fdiv_rn(sum, num);
}

// Inclusive count along the ring that starts at ``offset``, from the
// plain inclusive prefix ``xc`` at position p, the count ``x_off`` before
// the offset and the ``total`` (the two-segment prefix-sum trick)
__device__ __forceinline__ int rot_incl(int xc, int x_off, int total, int p, int offset) {
  return p >= offset ? xc - x_off : total - x_off + xc;
}

// Order-preserving map of a float to uint32 (ascending), with -0.0 folded
// onto +0.0 as lax.sort's comparator and IEEE equality both do
__device__ __forceinline__ uint32_t float_order(float x) {
  if (x == 0.0f) x = 0.0f;
  const uint32_t b = (uint32_t)__float_as_int(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

}  // namespace ntt
