// One lane of K17 (dot_kernels.cu): a weighted sum of Montgomery products
//   acc = sum_e w_e * A[k_e] * B[k_e] * R^-1 mod p
// over the entries e of one output row of a small signed weight matrix.
//
// The entries are the row's non-zero weights, two 32-bit words each:
//   word 0: the pair index k (bits 0-29), and kDotSquare where the pair is
//           a square (A[k] = B[k]; only A is read, the product is mont_sq);
//   word 1: the weight, a signed integer, never 0.
// Each product is canonical, so |w| t is formed by double-and-add over the
// bits of |w| and added to or subtracted from the sum with mod_add/mod_sub:
// every step stays canonical, and the result is the unique canonical value
// of the sum whatever the order, which is what the reference's one shared
// reduction gives too.
//
// Operand k of lane `off` sits at limb stride `ls` and offset k * ps + off
// (A and B are [L, K, n] arrays: ls = K n, ps = n).

#pragma once

#include "mont.cuh"

constexpr uint32_t kDotSquare = 1u << 30;
constexpr uint32_t kDotPair = kDotSquare - 1;

template <int W>
__device__ __forceinline__ void dot_lane(uint32_t (&acc)[W], const uint32_t* A,
                                         const uint32_t* B, size_t ls, size_t ps,
                                         size_t off, const int32_t* ent, int count,
                                         const FieldParams<W>& fp) {
#pragma unroll
  for (int k = 0; k < W; ++k) acc[k] = 0;
  for (int e = 0; e < count; ++e) {
    uint32_t code = (uint32_t)ent[2 * e];
    int32_t w = ent[2 * e + 1];
    size_t at = (size_t)(code & kDotPair) * ps + off;
    uint32_t a[W], t[W];
    load_limbs<W>(a, A, ls, at);
    if (code & kDotSquare) {
      mont_sq<W>(t, a, fp);
    } else {
      uint32_t b[W];
      load_limbs<W>(b, B, ls, at);
      mont_mul<W>(t, a, b, fp);
    }
    uint32_t mag = w < 0 ? (uint32_t)(-w) : (uint32_t)w;
    int top = 0;
    while ((mag >> (top + 1)) != 0) ++top;
    uint32_t m[W];
#pragma unroll
    for (int k = 0; k < W; ++k) m[k] = t[k];
    for (int bit = top - 1; bit >= 0; --bit) {
      mod_add<W>(m, m, m, fp);
      if ((mag >> bit) & 1u) mod_add<W>(m, m, t, fp);
    }
    if (w < 0) {
      mod_sub<W>(acc, acc, m, fp);
    } else {
      mod_add<W>(acc, acc, m, fp);
    }
  }
}
