// Multi-word Montgomery field arithmetic for Hopper, as __device__ functions
// templated on the 32-bit word count W (8: BLS12-381 Fr, 12: BLS12-381 Fq,
// 24: MNT4-753 Fq).  One thread holds one field element in W registers.
//
// Storage format (shared with the Python side): limb-major int32/uint32
// arrays [L = 2W, N] of 16-bit limbs, little-endian, one limb per 32-bit
// word.  Thread i reads limb k at word k * limb_stride + i, so the loads of
// a warp are contiguous.  Limbs are packed in pairs into 32-bit words in
// registers; because R = 2^(32 W) = 2^(16 L), a Montgomery-form value is the
// same integer at either limb width.
//
// Nothing is hard-coded for one field: the modulus words and
// inv32 = -p^-1 mod 2^32 arrive in a FieldParams struct passed by value
// (it lands in the kernel's constant bank, so p[k] with a static k is an
// immediate-like operand after unrolling).
//
// These functions are what the inversion kernels inline, and what the later
// group-law kernels will.

#pragma once

#include <cstddef>
#include <cstdint>

template <int W>
struct FieldParams {
  uint32_t p[W];   // modulus, little-endian 32-bit words
  uint32_t inv32;  // -p^-1 mod 2^32
};

// W words passed to a kernel by value: a field constant (one in Montgomery
// form) or an exponent.
template <int W>
struct Words {
  uint32_t w[W];
};

// ---------------------------------------------------------------- load/store

// Read one element: 2W 16-bit limbs at stride `ls`, offset `off`, packed in
// pairs.  Limbs are < 2^16 by the format's contract.
template <int W>
__device__ __forceinline__ void load_limbs(uint32_t (&r)[W], const uint32_t* x,
                                           size_t ls, size_t off) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    uint32_t lo = x[(size_t)(2 * k) * ls + off];
    uint32_t hi = x[(size_t)(2 * k + 1) * ls + off];
    r[k] = lo | (hi << 16);
  }
}

template <int W>
__device__ __forceinline__ void store_limbs(uint32_t* x, size_t ls, size_t off,
                                            const uint32_t (&r)[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    x[(size_t)(2 * k) * ls + off] = r[k] & 0xFFFFu;
    x[(size_t)(2 * k + 1) * ls + off] = r[k] >> 16;
  }
}

// Bounded forms, for an array [2W, n] whose last block is ragged: element
// `off` is read and written at limb stride n where off < n; past the end a
// load gives `fill` and a store does nothing, so no caller pads a copy.
template <int W>
__device__ __forceinline__ void load_limbs_bounded(uint32_t (&r)[W],
                                                   const uint32_t* x, size_t n,
                                                   size_t off,
                                                   const Words<W>& fill) {
  if (off < n) {
    load_limbs<W>(r, x, n, off);
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) r[k] = fill.w[k];
  }
}

template <int W>
__device__ __forceinline__ void store_limbs_bounded(uint32_t* x, size_t n,
                                                    size_t off,
                                                    const uint32_t (&r)[W]) {
  if (off < n) store_limbs<W>(x, n, off, r);
}

template <int W>
__device__ __forceinline__ bool is_zero(const uint32_t (&a)[W]) {
  uint32_t any = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) any |= a[k];
  return any == 0;
}

// ------------------------------------------------------------- add/sub/reduce

// r = (carry:x) - p if (carry:x) >= p else x, for (carry:x) < 2p.  The carry
// word takes part in the comparison, so a modulus without a spare top bit
// reduces correctly too.
template <int W>
__device__ __forceinline__ void cond_sub(uint32_t (&r)[W], const uint32_t (&x)[W],
                                         uint32_t carry, const FieldParams<W>& fp) {
  uint32_t d[W];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    uint64_t t = (uint64_t)x[k] - fp.p[k] - borrow;
    d[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  bool ge = (carry != 0) || (borrow == 0);
#pragma unroll
  for (int k = 0; k < W; ++k) r[k] = ge ? d[k] : x[k];
}

// r = a + b mod p, for a, b < p.
template <int W>
__device__ __forceinline__ void mod_add(uint32_t (&r)[W], const uint32_t (&a)[W],
                                        const uint32_t (&b)[W],
                                        const FieldParams<W>& fp) {
  uint32_t s[W];
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    uint64_t t = (uint64_t)a[k] + b[k] + carry;
    s[k] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
  cond_sub<W>(r, s, carry, fp);
}

// r = a - b mod p, for a, b < p.
template <int W>
__device__ __forceinline__ void mod_sub(uint32_t (&r)[W], const uint32_t (&a)[W],
                                        const uint32_t (&b)[W],
                                        const FieldParams<W>& fp) {
  uint32_t d[W];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    uint64_t t = (uint64_t)a[k] - b[k] - borrow;
    d[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  // add back p where the subtraction wrapped (mask is 0 or all ones)
  uint32_t mask = 0u - borrow;
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    uint64_t t = (uint64_t)d[k] + (fp.p[k] & mask) + carry;
    r[k] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
}

// ------------------------------------------------------------------- multiply

// r = a * b * R^-1 mod p (R = 2^(32 W)), for a, b < p: coarsely integrated
// operand scanning (CIOS).  Round i adds a * b[i] into a (W+2)-word window,
// picks m so the lowest word cancels, adds m * p and shifts down one word.
// Every partial sum x*y + t + c with 32-bit x, y, t, c fits 64 bits exactly
// ((2^32-1)^2 + 2(2^32-1) = 2^64 - 1), so the compiler's 64-bit multiply-add
// (IMAD.WIDE) carries the chain without flags.  The window keeps a top carry
// word, so the result is exact for any odd modulus below 2^(32 W).
template <int W>
__device__ __forceinline__ void mont_mul(uint32_t (&r)[W], const uint32_t (&a)[W],
                                         const uint32_t (&b)[W],
                                         const FieldParams<W>& fp) {
  uint32_t t[W + 2];
#pragma unroll
  for (int k = 0; k < W + 2; ++k) t[k] = 0;

#pragma unroll
  for (int i = 0; i < W; ++i) {
    // t += a * b[i]
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[W] + c;
    t[W] = (uint32_t)s;
    t[W + 1] = (uint32_t)(s >> 32);

    // t = (t + m * p) / 2^32
    uint32_t m = t[0] * fp.inv32;
    c = ((uint64_t)m * fp.p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < W; ++j) {
      uint64_t u = (uint64_t)m * fp.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)u;
      c = u >> 32;
    }
    s = (uint64_t)t[W] + c;
    t[W - 1] = (uint32_t)s;
    t[W] = t[W + 1] + (uint32_t)(s >> 32);
  }

  uint32_t res[W];
#pragma unroll
  for (int k = 0; k < W; ++k) res[k] = t[k];
  cond_sub<W>(r, res, t[W], fp);
}

// r = a * a * R^-1 mod p, bit for bit what mont_mul<W>(r, a, a, fp) gives,
// with W(W+1)/2 + W^2 + W multiply-adds in place of 2 W^2 + W.  The square
// is formed first (each product a[i]*a[j], i < j, once, then doubled, then
// the diagonal added), and reduced after: round i picks m so word i
// cancels and adds m * p at word i.  Both orders add the same multiple
// M * p (the one M < R with a*a + M*p = 0 mod R), so the word-by-word
// results agree.  a*a + M*p < 2 R p needs one bit above 2W words: `top`.
// r may be a itself: a is read only before r is written.
template <int W>
__device__ __forceinline__ void mont_sq(uint32_t (&r)[W], const uint32_t (&a)[W],
                                        const FieldParams<W>& fp) {
  uint32_t t[2 * W];
#pragma unroll
  for (int k = 0; k < 2 * W; ++k) t[k] = 0;

  // t = sum over i < j of a[i] a[j] 2^(32 (i + j))   (< 2^(64 W - 1))
#pragma unroll
  for (int i = 0; i < W - 1; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < W; ++j) {
      uint64_t s = (uint64_t)a[i] * a[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + W] = (uint32_t)c;  // first write of this word
  }

  // t = 2 t + sum over i of a[i]^2 2^(64 i)
#pragma unroll
  for (int k = 2 * W - 1; k > 0; --k) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
  t[0] = 0;  // word 0 holds no cross product
  {
    uint32_t c = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      uint64_t sq = (uint64_t)a[i] * a[i];
      uint64_t s = (uint64_t)t[2 * i] + (uint32_t)sq + c;
      t[2 * i] = (uint32_t)s;
      s = (uint64_t)t[2 * i + 1] + (uint32_t)(sq >> 32) + (uint32_t)(s >> 32);
      t[2 * i + 1] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
  }

  // reduce: after round i words 0..i are zero; `top` is the carry out of
  // word i + W, added at word i + W + 1 in the next round
  uint32_t top = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint32_t m = t[i] * fp.inv32;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      uint64_t s = (uint64_t)m * fp.p[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[i + W] + c + top;
    t[i + W] = (uint32_t)s;
    top = (uint32_t)(s >> 32);
  }

  uint32_t res[W];
#pragma unroll
  for (int k = 0; k < W; ++k) res[k] = t[W + k];
  cond_sub<W>(r, res, top, fp);
}
