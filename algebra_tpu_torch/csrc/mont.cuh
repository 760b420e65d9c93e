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
// Every kernel of the port inlines these functions: the products and sums
// are written as PTX carry chains (see "carry chains" below).

#pragma once

#include <cstddef>
#include <cstdint>

#ifdef MONT_HOST_EMULATION  // a host build of this header (see "carry chains")
#define __device__
#define __forceinline__ inline
#define __noinline__
#endif

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

// ------------------------------------------------------------- carry chains
// The field arithmetic below is written in PTX's carry-flag instructions,
// one asm statement each: add.cc / addc(.cc) / sub.cc / subc(.cc), and the
// multiply-adds mad.lo.cc / madc.lo.cc / madc.hi(.cc), which add a 32x32
// product's low or high word and the carry flag (CC.CF) in one instruction.
// A chain is a run of these statements; each reads the flag the one before
// it left, and the statements are volatile so that they stay in order.
// Nothing between two statements of a chain writes the flag: the code
// around them is 32-bit arithmetic, which the compiler does not lower to
// flag instructions.
//
// With MONT_HOST_EMULATION defined, the same primitives are plain C++ over
// a host carry flag, so that a host compiler can build this header and the
// carry logic can be checked against big integers without a GPU.

#ifdef MONT_HOST_EMULATION
namespace chain {
inline uint32_t& flag() {
  static thread_local uint32_t cf = 0;
  return cf;
}
inline uint32_t add_cc(uint32_t a, uint32_t b) {
  uint64_t s = (uint64_t)a + b;
  flag() = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint64_t s = (uint64_t)a + b + flag();
  flag() = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + flag(); }
inline uint32_t sub_cc(uint32_t a, uint32_t b) {
  flag() = a < b;
  return a - b;
}
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint64_t d = (uint64_t)a - b - flag();
  flag() = (uint32_t)(d >> 63);
  return (uint32_t)d;
}
inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - flag(); }
inline uint32_t mul_lo(uint32_t a, uint32_t b) { return a * b; }
inline uint32_t mul_hi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) { return add_cc(a * b, c); }
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) { return addc_cc(a * b, c); }
inline uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) { return add_cc(mul_hi(a, b), c); }
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return addc_cc(mul_hi(a, b), c);
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) { return mul_hi(a, b) + c + flag(); }
inline uint32_t mad_hi(uint32_t a, uint32_t b, uint32_t c) { return mul_hi(a, b) + c; }
}  // namespace chain
#else
namespace chain {
#define MONT_CHAIN2(name, insn)                                                  \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {             \
    uint32_t r;                                                                  \
    asm volatile(insn " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));                \
    return r;                                                                    \
  }
#define MONT_CHAIN3(name, insn)                                                  \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b, uint32_t c) { \
    uint32_t r;                                                                  \
    asm volatile(insn " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));    \
    return r;                                                                    \
  }
MONT_CHAIN2(add_cc, "add.cc.u32")
MONT_CHAIN2(addc_cc, "addc.cc.u32")
MONT_CHAIN2(addc, "addc.u32")
MONT_CHAIN2(sub_cc, "sub.cc.u32")
MONT_CHAIN2(subc_cc, "subc.cc.u32")
MONT_CHAIN2(subc, "subc.u32")
MONT_CHAIN3(mad_lo_cc, "mad.lo.cc.u32")
MONT_CHAIN3(madc_lo_cc, "madc.lo.cc.u32")
MONT_CHAIN3(mad_hi_cc, "mad.hi.cc.u32")
MONT_CHAIN3(madc_hi_cc, "madc.hi.cc.u32")
MONT_CHAIN3(madc_hi, "madc.hi.u32")
#undef MONT_CHAIN2
#undef MONT_CHAIN3
// No flag: ordinary 32-bit arithmetic.
__device__ __forceinline__ uint32_t mul_lo(uint32_t a, uint32_t b) { return a * b; }
__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) { return __umulhi(a, b); }
__device__ __forceinline__ uint32_t mad_hi(uint32_t a, uint32_t b, uint32_t c) {
  return __umulhi(a, b) + c;
}
}  // namespace chain
#endif

// ------------------------------------------------------------- add/sub/reduce

// r = (carry:x) - p if (carry:x) >= p else x, for (carry:x) < 2p.  The carry
// word takes part in the comparison, so a modulus without a spare top bit
// reduces correctly too: the chain's last step gives carry - borrow, which
// is negative exactly when (carry:x) < p.
template <int W>
__device__ __forceinline__ void cond_sub(uint32_t (&r)[W], const uint32_t (&x)[W],
                                         uint32_t carry, const FieldParams<W>& fp) {
  uint32_t d[W];
  d[0] = chain::sub_cc(x[0], fp.p[0]);
#pragma unroll
  for (int k = 1; k < W; ++k) d[k] = chain::subc_cc(x[k], fp.p[k]);
  bool ge = (chain::subc(carry, 0u) >> 31) == 0;
#pragma unroll
  for (int k = 0; k < W; ++k) r[k] = ge ? d[k] : x[k];
}

// r = a + b mod p, for a, b < p.
template <int W>
__device__ __forceinline__ void mod_add(uint32_t (&r)[W], const uint32_t (&a)[W],
                                        const uint32_t (&b)[W],
                                        const FieldParams<W>& fp) {
  uint32_t s[W];
  s[0] = chain::add_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < W; ++k) s[k] = chain::addc_cc(a[k], b[k]);
  uint32_t carry = chain::addc(0u, 0u);
  cond_sub<W>(r, s, carry, fp);
}

// r = a - b mod p, for a, b < p.
template <int W>
__device__ __forceinline__ void mod_sub(uint32_t (&r)[W], const uint32_t (&a)[W],
                                        const uint32_t (&b)[W],
                                        const FieldParams<W>& fp) {
  uint32_t d[W];
  d[0] = chain::sub_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < W; ++k) d[k] = chain::subc_cc(a[k], b[k]);
  // add back p where the subtraction wrapped (mask is 0 or all ones)
  uint32_t mask = chain::subc(0u, 0u);
  uint32_t pm[W];
#pragma unroll
  for (int k = 0; k < W; ++k) pm[k] = fp.p[k] & mask;
  r[0] = chain::add_cc(d[0], pm[0]);
#pragma unroll
  for (int k = 1; k < W; ++k) r[k] = chain::addc_cc(d[k], pm[k]);
}

// ------------------------------------------------------------------- multiply

// The Montgomery products keep their running sum T in two W-word arrays and
// a carry word, T = E + O 2^32 + top 2^(32 (W + 1)): E takes the products
// of the even words of an operand (a 32x32 product's low word at position
// 2k, its high word at 2k + 1) and O those of the odd words (positions
// 2k + 1, 2k + 2), so within one array the words of neighbouring products
// do not overlap, and one chain of mad.lo.cc / madc.hi.cc adds a whole row
// with the carries running along it; no carry has to ripple past a row.
// `top` takes the carry out of the highest position, so the sums are exact
// for any odd modulus below 2^(32 W), with no spare bit needed.
//
// One step of the reduction: m = E[0] (-p^-1) mod 2^32, T += m p, which
// makes position 0 zero.
template <int W>
__device__ __forceinline__ void redc_step(uint32_t (&E)[W], uint32_t (&O)[W],
                                          uint32_t& top, const FieldParams<W>& fp) {
  uint32_t m = E[0] * fp.inv32;
  O[0] = chain::mad_lo_cc(fp.p[1], m, O[0]);
  O[1] = chain::madc_hi_cc(fp.p[1], m, O[1]);
#pragma unroll
  for (int k = 2; k < W; k += 2) {
    O[k] = chain::madc_lo_cc(fp.p[k + 1], m, O[k]);
    O[k + 1] = chain::madc_hi_cc(fp.p[k + 1], m, O[k + 1]);
  }
  top = chain::addc(top, 0u);
  E[0] = chain::mad_lo_cc(fp.p[0], m, E[0]);
  E[1] = chain::madc_hi_cc(fp.p[0], m, E[1]);
#pragma unroll
  for (int k = 2; k < W; k += 2) {
    E[k] = chain::madc_lo_cc(fp.p[k], m, E[k]);
    E[k + 1] = chain::madc_hi_cc(fp.p[k], m, E[k + 1]);
  }
  O[W - 1] = chain::addc_cc(O[W - 1], 0u);
  top = chain::addc(top, 0u);
}

// After a reduction step E[0] = 0, and T / 2^32 = (E >> 32) + O +
// top 2^(32 W).  In the frame one word down, O is the new even-aligned
// array; E's words 2.. move to odd alignment (new O[k] = E[k + 2]), top to
// the new O[W - 1], and E[1] is added to the new E[0].  `shift_add` does
// that and adds x y in the same two chains (x the odd words of a's row
// with y = b[i] in the product, p with y = m in the squaring's reduction).
template <int W>
__device__ __forceinline__ void shift_add(uint32_t (&E)[W], uint32_t (&O)[W],
                                          uint32_t& top, const uint32_t* x,
                                          uint32_t y) {
  uint32_t En[W], On[W];
  En[0] = chain::add_cc(O[0], E[1]);
#pragma unroll
  for (int k = 0; k < W - 2; k += 2) {
    On[k] = chain::madc_lo_cc(x[k + 1], y, E[k + 2]);
    On[k + 1] = chain::madc_hi_cc(x[k + 1], y, E[k + 3]);
  }
  On[W - 2] = chain::madc_lo_cc(x[W - 1], y, 0u);
  On[W - 1] = chain::madc_hi_cc(x[W - 1], y, top);
  uint32_t tn = chain::addc(0u, 0u);
  En[0] = chain::mad_lo_cc(x[0], y, En[0]);
  En[1] = chain::madc_hi_cc(x[0], y, O[1]);
#pragma unroll
  for (int k = 2; k < W; k += 2) {
    En[k] = chain::madc_lo_cc(x[k], y, O[k]);
    En[k + 1] = chain::madc_hi_cc(x[k], y, O[k + 1]);
  }
  On[W - 1] = chain::addc_cc(On[W - 1], 0u);
  top = chain::addc(tn, 0u);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    E[k] = En[k];
    O[k] = On[k];
  }
}

// res = T / 2^32 after the last reduction step, W words and the carry.
template <int W>
__device__ __forceinline__ uint32_t redc_merge(uint32_t (&res)[W], const uint32_t (&E)[W],
                                               const uint32_t (&O)[W], uint32_t top) {
  res[0] = chain::add_cc(O[0], E[1]);
#pragma unroll
  for (int k = 1; k < W - 1; ++k) res[k] = chain::addc_cc(O[k], E[k + 1]);
  res[W - 1] = chain::addc_cc(O[W - 1], 0u);
  return chain::addc(top, 0u);
}

// r = a * b * R^-1 mod p (R = 2^(32 W)), for a, b < p: coarsely integrated
// operand scanning (CIOS) on the even/odd arrays above.  Round i adds
// a * b[i] and m p and moves down one word; between rounds T < 2p, within
// a round T < 2^33 p < 2^(32 (W + 1) + 1), so `top` is 0 or 1.  About 4 W
// instructions a round, all but a few of them multiply-adds.  r may be a
// or b: they are read only before r is written.
template <int W>
__device__ __forceinline__ void mont_mul(uint32_t (&r)[W], const uint32_t (&a)[W],
                                         const uint32_t (&b)[W],
                                         const FieldParams<W>& fp) {
  static_assert(W % 2 == 0, "the even/odd split takes an even word count");
  uint32_t E[W], O[W], top = 0;
#pragma unroll
  for (int k = 0; k < W; k += 2) {
    E[k] = chain::mul_lo(a[k], b[0]);
    E[k + 1] = chain::mul_hi(a[k], b[0]);
    O[k] = chain::mul_lo(a[k + 1], b[0]);
    O[k + 1] = chain::mul_hi(a[k + 1], b[0]);
  }
  redc_step<W>(E, O, top, fp);
#pragma unroll
  for (int i = 1; i < W; ++i) {
    shift_add<W>(E, O, top, a, b[i]);
    redc_step<W>(E, O, top, fp);
  }
  uint32_t res[W];
  uint32_t carry = redc_merge<W>(res, E, O, top);
  cond_sub<W>(r, res, carry, fp);
}

// r = a * a * R^-1 mod p, bit for bit what mont_mul<W>(r, a, a, fp) gives
// (a Montgomery product of canonical operands is unique), with
// W (W - 1) / 2 + W + W^2 products in place of 2 W^2.  The square
// S = a * a is formed first in 2W words t: each cross product a[i] a[j],
// i < j, once (row i: a chain of low words, then one of high words), then
// doubled, then the diagonal a[i]^2 added in one chain.  Its low half is
// reduced by W steps on the even/odd arrays (the moves down folded into
// the odd chains of m p), and the high half added at the end:
// (S + M p) / R = (S_lo + M p) / R + S_hi < p + 1 + p.  r may be a itself.
template <int W>
__device__ __forceinline__ void mont_sq(uint32_t (&r)[W], const uint32_t (&a)[W],
                                        const FieldParams<W>& fp) {
  static_assert(W % 2 == 0, "the even/odd split takes an even word count");
  uint32_t t[2 * W];
  // row 0: low words at 1..W-1, high words at 2..W
#pragma unroll
  for (int j = 1; j < W; ++j) t[j] = chain::mul_lo(a[0], a[j]);
  t[2] = chain::mad_hi_cc(a[0], a[1], t[2]);
#pragma unroll
  for (int j = 2; j < W - 1; ++j) t[j + 1] = chain::madc_hi_cc(a[0], a[j], t[j + 1]);
  t[W] = chain::madc_hi(a[0], a[W - 1], 0u);
  // rows 1..W-2: low words at 2i+1..i+W-1 (carry into the new word i+W),
  // high words at 2i+2..i+W (no carry out: the rows so far are below
  // 2^(32 (i + W + 1)))
#pragma unroll
  for (int i = 1; i < W - 1; ++i) {
    t[2 * i + 1] = chain::mad_lo_cc(a[i], a[i + 1], t[2 * i + 1]);
#pragma unroll
    for (int j = i + 2; j < W; ++j) t[i + j] = chain::madc_lo_cc(a[i], a[j], t[i + j]);
    t[i + W] = chain::addc(0u, 0u);
    if (i + 1 == W - 1) {
      t[i + W] = chain::mad_hi(a[i], a[W - 1], t[i + W]);
    } else {
      t[2 * i + 2] = chain::mad_hi_cc(a[i], a[i + 1], t[2 * i + 2]);
#pragma unroll
      for (int j = i + 2; j < W - 1; ++j)
        t[i + j + 1] = chain::madc_hi_cc(a[i], a[j], t[i + j + 1]);
      t[i + W] = chain::madc_hi(a[i], a[W - 1], t[i + W]);
    }
  }
  // double (the cross sum is below 2^(64 W - 1)), then add the diagonal
  t[2 * W - 1] = t[2 * W - 2] >> 31;
#pragma unroll
  for (int k = 2 * W - 2; k > 1; --k) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
  t[1] <<= 1;
  t[0] = chain::mul_lo(a[0], a[0]);
  t[1] = chain::mad_hi_cc(a[0], a[0], t[1]);
#pragma unroll
  for (int i = 1; i < W - 1; ++i) {
    t[2 * i] = chain::madc_lo_cc(a[i], a[i], t[2 * i]);
    t[2 * i + 1] = chain::madc_hi_cc(a[i], a[i], t[2 * i + 1]);
  }
  t[2 * W - 2] = chain::madc_lo_cc(a[W - 1], a[W - 1], t[2 * W - 2]);
  t[2 * W - 1] = chain::madc_hi(a[W - 1], a[W - 1], t[2 * W - 1]);

  // reduce the low half: E = t[0..W), O = 0
  uint32_t E[W], O[W], top = 0;
  uint32_t m = t[0] * fp.inv32;
#pragma unroll
  for (int k = 0; k < W; ++k) E[k] = t[k];
#pragma unroll
  for (int k = 0; k < W; k += 2) {
    O[k] = chain::mul_lo(fp.p[k + 1], m);
    O[k + 1] = chain::mul_hi(fp.p[k + 1], m);
  }
  E[0] = chain::mad_lo_cc(fp.p[0], m, E[0]);
  E[1] = chain::madc_hi_cc(fp.p[0], m, E[1]);
#pragma unroll
  for (int k = 2; k < W; k += 2) {
    E[k] = chain::madc_lo_cc(fp.p[k], m, E[k]);
    E[k + 1] = chain::madc_hi_cc(fp.p[k], m, E[k + 1]);
  }
  O[W - 1] = chain::addc_cc(O[W - 1], 0u);
  top = chain::addc(top, 0u);
#pragma unroll
  for (int i = 1; i < W; ++i) {
    // m of the next step from the word that lands at position 0 after the
    // move down (the sum's carry goes along in shift_add's chain)
    m = (O[0] + E[1]) * fp.inv32;
    shift_add<W>(E, O, top, fp.p, m);
  }
  uint32_t res[W];
  uint32_t carry = redc_merge<W>(res, E, O, top);
  res[0] = chain::add_cc(res[0], t[W]);
#pragma unroll
  for (int k = 1; k < W; ++k) res[k] = chain::addc_cc(res[k], t[W + k]);
  carry = chain::addc(carry, 0u);
  cond_sub<W>(r, res, carry, fp);
}
