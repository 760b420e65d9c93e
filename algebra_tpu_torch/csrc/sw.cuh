// The Jacobian group law of a short-Weierstrass curve y^2 = x^3 + b (a = 0)
// over a prime field, as __device__ functions over mont.cuh.  One thread
// holds one point: three coordinates of W words each, in registers.
//
// A point (X, Y, Z) stands for the affine (X / Z^2, Y / Z^3); any point with
// Z = 0 is infinity.  The formulas are the EFD ones of the JAX reference's
// ops/sw_pallas.py: dbl-2009-l (_double_lm), add-2007-bl (_add_kernel),
// madd-2007-bl (_madd_kernel).  Every field operation returns a canonical
// value, so any order of the same operations gives the same words; what
// fixes the result is the order of the exceptional-case selects, which is
// the reference's:
//   add:  P = inf -> Q;  else Q = inf -> P;  else P = Q -> double(P);
//         else the generic sum
//   madd: the same with Q affine, and P = inf -> from_affine(Q), i.e.
//         (x2, y2, 1), or (1, 1, 0) where Q is infinity too.
// The TPU computes the generic sum and the doubling in every lane and
// selects, because its lanes cannot branch.  Here a lane branches: the
// infinity lanes copy, and a P = Q lane computes the doubling instead of the
// rest of the sum.  A warp that no lane sends down a branch pays nothing for
// it; the results are the selects' results, bit for bit.
//
// Outputs may not alias inputs: each function reads its inputs to the end.

#pragma once

#include "mont.cuh"

template <int W>
__device__ __forceinline__ void copy_words(uint32_t (&r)[W], const uint32_t (&a)[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) r[k] = a[k];
}

template <int W>
__device__ __forceinline__ void mod_dbl(uint32_t (&r)[W], const uint32_t (&a)[W],
                                        const FieldParams<W>& fp) {
  mod_add<W>(r, a, a, fp);
}

// The products of the group law.  Up to 12 words they are inlined, as in
// every other kernel.  At 24 words one product is ~4 W^2 = 2,300
// instructions, and a group-law kernel with all its products inlined is
// tens of thousands: ptxas then takes minutes (PERF.md), for a word count
// that no path of the port runs yet.  There each product is a call to one
// out-of-line copy.
template <int W>
__device__ __noinline__ void mont_mul_call(uint32_t (&r)[W], const uint32_t (&a)[W],
                                           const uint32_t (&b)[W],
                                           const FieldParams<W>& fp) {
  mont_mul<W>(r, a, b, fp);
}

template <int W>
__device__ __noinline__ void mont_sq_call(uint32_t (&r)[W], const uint32_t (&a)[W],
                                          const FieldParams<W>& fp) {
  mont_sq<W>(r, a, fp);
}

template <int W>
__device__ __forceinline__ void fmul(uint32_t (&r)[W], const uint32_t (&a)[W],
                                     const uint32_t (&b)[W], const FieldParams<W>& fp) {
  if constexpr (W > 12) {
    mont_mul_call<W>(r, a, b, fp);
  } else {
    mont_mul<W>(r, a, b, fp);
  }
}

template <int W>
__device__ __forceinline__ void fsq(uint32_t (&r)[W], const uint32_t (&a)[W],
                                    const FieldParams<W>& fp) {
  if constexpr (W > 12) {
    mont_sq_call<W>(r, a, fp);
  } else {
    mont_sq<W>(r, a, fp);
  }
}

// dbl-2009-l (a = 0): 5 squarings, 2 products.  Infinity falls out:
// Z3 = 2 Y1 Z1 = 0 where Z1 = 0.
template <int W>
__device__ __forceinline__ void jac_double(uint32_t (&X3)[W], uint32_t (&Y3)[W],
                                           uint32_t (&Z3)[W], const uint32_t (&X1)[W],
                                           const uint32_t (&Y1)[W],
                                           const uint32_t (&Z1)[W],
                                           const FieldParams<W>& fp) {
  uint32_t A[W], B[W], C[W], D[W], E[W];
  fsq<W>(A, X1, fp);
  fsq<W>(B, Y1, fp);
  fsq<W>(C, B, fp);
  // D = 2 ((X1 + B)^2 - A - C)
  mod_add<W>(D, X1, B, fp);
  fsq<W>(D, D, fp);
  mod_sub<W>(D, D, A, fp);
  mod_sub<W>(D, D, C, fp);
  mod_dbl<W>(D, D, fp);
  // E = 3 A;  X3 = E^2 - 2 D
  mod_dbl<W>(E, A, fp);
  mod_add<W>(E, E, A, fp);
  fsq<W>(X3, E, fp);
  mod_dbl<W>(B, D, fp);
  mod_sub<W>(X3, X3, B, fp);
  // Y3 = E (D - X3) - 8 C
  mod_sub<W>(B, D, X3, fp);
  fmul<W>(Y3, E, B, fp);
  mod_dbl<W>(C, C, fp);
  mod_dbl<W>(C, C, fp);
  mod_dbl<W>(C, C, fp);
  mod_sub<W>(Y3, Y3, C, fp);
  // Z3 = 2 Y1 Z1
  fmul<W>(Z3, Y1, Z1, fp);
  mod_dbl<W>(Z3, Z3, fp);
}

// add-2007-bl with the reference's selects: 5 squarings and 11 products for
// the generic sum.
template <int W>
__device__ __forceinline__ void jac_add(uint32_t (&X3)[W], uint32_t (&Y3)[W],
                                        uint32_t (&Z3)[W], const uint32_t (&X1)[W],
                                        const uint32_t (&Y1)[W], const uint32_t (&Z1)[W],
                                        const uint32_t (&X2)[W], const uint32_t (&Y2)[W],
                                        const uint32_t (&Z2)[W],
                                        const FieldParams<W>& fp) {
  if (is_zero<W>(Z1)) {
    copy_words<W>(X3, X2);
    copy_words<W>(Y3, Y2);
    copy_words<W>(Z3, Z2);
    return;
  }
  if (is_zero<W>(Z2)) {
    copy_words<W>(X3, X1);
    copy_words<W>(Y3, Y1);
    copy_words<W>(Z3, Z1);
    return;
  }
  uint32_t Z1Z1[W], Z2Z2[W], U1[W], S1[W], H[W], r[W], t[W];
  fsq<W>(Z1Z1, Z1, fp);
  fsq<W>(Z2Z2, Z2, fp);
  fmul<W>(U1, X1, Z2Z2, fp);
  fmul<W>(H, X2, Z1Z1, fp);  // U2
  mod_sub<W>(H, H, U1, fp);       // H = U2 - U1
  fmul<W>(t, Z2, Z2Z2, fp);
  fmul<W>(S1, Y1, t, fp);
  fmul<W>(t, Z1, Z1Z1, fp);
  fmul<W>(r, Y2, t, fp);  // S2
  mod_sub<W>(r, r, S1, fp);
  mod_dbl<W>(r, r, fp);  // r = 2 (S2 - S1)
  if (is_zero<W>(H) && is_zero<W>(r)) {  // P = Q
    jac_double<W>(X3, Y3, Z3, X1, Y1, Z1, fp);
    return;
  }
  // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  mod_add<W>(t, Z1, Z2, fp);
  fsq<W>(t, t, fp);
  mod_sub<W>(t, t, Z1Z1, fp);
  mod_sub<W>(t, t, Z2Z2, fp);
  fmul<W>(Z3, t, H, fp);
  // I = (2 H)^2;  J = H I;  V = U1 I  (the arrays are unrolled to registers,
  // so a dead temporary's registers are reused without naming it again)
  uint32_t I[W], J[W], V[W];
  mod_dbl<W>(t, H, fp);
  fsq<W>(I, t, fp);
  fmul<W>(J, H, I, fp);
  fmul<W>(V, U1, I, fp);
  // X3 = r^2 - J - 2 V
  fsq<W>(X3, r, fp);
  mod_sub<W>(X3, X3, J, fp);
  mod_dbl<W>(t, V, fp);
  mod_sub<W>(X3, X3, t, fp);
  // Y3 = r (V - X3) - 2 S1 J
  mod_sub<W>(t, V, X3, fp);
  fmul<W>(Y3, r, t, fp);
  fmul<W>(t, S1, J, fp);
  mod_dbl<W>(t, t, fp);
  mod_sub<W>(Y3, Y3, t, fp);
}

// madd-2007-bl, P Jacobian plus Q = (X2, Y2) affine with infinity flag
// q_inf, and the reference's selects: 4 squarings and 7 products for the
// generic sum.  `one` is 1 in Montgomery form.
template <int W>
__device__ __forceinline__ void jac_madd(uint32_t (&X3)[W], uint32_t (&Y3)[W],
                                         uint32_t (&Z3)[W], const uint32_t (&X1)[W],
                                         const uint32_t (&Y1)[W], const uint32_t (&Z1)[W],
                                         const uint32_t (&X2)[W], const uint32_t (&Y2)[W],
                                         bool q_inf, const Words<W>& one,
                                         const FieldParams<W>& fp) {
  if (is_zero<W>(Z1)) {  // from_affine(Q)
#pragma unroll
    for (int k = 0; k < W; ++k) {
      X3[k] = q_inf ? one.w[k] : X2[k];
      Y3[k] = q_inf ? one.w[k] : Y2[k];
      Z3[k] = q_inf ? 0u : one.w[k];
    }
    return;
  }
  if (q_inf) {
    copy_words<W>(X3, X1);
    copy_words<W>(Y3, Y1);
    copy_words<W>(Z3, Z1);
    return;
  }
  uint32_t Z1Z1[W], H[W], r[W], t[W];
  fsq<W>(Z1Z1, Z1, fp);
  fmul<W>(H, X2, Z1Z1, fp);  // U2
  mod_sub<W>(H, H, X1, fp);       // H = U2 - X1
  fmul<W>(t, Z1, Z1Z1, fp);
  fmul<W>(r, Y2, t, fp);  // S2
  mod_sub<W>(r, r, Y1, fp);
  mod_dbl<W>(r, r, fp);  // r = 2 (S2 - Y1)
  if (is_zero<W>(H) && is_zero<W>(r)) {  // P = Q
    jac_double<W>(X3, Y3, Z3, X1, Y1, Z1, fp);
    return;
  }
  uint32_t HH[W], I[W], J[W], V[W];
  fsq<W>(HH, H, fp);
  // Z3 = (Z1 + H)^2 - Z1Z1 - HH
  mod_add<W>(t, Z1, H, fp);
  fsq<W>(t, t, fp);
  mod_sub<W>(t, t, Z1Z1, fp);
  mod_sub<W>(Z3, t, HH, fp);
  // I = 4 HH;  J = H I;  V = X1 I
  mod_dbl<W>(I, HH, fp);
  mod_dbl<W>(I, I, fp);
  fmul<W>(J, H, I, fp);
  fmul<W>(V, X1, I, fp);
  // X3 = r^2 - J - 2 V
  fsq<W>(X3, r, fp);
  mod_sub<W>(X3, X3, J, fp);
  mod_dbl<W>(t, V, fp);
  mod_sub<W>(X3, X3, t, fp);
  // Y3 = r (V - X3) - 2 Y1 J
  mod_sub<W>(t, V, X3, fp);
  fmul<W>(Y3, r, t, fp);
  fmul<W>(t, Y1, J, fp);
  mod_dbl<W>(t, t, fp);
  mod_sub<W>(Y3, Y3, t, fp);
}

// The case analysis of the affine chord/tangent addition of (x1, y1) and
// (x2, y2), each possibly infinity (i1, i2), as the reference's _aff_cases
// (ops/sw_pallas.py): d = x2 - x1; a tangent (dbl) where the x agree and
// the y are equal and nonzero; opposite points (opp) where the x agree
// otherwise; a degenerate lane (an infinity or opp), whose denominator is
// one, so that the batched inversion stays defined.  Canonical values, so
// y equality is word equality.
template <int W>
__device__ __forceinline__ void aff_cases(uint32_t (&d)[W], bool& dbl, bool& opp,
                                          bool& degen, const uint32_t (&x1)[W],
                                          const uint32_t (&y1)[W], bool i1,
                                          const uint32_t (&x2)[W],
                                          const uint32_t (&y2)[W], bool i2,
                                          const FieldParams<W>& fp) {
  mod_sub<W>(d, x2, x1, fp);
  bool same_x = is_zero<W>(d);
  uint32_t diff = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) diff |= y1[k] ^ y2[k];
  dbl = same_x && diff == 0 && !is_zero<W>(y1);
  opp = same_x && !dbl;
  degen = i1 || i2 || opp;
}

// The rest of the affine addition of two finite points, given the inverse
// `inv` of the denominator that aff_cases' analysis chose:
// lambda = num * inv with num = 3 x1^2 + a for a tangent (dbl), y2 - y1
// otherwise; x3 = lambda^2 - x1 - x2; y3 = lambda (x1 - x3) - y1.  Two
// products and a square (a tangent one square more).  An opposite-points
// lane computes too, with the inverse of one, as the reference does.
template <int W>
__device__ __forceinline__ void aff_complete(uint32_t (&x3)[W], uint32_t (&y3)[W],
                                             const uint32_t (&x1)[W],
                                             const uint32_t (&y1)[W],
                                             const uint32_t (&x2)[W],
                                             const uint32_t (&y2)[W], bool dbl,
                                             const uint32_t (&inv)[W],
                                             const Words<W>& a, bool has_a,
                                             const FieldParams<W>& fp) {
  uint32_t num[W], lam[W], t[W];
  if (dbl) {  // num = 3 x1^2 + a
    fsq<W>(t, x1, fp);
    mod_add<W>(num, t, t, fp);
    mod_add<W>(num, num, t, fp);
    if (has_a) mod_add<W>(num, num, a.w, fp);
  } else {
    mod_sub<W>(num, y2, y1, fp);
  }
  fmul<W>(lam, num, inv, fp);
  fsq<W>(x3, lam, fp);
  mod_sub<W>(x3, x3, x1, fp);
  mod_sub<W>(x3, x3, x2, fp);
  mod_sub<W>(t, x1, x3, fp);
  fmul<W>(y3, lam, t, fp);
  mod_sub<W>(y3, y3, y1, fp);
}
