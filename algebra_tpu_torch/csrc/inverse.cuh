// Inversion in a prime field by Bernstein-Yang "safegcd" (D. J. Bernstein,
// B.-Y. Yang, "Fast constant-time gcd computation and modular inversion",
// TCHES 2019), in batches of 30 divsteps on 32-bit words with the batch's
// transition matrix applied to signed 30-bit limbs, as libsecp256k1's
// modinv32 does.  One thread inverts one element; every thread runs the
// same fixed number of divsteps with selects in place of branches, so a
// warp never diverges.  The arithmetic is plain C++ integer code (32 x 32
// -> 64-bit signed and unsigned products), so the host build
// (MONT_HOST_EMULATION) runs the code the kernel runs.
//
// The divstep is the paper's original one, on (delta, f, g) with f odd:
//   delta > 0 and g odd:  (1 - delta, g, (g - f) / 2)
//   otherwise:            (1 + delta, f, (g + (g mod 2) f) / 2)
// from delta = 1, f = p, g = x.  Theorem 11.2 of the paper: if
// f^2 + 4 g^2 <= 5 * 2^(2 d), then g = 0 after floor((49 d + 57) / 17)
// divsteps for d >= 46 (floor((49 d + 80) / 17) for d < 46), and f = +-gcd.
// With d = bits(p) (x < p) that is 738 divsteps for BLS12-381 Fr, 741 for
// secp256k1 and 2^256 - 189, 1101 for BLS12-381 Fq, 2173 for MNT4-753 Fq.
// The caller (mont_kernels.gcd_batches) rounds the ceiling of the bound up
// to whole batches of 30: 25, 37 and 73 batches.  Divsteps after g = 0 keep
// f and d and only halve e, so the count may exceed the bound.
//
// Alongside f and g run d and e, with f = d x / R^2 and g = e x / R^2
// mod p.  Starting at d = 0, e = R^2 mod p, the end (f = +-1) gives
// d = +-R^2 / x: for x = a R (Montgomery form) that is a^-1 R, the
// Montgomery form of the inverse, with no extra product.  x = 0 keeps
// g = 0 and d = 0 throughout, so zero maps to zero.
//
// Each step writes separate output arrays (at 24 words the group law
// writing into a struct's members gave a wrong result on the card).

#pragma once

#include "mont.cuh"

#ifdef MONT_HOST_EMULATION
#define __host__
#endif

constexpr int32_t kM30 = 0x3FFFFFFF;

// Signed 30-bit limbs of f, g, d, e: limbs 0..N-2 in [0, 2^30) after each
// update, the top one signed.  30 (N - 1) + 31 bits hold (-2p, p).
template <int W>
struct Gcd {
  static constexpr int N = 32 * W / 30 + 1;
};

template <int W>
struct GcdParams {
  int32_t p[Gcd<W>::N];  // modulus, 30-bit limbs
  uint32_t p_inv30;      // p^-1 mod 2^30
  uint32_t r2[W];        // R^2 mod p, 32-bit words
  int batches;           // batches of 30 divsteps, from the bound above
};

// W 32-bit words (a value below 2^(32 W)) -> N 30-bit limbs.
template <int W>
__host__ __device__ __forceinline__ void to_signed30(int32_t (&r)[Gcd<W>::N],
                                                     const uint32_t* x) {
#pragma unroll
  for (int i = 0; i < Gcd<W>::N; ++i) {
    const int bit = 30 * i, w = bit >> 5, s = bit & 31;
    uint32_t v = w < W ? x[w] >> s : 0u;
    if (s > 2 && w + 1 < W) v |= x[w + 1] << (32 - s);
    r[i] = (int32_t)(v & (uint32_t)kM30);
  }
}

// N limbs, each in [0, 2^30), of a value below 2^(32 W) -> W words.  The
// word k starts at bit 32 k, which is 2 k mod 30 into its limb: an even
// offset s <= 28, so two limbs cover it.
template <int W>
__device__ __forceinline__ void from_signed30(uint32_t (&r)[W],
                                              const int32_t (&x)[Gcd<W>::N]) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int bit = 32 * k, i = bit / 30, s = bit % 30;
    uint32_t v = (uint32_t)x[i] >> s;
    if (i + 1 < Gcd<W>::N) v |= (uint32_t)x[i + 1] << (30 - s);
    r[k] = v;
  }
}

// 30 divsteps on the low 30 bits of f and g; eta = -delta.  Returns the new
// eta and the transition matrix t = (u, v, q, r), scaled by 2^30:
// 2^30 (f', g') = (u f + v g, q f + r g).  Its entries are in
// [-2^30, 2^30], kept as words mod 2^32.  Each divstep forms both
// candidates of g, q, r (g - f or g + f, ...) and picks one by selects on
// two predicates, g odd and the swap (g odd and delta > 0): 26 word
// operations as written.  On an H100 a batch is some 1,250 instructions at
// W = 8 and one lane issues about 0.65 a cycle, so the time of a lane is
// mostly their count.  (Masks in place of the selects, as libsecp256k1
// writes it, took 3-11 % longer; a batch's divsteps interleaved with the
// update before it, 2-7 % longer; f carried with delta's sign, from 2 %
// faster to 12 % slower.)
__device__ __forceinline__ int32_t divsteps_30(int32_t eta, uint32_t f0, uint32_t g0,
                                               int32_t (&t)[4]) {
  uint32_t u = 1, v = 0, q = 0, r = 1, f = f0, g = g0;
#pragma unroll
  for (int i = 0; i < 30; ++i) {
    const bool odd = (g & 1u) != 0, swap = odd && eta < 0;
    const uint32_t g_odd = (swap ? g - f : g + f) >> 1;  // (g -+ f) / 2
    const uint32_t q_odd = swap ? q - u : q + u, r_odd = swap ? r - v : r + v;
    f = swap ? g : f;  // the swap: f takes the old g
    u = (swap ? q : u) << 1;
    v = (swap ? r : v) << 1;
    g = odd ? g_odd : g >> 1;
    q = odd ? q_odd : q;
    r = odd ? r_odd : r;
    eta = swap ? -eta - 1 : eta - 1;  // delta -> 1 - delta or 1 + delta
  }
  t[0] = (int32_t)u;
  t[1] = (int32_t)v;
  t[2] = (int32_t)q;
  t[3] = (int32_t)r;
  return eta;
}

// (nf, ng) = t (f, g) / 2^30, exact (the divsteps made the low 30 bits
// zero).  4 N multiply-adds.
template <int W>
__device__ __forceinline__ void update_fg(int32_t (&nf)[Gcd<W>::N], int32_t (&ng)[Gcd<W>::N],
                                          const int32_t (&f)[Gcd<W>::N],
                                          const int32_t (&g)[Gcd<W>::N],
                                          const int32_t (&t)[4]) {
  constexpr int N = Gcd<W>::N;
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cf = (int64_t)u * f[0] + (int64_t)v * g[0];
  int64_t cg = (int64_t)q * f[0] + (int64_t)r * g[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < N; ++i) {
    cf += (int64_t)u * f[i] + (int64_t)v * g[i];
    cg += (int64_t)q * f[i] + (int64_t)r * g[i];
    nf[i - 1] = (int32_t)cf & kM30;
    ng[i - 1] = (int32_t)cg & kM30;
    cf >>= 30;
    cg >>= 30;
  }
  nf[N - 1] = (int32_t)cf;
  ng[N - 1] = (int32_t)cg;
}

// (nd, ne) = (t (d, e) + p (md, me)) / 2^30, with md, me chosen to make
// the low 30 bits zero; d, e stay in (-2p, p) (libsecp256k1's
// safegcd_implementation.md, section 6).  6 N + 2 multiply-adds.
template <int W>
__device__ __forceinline__ void update_de(int32_t (&nd)[Gcd<W>::N], int32_t (&ne)[Gcd<W>::N],
                                          const int32_t (&d)[Gcd<W>::N],
                                          const int32_t (&e)[Gcd<W>::N],
                                          const int32_t (&t)[4], const GcdParams<W>& gp) {
  constexpr int N = Gcd<W>::N;
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  // start from (u, q) where d < 0 and (v, r) where e < 0: that keeps the
  // result above -2p
  const int32_t sd = d[N - 1] >> 31, se = e[N - 1] >> 31;
  int32_t md = (u & sd) + (v & se);
  int32_t me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d[0] + (int64_t)v * e[0];
  int64_t ce = (int64_t)q * d[0] + (int64_t)r * e[0];
  md -= (int32_t)((gp.p_inv30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)kM30);
  me -= (int32_t)((gp.p_inv30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)kM30);
  cd += (int64_t)gp.p[0] * md;
  ce += (int64_t)gp.p[0] * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < N; ++i) {
    cd += (int64_t)u * d[i] + (int64_t)v * e[i] + (int64_t)gp.p[i] * md;
    ce += (int64_t)q * d[i] + (int64_t)r * e[i] + (int64_t)gp.p[i] * me;
    nd[i - 1] = (int32_t)cd & kM30;
    ne[i - 1] = (int32_t)ce & kM30;
    cd >>= 30;
    ce >>= 30;
  }
  nd[N - 1] = (int32_t)cd;
  ne[N - 1] = (int32_t)ce;
}

// r += p where r's top limb is negative, then carry: each limb back in
// [0, 2^30), the top one signed.
template <int W>
__device__ __forceinline__ void add_p_if_negative(int32_t (&r)[Gcd<W>::N],
                                                  const GcdParams<W>& gp) {
  constexpr int N = Gcd<W>::N;
  const int32_t neg = r[N - 1] >> 31;
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] += gp.p[i] & neg;
#pragma unroll
  for (int i = 0; i < N - 1; ++i) {
    r[i + 1] += r[i] >> 30;
    r[i] &= kM30;
  }
}

// out = d * sign in [0, p), for d in (-2p, p) and sign = f's top limb
// (f = +-1 at the end).
template <int W>
__device__ __forceinline__ void normalize(int32_t (&out)[Gcd<W>::N],
                                          const int32_t (&d)[Gcd<W>::N], int32_t f_top,
                                          const GcdParams<W>& gp) {
  constexpr int N = Gcd<W>::N;
  const int32_t neg = f_top >> 31;
  // (-2p, p) -> (-p, p), negated where f = -1: each limb within (-2^31, 2^31)
  const int32_t dneg = d[N - 1] >> 31;
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = ((d[i] + (gp.p[i] & dneg)) ^ neg) - neg;
#pragma unroll
  for (int i = 0; i < N - 1; ++i) {
    out[i + 1] += out[i] >> 30;
    out[i] &= kM30;
  }
  add_p_if_negative<W>(out, gp);  // (-p, p) -> [0, p)
}

template <int W>
__device__ __forceinline__ bool is_zero30(const int32_t (&x)[Gcd<W>::N]) {
  int32_t any = 0;
#pragma unroll
  for (int i = 0; i < Gcd<W>::N; ++i) any |= x[i];
  return any == 0;
}

// out = R^2 / x mod p (a^-1 R for x = a R), canonical; 0 for x = 0.  x < p.
// Returns the number of batches after which g was still nonzero, for the
// host build's check that the fixed count sufficed (a kernel discards it,
// and the compiler with it).
template <int W>
__device__ __forceinline__ int inv_gcd(uint32_t (&out)[W], const uint32_t (&x)[W],
                                       const GcdParams<W>& gp) {
  constexpr int N = Gcd<W>::N;
  int32_t f[N], g[N], d[N], e[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f[i] = gp.p[i];
    d[i] = 0;
  }
  to_signed30<W>(g, x);
  to_signed30<W>(e, gp.r2);
  int32_t eta = -1;  // delta = 1
  int live = 0;
#pragma unroll 1
  for (int b = 0; b < gp.batches; ++b) {
    int32_t t[4], nf[N], ng[N], nd[N], ne[N];
    eta = divsteps_30(eta, (uint32_t)f[0], (uint32_t)g[0], t);
    update_fg<W>(nf, ng, f, g, t);
    update_de<W>(nd, ne, d, e, t, gp);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      f[i] = nf[i];
      g[i] = ng[i];
      d[i] = nd[i];
      e[i] = ne[i];
    }
    live += is_zero30<W>(g) ? 0 : 1;
  }
  int32_t r[N];
  normalize<W>(r, d, f[N - 1], gp);
  from_signed30<W>(out, r);
  return live;
}
