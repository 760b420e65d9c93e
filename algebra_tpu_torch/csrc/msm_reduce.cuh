// The MSM's tail as __device__ functions over sw.cuh: the weighted bucket
// reduction sum_k (k+1) S_k of every window and the Horner fold over the
// windows, step by step in the reference's order (algebra_tpu/ops/msm.py
// _weighted_tree_reduce, _horner_fold).  msm_reduce_kernels.cu runs them in
// two launches; a host build (MONT_HOST_EMULATION) runs the same steps in
// the same lockstep schedule to check them without a GPU.
//
// The reduction of a window's B buckets, in blocks of G (k = b G + i):
//   inner scan, for i = G-1 ... 0, on every (window, block) lane:
//       accT = accT + P[i]        (the suffix sum in the block: T_b at the end)
//       accW = accW + accT        (the (i+1)-weighted sum: innerW_b)
//   outer scan, for b = nb-1 ... 0, on every window:
//       accB = accB + accT        (strictly later suffix: b T_b in all)
//       accT = accT + T[b]
//       accI = accI + innerW[b]
//   then accB doubled log2(G) times, and the window's sum accI + accB.
// The fold, from the top window down: c doublings of the total, then
// total + S_w.
//
// Each chain is its own thread.  A chain that adds what another produced
// runs one step behind it and receives that value at the end of each step
// (a warp shuffle on the card).  In one step each thread makes at most one
// jac_add, so the dependent depth of the inner scan is G + 1 adds instead
// of 2 G, and the outer scan's nb instead of 3 nb.  Every add has the
// operands the reference gives it, in the same order, so the words are the
// reference's (sw.cuh: a lane branches where the TPU selects).

#pragma once

#include "sw.cuh"

template <int W>
struct Jac {
  uint32_t x[W], y[W], z[W];
};

template <int W>
__device__ __forceinline__ void jac_set_zero(Jac<W>& p, const Words<W>& one) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    p.x[k] = one.w[k];
    p.y[k] = one.w[k];
    p.z[k] = 0u;
  }
}

// The group law writes into arrays of its own, which are then copied into
// the accumulator (register moves up to 12 words).  At 24 words, where the
// products are out-of-line calls (sw.cuh), jac_double writing into the
// members of a Jac gave a wrong Z on the card, though the host build of the
// same source is right; with separate output arrays, as the general kernels
// have them, it is right (PERF.md, section 6).
template <int W>
__device__ __forceinline__ void jac_set(Jac<W>& acc, const uint32_t (&X)[W],
                                        const uint32_t (&Y)[W], const uint32_t (&Z)[W]) {
  copy_words<W>(acc.x, X);
  copy_words<W>(acc.y, Y);
  copy_words<W>(acc.z, Z);
}

// acc = acc + q (jac_add with acc as P).
template <int W>
__device__ __forceinline__ void jac_accumulate(Jac<W>& acc, const Jac<W>& q,
                                               const FieldParams<W>& fp) {
  uint32_t X[W], Y[W], Z[W];
  jac_add<W>(X, Y, Z, acc.x, acc.y, acc.z, q.x, q.y, q.z, fp);
  jac_set<W>(acc, X, Y, Z);
}

// acc = p + acc (jac_add with acc as Q): the window's final accI + accB.
template <int W>
__device__ __forceinline__ void jac_accumulate_right(Jac<W>& acc, const Jac<W>& p,
                                                     const FieldParams<W>& fp) {
  uint32_t X[W], Y[W], Z[W];
  jac_add<W>(X, Y, Z, p.x, p.y, p.z, acc.x, acc.y, acc.z, fp);
  jac_set<W>(acc, X, Y, Z);
}

template <int W>
__device__ __forceinline__ void jac_double_acc(Jac<W>& acc, const FieldParams<W>& fp) {
  uint32_t X[W], Y[W], Z[W];
  jac_double<W>(X, Y, Z, acc.x, acc.y, acc.z, fp);
  jac_set<W>(acc, X, Y, Z);
}

// A point of three limb-major coordinate arrays [2W, ls] (16-bit limbs).
template <int W>
__device__ __forceinline__ void load_jac(Jac<W>& p, const uint32_t* x, const uint32_t* y,
                                         const uint32_t* z, size_t ls, size_t i) {
  load_limbs<W>(p.x, x, ls, i);
  load_limbs<W>(p.y, y, ls, i);
  load_limbs<W>(p.z, z, ls, i);
}

template <int W>
__device__ __forceinline__ void store_jac(uint32_t* x, uint32_t* y, uint32_t* z, size_t ls,
                                          size_t i, const Jac<W>& p) {
  store_limbs<W>(x, ls, i, p.x);
  store_limbs<W>(y, ls, i, p.y);
  store_limbs<W>(z, ls, i, p.z);
}

// ------------------------------------------------------------- inner scan
// A (window, block) lane is a pair of threads, G + 1 steps s = 0 ... G.
// Role 0 carries accT and at step s < G adds bucket G - 1 - s of its block;
// role 1 carries accW and at step s >= 1 adds the accT role 0 held at the
// end of step s - 1.  Both start at infinity (one, one, 0).

constexpr int kInnerT = 0, kInnerW = 1;

__device__ __forceinline__ bool inner_adds(int role, int s, int G) {
  return role == kInnerT ? s < G : s >= 1;
}

__device__ __forceinline__ int inner_bucket(int s, int G) { return G - 1 - s; }

// ------------------------------------------------------------- outer scan
// A window is three threads, nb steps s = 0 ... nb-1 over block b = nb-1-s.
// Role T adds T[b]; role I adds innerW[b]; role B adds the accT that role T
// held at the end of step s - 1 (infinity at step 0, as the reference adds
// its zero accT first).  Then role B doubles log2(G) times and takes role
// I's accI: the window's sum is accI + accB.

constexpr int kOuterT = 0, kOuterB = 1, kOuterI = 2, kOuterRoles = 4;

__device__ __forceinline__ int outer_block(int s, int nb) { return nb - 1 - s; }

template <int W>
__device__ __forceinline__ void window_sum(Jac<W>& accB, const Jac<W>& accI, int log2G,
                                           const FieldParams<W>& fp) {
  for (int j = 0; j < log2G; ++j) jac_double_acc<W>(accB, fp);
  jac_accumulate_right<W>(accB, accI, fp);
}

// ------------------------------------------------------------- Horner fold
// One window of the fold, top window first: c doublings, then + S_w.
template <int W>
__device__ __forceinline__ void horner_step(Jac<W>& total, const Jac<W>& sum, int c,
                                            const FieldParams<W>& fp) {
  for (int j = 0; j < c; ++j) jac_double_acc<W>(total, fp);
  jac_accumulate<W>(total, sum, fp);
}
