// The Jacobian group-law kernels of the MSM path: K6 doubling, K7 full
// addition, K8 mixed addition (a = 0 curves over a prime field) in two
// kernels, the general one on any operands and the one that runs a
// lockstep round of the MSM's bucket phase; below them the affine
// additions, K11/K12 on packed rows and K9/K10 on coordinate arrays (any
// a).  Built and bound as launch.cuh says; the group law itself is in
// sw.cuh, the field arithmetic (carry-chain Montgomery products) in
// mont.cuh.
//
// They replace the TPU kernels _double_kernel, _add_kernel and _madd_kernel
// (algebra_tpu/ops/sw_pallas.py:111, :120, :56).  One thread per lane,
// grid-stride.  What holds them back on this card:
//   * operations as much as bytes: K8 moves 8 L words a lane (five
//     coordinates in, three out) and does 11 Montgomery products; at
//     W = 12 that is 769 B against ~3000 32-bit multiply-adds, close to
//     the card's ratio of integer rate to memory rate (PERF.md has the
//     instruction counts from the compiled code);
//   * registers: a lane holds five or six coordinates and the product's
//     running sum, so few warps fit a multiprocessor and the latency of
//     the dependent multiply-add chains is poorly hidden.  The round
//     kernel bounds its registers with __launch_bounds__ (kRoundBlocks).
//
// Operands of the general kernels.  Every input coordinate is read at word
// k * ls + i * bs for limb k of lane i, so a coordinate may be a full
// limb-major [L, n] array (ls = n, bs = 1), one element broadcast over the
// batch (ls = 1, bs = 0), or point-major rows [n, L] (ls = 1, bs = L or
// 2L), without a copy.  Outputs are limb-major [L, n].  An output may be
// the same array as the matching input P coordinate (accumulation in
// place): a thread reads its lane before it writes it, and no other thread
// touches that lane.

#include "launch.cuh"
#include "rows.cuh"
#include "sw.cuh"

struct Operand {
  const uint32_t* p;
  size_t ls;  // limb stride, in words
  size_t bs;  // lane stride, in words
};

template <int W>
__device__ __forceinline__ void load_op(uint32_t (&r)[W], const Operand& o, size_t i) {
  load_limbs<W>(r, o.p, o.ls, i * o.bs);
}

template <int W>
__device__ __forceinline__ void store_point(uint32_t* xo, uint32_t* yo, uint32_t* zo,
                                            size_t n, size_t i, const uint32_t (&X)[W],
                                            const uint32_t (&Y)[W],
                                            const uint32_t (&Z)[W]) {
  store_limbs<W>(xo, n, i, X);
  store_limbs<W>(yo, n, i, Y);
  store_limbs<W>(zo, n, i, Z);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
jac_double_kernel(Operand x1, Operand y1, Operand z1, uint32_t* xo, uint32_t* yo,
                  uint32_t* zo, size_t n, FieldParams<W> fp) {
  size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    uint32_t X1[W], Y1[W], Z1[W], X3[W], Y3[W], Z3[W];
    load_op<W>(X1, x1, i);
    load_op<W>(Y1, y1, i);
    load_op<W>(Z1, z1, i);
    jac_double<W>(X3, Y3, Z3, X1, Y1, Z1, fp);
    store_point<W>(xo, yo, zo, n, i, X3, Y3, Z3);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
jac_add_kernel(Operand x1, Operand y1, Operand z1, Operand x2, Operand y2, Operand z2,
               uint32_t* xo, uint32_t* yo, uint32_t* zo, size_t n, FieldParams<W> fp) {
  size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    uint32_t X1[W], Y1[W], Z1[W], X2[W], Y2[W], Z2[W], X3[W], Y3[W], Z3[W];
    load_op<W>(X1, x1, i);
    load_op<W>(Y1, y1, i);
    load_op<W>(Z1, z1, i);
    load_op<W>(X2, x2, i);
    load_op<W>(Y2, y2, i);
    load_op<W>(Z2, z2, i);
    jac_add<W>(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2, fp);
    store_point<W>(xo, yo, zo, n, i, X3, Y3, Z3);
  }
}

// q_inf: one byte a lane (a torch.bool array) at i * inf_bs; nonzero means
// Q is infinity.
template <int W>
__global__ void __launch_bounds__(kThreads)
jac_madd_kernel(Operand x1, Operand y1, Operand z1, Operand x2, Operand y2,
                const uint8_t* q_inf, size_t inf_bs, uint32_t* xo, uint32_t* yo,
                uint32_t* zo, size_t n, FieldParams<W> fp, Words<W> one) {
  size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    uint32_t X1[W], Y1[W], Z1[W], X2[W], Y2[W], X3[W], Y3[W], Z3[W];
    load_op<W>(X1, x1, i);
    load_op<W>(Y1, y1, i);
    load_op<W>(Z1, z1, i);
    load_op<W>(X2, x2, i);
    load_op<W>(Y2, y2, i);
    bool inf = q_inf[i * inf_bs] != 0;
    jac_madd<W>(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, inf, one, fp);
    store_point<W>(xo, yo, zo, n, i, X3, Y3, Z3);
  }
}

// ---------------------------------------------------------------------------
// K8 in the MSM's lockstep bucket phase: one launch a round.  Lane i of the
// accumulators (limb-major [L, m], updated in place) is one (window, bucket);
// its points are the run order[first[i] .. first[i] + count[i]) of the
// window's sorted signed order, whose entries are rows of the signed table
// ([2n, 2L] point-major, x | y, row n + j holding -y_j: the digit's sign
// is in the row).  Round r:
//   * r < count[i]: the lane reads row order[first[i] + r] itself, as
//     16-byte pieces (a row is 16 W bytes), and adds it: jac_madd with Q
//     finite;
//   * otherwise Q is infinity, and the reference's rule applies bit for
//     bit: where Z1 = 0 the lane becomes (one, one, 0) (an accumulator can
//     hold (X, Y, 0) with X, Y != one after P + (-P)); elsewhere it is left
//     as it is and not written.
// The round's gather, sign and infinity mask so take no launch of their
// own and no array in device memory.  By the count, bytes bound a round
// (P read and written, the row, the order entry, first and count: 792 B
// a lane at W = 12) about as much as the multiply-adds do; the registers
// a lane needs decide the occupancy (kRoundBlocks).
// ---------------------------------------------------------------------------

// Blocks of kThreads a multiprocessor must hold: the register budget of
// the round kernel, 65536 / (kThreads * kRoundBlocks) a thread.  At 24
// words a lane's five coordinates alone take 120 registers.  At 12 words
// no bound is free of spills; 4 blocks (a small spill) against 3 is timed
// at the MSM's rounds by chip_probes.py round-blocks, which builds the
// other bound with -DROUND_BLOCKS=n (PERF.md has the readings).
#ifdef ROUND_BLOCKS
constexpr int kRoundBlocks = ROUND_BLOCKS;
#else
constexpr int kRoundBlocks = kW <= 12 ? 4 : 1;
#endif

// v, with the compiler told nothing of where it came from.  The round
// kernel writes its accumulators at the addresses it read them from; left
// alone, the compiler keeps the 6 W load addresses live across the whole
// addition to reuse them for the stores, which took the kernel to the
// 255-register ceiling with spills at 12 words.  Stores through opaque
// copies of the base and the index recompute their addresses instead.
template <class T>
__device__ __forceinline__ T opaque(T v) {
  asm volatile("" : "+l"(v));
  return v;
}

template <int W>
__global__ void __launch_bounds__(kThreads, kRoundBlocks)
jac_madd_round_kernel(uint32_t* __restrict__ xa, uint32_t* __restrict__ ya,
                      uint32_t* __restrict__ za, size_t m,
                      const uint32_t* __restrict__ table,
                      const int64_t* __restrict__ order,
                      const int64_t* __restrict__ first,
                      const int64_t* __restrict__ count, int64_t r, FieldParams<W> fp,
                      Words<W> one) {
  size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += step) {
    uint32_t Z1[W];
    if (r < count[i]) {
      const uint4* row = reinterpret_cast<const uint4*>(
          table + (size_t)order[first[i] + r] * (4 * W));
      uint32_t X1[W], Y1[W], X2[W], Y2[W], X3[W], Y3[W], Z3[W];
      load_row_coord<W>(X2, row);
      load_row_coord<W>(Y2, row + W / 2);
      load_limbs<W>(X1, xa, m, i);
      load_limbs<W>(Y1, ya, m, i);
      load_limbs<W>(Z1, za, m, i);
      jac_madd<W>(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, false, one, fp);
      store_point<W>(opaque(xa), opaque(ya), opaque(za), opaque(m), opaque(i), X3, Y3, Z3);
    } else {
      load_limbs<W>(Z1, za, m, i);
      if (is_zero<W>(Z1)) store_point<W>(xa, ya, za, m, i, one.w, one.w, Z1);
    }
  }
}

// ---------------------------------------------------------------------------
// One halving level of the MSM's affine tree on packed rows (rows.cuh):
// K11 affr_denom and K12 affr_post, around the batched inversion (K2-K4).
// They replace _affr_denom_kernel and _affr_post_kernel
// (algebra_tpu/ops/sw_pallas.py:373, :391).  V holds 2m rows, pair i in
// rows 2i (P) and 2i + 1 (Q); `valid`, when given (the first level of a
// stage), is a bool a row, and an invalid row counts as infinity.  One
// thread a pair, its rows read as 16-byte pieces.
//   * K11 writes the slope's denominator, limb-major [L, m] for the
//     inversion: 2 y1 for a tangent, x2 - x1 for a chord, one for a
//     degenerate lane.  No products: bound by bytes (two rows in, one
//     element out).
//   * K12 writes P + Q as a row: lambda = num * inv, x3 = lambda^2 - x1 - x2,
//     y3 = lambda (x1 - x3) - y1, num = 3 x1^2 + a for a tangent, y2 - y1
//     otherwise.  The reference computes this in every lane and then
//     selects x3 = i1 ? x2 : (i2 ? x1 : x3) (y3 alike) and
//     inf3 = (i1 and i2) or (not i1 and not i2 and opp).  Here an infinity
//     lane copies and only the other lanes compute, which gives the same
//     words; an opposite-points lane computes with inv = 1 as the
//     reference does, so its (flagged) coordinates agree too.  Two
//     products and a square a lane (a tangent one more square): at W = 12,
//     834 multiply-adds against 2 x 196 + 96 + 208 bytes, so by the count
//     bytes bound it, four to one; as for K8, the instructions around the
//     multiply-adds and the registers a lane holds decide in practice.
// ---------------------------------------------------------------------------

template <int W>
__device__ __forceinline__ void load_pair(uint32_t (&x1)[W], uint32_t (&y1)[W], bool& i1,
                                          uint32_t (&x2)[W], uint32_t (&y2)[W], bool& i2,
                                          const uint32_t* V, const uint8_t* valid,
                                          size_t i) {
  load_row<W>(x1, y1, i1, V, 2 * i);
  load_row<W>(x2, y2, i2, V, 2 * i + 1);
  if (valid != nullptr) {
    i1 = i1 || valid[2 * i] == 0;
    i2 = i2 || valid[2 * i + 1] == 0;
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
affr_denom_kernel(const uint32_t* __restrict__ V, const uint8_t* __restrict__ valid,
                  uint32_t* __restrict__ den, size_t m, FieldParams<W> fp, Words<W> one) {
  size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += step) {
    uint32_t x1[W], y1[W], x2[W], y2[W], d[W];
    bool i1, i2, dbl, opp, degen;
    load_pair<W>(x1, y1, i1, x2, y2, i2, V, valid, i);
    aff_cases<W>(d, dbl, opp, degen, x1, y1, i1, x2, y2, i2, fp);
    if (degen) {
      copy_words<W>(d, one.w);
    } else if (dbl) {
      mod_add<W>(d, y1, y1, fp);
    }
    store_limbs<W>(den, m, i, d);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
affr_post_kernel(const uint32_t* __restrict__ V, const uint8_t* __restrict__ valid,
                 const uint32_t* __restrict__ inv, uint32_t* __restrict__ out, size_t m,
                 FieldParams<W> fp, Words<W> a, int has_a) {
  size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += step) {
    uint32_t x1[W], y1[W], x2[W], y2[W];
    bool i1, i2;
    load_pair<W>(x1, y1, i1, x2, y2, i2, V, valid, i);
    if (i1) {
      store_row<W>(out, i, x2, y2, i2);
      continue;
    }
    if (i2) {
      store_row<W>(out, i, x1, y1, false);
      continue;
    }
    uint32_t d[W], x3[W], y3[W];
    bool dbl, opp, degen;
    aff_cases<W>(d, dbl, opp, degen, x1, y1, i1, x2, y2, i2, fp);
    load_limbs<W>(d, inv, m, i);
    aff_complete<W>(x3, y3, x1, y1, x2, y2, dbl, d, a, has_a != 0, fp);
    store_row<W>(out, i, x3, y3, opp);
  }
}

// ---------------------------------------------------------------------------
// The affine chord/tangent addition on coordinate arrays (SWCurve.affine_add):
// K9 aff_denom and K10 aff_post, around the batched inversion (K2-K4).
// They replace _aff_denom_kernel and _aff_post_kernel
// (algebra_tpu/ops/sw_pallas.py:199, :216).  The same arithmetic as K11/K12
// (aff_cases, aff_complete), with operands as limb-major coordinates read
// through a limb and a lane stride (as K6-K8 read theirs) and the flags as
// bool arrays, one byte a lane at a lane stride; neg1/neg2, when given,
// negate y1/y2 first (0 stays 0), as the reference's _aff_neg does.  One
// thread a lane.
//   * K9 writes the slope's denominator, [L, n]: 2 y1 for a tangent,
//     x2 - x1 for a chord, one for a degenerate lane (an infinity, or
//     opposite points).  No products: bound by bytes, four coordinates and
//     the flags in, one coordinate out.
//   * K10 writes x3, y3 [L, n] and inf3 [n].  An infinity lane copies the
//     other operand where the reference selects (both at infinity: x2, y2
//     and inf); every other lane computes, an opposite-points lane with
//     the inverse of one, so even its flagged coordinates are the
//     reference's; inf3 = (i1 and i2) or (not i1 and not i2 and opp).
//     Two products and a square a computed lane (a tangent one square
//     more) against five coordinates in and two out: bytes bound it by the
//     count, as for K12.
// ---------------------------------------------------------------------------

struct Mask {
  const uint8_t* p;  // one byte a lane, nonzero = set; null = no mask
  size_t bs;         // lane stride, in bytes
};

__device__ __forceinline__ bool mask_at(const Mask& m, size_t i) {
  return m.p != nullptr && m.p[i * m.bs] != 0;
}

template <int W>
__device__ __forceinline__ void neg_if(uint32_t (&y)[W], bool neg,
                                       const FieldParams<W>& fp) {
  if (neg) {
    uint32_t zero[W] = {};
    mod_sub<W>(y, zero, y, fp);
  }
}

template <int W>
__device__ __forceinline__ void load_aff_pair(
    uint32_t (&x1)[W], uint32_t (&y1)[W], bool& i1, uint32_t (&x2)[W],
    uint32_t (&y2)[W], bool& i2, const Operand& ox1, const Operand& oy1,
    const Mask& mi1, const Operand& ox2, const Operand& oy2, const Mask& mi2,
    const Mask& n1, const Mask& n2, size_t i, const FieldParams<W>& fp) {
  load_op<W>(x1, ox1, i);
  load_op<W>(y1, oy1, i);
  load_op<W>(x2, ox2, i);
  load_op<W>(y2, oy2, i);
  i1 = mask_at(mi1, i);
  i2 = mask_at(mi2, i);
  neg_if<W>(y1, mask_at(n1, i), fp);
  neg_if<W>(y2, mask_at(n2, i), fp);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
aff_denom_kernel(Operand ox1, Operand oy1, Mask mi1, Operand ox2, Operand oy2, Mask mi2,
                 Mask n1, Mask n2, uint32_t* __restrict__ den, size_t n,
                 FieldParams<W> fp, Words<W> one) {
  size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    uint32_t x1[W], y1[W], x2[W], y2[W], d[W];
    bool i1, i2, dbl, opp, degen;
    load_aff_pair<W>(x1, y1, i1, x2, y2, i2, ox1, oy1, mi1, ox2, oy2, mi2, n1, n2, i, fp);
    aff_cases<W>(d, dbl, opp, degen, x1, y1, i1, x2, y2, i2, fp);
    if (degen) {
      copy_words<W>(d, one.w);
    } else if (dbl) {
      mod_add<W>(d, y1, y1, fp);
    }
    store_limbs<W>(den, n, i, d);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
aff_post_kernel(Operand ox1, Operand oy1, Mask mi1, Operand ox2, Operand oy2, Mask mi2,
                Mask n1, Mask n2, const uint32_t* __restrict__ inv,
                uint32_t* __restrict__ xo, uint32_t* __restrict__ yo,
                uint8_t* __restrict__ io, size_t n, FieldParams<W> fp, Words<W> a,
                int has_a) {
  size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    uint32_t x1[W], y1[W], x2[W], y2[W];
    bool i1, i2;
    load_aff_pair<W>(x1, y1, i1, x2, y2, i2, ox1, oy1, mi1, ox2, oy2, mi2, n1, n2, i, fp);
    if (i1) {
      store_limbs<W>(xo, n, i, x2);
      store_limbs<W>(yo, n, i, y2);
      io[i] = i2;
      continue;
    }
    if (i2) {
      store_limbs<W>(xo, n, i, x1);
      store_limbs<W>(yo, n, i, y1);
      io[i] = 0;
      continue;
    }
    uint32_t d[W], x3[W], y3[W];
    bool dbl, opp, degen;
    aff_cases<W>(d, dbl, opp, degen, x1, y1, i1, x2, y2, i2, fp);
    load_limbs<W>(d, inv, n, i);
    aff_complete<W>(x3, y3, x1, y1, x2, y2, dbl, d, a, has_a != 0, fp);
    store_limbs<W>(xo, n, i, x3);
    store_limbs<W>(yo, n, i, y3);
    io[i] = opp;
  }
}

static inline Operand op(const void* p, size_t ls, size_t bs) {
  return Operand{(const uint32_t*)p, ls, bs};
}

static inline Mask mask(const void* p, size_t bs) { return Mask{(const uint8_t*)p, bs}; }

extern "C" {

int sw_words() { return kW; }

int jac_double_launch(const void* x1, size_t x1_ls, size_t x1_bs, const void* y1,
                      size_t y1_ls, size_t y1_bs, const void* z1, size_t z1_ls,
                      size_t z1_bs, void* xo, void* yo, void* zo, size_t n,
                      const uint32_t* p_words, uint32_t inv32, void* stream) {
  jac_double_kernel<kW><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      op(x1, x1_ls, x1_bs), op(y1, y1_ls, y1_bs), op(z1, z1_ls, z1_bs), (uint32_t*)xo,
      (uint32_t*)yo, (uint32_t*)zo, n, make_params(p_words, inv32));
  return (int)cudaGetLastError();
}

int jac_add_launch(const void* x1, size_t x1_ls, size_t x1_bs, const void* y1,
                   size_t y1_ls, size_t y1_bs, const void* z1, size_t z1_ls, size_t z1_bs,
                   const void* x2, size_t x2_ls, size_t x2_bs, const void* y2,
                   size_t y2_ls, size_t y2_bs, const void* z2, size_t z2_ls, size_t z2_bs,
                   void* xo, void* yo, void* zo, size_t n, const uint32_t* p_words,
                   uint32_t inv32, void* stream) {
  jac_add_kernel<kW><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      op(x1, x1_ls, x1_bs), op(y1, y1_ls, y1_bs), op(z1, z1_ls, z1_bs),
      op(x2, x2_ls, x2_bs), op(y2, y2_ls, y2_bs), op(z2, z2_ls, z2_bs), (uint32_t*)xo,
      (uint32_t*)yo, (uint32_t*)zo, n, make_params(p_words, inv32));
  return (int)cudaGetLastError();
}

int jac_madd_launch(const void* x1, size_t x1_ls, size_t x1_bs, const void* y1,
                    size_t y1_ls, size_t y1_bs, const void* z1, size_t z1_ls,
                    size_t z1_bs, const void* x2, size_t x2_ls, size_t x2_bs,
                    const void* y2, size_t y2_ls, size_t y2_bs, const void* q_inf,
                    size_t inf_bs, void* xo, void* yo, void* zo, size_t n,
                    const uint32_t* p_words, uint32_t inv32, const uint32_t* one_words,
                    void* stream) {
  jac_madd_kernel<kW><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      op(x1, x1_ls, x1_bs), op(y1, y1_ls, y1_bs), op(z1, z1_ls, z1_bs),
      op(x2, x2_ls, x2_bs), op(y2, y2_ls, y2_bs), (const uint8_t*)q_inf, inf_bs,
      (uint32_t*)xo, (uint32_t*)yo, (uint32_t*)zo, n, make_params(p_words, inv32),
      make_words(one_words));
  return (int)cudaGetLastError();
}

int jac_madd_round_launch(void* xa, void* ya, void* za, size_t m, const void* table,
                          const void* order, const void* first, const void* count,
                          long long r, const uint32_t* p_words, uint32_t inv32,
                          const uint32_t* one_words, void* stream) {
  jac_madd_round_kernel<kW><<<grid_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)xa, (uint32_t*)ya, (uint32_t*)za, m, (const uint32_t*)table,
      (const int64_t*)order, (const int64_t*)first, (const int64_t*)count, (int64_t)r,
      make_params(p_words, inv32), make_words(one_words));
  return (int)cudaGetLastError();
}

int affr_denom_launch(const void* V, const void* valid, void* den, size_t m,
                      const uint32_t* p_words, uint32_t inv32, const uint32_t* one_words,
                      void* stream) {
  affr_denom_kernel<kW><<<grid_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)V, (const uint8_t*)valid, (uint32_t*)den, m,
      make_params(p_words, inv32), make_words(one_words));
  return (int)cudaGetLastError();
}

int affr_post_launch(const void* V, const void* valid, const void* inv, void* out, size_t m,
                     const uint32_t* p_words, uint32_t inv32, const uint32_t* a_words,
                     int has_a, void* stream) {
  affr_post_kernel<kW><<<grid_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)V, (const uint8_t*)valid, (const uint32_t*)inv, (uint32_t*)out, m,
      make_params(p_words, inv32), make_words(a_words), has_a);
  return (int)cudaGetLastError();
}

int aff_denom_launch(const void* x1, size_t x1_ls, size_t x1_bs, const void* y1,
                     size_t y1_ls, size_t y1_bs, const void* i1, size_t i1_bs,
                     const void* x2, size_t x2_ls, size_t x2_bs, const void* y2,
                     size_t y2_ls, size_t y2_bs, const void* i2, size_t i2_bs,
                     const void* n1, size_t n1_bs, const void* n2, size_t n2_bs, void* den,
                     size_t n, const uint32_t* p_words, uint32_t inv32,
                     const uint32_t* one_words, void* stream) {
  aff_denom_kernel<kW><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      op(x1, x1_ls, x1_bs), op(y1, y1_ls, y1_bs), mask(i1, i1_bs), op(x2, x2_ls, x2_bs),
      op(y2, y2_ls, y2_bs), mask(i2, i2_bs), mask(n1, n1_bs), mask(n2, n2_bs),
      (uint32_t*)den, n, make_params(p_words, inv32), make_words(one_words));
  return (int)cudaGetLastError();
}

int aff_post_launch(const void* x1, size_t x1_ls, size_t x1_bs, const void* y1,
                    size_t y1_ls, size_t y1_bs, const void* i1, size_t i1_bs,
                    const void* x2, size_t x2_ls, size_t x2_bs, const void* y2,
                    size_t y2_ls, size_t y2_bs, const void* i2, size_t i2_bs,
                    const void* n1, size_t n1_bs, const void* n2, size_t n2_bs,
                    const void* inv, void* xo, void* yo, void* io, size_t n,
                    const uint32_t* p_words, uint32_t inv32, const uint32_t* a_words,
                    int has_a, void* stream) {
  aff_post_kernel<kW><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      op(x1, x1_ls, x1_bs), op(y1, y1_ls, y1_bs), mask(i1, i1_bs), op(x2, x2_ls, x2_bs),
      op(y2, y2_ls, y2_bs), mask(i2, i2_bs), mask(n1, n1_bs), mask(n2, n2_bs),
      (const uint32_t*)inv, (uint32_t*)xo, (uint32_t*)yo, (uint8_t*)io, n,
      make_params(p_words, inv32), make_words(a_words), has_a);
  return (int)cudaGetLastError();
}

}  // extern "C"
