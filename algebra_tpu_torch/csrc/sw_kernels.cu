// The Jacobian group-law kernels of the MSM path: K6 doubling, K7 full
// addition, K8 mixed addition (a = 0 curves over a prime field).  Built and
// bound as launch.cuh says; the group law itself is in sw.cuh.
//
// They replace the TPU kernels _double_kernel, _add_kernel and _madd_kernel
// (algebra_tpu/ops/sw_pallas.py:111, :120, :56).  One thread per lane,
// grid-stride.  What holds them back on this card:
//   * operations as much as bytes: K8 moves 8 L words a lane (five
//     coordinates in, three out) and the flag, and does 11 Montgomery
//     products; at W = 12 that is 769 B against ~3000 32-bit multiply-adds,
//     close to the card's ratio of integer rate to memory rate, and the
//     carry chains add instructions beyond the multiply-adds (PERF.md has
//     the count from the compiled code);
//   * registers: a lane holds five or six coordinates and the product's
//     window, so few warps fit a multiprocessor and the latency of the
//     dependent multiply-add chains is poorly hidden;
//   * the MSM's lockstep round gathers the affine operand point-major and
//     selects its sign in plain PyTorch before K8 reads it.
// A later PR can fold the gather and the sign into K8 and stage operands
// in shared memory; these kernels are the simple, exact version.
//
// Operands.  Every input coordinate is read at word k * ls + i * bs for
// limb k of lane i, so a coordinate may be a full limb-major [L, n] array
// (ls = n, bs = 1), one element broadcast over the batch (ls = 1, bs = 0),
// or point-major rows [n, L] gathered by the MSM (ls = 1, bs = L or 2L),
// without a copy.  Outputs are limb-major [L, n].  An output may be the
// same array as the matching input P coordinate (the MSM accumulates in
// place): a thread reads its lane before it writes it, and no other thread
// touches that lane.

#include "launch.cuh"
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

static inline Operand op(const void* p, size_t ls, size_t bs) {
  return Operand{(const uint32_t*)p, ls, bs};
}

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

}  // extern "C"
