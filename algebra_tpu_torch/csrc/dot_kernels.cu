// K17: weighted sums of Montgomery products, the port's counterpart of the
// JAX package's ops/mont.py dot_stacked (an XLA fusion there, no Pallas
// kernel).  It is what every tower product runs: an Fq2, Fq6 or Fp12
// product, the pairing's sparse line products and the Miller loop's and the
// G2 group law's fused "waves" are each one launch,
//   out[:, o, i] = sum_k W[o, k] * A[:, k, i] * B[:, k, i] * R^-1 mod p,
// with A, B [L, K, n] and W a small signed [n_out, K] matrix.  Built and
// bound as launch.cuh says.
//
// Design (a simple first one): one thread per (lane, output row); the grid's
// y index is the row, so a block's threads share one row's weights, which
// the block first copies to shared memory (the host compresses W to the
// non-zero entries of each row, csrc/dot.cuh's format).  Each entry costs one
// product (mont_mul, or mont_sq for a square pair) and its weight's
// double-and-add; a product that several rows use is recomputed in each.
// Bound: the bytes of A, B and out (2 K + n_out words of L limbs a lane)
// against K products a lane; at an Fp12 product (K = 144, n_out = 12,
// W = 12) the bytes bound it.  The reference's one shared reduction per row
// and products shared between rows are for a later redesign.

#include "launch.cuh"
#include "dot.cuh"

// Entries of one row at most: a row's weight mass is at most
// dot_mass_limit (<= 1022 for any field here), and each entry weighs >= 1.
constexpr int kDotMaxRow = 1024;

template <int W>
__global__ void __launch_bounds__(kThreads)
mont_dot_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
                uint32_t* __restrict__ out, size_t n, int K, int n_out,
                const int32_t* __restrict__ row_start, const int32_t* __restrict__ ent,
                FieldParams<W> fp) {
  __shared__ int32_t s_ent[2 * kDotMaxRow];
  int o = blockIdx.y;
  int begin = row_start[o];
  int count = row_start[o + 1] - begin;
  for (int e = threadIdx.x; e < 2 * count; e += blockDim.x) s_ent[e] = ent[2 * begin + e];
  __syncthreads();
  size_t ls = (size_t)K * n;
  size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    uint32_t acc[W];
    dot_lane<W>(acc, A, B, ls, n, i, s_ent, count, fp);
    store_limbs<W>(out, (size_t)n_out * n, (size_t)o * n + i, acc);
  }
}

extern "C" {

int dot_words() { return kW; }

int dot_max_row() { return kDotMaxRow; }

int mont_dot_launch(const void* A, const void* B, void* out, size_t n, int K, int n_out,
                    const void* row_start, const void* ent, const uint32_t* p_words,
                    uint32_t inv32, void* stream) {
  dim3 grid(grid_for(n), (unsigned)n_out);
  mont_dot_kernel<kW><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)A, (const uint32_t*)B, (uint32_t*)out, n, K, n_out,
      (const int32_t*)row_start, (const int32_t*)ent, make_params(p_words, inv32));
  return (int)cudaGetLastError();
}

}  // extern "C"
