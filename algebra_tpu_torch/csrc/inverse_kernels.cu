// The three kernels of blocked batched inversion (Montgomery's trick).
// Built and bound as launch.cuh says.
//
// One level sees its n elements as G rows of m = ceil(n / G) consecutive
// elements; thread j owns column j, that is elements j, m + j, 2m + j, ...
// (a warp's loads of one row are contiguous).  The prefix kernel leaves the
// running products down each column and the column's total (its "tail");
// the tails are a batch of m elements for the next level.  The bottom level
// is inverted element by element with a fixed-exponent ladder, and the
// backward kernel turns a level's tail inverses into its element inverses.
// About three products an element in all.
//
// A ragged last row needs no padding: an element past n reads as one and is
// never written.  A zero element counts as one in the products and gets the
// inverse zero, so the caller masks nothing.

#include "inverse.cuh"
#include "launch.cuh"

template <int W>
__device__ __forceinline__ void one_if_zero(uint32_t (&x)[W], const Words<W>& one) {
  bool z = is_zero<W>(x);
#pragma unroll
  for (int k = 0; k < W; ++k) x[k] = z ? one.w[k] : x[k];
}

// pref[i*m + j] = product of rows 0..i of column j; tails[j] = the whole
// column's product.  a, pref: [2W, n]; tails: [2W, m].
template <int W>
__global__ void __launch_bounds__(kThreads)
inv_prefix_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ pref,
                  uint32_t* __restrict__ tails, size_t n, size_t m, int G,
                  FieldParams<W> fp, Words<W> one) {
  size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x; j < m; j += step) {
    uint32_t p[W], x[W];
    load_limbs<W>(p, a, n, j);  // j < m <= n
    one_if_zero<W>(p, one);
    store_limbs<W>(pref, n, j, p);
    for (int i = 1; i < G; ++i) {
      size_t idx = (size_t)i * m + j;
      load_limbs_bounded<W>(x, a, n, idx, one);
      one_if_zero<W>(x, one);
      mont_mul<W>(p, p, x, fp);
      store_limbs_bounded<W>(pref, n, idx, p);
    }
    store_limbs<W>(tails, m, j, p);
  }
}

// From tinv[j] = 1 / (product of column j), upwards from the last row:
//   out[i*m + j] = running * pref[(i-1)*m + j];  running *= a[i*m + j];
// and out[j] = running.  Where a is zero, out is zero and running stays.
template <int W>
__global__ void __launch_bounds__(kThreads)
inv_backward_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ pref,
                    const uint32_t* __restrict__ tinv, uint32_t* __restrict__ out,
                    size_t n, size_t m, int G, FieldParams<W> fp, Words<W> one) {
  size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x; j < m; j += step) {
    uint32_t run[W], x[W], q[W], o[W];
    load_limbs<W>(run, tinv, m, j);
    for (int i = G - 1; i >= 1; --i) {
      size_t idx = (size_t)i * m + j;
      load_limbs_bounded<W>(x, a, n, idx, one);
      load_limbs_bounded<W>(q, pref, n, idx - m, one);
      bool z = is_zero<W>(x);
      mont_mul<W>(o, run, q, fp);
#pragma unroll
      for (int k = 0; k < W; ++k) o[k] = z ? 0u : o[k];
      store_limbs_bounded<W>(out, n, idx, o);
      one_if_zero<W>(x, one);
      mont_mul<W>(run, run, x, fp);
    }
    load_limbs<W>(x, a, n, j);
    bool z = is_zero<W>(x);
#pragma unroll
    for (int k = 0; k < W; ++k) run[k] = z ? 0u : run[k];
    store_limbs<W>(out, n, j, run);
  }
}

// out = a^e for a launch-constant exponent e of nbits >= 1 bits: square,
// then multiply where the bit is set, most significant bit first.  The bit
// is the same for every thread, so the branch does not diverge.  With
// e = p - 2 this is the inverse, and zero goes to zero.
template <int W>
__global__ void __launch_bounds__(kThreads)
inv_fermat_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, size_t n,
                  Words<W> e, int nbits, FieldParams<W> fp) {
  size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += step) {
    uint32_t x[W], r[W];
    load_limbs<W>(x, a, n, j);
#pragma unroll
    for (int k = 0; k < W; ++k) r[k] = x[k];
#pragma unroll 1
    for (int b = nbits - 2; b >= 0; --b) {
      mont_sq<W>(r, r, fp);
      if ((e.w[b >> 5] >> (b & 31)) & 1u) mont_mul<W>(r, r, x, fp);
    }
    store_limbs<W>(out, n, j, r);
  }
}

// out = a^-1 (Montgomery form in, Montgomery form out, zero to zero) by
// safegcd, one thread an element (inverse.cuh).  Every thread runs the
// same gp.batches batches of 30 divsteps.  Up to one block a
// multiprocessor (2^14 elements) the time is that of one thread's
// instructions, some 1,250 a batch at W = 8, not that of ~1.5 bits(p)
// dependent Montgomery products as in the ladder.
template <int W>
__global__ void __launch_bounds__(kThreads)
inv_gcd_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, size_t n,
               GcdParams<W> gp) {
  size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += step) {
    uint32_t x[W], r[W];
    load_limbs<W>(x, a, n, j);
    inv_gcd<W>(r, x, gp);
    store_limbs<W>(out, n, j, r);
  }
}

static GcdParams<kW> make_gcd_params(const uint32_t* p_words, uint32_t inv32,
                                     const uint32_t* r2_words, int batches) {
  GcdParams<kW> gp;
  to_signed30<kW>(gp.p, p_words);
  gp.p_inv30 = (0u - inv32) & (uint32_t)kM30;  // inv32 = -p^-1 mod 2^32
  for (int k = 0; k < kW; ++k) gp.r2[k] = r2_words[k];
  gp.batches = batches;
  return gp;
}

extern "C" {

int inverse_words() { return kW; }

int inv_prefix_launch(const void* a, void* pref, void* tails, size_t n, size_t m,
                      int G, const uint32_t* p_words, uint32_t inv32,
                      const uint32_t* one_words, void* stream) {
  inv_prefix_kernel<kW><<<grid_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (uint32_t*)pref, (uint32_t*)tails, n, m, G,
      make_params(p_words, inv32), make_words(one_words));
  return (int)cudaGetLastError();
}

int inv_backward_launch(const void* a, const void* pref, const void* tinv, void* out,
                        size_t n, size_t m, int G, const uint32_t* p_words,
                        uint32_t inv32, const uint32_t* one_words, void* stream) {
  inv_backward_kernel<kW><<<grid_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)pref, (const uint32_t*)tinv,
      (uint32_t*)out, n, m, G, make_params(p_words, inv32), make_words(one_words));
  return (int)cudaGetLastError();
}

int inv_fermat_launch(const void* a, void* out, size_t n, const uint32_t* e_words,
                      int nbits, const uint32_t* p_words, uint32_t inv32,
                      void* stream) {
  inv_fermat_kernel<kW><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (uint32_t*)out, n, make_words(e_words), nbits,
      make_params(p_words, inv32));
  return (int)cudaGetLastError();
}

int inv_gcd_launch(const void* a, void* out, size_t n, const uint32_t* p_words,
                   uint32_t inv32, const uint32_t* r2_words, int batches, void* stream) {
  inv_gcd_kernel<kW><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (uint32_t*)out, n, make_gcd_params(p_words, inv32, r2_words, batches));
  return (int)cudaGetLastError();
}

}  // extern "C"
