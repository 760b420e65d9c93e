// The field kernels of the NTT path: the Montgomery product and one
// butterfly stage.  Built and bound as launch.cuh says.

#include "launch.cuh"

// Montgomery product, one thread per element, grid-stride.  Operand x sits
// at word k * x_ls + i * x_bs: x_bs = 1 for a full [L, n] array, x_bs = 0
// (with x_ls = 1) for one element broadcast over the whole batch.
template <int W>
__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const uint32_t* __restrict__ a, size_t a_ls, size_t a_bs,
                const uint32_t* __restrict__ b, size_t b_ls, size_t b_bs,
                uint32_t* __restrict__ out, size_t n, FieldParams<W> fp) {
  size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    uint32_t x[W], y[W], r[W];
    load_limbs<W>(x, a, a_ls, i * a_bs);
    load_limbs<W>(y, b, b_ls, i * b_bs);
    mont_mul<W>(r, x, y, fp);
    store_limbs<W>(out, n, i, r);
  }
}

// One decimation-in-time butterfly stage, one thread per butterfly:
//   t = hi * w;  olo = lo + t;  ohi = lo - t.
// Butterfly number i splits as i = q * span + r with span = 2^span_log2:
// q is the group, r = j * B + b the place inside the group's half
// (B = 2^b_log2 batch columns ride the minor axis; j is the twiddle index).
// Its operands sit at offset q * pitch + r (pitch = 2^pitch_log2) from the
// lo / hi base pointers, at limb stride ls; its twiddle is column j of w,
// at word k * w_ls + j * w_cs.
//   * in-array stage on x[L, n1, B]: lo = x, hi = x + span, pitch = 2 * span
//     (span = half * B); twiddles are a strided view of the root table, so
//     nothing is repeated or concatenated;
//   * flat halves lo, hi [L, n_half] with period-`half` twiddles:
//     B = 1, span = pitch = half, so the offset is i itself.
// The stage may run in place (olo == lo, ohi == hi): a thread reads its pair
// before it writes it, and no other thread touches that pair.
template <int W>
__global__ void __launch_bounds__(kThreads)
butterfly_kernel(const uint32_t* lo, const uint32_t* hi, uint32_t* olo,
                 uint32_t* ohi, size_t ls, size_t n_pairs, int span_log2,
                 int pitch_log2, int b_log2, const uint32_t* __restrict__ w,
                 size_t w_ls, size_t w_cs, FieldParams<W> fp) {
  size_t step = (size_t)gridDim.x * blockDim.x;
  size_t span_mask = ((size_t)1 << span_log2) - 1;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_pairs;
       i += step) {
    size_t q = i >> span_log2;
    size_t r = i & span_mask;
    size_t off = (q << pitch_log2) + r;
    size_t j = r >> b_log2;

    uint32_t x[W], y[W], tw[W], t[W], s[W], d[W];
    load_limbs<W>(y, hi, ls, off);
    load_limbs<W>(tw, w, w_ls, j * w_cs);
    mont_mul<W>(t, y, tw, fp);
    load_limbs<W>(x, lo, ls, off);
    mod_add<W>(s, x, t, fp);
    mod_sub<W>(d, x, t, fp);
    store_limbs<W>(olo, ls, off, s);
    store_limbs<W>(ohi, ls, off, d);
  }
}

extern "C" {

int mont_words() { return kW; }

int mont_mul_launch(const void* a, size_t a_ls, size_t a_bs, const void* b,
                    size_t b_ls, size_t b_bs, void* out, size_t n,
                    const uint32_t* p_words, uint32_t inv32, void* stream) {
  mont_mul_kernel<kW><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, a_ls, a_bs, (const uint32_t*)b, b_ls, b_bs,
      (uint32_t*)out, n, make_params(p_words, inv32));
  return (int)cudaGetLastError();
}

int butterfly_launch(const void* lo, const void* hi, void* olo, void* ohi,
                     size_t ls, size_t n_pairs, int span_log2, int pitch_log2,
                     int b_log2, const void* w, size_t w_ls, size_t w_cs,
                     const uint32_t* p_words, uint32_t inv32, void* stream) {
  butterfly_kernel<kW><<<grid_for(n_pairs), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)lo, (const uint32_t*)hi, (uint32_t*)olo, (uint32_t*)ohi,
      ls, n_pairs, span_log2, pitch_log2, b_log2, (const uint32_t*)w, w_ls, w_cs,
      make_params(p_words, inv32));
  return (int)cudaGetLastError();
}

}  // extern "C"
