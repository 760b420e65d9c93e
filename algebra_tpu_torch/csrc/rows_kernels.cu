// The row kernels of the MSM's affine halving tree: K13 pack, K14 unpack,
// K15 negate_y, K16 expand_units.  Built and bound as launch.cuh says; the
// row layout is rows.cuh's (RW = 4W + 4 words a row).
//
// They replace the TPU kernels _pack_kernel, _unpack_kernel, _neg_kernel
// and _expand_kernel (algebra_tpu/ops/rows_pallas.py:36, :86, :131, :166).
// All four are copies, bound by device memory: they move each byte they
// must once and do no products (K15 one modular subtraction a row).
//   * K13 and K14 are transposes between limb-major [L, n] coordinates and
//     row-major [n, RW] rows.  A block stages 32 points in shared memory as
//     a [2L + 1][33] tile: the limb-major side is read or written 32
//     consecutive points a limb (128 B a warp), the row side as the 32 rows'
//     contiguous words; the odd pitch keeps the tile's columns on distinct
//     banks.
//   * K15 stages 32 rows the same way, negates y of the masked rows in
//     shared memory, and writes the rows back contiguously.
//   * K16 copies units of U consecutive rows, one warp a unit, 16 B a
//     thread.  The TPU ran a ring of 16 DMAs for this; on the card the copy
//     is a plain coalesced one.  Each row index is clipped to [0, S - 1],
//     so no thread reads past src whatever the caller passes, and a unit
//     that starts near the end still reads its own first rows (clipping the
//     unit's start instead, as the reference's caller does, would shift
//     them).

#include "launch.cuh"
#include "rows.cuh"

constexpr int kTilePoints = 32;

static inline unsigned tile_grid(size_t n) {
  size_t tiles = (n + kTilePoints - 1) / kTilePoints;
  size_t cap = 132 * 32;
  return (unsigned)(tiles < cap ? (tiles ? tiles : 1) : cap);
}

// K13: rows[i] = x[:, i] | y[:, i] | inf[i] | 0.  x, y: [L, n]; inf: bool [n].
template <int W>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
            const uint8_t* __restrict__ inf, uint32_t* __restrict__ rows, size_t n) {
  using RL = RowLayout<W>;
  constexpr int L = RL::L, C = 2 * L + 1;
  __shared__ uint32_t tile[C][kTilePoints + 1];
  for (size_t i0 = (size_t)blockIdx.x * kTilePoints; i0 < n;
       i0 += (size_t)gridDim.x * kTilePoints) {
    int here = (int)(n - i0 < (size_t)kTilePoints ? n - i0 : kTilePoints);
    for (int k = threadIdx.x; k < C * kTilePoints; k += blockDim.x) {
      int c = k / kTilePoints, r = k % kTilePoints;
      size_t i = i0 + r;
      uint32_t v = 0;
      if (r < here) {
        v = c < L ? x[(size_t)c * n + i]
                  : (c < 2 * L ? y[(size_t)(c - L) * n + i] : (uint32_t)(inf[i] != 0));
      }
      tile[c][r] = v;
    }
    __syncthreads();
    uint32_t* out = rows + i0 * RL::RW;
    for (int k = threadIdx.x; k < here * RL::RW; k += blockDim.x) {
      int r = k / RL::RW, c = k % RL::RW;
      out[k] = c < C ? tile[c][r] : 0u;
    }
    __syncthreads();
  }
}

// K14: the inverse of K13; inf[i] = (word 2L of row i) != 0.
template <int W>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint32_t* __restrict__ rows, uint32_t* __restrict__ x,
              uint32_t* __restrict__ y, uint8_t* __restrict__ inf, size_t n) {
  using RL = RowLayout<W>;
  constexpr int L = RL::L, C = 2 * L + 1;
  __shared__ uint32_t tile[C][kTilePoints + 1];
  for (size_t i0 = (size_t)blockIdx.x * kTilePoints; i0 < n;
       i0 += (size_t)gridDim.x * kTilePoints) {
    int here = (int)(n - i0 < (size_t)kTilePoints ? n - i0 : kTilePoints);
    const uint32_t* in = rows + i0 * RL::RW;
    for (int k = threadIdx.x; k < here * RL::RW; k += blockDim.x) {
      int r = k / RL::RW, c = k % RL::RW;
      if (c < C) tile[c][r] = in[k];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < C * kTilePoints; k += blockDim.x) {
      int c = k / kTilePoints, r = k % kTilePoints;
      if (r >= here) continue;
      size_t i = i0 + r;
      uint32_t v = tile[c][r];
      if (c < L) {
        x[(size_t)c * n + i] = v;
      } else if (c < 2 * L) {
        y[(size_t)(c - L) * n + i] = v;
      } else {
        inf[i] = v != 0;
      }
    }
    __syncthreads();
  }
}

// K15: out[i] = rows[i] with y := p - y where neg[i] (0 stays 0: mod_sub).
template <int W>
__global__ void __launch_bounds__(kThreads)
negate_y_kernel(const uint32_t* __restrict__ rows, const uint8_t* __restrict__ neg,
                uint32_t* __restrict__ out, size_t n, FieldParams<W> fp) {
  using RL = RowLayout<W>;
  constexpr int L = RL::L;
  __shared__ uint32_t tile[kTilePoints * RL::RW];
  for (size_t i0 = (size_t)blockIdx.x * kTilePoints; i0 < n;
       i0 += (size_t)gridDim.x * kTilePoints) {
    int here = (int)(n - i0 < (size_t)kTilePoints ? n - i0 : kTilePoints);
    const uint32_t* in = rows + i0 * RL::RW;
    for (int k = threadIdx.x; k < here * RL::RW; k += blockDim.x) tile[k] = in[k];
    __syncthreads();
    int r = threadIdx.x;
    if (r < here && neg[i0 + r]) {
      uint32_t* row = tile + r * RL::RW;
      uint32_t yv[W], zero[W], ny[W];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        yv[k] = row[L + 2 * k] | (row[L + 2 * k + 1] << 16);
        zero[k] = 0;
      }
      mod_sub<W>(ny, zero, yv, fp);
#pragma unroll
      for (int k = 0; k < W; ++k) {
        row[L + 2 * k] = ny[k] & 0xFFFFu;
        row[L + 2 * k + 1] = ny[k] >> 16;
      }
    }
    __syncthreads();
    uint32_t* o = out + i0 * RL::RW;
    for (int k = threadIdx.x; k < here * RL::RW; k += blockDim.x) o[k] = tile[k];
    __syncthreads();
  }
}

// K16: out row j U + t = src row us[j] + t, for t < U, the row index
// clipped to [0, S - 1] (S >= 1 rows in src).
template <int W>
__global__ void __launch_bounds__(kThreads)
expand_units_kernel(const uint4* __restrict__ src, const int64_t* __restrict__ us,
                    uint4* __restrict__ out, size_t mu, int U, size_t S) {
  using RL = RowLayout<W>;
  const int lane = threadIdx.x & 31;
  const size_t warps = (size_t)gridDim.x * (blockDim.x / 32);
  const int per_unit = U * RL::Q;
  const long long last = (long long)S - 1;
  for (size_t j = (size_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; j < mu;
       j += warps) {
    const long long s = us[j];
    uint4* to = out + j * (size_t)per_unit;
    for (int q = lane; q < per_unit; q += 32) {
      long long row = s + q / RL::Q;
      row = row < 0 ? 0 : (row > last ? last : row);
      to[q] = src[(size_t)row * RL::Q + q % RL::Q];
    }
  }
}

extern "C" {

int rows_words() { return kW; }

int pack_launch(const void* x, const void* y, const void* inf, void* rows, size_t n,
                void* stream) {
  pack_kernel<kW><<<tile_grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint8_t*)inf, (uint32_t*)rows, n);
  return (int)cudaGetLastError();
}

int unpack_launch(const void* rows, void* x, void* y, void* inf, size_t n, void* stream) {
  unpack_kernel<kW><<<tile_grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (uint32_t*)x, (uint32_t*)y, (uint8_t*)inf, n);
  return (int)cudaGetLastError();
}

int negate_y_launch(const void* rows, const void* neg, void* out, size_t n,
                    const uint32_t* p_words, uint32_t inv32, void* stream) {
  negate_y_kernel<kW><<<tile_grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (const uint8_t*)neg, (uint32_t*)out, n,
      make_params(p_words, inv32));
  return (int)cudaGetLastError();
}

int expand_units_launch(const void* src, const void* us, void* out, size_t mu, int U,
                        size_t S, void* stream) {
  size_t blocks = (mu + kThreads / 32 - 1) / (kThreads / 32);
  size_t cap = 132 * 64;
  unsigned grid = (unsigned)(blocks < cap ? (blocks ? blocks : 1) : cap);
  expand_units_kernel<kW><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, (const int64_t*)us, (uint4*)out, mu, U, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
