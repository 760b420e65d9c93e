// The packed point row of the MSM's affine halving tree, as the kernels
// see it.  A row holds one affine point of a prime field with W 32-bit
// words an element (L = 2W 16-bit limbs, one limb a word, as in every other
// array of the port):
//   words [0, L)       x, limbs little-endian
//   words [L, 2L)      y
//   word  2L           the infinity flag, 0 or 1
//   words 2L+1 .. RW   zero
// RW = 2L + 4 = 4W + 4, the 2L + 1 words rounded up to a multiple of four,
// so a row and each coordinate in it start on a 16-byte boundary (L is a
// multiple of four) and move as 16-byte loads and stores.  The TPU's rows
// are 128 words wide because its tile is; that width is not the
// mathematics', and here a BLS12-381 Fq row is 52 words (208 B, not 512).

#pragma once

#include "mont.cuh"

template <int W>
struct RowLayout {
  static_assert(W % 2 == 0, "a coordinate must be a whole number of 16-byte pieces");
  static constexpr int L = 2 * W;
  static constexpr int RW = 2 * L + 4;  // words a row
  static constexpr int Q = RW / 4;      // 16-byte pieces a row
};

// One coordinate of a row (W/2 16-byte pieces from p) as W packed words.
template <int W>
__device__ __forceinline__ void load_row_coord(uint32_t (&r)[W], const uint4* p) {
#pragma unroll
  for (int q = 0; q < W / 2; ++q) {
    uint4 v = p[q];
    r[2 * q] = v.x | (v.y << 16);
    r[2 * q + 1] = v.z | (v.w << 16);
  }
}

template <int W>
__device__ __forceinline__ void store_row_coord(uint4* p, const uint32_t (&r)[W]) {
#pragma unroll
  for (int q = 0; q < W / 2; ++q) {
    p[q] = make_uint4(r[2 * q] & 0xFFFFu, r[2 * q] >> 16, r[2 * q + 1] & 0xFFFFu,
                      r[2 * q + 1] >> 16);
  }
}

// Row i of `rows`: (x, y, inf).
template <int W>
__device__ __forceinline__ void load_row(uint32_t (&x)[W], uint32_t (&y)[W], bool& inf,
                                         const uint32_t* rows, size_t i) {
  using RL = RowLayout<W>;
  const uint4* p = reinterpret_cast<const uint4*>(rows + i * RL::RW);
  load_row_coord<W>(x, p);
  load_row_coord<W>(y, p + W / 2);
  inf = p[W].x != 0;
}

// Row i of `rows` := (x, y, inf), padding words zero.
template <int W>
__device__ __forceinline__ void store_row(uint32_t* rows, size_t i, const uint32_t (&x)[W],
                                          const uint32_t (&y)[W], bool inf) {
  using RL = RowLayout<W>;
  uint4* p = reinterpret_cast<uint4*>(rows + i * RL::RW);
  store_row_coord<W>(p, x);
  store_row_coord<W>(p + W / 2, y);
  p[W] = make_uint4(inf ? 1u : 0u, 0u, 0u, 0u);
}
