// Host-side helpers shared by the kernel sources.  Each source is compiled
// once per word count:
//   nvcc -DMONT_W=8|12|24 -gencode arch=compute_90a,code=sm_90a -shared ...
// and gives a plain C interface (loaded with ctypes): every launcher takes
// raw device pointers and a stream, launches, and returns
// cudaGetLastError().  No allocation and no synchronisation happen there.

#pragma once

#include <cuda_runtime.h>

#include "mont.cuh"

#ifndef MONT_W
#error "compile with -DMONT_W=<number of 32-bit words per field element>"
#endif

constexpr int kW = MONT_W;
constexpr int kThreads = 128;

static inline FieldParams<kW> make_params(const uint32_t* p_words, uint32_t inv32) {
  FieldParams<kW> fp;
  for (int k = 0; k < kW; ++k) fp.p[k] = p_words[k];
  fp.inv32 = inv32;
  return fp;
}

static inline Words<kW> make_words(const uint32_t* words) {
  Words<kW> v;
  for (int k = 0; k < kW; ++k) v.w[k] = words[k];
  return v;
}

static inline unsigned grid_for(size_t n) {
  // enough blocks to fill the card several times over; the kernels stride
  size_t blocks = (n + kThreads - 1) / kThreads;
  size_t cap = 132 * 64;
  return (unsigned)(blocks < cap ? (blocks ? blocks : 1) : cap);
}
