// The MSM's tail in two launches: the weighted bucket reduction's inner scan
// (bucket_reduce_inner_kernel) and its outer scan with the Horner fold
// (reduce_fold_kernel), over the steps of msm_reduce.cuh.  Built and bound
// as launch.cuh says.
//
// They replace, for this use, the general K7 and K6 (jac_add_kernel,
// jac_double_kernel in sw_kernels.cu; the TPU's _add_kernel and
// _double_kernel, algebra_tpu/ops/sw_pallas.py:120, :111), which the
// reduction and the fold launched once a step: ~1,180 launches of a few
// microseconds of device time and ~0.06-0.11 ms of host time each for a
// 2^20 MSM.  Here the accumulators stay in registers for the whole scan.
//
// What bounds them: the chain of dependent additions, not bytes or
// operations.  The inner scan has a lane a (window, block), 2048 lanes at
// 2^20 (2 W B adds in all, ~0.3 ms of the card's multiply-add rate), but
// each lane's G + 1 steps follow one another; the fold is one thread's c W
// doublings.  The design shortens the chains (two or three threads a
// window or lane, one step apart) and keeps every add's operands and order
// the reference's, so the results are the general kernels' words.

#include "launch.cuh"
#include "msm_reduce.cuh"

// Threads a block of the inner scan: 32 lanes, so that the 2048 lanes of a
// 2^20 MSM spread over 64 blocks and no multiprocessor holds more than one
// block's two warps.
constexpr int kInnerThreads = 64;
constexpr int kInnerLanes = kInnerThreads / 2;
constexpr unsigned kFullWarp = 0xffffffffu;

template <int W>
__device__ __forceinline__ void shfl_jac(Jac<W>& r, const Jac<W>& v, int src_lane) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    r.x[k] = __shfl_sync(kFullWarp, v.x[k], src_lane);
    r.y[k] = __shfl_sync(kFullWarp, v.y[k], src_lane);
    r.z[k] = __shfl_sync(kFullWarp, v.z[k], src_lane);
  }
}

// 4-byte asynchronous copies from device memory to shared memory (cp.async):
// the next step's bucket arrives while this step's add runs, in no register.
__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;"); }

// 2W 16-bit limbs in shared memory -> W packed words.
template <int W>
__device__ __forceinline__ void unstage(uint32_t (&r)[W], const uint32_t* limbs) {
#pragma unroll
  for (int k = 0; k < W; ++k) r[k] = limbs[2 * k] | (limbs[2 * k + 1] << 16);
}

// The inner scan.  P: buckets, three coordinates limb-major [2W, m G] (lane
// j's bucket i at column j G + i: lane j = w nb + b is block b of window w,
// and w B + b G + i = j G + i).  T, innerW: [2W, m] each.  Thread 2j + r
// of the grid is role r of lane j; lanes past m run the steps on nothing,
// so that every shuffle has its whole warp.
template <int W>
__global__ void __launch_bounds__(kInnerThreads)
bucket_reduce_inner_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                           const uint32_t* __restrict__ pz, uint32_t* tx, uint32_t* ty,
                           uint32_t* tz, uint32_t* iwx, uint32_t* iwy, uint32_t* iwz,
                           size_t m, int G, FieldParams<W> fp, Words<W> one) {
  __shared__ uint32_t stage[2][kInnerLanes][6 * W];
  const int role = threadIdx.x & 1;
  const int slot = threadIdx.x >> 1;
  const size_t lane = (size_t)blockIdx.x * kInnerLanes + slot;
  const bool live = lane < m;
  const size_t n = m * (size_t)G;
  const bool loads = live && role == kInnerT;

  auto prefetch = [&](int buf, int i) {
    if (loads) {
      uint32_t* dst = stage[buf][slot];
      const size_t col = lane * G + i;
#pragma unroll
      for (int k = 0; k < 2 * W; ++k) {
        cp_async4(dst + k, px + k * n + col);
        cp_async4(dst + 2 * W + k, py + k * n + col);
        cp_async4(dst + 4 * W + k, pz + k * n + col);
      }
    }
    cp_async_commit();
  };

  Jac<W> acc, opnd;
  jac_set_zero<W>(acc, one);
  jac_set_zero<W>(opnd, one);
  prefetch(0, inner_bucket(0, G));
  for (int s = 0; s <= G; ++s) {
    if (role == kInnerT && s < G) {
      cp_async_wait_all();
      const uint32_t* src = stage[s & 1][slot];
      unstage<W>(opnd.x, src);
      unstage<W>(opnd.y, src + 2 * W);
      unstage<W>(opnd.z, src + 4 * W);
      if (s + 1 < G) prefetch((s + 1) & 1, inner_bucket(s + 1, G));
    }
    if (live && inner_adds(role, s, G)) jac_accumulate<W>(acc, opnd, fp);
    Jac<W> got;
    shfl_jac<W>(got, acc, (threadIdx.x & 31) & ~1);  // role 0's accT, to role 1
    if (role == kInnerW) opnd = got;
  }
  if (live) {
    if (role == kInnerT) {
      store_jac<W>(tx, ty, tz, m, lane, acc);
    } else {
      store_jac<W>(iwx, iwy, iwz, m, lane, acc);
    }
  }
}

// The outer scan of every window and the fold, one block.  T, innerW:
// [2W, nw nb] (window w's block b at column w nb + b).  With `direct` the
// reduction is skipped: T holds the window sums [2W, nw] (B = 1), innerW is
// not read.  sums: scratch [3][2W, nw] for the window sums.  out: the
// result, three [2W] coordinates.  Thread 4w + r is role r of window w, in
// rounds of blockDim.x / 4 windows; the rounds and steps are the same for
// every thread, so that every shuffle has its whole warp.
template <int W>
__global__ void __launch_bounds__(256)
reduce_fold_kernel(const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
                   const uint32_t* __restrict__ tz, const uint32_t* __restrict__ iwx,
                   const uint32_t* __restrict__ iwy, const uint32_t* __restrict__ iwz,
                   uint32_t* sums, uint32_t* ox, uint32_t* oy, uint32_t* oz, int nw, int nb,
                   int log2G, int c, int direct, FieldParams<W> fp, Words<W> one) {
  const size_t m = (size_t)nw * nb;
  const int role = threadIdx.x % kOuterRoles;
  const int lane32 = threadIdx.x & 31;
  uint32_t* sx = sums;
  uint32_t* sy = sums + (size_t)2 * W * nw;
  uint32_t* sz = sums + (size_t)4 * W * nw;
  if (!direct) {
    const int per_round = blockDim.x / kOuterRoles;
    for (int w0 = 0; w0 < nw; w0 += per_round) {
      const int w = w0 + threadIdx.x / kOuterRoles;
      const bool live = w < nw && role != kOuterRoles - 1;
      Jac<W> acc, opnd;
      jac_set_zero<W>(acc, one);
      jac_set_zero<W>(opnd, one);
      for (int s = 0; s < nb; ++s) {
        const size_t col = (size_t)w * nb + outer_block(s, nb);
        if (live && role == kOuterT) load_jac<W>(opnd, tx, ty, tz, m, col);
        if (live && role == kOuterI) load_jac<W>(opnd, iwx, iwy, iwz, m, col);
        if (live) jac_accumulate<W>(acc, opnd, fp);
        Jac<W> got;
        shfl_jac<W>(got, acc, lane32 - role + kOuterT);  // role T's accT, to role B
        if (role == kOuterB) opnd = got;
      }
      Jac<W> accI;
      shfl_jac<W>(accI, acc, lane32 - role + kOuterI);
      if (live && role == kOuterB) {
        window_sum<W>(acc, accI, log2G, fp);
        store_jac<W>(sx, sy, sz, nw, w, acc);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    Jac<W> total, sum;
    jac_set_zero<W>(total, one);
    for (int w = nw - 1; w >= 0; --w) {
      if (direct) {
        load_jac<W>(sum, tx, ty, tz, nw, w);
      } else {
        load_jac<W>(sum, sx, sy, sz, nw, w);
      }
      horner_step<W>(total, sum, c, fp);
    }
    store_jac<W>(ox, oy, oz, 1, 0, total);
  }
}

extern "C" {

int msm_words() { return kW; }

int bucket_reduce_inner_launch(const void* px, const void* py, const void* pz, void* tx,
                               void* ty, void* tz, void* iwx, void* iwy, void* iwz, size_t m,
                               int G, const uint32_t* p_words, uint32_t inv32,
                               const uint32_t* one_words, void* stream) {
  unsigned blocks = (unsigned)((m + kInnerLanes - 1) / kInnerLanes);
  bucket_reduce_inner_kernel<kW><<<blocks, kInnerThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (uint32_t*)tx,
      (uint32_t*)ty, (uint32_t*)tz, (uint32_t*)iwx, (uint32_t*)iwy, (uint32_t*)iwz, m, G,
      make_params(p_words, inv32), make_words(one_words));
  return (int)cudaGetLastError();
}

int reduce_fold_launch(const void* tx, const void* ty, const void* tz, const void* iwx,
                       const void* iwy, const void* iwz, void* sums, void* ox, void* oy,
                       void* oz, int nw, int nb, int log2G, int c, int direct,
                       const uint32_t* p_words, uint32_t inv32, const uint32_t* one_words,
                       void* stream) {
  // four threads a window, whole warps, at most 256 (the rest in rounds)
  int threads = direct ? 32 : ((nw * kOuterRoles + 31) / 32) * 32;
  threads = threads < 32 ? 32 : threads > 256 ? 256 : threads;
  reduce_fold_kernel<kW><<<1, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tx, (const uint32_t*)ty, (const uint32_t*)tz, (const uint32_t*)iwx,
      (const uint32_t*)iwy, (const uint32_t*)iwz, (uint32_t*)sums, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, nw, nb, log2G, c, direct, make_params(p_words, inv32),
      make_words(one_words));
  return (int)cudaGetLastError();
}

}  // extern "C"
