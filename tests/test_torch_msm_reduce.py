"""The MSM's tail: the weighted bucket reduction and the Horner fold
(``csrc/msm_reduce.cuh``, run by ``csrc/msm_reduce_kernels.cu``'s
``bucket_reduce_inner`` and ``reduce_fold`` kernels), built for the host
and checked without a GPU.

There is no CUDA compiler here, so the header is compiled with the host's
C++ compiler and ``MONT_HOST_EMULATION`` (as ``test_torch_mont_chains.py``
does for the field arithmetic), and a harness runs its step functions in
the kernels' lockstep schedule: the inner scan's pairs of threads (accT,
and accW one step behind it), the outer scan's three threads a window
(accT, accB one step behind it, accI), the window's doublings and final
add, and the fold; where a kernel passes a value by a warp shuffle, the
harness copies it at the same step.  The results are held bit-exact
(tolerance 0) in Jacobian coordinates against the plain versions
(``sw_kernels.bucket_reduce_plain``, ``reduce_fold_plain``: the loops the
CPU MSM runs, which ``test_torch_msm.py`` holds bit-exact against the JAX
``msm``), and in affine against host integers: sum_k (k+1) S_k a window and
sum_w 2^(c w) S_w.  Buckets are curve points made from a seed, in Jacobian
form with random Z; planted among them are buckets at infinity, as (1, 1,
0) and as (X, Y, 0); the same point twice in a row (a doubling in the accT
chain); an infinity right after a nonzero bucket, which makes two equal
suffix sums (a doubling in the accW chain); and a window of infinities.
No JAX function is compiled.
"""

import ctypes
import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from algebra_tpu_torch.bigint import batch_int_to_limbs
from algebra_tpu_torch.curves.instances import bls12_381, secp256k1
from algebra_tpu_torch.curves.sw import SWCurve
from algebra_tpu_torch.ops import msm, sw_kernels

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "algebra_tpu_torch", "csrc")

HARNESS = r"""
#define MONT_HOST_EMULATION
#include "msm_reduce.cuh"
#include <vector>

template <int W>
static FieldParams<W> params(const uint32_t* p, uint32_t inv) {
  FieldParams<W> fp;
  for (int k = 0; k < W; ++k) fp.p[k] = p[k];
  fp.inv32 = inv;
  return fp;
}

template <int W>
static Words<W> words(const uint32_t* v) {
  Words<W> r;
  for (int k = 0; k < W; ++k) r.w[k] = v[k];
  return r;
}

// A point of a [3, 2W, ls] array (x, y, z limb-major), column i.
template <int W>
static void get(Jac<W>& p, const uint32_t* a, size_t ls, size_t i) {
  load_jac<W>(p, a, a + 2 * W * ls, a + 4 * W * ls, ls, i);
}

template <int W>
static void put(uint32_t* a, size_t ls, size_t i, const Jac<W>& p) {
  store_jac<W>(a, a + 2 * W * ls, a + 4 * W * ls, ls, i, p);
}

// bucket_reduce_inner_kernel's schedule: thread 2j + r is role r of lane j.
template <int W>
static void inner(const uint32_t* P, uint32_t* T, uint32_t* IW, size_t m, int G,
                  const FieldParams<W>& fp, const Words<W>& one) {
  const size_t n = m * G;
  std::vector<Jac<W>> acc(2 * m), opnd(2 * m);
  for (size_t t = 0; t < 2 * m; ++t) {
    jac_set_zero<W>(acc[t], one);
    jac_set_zero<W>(opnd[t], one);
  }
  for (int s = 0; s <= G; ++s) {
    for (size_t j = 0; j < m; ++j)
      if (s < G) get<W>(opnd[2 * j + kInnerT], P, n, j * G + inner_bucket(s, G));
    for (size_t t = 0; t < 2 * m; ++t)
      if (inner_adds((int)(t & 1), s, G)) jac_accumulate<W>(acc[t], opnd[t], fp);
    for (size_t j = 0; j < m; ++j) opnd[2 * j + kInnerW] = acc[2 * j + kInnerT];
  }
  for (size_t j = 0; j < m; ++j) {
    put<W>(T, m, j, acc[2 * j + kInnerT]);
    put<W>(IW, m, j, acc[2 * j + kInnerW]);
  }
}

// reduce_fold_kernel's schedule: thread 4w + r is role r of window w.
template <int W>
static void fold(const uint32_t* T, const uint32_t* IW, uint32_t* out, int nw, int nb,
                 int log2G, int c, int direct, const FieldParams<W>& fp,
                 const Words<W>& one) {
  const size_t m = (size_t)nw * nb;
  std::vector<Jac<W>> sums(nw);
  if (direct) {
    for (int w = 0; w < nw; ++w) get<W>(sums[w], T, nw, w);
  } else {
    std::vector<Jac<W>> acc(kOuterRoles * nw), opnd(kOuterRoles * nw);
    for (size_t t = 0; t < acc.size(); ++t) {
      jac_set_zero<W>(acc[t], one);
      jac_set_zero<W>(opnd[t], one);
    }
    for (int s = 0; s < nb; ++s) {
      const int b = outer_block(s, nb);
      for (int w = 0; w < nw; ++w) {
        get<W>(opnd[kOuterRoles * w + kOuterT], T, m, (size_t)w * nb + b);
        get<W>(opnd[kOuterRoles * w + kOuterI], IW, m, (size_t)w * nb + b);
      }
      for (int w = 0; w < nw; ++w)
        for (int r : {kOuterT, kOuterB, kOuterI})
          jac_accumulate<W>(acc[kOuterRoles * w + r], opnd[kOuterRoles * w + r], fp);
      for (int w = 0; w < nw; ++w)
        opnd[kOuterRoles * w + kOuterB] = acc[kOuterRoles * w + kOuterT];
    }
    for (int w = 0; w < nw; ++w) {
      window_sum<W>(acc[kOuterRoles * w + kOuterB], acc[kOuterRoles * w + kOuterI], log2G, fp);
      sums[w] = acc[kOuterRoles * w + kOuterB];
    }
  }
  Jac<W> total;
  jac_set_zero<W>(total, one);
  for (int w = nw - 1; w >= 0; --w) horner_step<W>(total, sums[w], c, fp);
  put<W>(out, 1, 0, total);
}

extern "C" int inner_scan(int W, const uint32_t* P, uint32_t* T, uint32_t* IW, size_t m,
                          int G, const uint32_t* p, uint32_t inv, const uint32_t* one) {
  switch (W) {
    case 8: inner<8>(P, T, IW, m, G, params<8>(p, inv), words<8>(one)); return 0;
    case 12: inner<12>(P, T, IW, m, G, params<12>(p, inv), words<12>(one)); return 0;
  }
  return 1;
}

extern "C" int outer_fold(int W, const uint32_t* T, const uint32_t* IW, uint32_t* out,
                          int nw, int nb, int log2G, int c, int direct, const uint32_t* p,
                          uint32_t inv, const uint32_t* one) {
  switch (W) {
    case 8: fold<8>(T, IW, out, nw, nb, log2G, c, direct, params<8>(p, inv), words<8>(one));
      return 0;
    case 12: fold<12>(T, IW, out, nw, nb, log2G, c, direct, params<12>(p, inv),
                      words<12>(one));
      return 0;
  }
  return 1;
}
"""

CURVES = {"bls12_381_g1": bls12_381.g1, "secp256k1": secp256k1.g1}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build csrc/msm_reduce.cuh for the host")
    d = tmp_path_factory.mktemp("msm_reduce")
    src, so = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", f"-I{CSRC}", "-o",
                    str(so), str(src)], check=True, capture_output=True, timeout=300)
    out = ctypes.CDLL(str(so))
    vp, sz, ci, u32 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_uint32
    out.inner_scan.argtypes = [ci, vp, vp, vp, sz, ci, vp, u32, vp]
    out.outer_fold.argtypes = [ci, vp, vp, vp] + [ci] * 5 + [vp, u32, vp]
    return out


def field_args(spec):
    p = np.array(spec.p_words, dtype=np.uint32)
    one = spec.R % spec.modulus
    one = np.array([(one >> (32 * k)) & 0xFFFFFFFF for k in range(spec.n_words)],
                   dtype=np.uint32)
    return p, one


def jacobian(curve, pts, rng: random.Random):
    """Host affine points (None = infinity) -> three int32 [L, n] Montgomery
    coordinates, each finite point with a random Z; an infinity as (1, 1, 0)
    or, every other one, as (X, Y, 0) with random X, Y."""
    spec = curve.base.spec
    p, L = spec.modulus, spec.n_limbs
    cols = ([], [], [])
    for j, pt in enumerate(pts):
        if pt is None:
            xyz = (1, 1, 0) if j % 2 else (rng.randrange(p), rng.randrange(p), 0)
        else:
            z = rng.randrange(1, p)
            xyz = (pt[0] * z * z % p, pt[1] * z * z * z % p, z)
        for col, v in zip(cols, xyz):
            col.append(spec.to_mont(v))
    return tuple(torch.from_numpy(batch_int_to_limbs(c, L).astype(np.int32)) for c in cols)


def buckets(curve, W: int, B: int, seed: str, zero_window: bool):
    """(host points [W][B], Jacobian [L, W, B]): random subgroup points with
    the planted cases of the module docstring in window 0 (and window 1
    all infinity where ``zero_window``)."""
    rng = random.Random(seed)
    pool = curve.random_host(rng, 8)
    G = sw_kernels.reduce_block(B)
    host = [[rng.choice(pool + [None]) for _ in range(B)] for _ in range(W)]
    w0 = host[0]
    w0[B - 1] = pool[0]  # the top block: accT and accW one nonzero point ...
    w0[B - 2] = None  # ... then an equal suffix sum: accW doubles
    w0[B - G - 1], w0[B - G - 2] = pool[1], pool[1]  # the next block: accT doubles
    w0[B - 2 * G: B - 2 * G + 3] = [None] * 3
    if zero_window:
        host[1] = [None] * B
    flat = [pt for row in host for pt in row]
    coords = jacobian(curve, flat, rng)
    return host, tuple(c.reshape(-1, W, B) for c in coords)


def host_total(curve, host, c: int):
    """sum_w 2^(c w) sum_k (k+1) S_(w,k) on the host."""
    total = None
    for w in range(len(host) - 1, -1, -1):
        total = curve.host_mul_raw(total, 1 << c) if total is not None else None
        s = None
        for k, pt in enumerate(host[w]):
            if pt is not None:
                s = curve.host_add(s, curve.host_mul(pt, k + 1))
        total = curve.host_add(total, s)
    return total


def stack(P) -> np.ndarray:
    return np.ascontiguousarray(torch.stack([a.reshape(a.shape[0], -1) for a in P]).numpy()
                                .view(np.uint32))


def run_host(lib, spec, P, c: int):
    """The harness's inner scan and fold of buckets [L, W, B]: (T, innerW,
    the point), as int32 tensors of the plain versions' shapes."""
    L, W, B = P[0].shape
    G = sw_kernels.reduce_block(B)
    nb = B // G
    p, one = field_args(spec)
    src = stack(P)
    T = np.zeros((3, L, W * nb), dtype=np.uint32)
    IW = np.zeros_like(T)
    assert lib.inner_scan(spec.n_words, src.ctypes.data, T.ctypes.data, IW.ctypes.data,
                          W * nb, G, p.ctypes.data, spec.inv32, one.ctypes.data) == 0
    out = np.zeros((3, L, 1), dtype=np.uint32)
    assert lib.outer_fold(spec.n_words, T.ctypes.data, IW.ctypes.data, out.ctypes.data, W,
                          nb, G.bit_length() - 1, c, 0, p.ctypes.data, spec.inv32,
                          one.ctypes.data) == 0
    as_t = lambda a, shape: tuple(torch.from_numpy(a.view(np.int32)[i].reshape(shape))  # noqa: E731
                                  for i in range(3))
    return as_t(T, (L, W, nb)), as_t(IW, (L, W, nb)), as_t(out, (L,))


def same(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name, W, B, c, zero_window", [
    ("bls12_381_g1", 2, 64, 7, False),
    ("bls12_381_g1", 2, 64, 7, True),
    ("bls12_381_g1", 3, 32, 6, False),
    ("secp256k1", 2, 64, 7, False),
])
def test_reduce_and_fold_vs_plain_and_host(lib, name, W, B, c, zero_window):
    """The kernels' steps in their schedule against the plain versions
    (Jacobian words) and the host (affine)."""
    curve = CURVES[name]("cpu")
    spec = curve.base.spec
    host, P = buckets(curve, W, B, f"{name}-{W}-{B}-{zero_window}", zero_window)
    T, IW, total = run_host(lib, spec, P, c)
    # the MSM's own two steps, which on a CPU tensor run the plain versions
    partial = msm._weighted_reduce(curve, P)
    assert same(T, partial[0]) and same(IW, partial[1])
    assert partial[2] == sw_kernels.reduce_block(B)
    assert same(total, msm._horner_fold(curve, partial, c))
    assert curve.to_host(total) == host_total(curve, host, c)
    if zero_window:
        assert all(((t[:, 1] == 0).all() for t in (T[2], IW[2])))


def test_fold_of_window_sums(lib):
    """One bucket a window (B = 1): the buckets are the window sums, and the
    fold runs alone (``reduce_fold`` with innerW None)."""
    curve = bls12_381.g1("cpu")
    spec = curve.base.spec
    host, P = buckets(curve, 5, 8, "direct", zero_window=True)
    sums = tuple(a[:, :, 0].contiguous() for a in P)
    p, one = field_args(spec)
    src = stack(sums)
    out = np.zeros((3, spec.n_limbs, 1), dtype=np.uint32)
    assert lib.outer_fold(spec.n_words, src.ctypes.data, src.ctypes.data, out.ctypes.data, 5,
                          1, 0, 3, 1, p.ctypes.data, spec.inv32, one.ctypes.data) == 0
    got = tuple(torch.from_numpy(out.view(np.int32)[i, :, 0].copy()) for i in range(3))
    want = sw_kernels.reduce_fold(spec, sums, None, 1, 3)
    assert same(got, want)
    assert same(msm._horner_fold(curve, msm._weighted_reduce(curve, tuple(
        a[:, :, :1] for a in P)), 3), want)
    assert curve.to_host(got) == host_total(curve, [[row[0]] for row in host], 3)


def test_reduce_and_fold_over_a_curve_without_kernels():
    """a != 0 (y^2 = x^3 + 3x + 7 over BLS12-381 Fq) has no group-law
    kernels, so the MSM's two steps run the loops (``inner_scan``,
    ``outer_fold``) over the curve's composed law: held in affine against
    host integers, with planted infinities and repeated buckets."""
    base = bls12_381.g1("cpu").base
    p, a, b = base.spec.modulus, 3, 7
    pool, x = [], 2
    while len(pool) < 4:
        rhs = (x ** 3 + a * x + b) % p
        y = pow(rhs, (p + 1) // 4, p)
        if y * y % p == rhs:
            pool.append((x, y))
        x += 1
    curve = SWCurve(base, a, b, pool[0], cofactor=1, scalar_modulus=bls12_381.R,
                    name="toy")
    assert not curve._kernels
    rng = random.Random("toy")
    host = [[rng.choice(pool + [None]) for _ in range(8)] for _ in range(2)]
    host[0][7], host[0][6] = pool[1], pool[1]
    P = tuple(t.reshape(-1, 2, 8) for t in
              jacobian(curve, [pt for row in host for pt in row], rng))
    total = msm._horner_fold(curve, msm._weighted_reduce(curve, P), 3)
    assert curve.to_host(total) == host_total(curve, host, 3)


def _zeros(spec, *shape):
    return torch.zeros((spec.n_limbs,) + shape, dtype=torch.int32)


@pytest.mark.parametrize("shapes, match", [
    pytest.param([(2, 1)] * 3, "power of two >= 2", id="one bucket a window"),
    pytest.param([(2, 48)] * 3, "power of two >= 2", id="buckets not a power of two"),
    pytest.param([(2, 8)] * 2, "three int32 coordinates", id="two coordinates"),
    pytest.param([(2, 8), (2, 8), (2, 4)], "three int32 coordinates",
                 id="coordinates of two shapes"),
    pytest.param([(16,)] * 3, "three int32 coordinates", id="no window axis"),
])
def test_bucket_reduce_refuses_bad_buckets(shapes, match):
    """The wrapper checks its operands before it picks kernel or plain
    version: a launch on bad shapes would read past the buckets."""
    spec = bls12_381.g1("cpu").base.spec
    with pytest.raises(ValueError, match=match):
        sw_kernels.bucket_reduce(spec, tuple(_zeros(spec, *s) for s in shapes))


@pytest.mark.parametrize("t_shape, iw_shape, G, c, match", [
    pytest.param((2, 4), (2, 4), 3, 5, "power of two", id="block not a power of two"),
    pytest.param((2, 4), (2, 4), 4, -1, "c >= 0", id="negative window size"),
    pytest.param((2, 4), (2, 2), 4, 5, "innerW must match T", id="innerW of another shape"),
    pytest.param((2, 4), None, 1, 5, "three int32 coordinates", id="window sums not [L, W]"),
])
def test_reduce_fold_refuses_bad_arguments(t_shape, iw_shape, G, c, match):
    spec = bls12_381.g1("cpu").base.spec
    T = tuple(_zeros(spec, *t_shape) for _ in range(3))
    IW = None if iw_shape is None else tuple(_zeros(spec, *iw_shape) for _ in range(3))
    with pytest.raises(ValueError, match=match):
        sw_kernels.reduce_fold(spec, T, IW, G, c)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CURVES))
def test_reduce_fold_on_card_vs_cpu(name):
    """On a CUDA device: the two kernels against their plain versions on the
    CPU, on the planted buckets of the tests above (bit-exact)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")
    spec = CURVES[name]("cpu").base.spec
    _, P = buckets(CURVES[name]("cpu"), 3, 64, f"card-{name}", zero_window=True)
    want_T, want_IW = sw_kernels.bucket_reduce_plain(spec, P)
    T, IW = sw_kernels.bucket_reduce(spec, tuple(a.cuda() for a in P))
    assert same((t.cpu() for t in T), want_T) and same((t.cpu() for t in IW), want_IW)
    want = sw_kernels.reduce_fold_plain(spec, want_T, want_IW, 8, 7)
    got = sw_kernels.reduce_fold(spec, T, IW, 8, 7)
    assert same((g.cpu() for g in got), want)
