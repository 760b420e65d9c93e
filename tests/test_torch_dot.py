"""Weighted sums of Montgomery products: the port's ``ops/mont.dot_stacked``
(kernel K17, ``csrc/dot_kernels.cu`` over ``csrc/dot.cuh``; its plain
version ``mont_kernels.dot_plain``), ``sum_of_products``,
``dot_mass_limit`` and ``fields/dot.mul_tensor``, held against the JAX
package and against Python integers.

The CUDA kernel cannot run here, so its per-lane code (``dot_lane`` in
``csrc/dot.cuh``) is compiled with the host's C++ compiler and
``MONT_HOST_EMULATION`` (as ``test_torch_mont_chains.py`` does) and run over
the same limb-major arrays and the same compressed weight table
(``mont_kernels.dot_table``) the kernel reads, at 8, 12 and 24 words.  The
JAX side is the reference's ``dot_stacked`` compiled once at XLA's lowest
optimisation level.  Inputs are seeded; every comparison is exact
(tolerance 0).
"""

import ctypes
import os
import random
import shutil
import subprocess
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algebra_tpu.curves.instances import bls12_381 as ref_bls, mnt4_753 as ref_mnt
from algebra_tpu.fields import dot as ref_dot
from algebra_tpu.ops import mont as ref_mont

from algebra_tpu_torch import convert
from algebra_tpu_torch.bigint import batch_int_to_limbs, batch_limbs_to_int
from algebra_tpu_torch.curves.instances import bls12_381, mnt4_753
from algebra_tpu_torch.fields import dot
from algebra_tpu_torch.ops import mont, mont_kernels as mk

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "algebra_tpu_torch", "csrc")
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
SPECS = {"bls12_381_fr": bls12_381.fr_spec, "bls12_381_fq": bls12_381.fq_spec,
         "mnt4_753_fq": mnt4_753.fq_spec}
REF_SPECS = {"bls12_381_fr": ref_bls.fr_spec, "bls12_381_fq": ref_bls.fq_spec,
             "mnt4_753_fq": ref_mnt.fq_spec}

HARNESS = r"""
#define MONT_HOST_EMULATION
#include "dot.cuh"

template <int W>
static void run(size_t n, int K, int n_out, const uint32_t* A, const uint32_t* B,
                uint32_t* out, const int32_t* row_start, const int32_t* ent,
                const uint32_t* p, uint32_t inv32) {
  FieldParams<W> fp;
  for (int k = 0; k < W; ++k) fp.p[k] = p[k];
  fp.inv32 = inv32;
  for (int o = 0; o < n_out; ++o) {
    for (size_t i = 0; i < n; ++i) {  // what thread (i, o) of mont_dot_kernel does
      uint32_t acc[W];
      dot_lane<W>(acc, A, B, (size_t)K * n, n, i, ent + 2 * row_start[o],
                  row_start[o + 1] - row_start[o], fp);
      store_limbs<W>(out, (size_t)n_out * n, (size_t)o * n + i, acc);
    }
  }
}

extern "C" int dot_host(int W, size_t n, int K, int n_out, const uint32_t* A,
                        const uint32_t* B, uint32_t* out, const int32_t* row_start,
                        const int32_t* ent, const uint32_t* p, uint32_t inv32) {
  switch (W) {
    case 8: run<8>(n, K, n_out, A, B, out, row_start, ent, p, inv32); return 0;
    case 12: run<12>(n, K, n_out, A, B, out, row_start, ent, p, inv32); return 0;
    case 24: run<24>(n, K, n_out, A, B, out, row_start, ent, p, inv32); return 0;
  }
  return 1;
}
"""


@pytest.fixture(scope="module")
def dot_host(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build csrc/dot.cuh for the host")
    d = tmp_path_factory.mktemp("dot_lane")
    src, lib = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", f"-I{CSRC}", "-o",
                    str(lib), str(src)], check=True, capture_output=True, timeout=180)
    fn = ctypes.CDLL(str(lib)).dot_host
    fn.argtypes = [ctypes.c_int, ctypes.c_size_t, ctypes.c_int, ctypes.c_int] \
        + [ctypes.c_void_p] * 6 + [ctypes.c_uint32]
    return fn


def edge_values(spec) -> list:
    p = spec.modulus
    return [0, 1, 2, p - 1, p - 2, spec.R % p]


def operands(spec, K: int, n: int, seed, square_mask=None):
    """Seeded A, B as int32 [L, K, n] tensors, every value below p, the
    first lanes crossing the edge values; B = A on square pairs.  Also the
    values as Python ints [K][n] each."""
    rng = random.Random(seed)
    p, L = spec.modulus, spec.n_limbs
    edge = edge_values(spec)
    a = [[edge[(i + k) % len(edge)] if i < len(edge) else rng.randrange(p) for i in range(n)]
         for k in range(K)]
    b = [[edge[(i * 5 + k) % len(edge)] if i < len(edge) else rng.randrange(p)
          for i in range(n)] for k in range(K)]
    if square_mask is not None:
        b = [a[k] if square_mask[k] else b[k] for k in range(K)]

    def tensor(vals):
        flat = batch_int_to_limbs([v for row in vals for v in row], L)
        return convert.from_reference(flat.reshape(L, K, n), "cpu")

    return tensor(a), tensor(b), a, b


def host_dot(spec, W, a, b) -> list:
    """Python ints [n_out][n] of sum_k W[o, k] a_k b_k R^-1 mod p."""
    p = spec.modulus
    r_inv = pow(spec.R, -1, p)
    n = len(a[0])
    return [[sum(int(W[o, k]) * a[k][i] * b[k][i] for k in range(W.shape[1])) * r_inv % p
             for i in range(n)] for o in range(W.shape[0])]


def weights(spec, K: int, n_out: int, seed):
    """Signed weights, some zero; the last row at the mass limit."""
    rng = np.random.default_rng(zlib.crc32(seed.encode()))
    W = rng.integers(-9, 10, size=(n_out, K))
    W[0, : K // 2] = 0
    limit = mont.dot_mass_limit(spec)
    last = np.zeros(K, np.int64)
    last[0] = -(limit - (K - 1) * 1)
    last[1:] = rng.choice([-1, 1], size=K - 1)
    W[-1] = last
    assert np.abs(W[-1]).sum() == limit
    return W


def run_host(dot_host, spec, A, B, W, square_mask):
    table = mk.dot_table(W, square_mask, A.shape[1])
    L, K, n = A.shape
    n_out = W.shape[0]
    a = np.ascontiguousarray(convert.to_reference(A))
    b = np.ascontiguousarray(convert.to_reference(B))
    out = np.zeros((L, n_out, n), np.uint32)
    pw = np.array(spec.p_words, np.uint32)
    rs, ent = table["row_start"], table["entries"]
    assert dot_host(spec.n_words, n, K, n_out, a.ctypes.data, b.ctypes.data,
                    out.ctypes.data, rs.ctypes.data, ent.ctypes.data, pw.ctypes.data,
                    spec.inv32) == 0
    return out


@pytest.mark.parametrize("field", SPECS)
def test_dot_lane_host_build_vs_plain_and_integers(dot_host, field):
    """The kernel's per-lane code (host build) and ``dot_plain`` against
    Python integers: signed weights, a zero row part, a row at the mass
    limit, square pairs, edge operands."""
    spec = SPECS[field]
    K, n, n_out = 7, 11, 4
    sq = [k % 3 == 1 for k in range(K)]
    A, B, a, b = operands(spec, K, n, f"lane-{field}", sq)
    W = weights(spec, K, n_out, field)
    want = host_dot(spec, W, a, b)
    got_host = run_host(dot_host, spec, A, B, W, sq)
    got_plain = convert.to_reference(mk.dot_plain(spec, A, B, W, sq))
    assert np.array_equal(got_host, got_plain)
    assert batch_limbs_to_int(got_plain) == want


def test_dot_table_format():
    """Rows in order, zero weights dropped, bit 30 on square pairs."""
    W = np.array([[0, 3, -2], [1, 0, 0], [0, 0, 0]])
    t = mk.dot_table(W, [False, True, False], 3)
    assert t["row_start"].tolist() == [0, 2, 3, 3]
    assert t["entries"].tolist() == [[1 | (1 << 30), 3], [2, -2], [0, 1]]
    assert t["max_row"] == 2
    assert mk.dot_table(W, [False, True, False], 3) is t  # cached by value


def test_dot_mass_limit_and_mul_tensor_match_reference():
    """Host-only: the same mass limit for every field, and the same integer
    multiplication tensors for the BLS12-381 tower."""
    for field, spec in SPECS.items():
        assert mont.dot_mass_limit(spec) == ref_mont.dot_mass_limit(REF_SPECS[field])
    assert mont.dot_mass_limit(bls12_381.fq_spec) == 681
    ref_kinds = (ref_bls.fq2(), ref_bls.fq6(), ref_bls.fq12(), ref_bls.Fq)
    kinds = (bls12_381.fq2("cpu"), bls12_381.fq6("cpu"), bls12_381.fq12("cpu"),
             bls12_381.Fq.to("cpu"))
    for ref_kind, kind in zip(ref_kinds, kinds):
        assert dot.mul_tensor(kind) == ref_dot.mul_tensor(ref_kind)


@pytest.fixture(scope="module")
def reference_dots():
    """The reference's dot_stacked on three seeded cases, compiled once:
    Fq with negative weights and square pairs, Fq with a row at the mass
    limit, Fr with an Fp12-product-sized K."""
    cases = []
    for name, field, K, n, n_out in (("fq_signed", "bls12_381_fq", 9, 5, 5),
                                     ("fq_limit", "bls12_381_fq", 6, 3, 2),
                                     ("fr_wide", "bls12_381_fr", 40, 3, 12)):
        spec = SPECS[field]
        sq = [k % 4 == 0 for k in range(K)]
        A, B, _, _ = operands(spec, K, n, name, sq)
        cases.append((name, field, A, B, weights(spec, K, n_out, name), sq))

    def ref(*arrays):
        return tuple(ref_mont.dot_stacked(REF_SPECS[field], arrays[2 * i], arrays[2 * i + 1],
                                          W, square_mask=sq)
                     for i, (_, field, _, _, W, sq) in enumerate(cases))

    args = [jnp.asarray(convert.to_reference(t)) for c in cases for t in (c[2], c[3])]
    outs = jax.jit(ref).lower(*args).compile(FAST_COMPILE)(*args)
    return cases, [np.asarray(o) for o in outs]


def test_dot_stacked_vs_reference(reference_dots):
    cases, want = reference_dots
    for (name, field, A, B, W, sq), w in zip(cases, want):
        got = mont.dot_stacked(SPECS[field], A, B, W, square_mask=sq)
        assert got.dtype == torch.int32 and tuple(got.shape) == w.shape, name
        assert np.array_equal(convert.to_reference(got), w), name


def test_dot_stacked_rejects_mass_over_limit():
    spec = bls12_381.fq_spec
    A, B, _, _ = operands(spec, 2, 1, "over")
    with pytest.raises(ValueError, match="mass"):
        mont.dot_stacked(spec, A, B, np.array([[mont.dot_mass_limit(spec), 1]]))


def test_sum_of_products_vs_integers():
    """One dot_stacked call (the same object twice is a square pair),
    broadcast operands, against Python integers."""
    spec = bls12_381.fq_spec
    F = bls12_381.Fq.to("cpu")
    rng = random.Random(7)
    p = spec.modulus
    xs = [[rng.randrange(p) for _ in range(4)] for _ in range(3)]
    a = [F.from_int(x) for x in xs]
    c = F.from_int(rng.randrange(p))  # [L]: broadcast over the batch
    got = mont.sum_of_products(spec, [a[0], a[1], a[2]], [a[0], c, a[1]])
    cv = F.to_int(c)
    want = [(xs[0][i] ** 2 + xs[1][i] * cv + xs[2][i] * xs[1][i]) % p for i in range(4)]
    assert F.to_int(got) == want


@pytest.mark.cuda
def test_dot_kernel_vs_plain_on_card():
    """K17 against dot_plain on the card at 8, 12 and 24 words (runs where
    there is a CUDA device and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for field, spec in SPECS.items():
        K, n, n_out = 7, 4097, 4
        sq = [k % 3 == 1 for k in range(K)]
        A, B, _, _ = operands(spec, K, n, f"card-{field}", sq)
        W = weights(spec, K, n_out, field)
        A, B = A.cuda(), B.cuda()
        got = mk.dot(spec, A, B, W, sq)
        assert torch.equal(got, mk.dot_plain(spec, A, B, W, sq)), field
