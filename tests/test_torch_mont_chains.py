"""The carry-chain field arithmetic of ``algebra_tpu_torch/csrc/mont.cuh``
(the Montgomery product and square, modular sum and difference every
kernel inlines), built for the host and checked against Python integers.

There is no CUDA compiler here, so the header is compiled with the host's
C++ compiler and ``MONT_HOST_EMULATION``, which turns each PTX carry-flag
instruction (add.cc, madc.hi.cc, ...) into C++ over a host carry flag; the
rest of the code is the code the kernels run.  The fields are the port's
(BLS12-381 Fr and Fq, MNT4-753 Fq, secp256k1 Fq) and a synthetic
2^256 - 189, whose modulus, like secp256k1's, has no spare top bit.  The
operands cross 0, 1, 2, p - 1, p - 2, R mod p, R^2 mod p and (R - 1) mod p
with each other, plus random values and values just below p; a product
and a square also run with the output over an operand.  Results compare
exactly (tolerance 0).
"""

import ctypes
import os
import random
import shutil
import subprocess

import numpy as np
import pytest

from algebra_tpu_torch.curves.instances import bls12_381, mnt4_753, secp256k1

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "algebra_tpu_torch", "csrc")

HARNESS = r"""
#define MONT_HOST_EMULATION
#include "mont.cuh"

template <int W>
static void run(int op, size_t n, const uint32_t* a, const uint32_t* b, uint32_t* r,
                const uint32_t* p, uint32_t inv) {
  FieldParams<W> fp;
  for (int k = 0; k < W; ++k) fp.p[k] = p[k];
  fp.inv32 = inv;
  for (size_t i = 0; i < n; ++i) {
    uint32_t x[W], y[W], z[W];
    for (int k = 0; k < W; ++k) {
      x[k] = a[i * W + k];
      y[k] = b[i * W + k];
    }
    switch (op) {
      case 0: mont_mul<W>(z, x, y, fp); break;
      case 1: mont_sq<W>(z, x, fp); break;
      case 2: mod_add<W>(z, x, y, fp); break;
      case 3: mod_sub<W>(z, x, y, fp); break;
      case 4: mont_mul<W>(x, x, y, fp); for (int k = 0; k < W; ++k) z[k] = x[k]; break;
      default: mont_sq<W>(x, x, fp); for (int k = 0; k < W; ++k) z[k] = x[k];
    }
    for (int k = 0; k < W; ++k) r[i * W + k] = z[k];
  }
}

extern "C" int field_op(int W, int op, size_t n, const uint32_t* a, const uint32_t* b,
                        uint32_t* r, const uint32_t* p, uint32_t inv) {
  switch (W) {
    case 8: run<8>(op, n, a, b, r, p, inv); return 0;
    case 12: run<12>(op, n, a, b, r, p, inv); return 0;
    case 24: run<24>(op, n, a, b, r, p, inv); return 0;
  }
  return 1;
}
"""

FIELDS = {
    "bls12_381_fr": bls12_381.fr_spec.modulus,
    "bls12_381_fq": bls12_381.fq_spec.modulus,
    "mnt4_753_fq": mnt4_753.fq_spec.modulus,
    "secp256k1_fq": secp256k1.fq_spec.modulus,
    "full_width_256": 2**256 - 189,
}
OPS = {  # op code -> the integer result, R^-1 applied by the caller
    0: ("mul", lambda x, y, p, r_inv: x * y * r_inv % p),
    1: ("sq", lambda x, y, p, r_inv: x * x * r_inv % p),
    2: ("add", lambda x, y, p, r_inv: (x + y) % p),
    3: ("sub", lambda x, y, p, r_inv: (x - y) % p),
    4: ("mul, output over a", lambda x, y, p, r_inv: x * y * r_inv % p),
    5: ("sq, output over a", lambda x, y, p, r_inv: x * x * r_inv % p),
}


@pytest.fixture(scope="module")
def field_op(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build csrc/mont.cuh for the host")
    d = tmp_path_factory.mktemp("mont_chains")
    src, lib = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", f"-I{CSRC}", "-o",
                    str(lib), str(src)], check=True, capture_output=True, timeout=120)
    fn = ctypes.CDLL(str(lib)).field_op
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_size_t] + [ctypes.c_void_p] * 4 \
        + [ctypes.c_uint32]
    return fn


def words(vals, W: int) -> np.ndarray:
    return np.array([(v >> (32 * k)) & 0xFFFFFFFF for v in vals for k in range(W)],
                    dtype=np.uint32)


@pytest.mark.parametrize("name", list(FIELDS))
def test_field_ops_vs_integers(field_op, name):
    p = FIELDS[name]
    W = -(-p.bit_length() // 64) * 2
    R = 1 << (32 * W)
    rng = random.Random(name)
    edge = [0, 1, 2, p - 1, p - 2, R % p, R * R % p, (R - 1) % p]
    xs = [x for x in edge for _ in edge] + [rng.randrange(p) for _ in range(200)]
    ys = [y for _ in edge for y in edge] + [rng.randrange(p) for _ in range(200)]
    xs += [p - 1 - rng.randrange(1 << 40) for _ in range(50)]
    ys += [p - 1 - rng.randrange(1 << 20) for _ in range(50)]
    a, b = words(xs, W), words(ys, W)
    pw = words([p], W)
    inv = -pow(p, -1, 1 << 32) % (1 << 32)
    r_inv = pow(R, -1, p)
    for op, (what, f) in OPS.items():
        out = np.zeros_like(a)
        assert field_op(W, op, len(xs), a.ctypes.data, b.ctypes.data, out.ctypes.data,
                        pw.ctypes.data, inv) == 0
        got = out.reshape(-1, W).astype(object)
        got = [sum(int(v) << (32 * k) for k, v in enumerate(row)) for row in got]
        bad = [(x, y) for g, x, y in zip(got, xs, ys) if g != f(x, y, p, r_inv)]
        assert not bad, f"{name} {what}: {len(bad)} wrong, first operands {bad[0]}"
