"""The safegcd inversion of ``algebra_tpu_torch/csrc/inverse.cuh`` (the
bottom of the blocked batched inversion, kernel ``inv_gcd_kernel``), built
for the host and checked against Python integers.

There is no CUDA compiler here, so the header is compiled with the host's
C++ compiler and ``MONT_HOST_EMULATION`` (as ``test_torch_mont_chains.py``
does for the field arithmetic); the inversion is plain C++ integer code, so
the host runs the code the kernel runs, with the same fixed count of
divsteps (``mont_kernels.gcd_batches``).  The fields are the port's
(BLS12-381 Fr and Fq, MNT4-753 Fq, secp256k1 Fq) and a synthetic
2^256 - 189, whose modulus, like secp256k1's, has no spare top bit.  Inputs
are Montgomery-form values: 0, 1, 2, p - 1, p - 2, (p - 1) / 2, R mod p,
R^2 mod p, values just below p, and a few hundred seeded random ones.  Each
output must equal pow(x R^-1, -1, p) R mod p exactly (tolerance 0), zero
for zero, and the harness reports for every input how many batches left
g nonzero: fewer than the fixed count, so the count sufficed.  No JAX.
"""

import ctypes
import os
import random
import shutil
import subprocess

import numpy as np
import pytest

from algebra_tpu_torch.curves.instances import bls12_381, mnt4_753, secp256k1
from algebra_tpu_torch.fields.spec import field_spec
from algebra_tpu_torch.ops import mont_kernels as mk

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "algebra_tpu_torch", "csrc")

HARNESS = r"""
#define MONT_HOST_EMULATION
#include "inverse.cuh"

template <int W>
static void run(size_t n, const uint32_t* x, uint32_t* r, int* live, const uint32_t* p,
                uint32_t inv32, const uint32_t* r2, int batches) {
  GcdParams<W> gp;  // as inverse_kernels.cu's make_gcd_params builds it
  to_signed30<W>(gp.p, p);
  gp.p_inv30 = (0u - inv32) & (uint32_t)kM30;
  for (int k = 0; k < W; ++k) gp.r2[k] = r2[k];
  gp.batches = batches;
  for (size_t i = 0; i < n; ++i) {
    uint32_t a[W], z[W];
    for (int k = 0; k < W; ++k) a[k] = x[i * W + k];
    live[i] = inv_gcd<W>(z, a, gp);
    for (int k = 0; k < W; ++k) r[i * W + k] = z[k];
  }
}

extern "C" int field_inv(int W, size_t n, const uint32_t* x, uint32_t* r, int* live,
                         const uint32_t* p, uint32_t inv32, const uint32_t* r2,
                         int batches) {
  switch (W) {
    case 8: run<8>(n, x, r, live, p, inv32, r2, batches); return 0;
    case 12: run<12>(n, x, r, live, p, inv32, r2, batches); return 0;
    case 24: run<24>(n, x, r, live, p, inv32, r2, batches); return 0;
  }
  return 1;
}
"""

SPECS = {
    "bls12_381_fr": bls12_381.fr_spec,
    "bls12_381_fq": bls12_381.fq_spec,
    "mnt4_753_fq": mnt4_753.fq_spec,
    "secp256k1_fq": secp256k1.fq_spec,
    "full_width_256": field_spec(2**256 - 189, name="full_width_256"),
}
BATCHES = {"bls12_381_fr": 25, "bls12_381_fq": 37, "mnt4_753_fq": 73,
           "secp256k1_fq": 25, "full_width_256": 25}


@pytest.fixture(scope="module")
def field_inv(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build csrc/inverse.cuh for the host")
    d = tmp_path_factory.mktemp("inverse_gcd")
    src, lib = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", f"-I{CSRC}", "-o",
                    str(lib), str(src)], check=True, capture_output=True, timeout=120)
    fn = ctypes.CDLL(str(lib)).field_inv
    fn.argtypes = [ctypes.c_int, ctypes.c_size_t] + [ctypes.c_void_p] * 4 \
        + [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int]
    return fn


def words(vals, W: int) -> np.ndarray:
    return np.array([(v >> (32 * k)) & 0xFFFFFFFF for v in vals for k in range(W)],
                    dtype=np.uint32)


def run_inverse(field_inv, spec, xs, batches):
    """(outputs as ints, batches each input left g nonzero)."""
    W, p = spec.n_words, spec.modulus
    a, out = words(xs, W), np.zeros(len(xs) * W, dtype=np.uint32)
    live = np.zeros(len(xs), dtype=np.int32)
    r2 = words([spec.R * spec.R % p], W)
    assert field_inv(W, len(xs), a.ctypes.data, out.ctypes.data, live.ctypes.data,
                     words([p], W).ctypes.data, spec.inv32, r2.ctypes.data, batches) == 0
    got = [sum(int(v) << (32 * k) for k, v in enumerate(row))
           for row in out.reshape(-1, W)]
    return got, live


@pytest.mark.parametrize("name", list(SPECS))
def test_inverse_vs_integers(field_inv, name):
    spec = SPECS[name]
    p, R = spec.modulus, spec.R
    batches = mk.gcd_batches(spec)
    assert batches == BATCHES[name]
    rng = random.Random(f"gcd-{name}")
    xs = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, R % p, R * R % p]
    xs += [p - 1 - rng.randrange(1 << 40) for _ in range(50)]
    xs += [rng.randrange(p) for _ in range(300)]
    got, live = run_inverse(field_inv, spec, xs, batches)
    r_inv = pow(R, -1, p)
    want = [pow(x * r_inv % p, -1, p) * R % p if x else 0 for x in xs]
    bad = [x for g, w, x in zip(got, want, xs) if g != w]
    assert not bad, f"{name}: {len(bad)} wrong inverses, first input {bad[0]}"
    assert got[0] == 0 and live[0] == 0  # zero: g = 0 from the start
    # g reached zero within the fixed count, for every input
    assert int(live.max()) < batches, f"{name}: g nonzero after {live.max()} batches"
    # and the report sees a count that is too short: one batch leaves g nonzero
    _, short = run_inverse(field_inv, spec, xs[1:8], 1)
    assert short.tolist() == [1] * 7
