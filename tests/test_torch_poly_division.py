"""The division path of the port as a whole (``Evaluations.div``,
``Radix2EvaluationDomain.evaluate_all_lagrange_coefficients``,
``DensePolynomial.divide_with_q_and_r`` and ``entry.poly_quotient``) held
bit-exact against the same compositions on the JAX package's classes, over
BLS12-381 Fr, on the same seeded inputs.

The port runs on the CPU, so its batched inversion takes the kernels' plain
versions.  Every comparison is exact (tolerance 0).  The JAX side is
compiled at one size (2^6 points); larger sizes are held against host
integers and against the product they were made from.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algebra_tpu.curves.instances import bls12_381 as ref_bls
from algebra_tpu.poly.domain import Radix2EvaluationDomain as RefDomain
from algebra_tpu.poly.evaluations import Evaluations as RefEvaluations

from algebra_tpu_torch import convert, entry
from algebra_tpu_torch.bigint import batch_int_to_limbs
from algebra_tpu_torch.curves.instances import bls12_381
from algebra_tpu_torch.poly.dense import DensePolynomial
from algebra_tpu_torch.poly.domain import Radix2EvaluationDomain
from algebra_tpu_torch.poly.evaluations import Evaluations

SPEC = bls12_381.fr_spec
Fr = bls12_381.Fr.to("cpu")
P = SPEC.modulus
N = 64


def rand_ints(seed, n):
    rng = random.Random(f"division-{seed}")
    return [rng.randrange(P) for _ in range(n)]


def mont_limbs(ints):
    """Host ints -> uint32 [L, n] Montgomery limbs (reference format)."""
    return batch_int_to_limbs([SPEC.to_mont(v) for v in ints], SPEC.n_limbs)


def same(port_tensor, ref_array):
    return np.array_equal(convert.to_reference(port_tensor), np.asarray(ref_array))


def host_mul(a, b):
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + x * y) % P
    return out


def host_eval(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def test_evaluations_div():
    """Pointwise quotient with a zero divisor lane, against host integers."""
    coset = Radix2EvaluationDomain(Fr, N).get_coset(SPEC.generator)
    u_int, v_int = rand_ints("u", N), rand_ints("v", N)
    v_int[11] = 0
    u = Evaluations.from_ints(Fr, coset, u_int)
    v = Evaluations.from_ints(Fr, coset, v_int)
    got = u.div(v)
    want = [x * pow(y, -1, P) % P if y else 0 for x, y in zip(u_int, v_int)]
    assert got.to_ints() == want and want[11] == 0
    assert torch.equal(got.mul(v).evals[:, :11], u.evals[:, :11])


@pytest.mark.parametrize("log_n", [6, 7, 8])
def test_quotient_of_product_gives_back_the_factor(log_n):
    n = 1 << log_n
    q = convert.from_reference(mont_limbs(rand_ints(f"q{log_n}", n // 2)), "cpu")
    d = convert.from_reference(mont_limbs(rand_ints(f"d{log_n}", n // 2)), "cpu")
    num = entry.poly_product(q, d, device="cpu")
    quo = entry.poly_quotient(num, d, device="cpu")
    assert tuple(quo.shape) == (16, n)
    assert torch.equal(quo[:, : n // 2], q) and not quo[:, n // 2 :].any()


def test_quotient_by_a_divisor_that_vanishes_on_the_subgroup():
    """d = x^16 - 1 is zero on every point of the size-16 subgroup, and on
    16 points of the size-64 one; the coset keeps the division exact."""
    q_int = rand_ints("qv", 40)
    d_int = [P - 1] + [0] * 15 + [1]
    num = mont_limbs(host_mul(q_int, d_int))  # 56 coefficients -> 64 points
    quo = entry.poly_quotient(num, mont_limbs(d_int), device="cpu")
    assert Fr.to_int(quo)[:40] == q_int and not quo[:, 40:].any()


def test_poly_quotient_refuses_bad_input():
    x = np.zeros((16, 4), np.uint32)
    with pytest.raises(ValueError):
        entry.poly_quotient(x, np.zeros((16, 5), np.uint32), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            entry.poly_quotient(x, x)  # default device is "cuda": no fallback


@pytest.mark.parametrize("offset", [1, 5])
def test_lagrange_coefficients_inside_the_domain(offset):
    """tau on a domain point: the exact one-hot row, no inversion of zero."""
    domain = Radix2EvaluationDomain(Fr, 8, offset)
    li = domain.evaluate_all_lagrange_coefficients(Fr.from_int(domain.element(3)))
    assert Fr.to_int(li) == [0, 0, 0, 1, 0, 0, 0, 0]


@pytest.mark.parametrize("n_q,n_d,with_remainder", [(9, 5, True), (9, 5, False),
                                                    (1, 7, True), (6, 1, False)])
def test_divide_with_q_and_r(n_q, n_d, with_remainder):
    q_int, d_int = rand_ints(f"lq{n_q}", n_q), rand_ints(f"ld{n_d}", n_d)
    r_int = rand_ints(f"lr{n_d}", n_d - 1) if with_remainder else []
    num_int = host_mul(q_int, d_int)
    for i, r in enumerate(r_int):
        num_int[i] = (num_int[i] + r) % P
    num = DensePolynomial.from_ints(Fr, num_int)
    quo, rem = num.divide_with_q_and_r(DensePolynomial.from_ints(Fr, d_int))
    assert quo.to_ints() == q_int
    assert rem.truncated() == (r_int or [0])
    assert rem.num_coeffs == max(n_d - 1, 1)


def test_divide_with_q_and_r_short_dividend():
    low = DensePolynomial.from_ints(Fr, rand_ints("short", 3))
    quo, rem = low.divide_with_q_and_r(DensePolynomial.from_ints(Fr, rand_ints("long", 5)))
    assert quo.truncated() == [0] and rem is low


@pytest.mark.parametrize("offset", [1, 3])
def test_lagrange_coefficients_outside_the_domain(offset):
    """tau outside the domain (cf. the reference's own test at n = 16):
    sum_i L_i(tau) p(x_i) == p(tau) on the host; and, on the coset, the
    JAX domain's coefficients bit for bit."""
    n = 16
    tau_int = rand_ints(f"tau{offset}", 1)[0]
    domain = Radix2EvaluationDomain(Fr, n, offset)
    got = domain.evaluate_all_lagrange_coefficients(Fr.from_int(tau_int))
    assert tuple(got.shape) == (16, n)
    if offset != 1:
        ref_domain = RefDomain(ref_bls.Fr, n, offset)
        assert same(got, ref_domain.evaluate_all_lagrange_coefficients(
            ref_bls.Fr.from_int(tau_int)))
    coeffs = rand_ints(f"lag{offset}", n)
    li = Fr.to_int(got)
    evals = [host_eval(coeffs, domain.element(i)) for i in range(n)]
    assert sum(l * e for l, e in zip(li, evals)) % P == host_eval(coeffs, tau_int)
    assert sum(li) % P == 1


def test_poly_quotient_vs_reference_composition():
    """The slice as a whole at 2^6 points: the quotient of a product by one
    of its factors, against the same composition on the JAX classes
    (``get_coset`` of the field's generator, ``fft``, ``Evaluations.div``,
    ``interpolate``).  Both inputs are longer than a quarter of the domain,
    so the JAX side compiles one transform."""
    q_int, d_int = rand_ints("q", 24), rand_ints("d", 26)
    num, den = mont_limbs(host_mul(q_int, d_int)), mont_limbs(d_int)  # 49 coefficients
    F = ref_bls.Fr
    ref_coset = RefDomain(F, N).get_coset(SPEC.generator)
    num_e = RefEvaluations(F, ref_coset, ref_coset.fft(jnp.asarray(num)))
    den_e = RefEvaluations(F, ref_coset, ref_coset.fft(jnp.asarray(den)))
    ref_div = num_e.div(den_e)
    ref_quo = np.asarray(ref_div.interpolate().coeffs)

    got = entry.poly_quotient(num, den, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (16, N)
    assert same(got, ref_quo)
    assert Fr.to_int(got)[:24] == q_int and not got[:, 24:].any()
    # tensors in, same answer; and the steps agree one by one
    num_t, den_t = convert.from_reference(num, "cpu"), convert.from_reference(den, "cpu")
    assert torch.equal(got, entry.poly_quotient(num_t, den_t, device="cpu"))
    coset = Radix2EvaluationDomain(Fr, N).get_coset(SPEC.generator)
    port_num_e = Evaluations(Fr, coset, coset.fft(num_t))
    assert same(port_num_e.evals, num_e.evals)
    port_div = port_num_e.div(Evaluations(Fr, coset, coset.fft(den_t)))
    assert same(port_div.evals, ref_div.evals)
