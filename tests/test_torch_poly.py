"""The ported path as a whole: evaluation domains, dense polynomials and the
flagship polynomial product of the port (algebra_tpu_torch.poly, .entry)
held bit-exact against the JAX package over BLS12-381 Fr.

Both sides compute from the same state: the JAX domain's twiddle tables are
loaded into the port's domain through ``convert.domain_from_reference``, and
the inputs are the same seeded limb arrays.  The port runs on the CPU.
Every comparison is exact (tolerance 0).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algebra_tpu.curves.instances import bls12_381 as ref_bls
from algebra_tpu.ops import mont as ref_mont
from algebra_tpu.poly.dense import DensePolynomial as RefPoly
from algebra_tpu.poly.domain import Radix2EvaluationDomain as RefDomain

from algebra_tpu_torch import convert, entry
from algebra_tpu_torch.bigint import batch_int_to_limbs
from algebra_tpu_torch.curves.instances import bls12_381
from algebra_tpu_torch.poly.dense import DensePolynomial
from algebra_tpu_torch.poly.domain import (
    GeneralEvaluationDomain,
    Radix2EvaluationDomain,
)
from algebra_tpu_torch.poly.evaluations import Evaluations

REF = ref_bls.fr_spec
SPEC = bls12_381.fr_spec
Fr = bls12_381.Fr.to("cpu")
P = SPEC.modulus
N = 256


def rand_ints(seed, n):
    rng = random.Random(seed)
    return [rng.randrange(P) for _ in range(n)]


def mont_limbs(ints):
    """Host ints -> uint32 [L, n] Montgomery limbs (reference format)."""
    return batch_int_to_limbs([SPEC.to_mont(v) for v in ints], SPEC.n_limbs)


def same(port_tensor, ref_array):
    return np.array_equal(convert.to_reference(port_tensor), np.asarray(ref_array))


def host_eval(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


@pytest.fixture(scope="module")
def ref():
    """JAX side, computed once: the size-256 domain and its offset-7 coset,
    transforms of one full-length and one short input, and the flagship step
    (fft, fft, pointwise multiply, ifft, scale) of ``__graft_entry__.entry``
    rebuilt at n = 256 on the same inputs."""
    dom = RefDomain(ref_bls.Fr, N)
    roots, roots_inv = dom._root_tables()
    coset = dom.get_coset(7)
    a_int, b_int, s_int = rand_ints(1, N), rand_ints(2, N), rand_ints(3, 40)
    a, b, s = (mont_limbs(v) for v in (a_int, b_int, s_int))
    fa = dom.fft(jnp.asarray(a))
    out = {
        "roots": np.asarray(roots), "roots_inv": np.asarray(roots_inv),
        "a_int": a_int, "s_int": s_int, "a": a, "b": b, "s": s,
        "fft_a": np.asarray(fa),
        "ifft_fft_a": np.asarray(dom.ifft(fa)),
        "ifft_a": np.asarray(dom.ifft(jnp.asarray(a))),
        "fft_short": np.asarray(dom.fft(jnp.asarray(s))),
        "coset_fft_a": np.asarray(coset.fft(jnp.asarray(a))),
    }

    # the flagship step of __graft_entry__.entry() at n = 256: fft(a), fft(b),
    # pointwise mont.mul, fft over the inverse roots, scale by 1/n — the
    # domain's fft/ifft are those same calls, already compiled above
    half_a = jnp.asarray(a[:, : N // 2])
    half_b = jnp.asarray(b[:, : N // 2])
    prod = jax.jit(lambda x, y: ref_mont.mul(REF, x, y))(dom.fft(half_a), dom.fft(half_b))
    out["step"] = np.asarray(dom.ifft(prod))
    return out


@pytest.fixture(scope="module")
def domain(ref):
    return convert.domain_from_reference(Fr, N, 1, ref["roots"], ref["roots_inv"])


def test_domain_constants(domain):
    rd = RefDomain(ref_bls.Fr, N, 7)
    d = Radix2EvaluationDomain(Fr, N, 7)
    for attr in ("size", "log_size", "group_gen", "group_gen_inv", "size_inv",
                 "offset", "offset_inv", "offset_pow_size"):
        assert getattr(d, attr) == getattr(rd, attr), attr
    assert [d.element(i) for i in (0, 1, 77)] == [rd.element(i) for i in (0, 1, 77)]
    assert d.vanishing_polynomial() == rd.vanishing_polynomial()
    assert [d.reindex_by_subdomain(64, i) for i in (0, 5, 64, 200)] == [
        rd.reindex_by_subdomain(64, i) for i in (0, 5, 64, 200)]
    with pytest.raises(ValueError):
        Radix2EvaluationDomain(Fr, 48)
    with pytest.raises(ValueError):
        domain.fft(Fr.zero((N + 1,)))
    with pytest.raises(ValueError):
        domain.ifft(Fr.zero((N // 2,)))


def test_own_root_tables_match_reference(ref):
    d = Radix2EvaluationDomain(Fr, N)
    roots, roots_inv = d._root_tables()
    assert same(roots, ref["roots"]) and same(roots_inv, ref["roots_inv"])


def test_fft_ifft_vs_reference(ref, domain):
    a = convert.from_reference(ref["a"], "cpu")
    fa = domain.fft(a)
    assert same(fa, ref["fft_a"])
    back = domain.ifft(fa)
    assert same(back, ref["ifft_fft_a"]) and torch.equal(back, a)
    # against the definition, at a few points
    evals = Fr.to_int(fa[:, [0, 1, 200]])
    assert evals == [host_eval(ref["a_int"], domain.element(i)) for i in (0, 1, 200)]


def test_short_input_is_zero_padded(ref, domain):
    """40 coefficients in a 256-point domain: the degree-aware transform."""
    s = convert.from_reference(ref["s"], "cpu")
    fs = domain.fft(s)
    assert same(fs, ref["fft_short"])
    padded = torch.nn.functional.pad(s, (0, N - 40))
    assert torch.equal(domain.ifft(fs), padded)
    assert Fr.to_int(fs[:, 9]) == host_eval(ref["s_int"], domain.element(9))


def test_coset_vs_reference(ref, domain):
    coset = domain.get_coset(7)
    a = convert.from_reference(ref["a"], "cpu")
    b = convert.from_reference(ref["b"], "cpu")
    ca = coset.fft(a)
    assert same(ca, ref["coset_fft_a"])
    assert torch.equal(coset.fft(coset.ifft(b)), b)
    assert torch.equal(coset.ifft(ca), a)
    assert Fr.to_int(ca[:, 3]) == host_eval(ref["a_int"], coset.element(3))
    # a short input on the coset scales only its own coefficients
    s = convert.from_reference(ref["s"], "cpu")
    assert torch.equal(coset.ifft(coset.fft(s))[:, :40], s)


def test_elements_and_vanishing(domain):
    coset = domain.get_coset(7)
    el = Fr.to_int(coset.elements())
    assert el[:3] == [coset.element(i) for i in range(3)] and len(el) == N
    tau_int = [5, coset.element(9), 123456789]
    z = coset.evaluate_vanishing_polynomial(Fr.from_int(tau_int))
    want = [(pow(t, N, P) - coset.offset_pow_size) % P for t in tau_int]
    assert Fr.to_int(z) == want and want[1] == 0
    assert same(domain.mul_polynomials_in_evaluation_domain(el_t := coset.elements(), el_t),
                convert.to_reference(Fr.square(el_t)))


def test_general_domain():
    d = GeneralEvaluationDomain(Fr, 100)
    assert isinstance(d, Radix2EvaluationDomain) and d.size == 128
    from algebra_tpu_torch.curves.instances import mnt4_753
    with pytest.raises(NotImplementedError):
        GeneralEvaluationDomain(mnt4_753.Fq.to("cpu"), 1 << 20)


def test_dense_mul_vs_reference_and_naive():
    a_int, b_int = rand_ints(7, 32), rand_ints(8, 32)
    pa, pb = DensePolynomial.from_ints(Fr, a_int), DensePolynomial.from_ints(Fr, b_int)
    fft_prod = pa.mul(pb)
    ref_prod = RefPoly.from_ints(ref_bls.Fr, a_int).mul(RefPoly.from_ints(ref_bls.Fr, b_int))
    assert same(fft_prod.coeffs, ref_prod.coeffs)
    naive = pa.naive_mul(pb)
    assert fft_prod.num_coeffs == 64 and naive.num_coeffs == 63
    assert torch.equal(fft_prod.coeffs[:, :63], naive.coeffs)
    want = [0] * 63
    for i, x in enumerate(a_int):
        for j, y in enumerate(b_int):
            want[i + j] = (want[i + j] + x * y) % P
    assert naive.to_ints() == want and fft_prod.truncated() == want


def test_dense_arithmetic_and_evaluate():
    a_int, b_int = rand_ints(9, 20), rand_ints(10, 13)
    pa, pb = DensePolynomial.from_ints(Fr, a_int), DensePolynomial.from_ints(Fr, b_int)
    b_pad = b_int + [0] * 7
    assert pa.add(pb).to_ints() == [(x + y) % P for x, y in zip(a_int, b_pad)]
    assert pa.sub(pb).to_ints() == [(x - y) % P for x, y in zip(a_int, b_pad)]
    assert pa.neg().to_ints() == [(-x) % P for x in a_int]
    assert pa.scale(Fr.from_int(5)).to_ints() == [5 * x % P for x in a_int]
    assert pa.degree() == 19
    pts = [0, 1, 987654321]
    assert Fr.to_int(pa.evaluate(Fr.from_int(pts))) == [host_eval(a_int, x) for x in pts]
    assert Fr.to_int(pa.evaluate(Fr.from_int(3))) == host_eval(a_int, 3)
    assert DensePolynomial.from_ints(Fr, [4, 0, 0]).truncated() == [4]


def test_vanishing_poly_round_trip(domain):
    small = Radix2EvaluationDomain(Fr, 8, offset=7)
    q_int = rand_ints(11, 21)
    q = DensePolynomial.from_ints(Fr, q_int)
    prod = q.mul_by_vanishing_poly(small)
    assert prod.num_coeffs == 29
    quo, rem = prod.divide_by_vanishing_poly(small)
    assert quo.to_ints() == q_int and rem.truncated() == [0]
    # a remainder survives: add r of degree < 8
    r_int = rand_ints(12, 8)
    quo2, rem2 = prod.add(DensePolynomial.from_ints(Fr, r_int)).divide_by_vanishing_poly(small)
    assert quo2.to_ints() == q_int and rem2.to_ints() == r_int
    low = DensePolynomial.from_ints(Fr, r_int)
    q0, r0 = low.divide_by_vanishing_poly(small)
    assert q0.truncated() == [0] and r0 is low


def test_evaluations_interpolate(ref, domain):
    a = convert.from_reference(ref["a"], "cpu")
    b = convert.from_reference(ref["b"], "cpu")
    ea, eb = Evaluations(Fr, domain, a), Evaluations(Fr, domain, b)
    assert same(ea.interpolate().coeffs, ref["ifft_a"])
    assert torch.equal(ea.mul(eb).evals, Fr.mul(a, b))
    assert torch.equal(ea.add(eb).sub(eb).evals, a)
    vals = rand_ints(13, N)
    assert Evaluations.from_ints(Fr, domain, vals).to_ints() == vals


def test_field_helpers():
    rng = random.Random(5)
    x = Fr.random(rng, (3, 4))
    assert Fr.batch_shape(x) == (3, 4)
    ints = Fr.to_int(x)
    assert Fr.to_int(Fr.sum(x, axis=0)) == [sum(r[j] for r in ints) % P for j in range(4)]
    assert Fr.to_int(Fr.sum(x, axis=1)) == [sum(r) % P for r in ints]
    assert Fr.to_int(Fr.index(x, (1, slice(1, 3)))) == ints[1][1:3]
    assert Fr.stack([x, x], axis=0).shape == (16, 2, 3, 4)
    assert Fr.concatenate([x, x], axis=1).shape == (16, 3, 8)
    assert Fr.broadcast_to(Fr.one(), (2, 2)).shape == (16, 2, 2)
    assert bool(Fr.is_one(Fr.one((2,))).all()) and bool(Fr.is_zero(Fr.zero((2,))).all())
    assert Fr.to_int(Fr.inverse(Fr.from_int([0, 2]))) == [0, pow(2, -1, P)]
    assert Fr.to_int(Fr.constant(-1)) == P - 1 and Fr.characteristic() == P
    canon = Fr.to_canonical_limbs(x)
    assert torch.equal(Fr.from_canonical_limbs(canon), x)
    # the same seed gives the same values as the reference's sampler
    ref_x = ref_bls.Fr.random(random.Random(5), (3, 4))
    assert same(x, ref_x)
    assert Fr.to(torch.device("cpu")) is Fr and Fr.to("cuda").device.type == "cuda"


def test_poly_product_vs_flagship_step(ref):
    a_half, b_half = ref["a"][:, : N // 2], ref["b"][:, : N // 2]
    got = entry.poly_product(a_half, b_half, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (16, N)
    assert same(got, ref["step"])
    # tensors in, same answer
    got_t = entry.poly_product(
        convert.from_reference(a_half, "cpu"), convert.from_reference(b_half, "cpu"),
        device="cpu")
    assert torch.equal(got, got_t)


def test_poly_product_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = np.zeros((16, 4), np.uint32)
    with pytest.raises(RuntimeError):
        entry.poly_product(x, x)  # default device is "cuda": no fallback
