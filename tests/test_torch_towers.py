"""The port's BLS12-381 tower (``fields/quadratic.py``, ``cubic.py``,
``fp12.py``, ``element.py`` over ``fields/dot.py``: every product one
``dot_stacked``, kernel K17's plain version here) held against the JAX
package and against the port's host tower (``fields/host_tower.py``).

The JAX side is one compiled function (XLA's lowest optimisation level)
holding the products, squares, sparse products, Frobenius maps and the
cyclotomic square of Fq2, Fq6 and Fq12 on the same seeded inputs; both
sides start from the same Montgomery limbs.  Inversions, square roots,
Legendre symbols and the cyclotomic exponentiation are held against Python
integers (the host tower, and the JAX package's host square root), which
give the unique canonical answer: compiling the reference's inversion
ladders would cost minutes.  Every comparison is exact (tolerance 0).
"""

import random

import jax
import numpy as np
import pytest

from algebra_tpu.curves.instances import bls12_381 as ref_bls
from algebra_tpu.hostmath import host_sqrt, legendre_prime

from algebra_tpu_torch import convert
from algebra_tpu_torch.curves.instances import bls12_381
from algebra_tpu_torch.fields.element import Felt
from algebra_tpu_torch.fields.host_tower import HostCubicExt, HostQuadExt

P = bls12_381.P
N = 3
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}

H2 = bls12_381.host_fq2
H6 = HostCubicExt(H2, bls12_381.FQ6_NONRESIDUE)
H12 = HostQuadExt(H6, ((0, 0), (1, 0), (0, 0)))


def r2(rng):
    return (rng.randrange(P), rng.randrange(P))


def r6(rng):
    return (r2(rng), r2(rng), r2(rng))


def r12(rng):
    return (r6(rng), r6(rng))


def kinds():
    return bls12_381.fq2("cpu"), bls12_381.fq6("cpu"), bls12_381.fq12("cpu")


def port(kind, host_values):
    return kind.from_int(host_values)


def _ops(F2, F6, F12, a2, b2, a6, b6, a12, b12):
    """The tower operations both sides run, by name."""
    return {
        "fq2_mul": F2.mul(a2, b2),
        "fq2_square": F2.square(a2),
        "fq2_frobenius": F2.frobenius(a2, 1),
        "fq2_mul_by_base": F2.mul_by_base(a2, b2[0]),
        "fq6_mul": F6.mul(a6, b6),
        "fq6_square": F6.square(a6),
        "fq6_frobenius_1": F6.frobenius(a6, 1),
        "fq6_frobenius_2": F6.frobenius(a6, 2),
        "fq6_mul_by_01": F6.mul_by_01(a6, b2, a2),
        "fq6_mul_by_1": F6.mul_by_1(a6, b2),
        "fq6_mul_by_nonresidue": F6.mul_by_nonresidue(a2),
        "fq12_mul": F12.mul(a12, b12),
        "fq12_square": F12.square(a12),
        "fq12_frobenius_1": F12.frobenius(a12, 1),
        "fq12_frobenius_2": F12.frobenius(a12, 2),
        "fq12_frobenius_3": F12.frobenius(a12, 3),
        "fq12_mul_by_014": F12.mul_by_014(a12, a2, b2, a2),
        "fq12_mul_by_034": F12.mul_by_034(a12, b2, a2, b2),
        "fq12_cyclotomic_square": F12.cyclotomic_square(a12),
        "fq12_conjugate": F12.conjugate(a12),
    }


OPS = [
    "fq2_mul", "fq2_square", "fq2_frobenius", "fq2_mul_by_base", "fq6_mul", "fq6_square",
    "fq6_frobenius_1", "fq6_frobenius_2", "fq6_mul_by_01", "fq6_mul_by_1",
    "fq6_mul_by_nonresidue", "fq12_mul", "fq12_square", "fq12_frobenius_1",
    "fq12_frobenius_2", "fq12_frobenius_3", "fq12_mul_by_014", "fq12_mul_by_034",
    "fq12_cyclotomic_square", "fq12_conjugate"]


@pytest.fixture(scope="module")
def both():
    """(port outputs, reference outputs as numpy), by op name."""
    rng = random.Random(11)
    hosts = ([r2(rng) for _ in range(N)], [r2(rng) for _ in range(N)],
             [r6(rng) for _ in range(N)], [r6(rng) for _ in range(N)],
             [r12(rng) for _ in range(N)], [r12(rng) for _ in range(N)])
    ref_kinds = (ref_bls.fq2(), ref_bls.fq2(), ref_bls.fq6(), ref_bls.fq6(), ref_bls.fq12(),
                 ref_bls.fq12())
    ref_in = [k.from_int(h) for k, h in zip(ref_kinds, hosts)]
    fn = jax.jit(lambda *xs: _ops(ref_bls.fq2(), ref_bls.fq6(), ref_bls.fq12(), *xs))
    ref_out = fn.lower(*ref_in).compile(FAST_COMPILE)(*ref_in)
    ref_out = {k: convert.tower_to_reference(convert.tower_from_reference(v, "cpu"))
               for k, v in ref_out.items()}
    port_in = [convert.tower_from_reference(v, "cpu") for v in ref_in]
    port_out = {k: convert.tower_to_reference(v) for k, v in _ops(*kinds(), *port_in).items()}
    return port_out, ref_out


def _same(got, want) -> bool:
    if isinstance(want, tuple):
        return len(got) == len(want) and all(_same(g, w) for g, w in zip(got, want))
    return got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("op", OPS)
def test_tower_op_vs_reference(both, op):
    port_out, ref_out = both
    assert _same(port_out[op], ref_out[op]), op


def test_products_vs_host_tower():
    rng = random.Random(12)
    for kind, host, r in zip(kinds(), (H2, H6, H12), (r2, r6, r12)):
        xs, ys = [r(rng) for _ in range(N)], [r(rng) for _ in range(N)]
        a, b = port(kind, xs), port(kind, ys)
        assert kind.to_int(kind.mul(a, b)) == [host.mul(x, y) for x, y in zip(xs, ys)]
        assert kind.to_int(kind.square(a)) == [host.mul(x, x) for x in xs]


@pytest.mark.parametrize("level", ["fq2", "fq6", "fq12"])
def test_inverse_vs_host_tower(level):
    """Inverses are unique: the host tower's is the reference's.  A zero
    lane goes to zero."""
    rng = random.Random(f"inv-{level}")
    kind = dict(zip(("fq2", "fq6", "fq12"), kinds()))[level]
    host = {"fq2": H2, "fq6": H6, "fq12": H12}[level]
    r = {"fq2": r2, "fq6": r6, "fq12": r12}[level]
    xs = [r(rng) for _ in range(N)] + [host.zero()]
    got = kind.to_int(kind.inverse(port(kind, xs)))
    assert got[:N] == [host.inv(x) for x in xs[:N]]
    assert got[N] == host.zero()


def test_frobenius_vs_host_power():
    """frobenius(x, 1) = x^p on Fq2 and Fq6; Fq12's twelfth power is the
    identity."""
    rng = random.Random(13)
    F2, F6, F12 = kinds()
    x2, x6 = r2(rng), r6(rng)
    assert F2.to_int(F2.frobenius(port(F2, [x2]), 1)) == [H2.pow(x2, P)]
    assert F6.to_int(F6.frobenius(port(F6, [x6]), 1)) == [H6.pow(x6, P)]
    a = port(F12, [r12(rng)])
    f = a
    for _ in range(12):
        f = F12.frobenius(f, 1)
    assert F12.to_int(f) == F12.to_int(a)


def test_host_tower_constants_match_reference():
    """The port derives the same Frobenius and psi coefficients."""
    assert bls12_381.fq2("cpu")._frob_host == ref_bls.fq2()._frob_host
    assert bls12_381.fq6("cpu")._frob_c1_host == ref_bls.fq6()._frob_c1_host
    assert bls12_381.fq6("cpu")._frob_c2_host == ref_bls.fq6()._frob_c2_host
    assert bls12_381.fq12("cpu")._frob_host == ref_bls.fq12()._frob_host
    assert (bls12_381.G2_PSI_X, bls12_381.G2_PSI_Y) == (ref_bls.G2_PSI_X, ref_bls.G2_PSI_Y)


def test_fq2_sqrt_and_legendre_vs_host():
    """Squares (a1 = 0 and a1 != 0), non-squares and zero: ok where a root
    exists, and the root the reference's two-case algorithm picks (the JAX
    package's host square root runs the same algorithm)."""
    rng = random.Random(14)
    F2 = bls12_381.fq2("cpu")
    xs = [H2.mul(v, v) for v in (r2(rng), r2(rng))]
    xs += [(rng.randrange(P), 0) for _ in range(3)] + [r2(rng) for _ in range(3)]
    xs += [(0, 0)]
    ok, root = F2.sqrt(port(F2, xs))
    roots = F2.to_int(root)
    for x, good, got in zip(xs, ok.tolist(), roots):
        want = host_sqrt(ref_bls.host_fq2, x)
        assert good == (want is not None), x
        if want is not None:
            assert got == want, x
    norms = [H2.base.sub(x[0] * x[0], H2.nr * x[1] * x[1]) for x in xs]
    assert F2.legendre(port(F2, xs)).tolist() == [legendre_prime(v, P) for v in norms]


def test_cyclotomic_exp_vs_host_power():
    """On an element of the cyclotomic subgroup (the easy part of a random
    Fq12 value), signed-NAF exponentiation by |X| and by a small exponent
    equals the host power."""
    rng = random.Random(15)
    F12 = bls12_381.fq12("cpu")
    a = port(F12, [r12(rng)])
    t = F12.mul(F12.conjugate(a), F12.inverse(a))
    b = F12.mul(F12.frobenius(t, 2), t)
    bh = F12.to_int(b)[0]
    for e in (bls12_381.X_ABS, 0b1011011):
        assert F12.to_int(F12.cyclotomic_exp(b, e)) == [H12.pow(bh, e)], e
    assert F12.to_int(F12.cyclotomic_square(b)) == [H12.mul(bh, bh)]


def test_felt_operators():
    rng = random.Random(16)
    F2 = bls12_381.fq2("cpu")
    x, y = r2(rng), r2(rng)
    a, b = Felt(F2, port(F2, [x])), Felt(F2, port(F2, [y]))
    assert (a * b + a).to_int() == [H2.add(H2.mul(x, y), x)]
    assert (a / b).to_int() == [H2.mul(x, H2.inv(y))]
    assert (a ** 5).to_int() == [H2.pow(x, 5)]
    assert (-a + a).is_zero() and a == a and not a == b
