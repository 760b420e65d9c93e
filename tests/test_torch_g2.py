"""The port's BLS12-381 G2 (``SWCurve`` over Fq2: the group law as the
reference's ``dot_multi`` waves, each one ``dot_stacked``, kernel K17's
plain version here; the composed ``affine_add``; ``psi`` and the subgroup
checks) held against the JAX package and the host group law.

The JAX side is one compiled function a law (XLA's lowest optimisation
level), in that law's own test, for the doubling, the full add and the
mixed add on the same seeded Jacobian words, with planted lanes (P = inf,
Q = inf, P = Q, P = -Q, both infinite); the words compare exactly (tolerance 0).  Normalisation, scalar
multiplication, psi, the batched affine add and the subgroup checks give
unique affine results or booleans and are held against the host group law
(``SWCurve.host_*``, the JAX package's G2 host oracles), which costs no
compile.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algebra_tpu.curves.instances import bls12_381 as ref_bls
from algebra_tpu.hostmath import host_sqrt

from algebra_tpu_torch import convert
from algebra_tpu_torch.bigint import batch_int_to_limbs
from algebra_tpu_torch.curves.instances import bls12_381

P = bls12_381.P
ONE = bls12_381.fq_spec.R % P  # 1 in Montgomery form
N = 8
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def curves():
    return ref_bls.g2(), bls12_381.g2("cpu")


def planted(seed: str):
    """Montgomery-form Fq2 coordinates of P (Jacobian), Q (Jacobian) and
    Q's affine mask, as reference arrays ((c0, c1) of uint32 [24, N]):
    random but for lane 0 P = inf, 1 Q = inf, 2 P = Q with z = 1 (for both
    adds), 3 P = -Q with z = 1, 4 both infinite, 5 Q = P with z != 1."""
    rng = random.Random(seed)

    def r2():
        return (rng.randrange(P), rng.randrange(P))

    x1, y1, z1, x2, y2, z2 = ([r2() for _ in range(N)] for _ in range(6))
    inf2 = [False] * N
    one, zero = (ONE, 0), (0, 0)
    for i in (2, 3):
        z1[i] = z2[i] = one
        x2[i], y2[i] = x1[i], y1[i]
    y2[3] = ((P - y1[3][0]) % P, (P - y1[3][1]) % P)
    z1[0] = zero
    z2[1], inf2[1] = zero, True
    z1[4], z2[4], inf2[4] = zero, zero, True
    x2[5], y2[5], z2[5] = x1[5], y1[5], z1[5]

    def arr(c):
        return tuple(batch_int_to_limbs([v[k] for v in c], 24) for k in range(2))

    return [arr(c) for c in (x1, y1, z1, x2, y2, z2)], np.asarray(inf2)


_LAWS = {"double": lambda c, P1, P2, aff2: c.double(P1),
         "add": lambda c, P1, P2, aff2: c.add(P1, P2),
         "add_mixed": lambda c, P1, P2, aff2: c.add_mixed(P1, aff2)}


@pytest.fixture(scope="module")
def planted_inputs():
    """The planted operands as reference arrays and as the port's
    tensors."""
    arrs, inf2 = planted("g2-laws")
    pin = [convert.tower_from_reference(a, "cpu") for a in arrs]
    return arrs, inf2, pin


def _same(got, want) -> bool:
    if isinstance(want, tuple):
        return len(got) == len(want) and all(_same(g, w) for g, w in zip(got, want))
    return np.array_equal(convert.to_reference(got), np.asarray(want))


@pytest.mark.parametrize("law", ["double", "add", "add_mixed"])
def test_group_law_vs_reference(curves, planted_inputs, law):
    """One JAX compile a law, in its own test, so that no worker compiles a
    law it does not test."""
    rc, pc = curves
    arrs, inf2, pin = planted_inputs
    ref_in = [tuple(jnp.asarray(c) for c in a) for a in arrs] + [jnp.asarray(inf2)]

    def ref_fn(x1, y1, z1, x2, y2, z2, i2):
        return _LAWS[law](rc, (x1, y1, z1), (x2, y2, z2), (x2, y2, i2))

    ref_out = jax.jit(ref_fn).lower(*ref_in).compile(FAST_COMPILE)(*ref_in)
    i2 = torch.from_numpy(inf2)
    port_out = _LAWS[law](pc, tuple(pin[:3]), tuple(pin[3:]), (pin[3], pin[4], i2))
    assert _same(port_out, ref_out), law


def host_points(curve, n: int, seed: str) -> list:
    """n subgroup points k0 G + i d G, made by host additions."""
    rng = random.Random(seed)
    g = curve.generator_host
    step = curve.host_mul(g, rng.randrange(1, bls12_381.R))
    pts = [curve.host_mul(g, rng.randrange(1, bls12_381.R))]
    for _ in range(n - 1):
        pts.append(curve.host_add(pts[-1], step))
    return pts


def off_subgroup_point(seed: str):
    """A point of E'(Fq2) outside G2: x chosen until x^3 + 4(u + 1) is a
    square (the cofactor makes a subgroup point unlikely, and the host
    check confirms)."""
    h2 = ref_bls.host_fq2
    rng = random.Random(seed)
    while True:
        x = (rng.randrange(P), rng.randrange(P))
        rhs = h2.add(h2.mul(h2.mul(x, x), x), (4, 4))
        y = host_sqrt(h2, rhs)
        if y is not None:
            return (x, y)


def test_host_oracles_match_reference(curves):
    """The port's G2 host group law and psi are the reference's."""
    rc, pc = curves
    pts = host_points(pc, 3, "oracles")
    assert pc.host_add(pts[0], pts[1]) == rc.host_add(pts[0], pts[1])
    assert pc.host_double(pts[2]) == rc.host_double(pts[2])
    assert pc.host_mul(pts[0], 12345) == rc.host_mul(pts[0], 12345)
    assert pc.generator_host == rc.generator_host and pc.b_host == rc.b_host


def test_to_affine_and_host_round_trip(curves):
    _, pc = curves
    pts = host_points(pc, 4, "affine") + [None]
    aff = pc.from_host(pts)
    J = pc.double(pc.from_affine(aff))  # z != 1
    assert pc.to_host(J) == [pc.host_double(p) for p in pts]
    assert pc.is_on_curve(pc.to_affine(J)).all()


def test_scalar_mul_and_mul_int_vs_host(curves):
    """Per-lane 32-bit scalars (double-and-add over their bits, each step
    five waves of the add and three of the doubling) and a host constant."""
    _, pc = curves
    pts = host_points(pc, 3, "scalar")
    ks = [0xDEADBEEF, 1, 0]
    sc = convert.from_reference(batch_int_to_limbs(ks, 2), "cpu")
    P1 = pc.from_affine(pc.from_host(pts))
    assert pc.to_host(pc.scalar_mul(P1, sc)) == [pc.host_mul(p, k) for p, k in zip(pts, ks)]
    assert pc.to_host(pc.mul_int(P1, 1000003)) == [pc.host_mul(p, 1000003) for p in pts]


def test_affine_add_over_fq2_vs_host(curves):
    """The composed affine add with every case: a chord, P = Q (tangent),
    P = -Q, either operand infinite, y negated by a mask."""
    _, pc = curves
    a = host_points(pc, 6, "aff-a")
    b = host_points(pc, 6, "aff-b")
    b[1] = a[1]
    b[2] = pc.host_mul(a[2], bls12_381.R - 1)  # -a[2]
    a[3], b[4] = None, None
    neg2 = torch.tensor([False] * 5 + [True])
    got = pc.affine_add(pc.from_host(a), pc.from_host(b), pc.base.inverse, neg2=neg2)
    x, y, inf = got
    hosts = pc.to_host(pc.from_affine((x, y, inf)))
    b[5] = pc.host_mul(b[5], bls12_381.R - 1)
    assert hosts == [pc.host_add(p, q) for p, q in zip(a, b)]


def test_psi_and_subgroup_checks(curves):
    """psi on affine points equals the host map; G2 points pass both
    subgroup checks, points of E'(Fq2) outside it fail both; infinity
    passes."""
    _, pc = curves
    inside = host_points(pc, 2, "inside")
    outside = off_subgroup_point("outside")
    assert not pc.host_is_in_correct_subgroup(outside)
    assert all(pc.host_is_in_correct_subgroup(q) for q in inside)
    pts = inside + [outside, None]
    aff = pc.from_host(pts)
    px, py, _ = pc.psi(aff)
    got = list(zip(pc.base.to_int(px), pc.base.to_int(py)))
    assert got[:3] == [bls12_381.psi_host(q) for q in pts[:3]]
    ok = pc.is_in_correct_subgroup(pc.from_affine(aff))
    assert ok.tolist() == [True, True, False, True]
