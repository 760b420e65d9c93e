"""The port's G1 group law (algebra_tpu_torch ``curves/sw.py``, the plain
versions of the kernels K6-K8 in ``ops/sw_kernels.py``, the BLS12-381 G1
instance) held against the JAX package on the same seeded inputs.

The port runs on the CPU here, so the kernel wrappers take their plain
versions; the JAX curve computes through its bilinear-form waves
(``fields/dot.py``), which evaluate the same polynomials as the kernels'
formulas, so canonical outputs agree.  Group laws compare bit-exact in
Jacobian coordinates (tolerance 0), on 128 lanes with planted exceptional
lanes (P = inf, Q = inf, P = Q on lane 2 and a whole warp 64-95, P = -Q);
scalar multiplication and normalisation compare in affine and against the
host group law.  Each JAX value costs a compile, so there is one per law.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algebra_tpu.curves.instances import bls12_381 as ref_bls

from algebra_tpu_torch import convert
from algebra_tpu_torch.bigint import batch_int_to_limbs
from algebra_tpu_torch.curves.instances import bls12_381
from algebra_tpu_torch.curves.sw import SWCurve
from algebra_tpu_torch.ops import sw_kernels as swk

SPEC = bls12_381.fq_spec
P_MOD = SPEC.modulus
ONE = SPEC.R % P_MOD  # 1 in Montgomery form
N = 128


@pytest.fixture(scope="module")
def curves():
    return ref_bls.g1(), bls12_381.g1("cpu")


def planted(seed: str, n: int = N):
    """Montgomery-form coordinates (x1, y1, z1, x2, y2, z2) as uint32
    [24, n] arrays and a bool [n] mask inf2, random but for the planted
    lanes: 0 P = inf; 1 Q = inf; 2 and 64-95 P = Q (z1 = z2 = one, so it is
    P = Q for the mixed add too); 3 P = -Q; 4 both infinite; 5 Q = P with
    z != 1 (for the full add)."""
    rng = random.Random(seed)
    x1, y1, z1, x2, y2, z2 = ([rng.randrange(P_MOD) for _ in range(n)] for _ in range(6))
    inf2 = [rng.randrange(8) == 0 for _ in range(n)]
    for i in [2, 3] + list(range(64, min(96, n))):
        z1[i] = z2[i] = ONE
        x2[i], y2[i], inf2[i] = x1[i], y1[i], False
    y2[3] = (P_MOD - y1[3]) % P_MOD
    z1[0] = 0
    z2[1], inf2[1] = 0, True
    z1[4], z2[4], inf2[4] = 0, 0, True
    x2[5], y2[5], z2[5] = x1[5], y1[5], z1[5]
    arrs = [batch_int_to_limbs(c, SPEC.n_limbs) for c in (x1, y1, z1, x2, y2, z2)]
    return arrs, np.asarray(inf2)


def port(arrs):
    return tuple(convert.from_reference(a, "cpu") for a in arrs)


def ref(arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def same_points(port_pt, ref_pt) -> bool:
    return all(np.array_equal(convert.to_reference(p), np.asarray(r))
               for p, r in zip(port_pt, ref_pt))


def test_double_vs_reference(curves):
    rc, pc = curves
    arrs, _ = planted("double")
    got = pc.double(port(arrs[:3]))
    assert same_points(got, jax.jit(rc.double)(ref(arrs[:3])))
    assert not got[2][:, 0].any()  # infinity falls out as Z3 = 0


def test_add_vs_reference(curves):
    rc, pc = curves
    arrs, _ = planted("add")
    got = pc.add(port(arrs[:3]), port(arrs[3:]))
    assert same_points(got, jax.jit(rc.add)(ref(arrs[:3]), ref(arrs[3:])))
    # P = Q went to the doubling, P = -Q to Z3 = 0
    dbl = pc.double(port(arrs[:3]))
    assert all(torch.equal(g[:, 2], d[:, 2]) for g, d in zip(got, dbl))
    assert not got[2][:, 3].any()


def test_add_mixed_vs_reference(curves):
    rc, pc = curves
    arrs, inf2 = planted("madd")
    aff = (*port(arrs[3:5]), torch.from_numpy(inf2))
    got = pc.add_mixed(port(arrs[:3]), aff)
    want = jax.jit(rc.add_mixed)(ref(arrs[:3]), (*ref(arrs[3:5]), jnp.asarray(inf2)))
    assert same_points(got, want)
    # P = inf and Q = inf: from_affine(Q) is (1, 1, 0)
    assert [int(v) for v in convert.to_reference(got[2][:, 4])] == [0] * SPEC.n_limbs
    assert not got[2][:, 3].any()


def test_wrappers_broadcast_and_write_in_place():
    """A one-element Q and strided point-major rows go in as the MSM gives
    them; ``out`` accumulates in place; the same results as full arrays."""
    arrs, inf2 = planted("forms", 40)
    P, Q = port(arrs[:3]), port(arrs[3:])
    Q1 = tuple(c[:, 7:8] for c in Q)
    want = swk.add_plain(SPEC, *P, *(c.expand(-1, 40) for c in Q1))
    assert all(torch.equal(g, w) for g, w in zip(swk.add(SPEC, P, Q1), want))
    rows = torch.cat([Q[0].T, Q[1].T], dim=1)  # [40, 2L] point-major
    L = SPEC.n_limbs
    acc = tuple(c.clone() for c in P)
    swk.madd(SPEC, acc, (rows[:, :L].T, rows[:, L:].T, torch.from_numpy(inf2)), out=acc)
    want = swk.madd_plain(SPEC, *P, Q[0], Q[1], torch.from_numpy(inf2))
    assert all(torch.equal(g, w) for g, w in zip(acc, want))
    # a [2, 20] batch against a [20] one broadcasts right-aligned
    P2 = tuple(c.reshape(L, 2, 20) for c in P)
    got = swk.double(SPEC, P2)
    assert all(torch.equal(g.reshape(L, 40), w) for g, w in zip(got, swk.double(SPEC, P)))
    with pytest.raises(ValueError):
        swk.madd(SPEC, P, (Q[0], Q[1], torch.from_numpy(inf2).to(torch.int32)))


def host_points(curve, n, seed):
    return curve.random_host(random.Random(seed), n)


def test_scalar_mul_and_to_affine(curves):
    """scalar_mul with 32-bit scalars on 4 lanes (one at infinity, one zero
    scalar) against the host; to_affine of its Jacobian results against the
    JAX normalisation of the same points, bit-exact."""
    rc, pc = curves
    pts = host_points(pc, 4, "smul")
    pts[3] = None
    rng = random.Random("smul-k")
    ks = [rng.randrange(1 << 32) for _ in range(4)]
    ks[2] = 0
    sc = batch_int_to_limbs(ks, 2)
    got = pc.scalar_mul(pc.from_affine(pc.from_host(pts)), convert.from_reference(sc, "cpu"))
    aff = pc.to_affine(got)
    want = jax.jit(rc.to_affine)(tuple(jnp.asarray(convert.to_reference(c)) for c in got))
    assert same_points(aff[:2], want[:2])
    assert aff[2].tolist() == np.asarray(want[2]).tolist() == [False, False, True, True]
    assert pc.to_host(got) == [pc.host_mul(p, k) if p else None for p, k in zip(pts, ks)]
    assert pc.is_on_curve(aff).all()


def test_mul_int_equal_is_on_curve(curves):
    _, pc = curves
    pts = host_points(pc, 4, "mul_int")
    P = pc.from_affine(pc.from_host(pts))
    ks = (0, 1, 5, 13, 1000003, -3)
    got = pc.to_host(tuple(torch.cat(c, dim=1) for c in zip(*(pc.mul_int(P, k) for k in ks))))
    assert got == [pc.host_mul_raw(p, k) if k >= 0 else pc.host_mul(p, pc.scalar_modulus + k)
                   for k in ks for p in pts]
    # equal: another representative (x l^2, y l^3, z l) of the same point
    F = pc.base
    lam = F.from_int([3, 5, 7, 11])
    l2 = F.square(lam)
    Q = (F.mul(P[0], l2), F.mul(P[1], F.mul(l2, lam)), F.mul(P[2], lam))
    assert pc.equal(P, Q).all()
    D = pc.double(P)
    assert not pc.equal(P, D).any()
    Z = pc.zero((4,))
    assert pc.equal(Z, pc.mul_int(P, 0)).all() and not pc.equal(P, Z).any()
    aff = pc.to_affine(D)
    assert pc.is_on_curve(aff).all()
    bent = (aff[0], F.add(aff[1], F.one((4,))), aff[2])
    assert not pc.is_on_curve(bent).any()
    assert pc.is_on_curve((bent[0], bent[1], torch.ones(4, dtype=torch.bool))).all()


def test_sub_neg_and_sums_vs_host(curves):
    """sub, affine_neg and mul_bits_be, and the sequential and tree sums of
    the MSM module along a batch axis (5 points: an odd count, one at
    infinity), against the host group law."""
    from algebra_tpu_torch.ops import msm

    _, pc = curves
    pts = host_points(pc, 5, "sums")
    pts[3] = None
    aff = pc.from_host(pts)
    P = pc.from_affine(aff)
    Q = pc.double(pc.from_affine(pc.from_host(pts[1:] + pts[:1])))
    neg = [None if p is None else (p[0], (P_MOD - p[1]) % P_MOD) for p in pts]
    assert pc.to_host(pc.sub(P, Q)) == [
        pc.host_add(p, pc.host_double(q)) for p, q in zip(pts, neg[1:] + neg[:1])]
    na = pc.affine_neg(aff)
    assert pc.to_host(pc.from_affine(na)) == neg and pc.is_on_curve(na).all()
    assert pc.to_host(pc.mul_bits_be(P, [1, 0, 1, 1, 0, 1])) == pc.to_host(pc.mul_int(P, 45))
    total = None
    for p in pts:
        total = pc.host_add(total, p)
    P2 = tuple(c.reshape(-1, 1, 5) for c in P)  # batch [1, 5]: sum along axis 1
    for s in (msm.scan_sum(pc, P2, axis=1), msm._tree_sum(pc, P2, axis=1)):
        assert pc.to_host(s) == [total]


def test_cofactor_clearing_and_subgroup_check(curves):
    """Curve points outside G1 (random x with x^3 + 4 a square, by the
    port's sqrt): the checks say False, True after clearing, as on the host."""
    rc, pc = curves
    F = pc.base
    x = F.from_int(list(range(2, 14)))
    ok, y = F.sqrt(F.add(F.mul(F.square(x), x), F.constant(4)))
    off = (x[:, ok][:, :3], y[:, ok][:, :3], torch.zeros(3, dtype=torch.bool))
    assert pc.is_on_curve(off).all()
    P = pc.from_affine(off)
    host = pc.to_host(P)
    assert [pc.host_is_in_correct_subgroup(p) for p in host] == [False] * 3
    assert [rc.host_is_in_correct_subgroup(p) for p in host] == [False] * 3
    cleared = pc.clear_cofactor(P)
    assert pc.to_host(cleared) == [pc.host_mul_raw(p, bls12_381.G1_H_EFF) for p in host]
    both = tuple(torch.cat([a, b], dim=1) for a, b in zip(P, cleared))
    assert pc.is_in_correct_subgroup(both).tolist() == [False] * 3 + [True] * 3


def test_host_group_law_vs_reference(curves):
    rc, pc = curves
    rng = random.Random("host")
    pts = pc.random_host(rng, 3)
    assert pts == rc.random_host(random.Random("host"), 3)
    for a in pts + [None]:
        assert pc.host_double(a) == rc.host_double(a)
        for b in pts + [None, a]:
            assert pc.host_add(a, b) == rc.host_add(a, b)
    k = rng.randrange(1 << 300)
    assert pc.host_mul(pts[0], k) == rc.host_mul(pts[0], k)
    assert pc.host_mul_raw(pts[1], k) == rc.host_mul_raw(pts[1], k)
    assert pc.host_mul(pts[0], pc.scalar_modulus) is None
    assert pc.host_is_in_correct_subgroup(pts[2]) and pc.host_is_in_correct_subgroup(None)
    assert pc.generator_host == rc.generator_host
    assert (pc.cofactor, pc.scalar_modulus) == (rc.cofactor, rc.scalar_modulus)


def test_curve_constants_vs_reference():
    assert bls12_381.G1_BETA == ref_bls.G1_BETA
    assert (bls12_381.X_ABS, bls12_381.G1_H_EFF, bls12_381.G1_COFACTOR) == (
        ref_bls.X_ABS, ref_bls.G1_H_EFF, ref_bls.G1_COFACTOR)
    pc = bls12_381.g1("cpu")
    g = pc.generator_affine((2,))
    assert pc.is_on_curve(g).all() and not g[2].any()
    assert pc.to_host(pc.generator((2,))) == [pc.generator_host] * 2
    assert bls12_381.g1("cpu") is pc and pc.device == torch.device("cpu")


def test_composed_law_for_a_nonzero():
    """a != 0 runs the composed dbl-2007-bl / add-2007-bl / madd-2007-bl:
    y^2 = x^3 + 3x + 7 over BLS12-381 Fq, against the host group law, on
    lanes with P = inf, Q = inf, P = Q and P = -Q."""
    a, b = 3, 7
    pts, x = [], 2
    while len(pts) < 6:
        rhs = (x ** 3 + a * x + b) % P_MOD
        y = pow(rhs, (P_MOD + 1) // 4, P_MOD)
        if y * y % P_MOD == rhs:
            pts.append((x, y))
        x += 1
    curve = SWCurve(bls12_381.Fq.to("cpu"), a, b, pts[0], cofactor=1,
                    scalar_modulus=bls12_381.R, name="toy")
    assert not curve.a_is_zero
    ps = [None, pts[1], pts[2], pts[3], pts[4], None]
    qs = [pts[0], None, pts[2], (pts[3][0], P_MOD - pts[3][1]), pts[5], None]
    P = curve.from_affine(curve.from_host(ps))
    Qa = curve.from_host(qs)
    Q = curve.double(curve.from_affine(Qa))  # z != 1
    assert curve.to_host(curve.double(P)) == [curve.host_double(p) for p in ps]
    assert curve.to_host(curve.add(P, Q)) == [
        curve.host_add(p, curve.host_double(q)) for p, q in zip(ps, qs)]
    assert curve.to_host(curve.add_mixed(P, Qa)) == [
        curve.host_add(p, q) for p, q in zip(ps, qs)]
    assert curve.is_on_curve(curve.to_affine(curve.add(P, Q))).all()


@pytest.mark.cuda
def test_group_law_kernels_vs_plain_on_card():
    """On a CUDA device: K6-K8 against their plain versions on the planted
    lanes (the chip smoke script does the same at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")
    arrs, inf2 = planted("card")
    P = tuple(convert.from_reference(a, "cuda") for a in arrs[:3])
    Q = tuple(convert.from_reference(a, "cuda") for a in arrs[3:])
    m = torch.from_numpy(inf2).cuda()
    for got, want in ((swk.double(SPEC, P), swk.double_plain(SPEC, *P)),
                      (swk.add(SPEC, P, Q), swk.add_plain(SPEC, *P, *Q)),
                      (swk.madd(SPEC, P, (Q[0], Q[1], m)),
                       swk.madd_plain(SPEC, *P, Q[0], Q[1], m))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
