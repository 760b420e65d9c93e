"""The port's BN254 (``curves/instances/bn254.py``, ``_derive.py``,
``pairing/bn.py`` over ``pairing/common.py``'s D-twist line steps and
``Fp12Field.mul_by_034``; the G1 MSM at 8 words; the entry points with
``curve="bn254"``) held against the JAX package, a pinned value and host
integers, on the CPU (every tower product through K17's plain version,
every group-law and MSM kernel through its plain version).

One JAX function is compiled, inside ``test_bn254_pairing_vs_reference``
alone, so that one xdist worker pays for it: the JAX package's BN254
pairing at XLA's lowest optimisation level on 2 lanes, (g1, g2) and
(a g1, g2); the port's must give the same Montgomery words, and e(g1, g2)
must equal the pinned value below.  Everything else is held against that
pinned value, the JAX package's jax-free host code (the host Fq2, the G1
and G2 host group law, the instance's derived constants) and the port's
host tower with xi = 9 + u.  Every comparison is exact (tolerance 0).
"""

import random

import jax
import numpy as np
import pytest
import torch

from algebra_tpu.curves.instances import _derive as ref_derive
from algebra_tpu.curves.instances import bn254 as ref_bn
from algebra_tpu.fields import dot as ref_dot
from algebra_tpu.ops import mont as ref_mont

from algebra_tpu_torch import convert, entry
from algebra_tpu_torch.bigint import batch_int_to_limbs
from algebra_tpu_torch.curves.instances import _derive, bn254
from algebra_tpu_torch.fields import dot
from algebra_tpu_torch.fields.host_tower import HostCubicExt, HostQuadExt
from algebra_tpu_torch.ops import mont, msm
from algebra_tpu_torch.pairing.bls12 import G2Prepared
from algebra_tpu_torch.pairing.bn import BnG2Prepared

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}

P, R = bn254.P, bn254.R

# e(g1, g2) over BN254, canonical Fq coordinates in the order
# ((c0.c0, c0.c1), (c1.c0, c1.c1), (c2.c0, c2.c1)) of Fq12's c0 then c1:
# computed by the JAX package (algebra_tpu.curves.instances.bn254
# .pairing().pairing on the two generators, on the CPU).
GT_G1_G2 = (
    ((0x262B253FEDA94CFE0DA01BDE280A3ED6F87E5FEB898578B55E1F63739D870E95,
      0x02E02D2CC795A2000A1B1F823879ABBD397C4DEA0918ED66B49D34B48EFB8A4A),
     (0x13A9F2D6E29B128DA5B1AD44B31977935FD2957387ECB1FC4E135402FDBD1DE0,
      0x040BA9FA500F1A5C4B31984A74E68659C4B420BD699CE630B130B08A6EA1162B),
     (0x0AFC2F3FD870678FBE359D7F9873F052478F590B211CE30BF5E3EEAEF89EAFDB,
      0x1C54A530398C9064BDC662D929E645CADDA9A712CC5A8243F9CDDBD2D98DD1F0)),
    ((0x095C0FBF5D5A1AC023794A0D856F92591BA990ECFD4B7AEF5C0D58C5DC2429FE,
      0x14D3D6CA72D8A950A31DC10F7B4053C9E9AD9EBB590CB4A60F8215D4B99F2B4A),
     (0x1DC0E7BBC3D70E6689DC206B4B91C85759DC1A23043C585FDFAF545838CA7429,
      0x0B53320E5A6488CB98A855FFC837D2A75AB90D61AC16CC1B7AB2CD3ED5E22B97),
     (0x13A8AFD3085DAE4C6C91476EF36CD1D318CE07BAC42A9C0F9BD7FDDAF5EBD723,
      0x00F97B5221474526B601F3730A3AFA965CEEE1B343940C383E5314859E762C97)),
)

H2 = bn254.host_fq2
H6 = HostCubicExt(H2, (9, 1))
H12 = HostQuadExt(H6, ((0, 0), (1, 0), (0, 0)))
A = 0x2B1E_0D51  # the scalar of lane 1


def kinds():
    return bn254.fq2("cpu"), bn254.fq6("cpu"), bn254.fq12("cpu")


@pytest.fixture(scope="module")
def two_lanes():
    """(host G1 points, host G2 points, the port's pairing as host ints,
    the port's raw tensors) on the lanes (g1, g2) and (a g1, g2)."""
    g1, g2 = bn254.g1("cpu"), bn254.g2("cpu")
    P1, Q1 = g1.generator_host, g2.generator_host
    ps, qs = [P1, g1.host_mul(P1, A)], [Q1, Q1]
    got = entry.pairing(ps, qs, curve="bn254", device="cpu")
    return ps, qs, bn254.fq12("cpu").to_int(got), got


def _same(got, want) -> bool:
    if isinstance(want, tuple):
        return all(_same(g, w) for g, w in zip(got, want))
    return np.array_equal(convert.to_reference(got), np.asarray(want))


def test_bn254_pairing_vs_reference(two_lanes):
    """The one JAX compile of the file: the reference's pairing on the same
    two lanes, word for word; e(g1, g2) pinned."""
    ps, qs, e, got = two_lanes
    rp, rq = ref_bn.g1().from_host(ps), ref_bn.g2().from_host(qs)
    ref_fn = jax.jit(ref_bn.pairing().pairing).lower(rp, rq).compile(FAST_COMPILE)
    assert _same(got, ref_fn(rp, rq))
    assert e[0] == GT_G1_G2


def test_instance_constants_vs_reference():
    """P, R, T, the tower's Frobenius coefficients, the twist's b, the G2
    cofactor, the ate loop's NAF digits and the Frobenius twist constants
    against the JAX package's host values; the copied ``_derive`` helpers
    against the reference's."""
    assert (bn254.X, bn254.P, bn254.R, bn254.T) == (ref_bn.X, ref_bn.P, ref_bn.R, ref_bn.T)
    assert bn254.fq_spec.n_words == 8 and bn254.fq_spec.n_limbs == 16
    F2, F6, F12 = kinds()
    rctx = ref_bn.pairing()
    assert F2._frob_host == ref_bn.fq2()._frob_host
    assert F6._frob_c1_host == ref_bn.fq6()._frob_c1_host
    assert F6._frob_c2_host == ref_bn.fq6()._frob_c2_host
    assert F12._frob_host == ref_bn.fq12()._frob_host
    g2 = bn254.g2("cpu")
    assert g2.b_host == ref_bn.g2().b_host == bn254.G2_B
    assert g2.cofactor == ref_bn.g2().cofactor
    assert H2.mul(bn254.G2_B, (9, 1)) == (3, 0)  # b = 3 / xi
    ctx = bn254.pairing("cpu")
    assert ctx.ate_loop_count == rctx.ate_loop_count == bn254.ATE_LOOP_COUNT
    assert sum(d << i for i, d in enumerate(ctx.ate_loop_count)) == 6 * bn254.X + 2
    assert -1 in ctx.ate_loop_count and ctx.ate_loop_count[-1] == 1
    assert ctx.twist_mul_by_q_x_host == rctx.twist_mul_by_q_x_host
    assert ctx.twist_mul_by_q_y_host == rctx.twist_mul_by_q_y_host
    assert ctx.twist_type == "D" and not ctx.x_is_negative
    for t, k in ((bn254.T, 1), (bn254.T, 2), (7, 5)):
        assert _derive.trace_power(t, P, k) == ref_derive.trace_power(t, P, k)
        assert (_derive.quadratic_twist_order(P, t, k)
                == ref_derive.quadratic_twist_order(P, t, k))
    assert _derive.sextic_twist_orders(P, bn254.T) == ref_derive.sextic_twist_orders(P, bn254.T)
    for n in (1, 2, 3, 7, 0xDEADBEEF, 6 * bn254.X + 2):
        assert _derive.naf_digits_le(n) == ref_derive.naf_digits_le(n)
    with pytest.raises(AssertionError):
        _derive.pick_twist_order([R + 1, R + 2], R)


def _mass(T, dim: int, structure) -> int:
    """The largest row weight mass sum_k |W[o, k]| of one ``dot_multi``
    call structure over the multiplication tensor T, built term by term as
    the reference's ``dot_multi`` builds its weight matrix."""
    rows, cols = {}, {}
    for g, terms in enumerate(structure):
        for t, (s, a_mask, b_mask, symmetric) in enumerate(terms):
            for (o, i, j), w in T.items():
                if (a_mask and not a_mask[i]) or (b_mask and not b_mask[j]) or s == 0:
                    continue
                if symmetric and j < i:
                    i, j = j, i
                key = (g * dim + o, cols.setdefault((g, t, i, j), len(cols)))
                rows[key] = rows.get(key, 0) + s * w
    mass = {}
    for (row, _), w in rows.items():
        mass[row] = mass.get(row, 0) + abs(w)
    return max(mass.values(), default=0)


def test_dot_plans_match_reference(two_lanes):
    """xi = 9 + u puts weights of 9 into the tower's products: the port's
    multiplication tensors and mass limit are the reference's, and every
    ``dot_multi`` call structure the pairing made takes K17 or the generic
    path exactly where the reference's weight mass sends it."""
    limit = ref_mont.dot_mass_limit(ref_bn.fq_spec)
    assert mont.dot_mass_limit(bn254.fq_spec) == limit
    seen = 0
    for kind, ref_kind in zip(kinds(), (ref_bn.fq2(), ref_bn.fq6(), ref_bn.fq12())):
        T = dot.mul_tensor(kind)
        assert T == ref_dot.mul_tensor(ref_kind)
        for structure, plan in kind.__dict__.get("_dot_plans", {}).items():
            assert (plan is None) == (_mass(T, kind.extension_degree(), structure) > limit)
            seen += 1
    assert seen >= 10  # the pairing's waves, products, squares and line products


def _r2(rng):
    return (rng.randrange(P), rng.randrange(P))


def _r6(rng):
    return (_r2(rng), _r2(rng), _r2(rng))


def _r12(rng):
    return (_r6(rng), _r6(rng))


def _frob_host(h, a, k):
    return h.pow(a, P**k)


def test_tower_vs_host():
    """Fq2, Fq6 and Fq12 products, squares, inverses, the nonresidue
    products and Frobenius maps of 3 seeded random elements (and a zero
    lane for the inverses) against the host tower with xi = 9 + u; the
    sparse line products against the full product."""
    rng = random.Random("bn254-tower")
    F2, F6, F12 = kinds()
    for F, H, rnd in ((F2, H2, _r2), (F6, H6, _r6), (F12, H12, _r12)):
        a, b = [rnd(rng) for _ in range(3)], [rnd(rng) for _ in range(3)]
        ta, tb = F.from_int(a), F.from_int(b)
        assert F.to_int(F.mul(ta, tb)) == [H.mul(x, y) for x, y in zip(a, b)]
        assert F.to_int(F.square(ta)) == [H.mul(x, x) for x in a]
        zero = H.zero()
        inv = F.to_int(F.inverse(F.from_int(a + [zero])))
        assert inv == [H.inv(x) for x in a] + [zero]
        for k in (1, 2, 3) if F is F12 else (1, 2):
            assert F.to_int(F.frobenius(ta, k)) == [_frob_host(H, x, k) for x in a]
    a2 = [_r2(rng) for _ in range(3)]
    xi = F6.mul_by_nonresidue(F2.from_int(a2))
    assert F2.to_int(xi) == [H2.mul(x, (9, 1)) for x in a2]
    f = [_r12(rng) for _ in range(3)]
    c0, c3, c4 = ([_r2(rng) for _ in range(3)] for _ in range(3))
    z = H2.zero()
    want = [H12.mul(x, ((u, z, z), (v, w, z))) for x, u, v, w in zip(f, c0, c3, c4)]
    got = F12.mul_by_034(F12.from_int(f), F2.from_int(c0), F2.from_int(c3), F2.from_int(c4))
    assert F12.to_int(got) == want


def _host_points(curve, n: int, seed: str, steps: bool = False):
    """n subgroup points (k0 + i d) G, made by host additions; with
    ``steps``, also (k0, d)."""
    rng = random.Random(seed)
    g = curve.generator_host
    k0, d = rng.randrange(1, R), rng.randrange(1, R)
    step = curve.host_mul(g, d)
    pts = [curve.host_mul(g, k0)]
    for _ in range(n - 1):
        pts.append(curve.host_add(pts[-1], step))
    return (pts, k0, d) if steps else pts


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_group_law_vs_host(group):
    """Add, double, mixed add, ``scalar_mul`` and ``to_affine`` of G1 (the
    group-law kernels' plain versions at 8 words) and G2 (``dot_multi``
    waves over Fq2) against the JAX package's host group law, with planted
    lanes: P = Q, P = -Q, either point at infinity, both."""
    pc = getattr(bn254, group)("cpu")
    rc = getattr(ref_bn, group)()
    a = _host_points(pc, 7, f"{group}-a")
    b = _host_points(pc, 7, f"{group}-b")
    b[1] = a[1]
    b[2] = pc.host_mul(a[2], R - 1)
    a[3], b[4], a[5], b[5] = None, None, None, None
    Pa = pc.double(pc.from_affine(pc.from_host(a)))  # z != 1
    Pb = pc.from_affine(pc.from_host(b))
    assert pc.to_host(Pa) == [rc.host_double(x) for x in a]
    assert pc.to_host(pc.add(Pa, Pb)) == [
        rc.host_add(rc.host_double(x), y) for x, y in zip(a, b)]
    assert pc.to_host(pc.add_mixed(Pa, pc.from_host(b))) == [
        rc.host_add(rc.host_double(x), y) for x, y in zip(a, b)]
    assert pc.to_host(pc.double(Pb)) == [rc.host_double(y) for y in b]
    ks = [0xDEADBEEF, 1, 0, 77, 2**64 - 1, 5, 0x1234_5678_9ABC]
    sc = convert.from_reference(batch_int_to_limbs(ks, 4), "cpu")
    assert pc.to_host(pc.scalar_mul(Pb, sc)) == [rc.host_mul(y, k) for y, k in zip(b, ks)]
    x, y, inf = pc.to_affine(Pa)
    assert inf.tolist() == [p is None for p in a]
    assert pc.is_on_curve((x, y, inf)).all()


def _msm_inputs(n: int, seed: str, limbs: int = 16):
    """n G1 bases (k0 + i d) G, with a point at infinity at lane 3, and
    scalars s_i of ``limbs`` 16-bit limbs (zeros at lanes 0 and 5, the
    largest at lane 1: r - 1 at full width, else all ones; the rest
    random), with the host sum (sum s_i (k0 + i d)) G over the finite
    lanes.  Returns (points, scalars as limbs, the sum)."""
    g1 = bn254.g1("cpu")
    rng = random.Random(seed)
    pts, k0, d = _host_points(g1, n, seed, steps=True)
    pts[3] = None
    top = R if limbs == 16 else 1 << (16 * limbs)
    ks = [rng.randrange(top) for _ in range(n)]
    ks[0] = ks[5] = 0
    ks[1] = top - 1
    k = sum(s * (k0 + i * d) for i, s in enumerate(ks) if pts[i] is not None)
    return pts, batch_int_to_limbs(ks, limbs), g1.host_mul(g1.generator_host, k)


@pytest.mark.parametrize("n,c,limbs", [(300, 5, 16), (40, None, 4)])
def test_g1_msm_vs_host(n, c, limbs):
    """The G1 MSM at 8 words against the host sum: n = 300 through the
    lockstep rounds at c = 5, with its top window, zero scalars, r - 1 and
    a base at infinity; n = 40 through the tiny path (per-lane scalar
    multiplication and a sum), on 64-bit scalars.  The planner's own c is
    taken in ``test_entry_points_take_reference_arrays``."""
    g1 = bn254.g1("cpu")
    pts, ks, want = _msm_inputs(n, f"msm-{n}", limbs)
    got = msm.msm(g1, g1.from_host(pts), convert.from_reference(ks, "cpu"), c=c)
    assert g1.to_host(got) == want
    if n >= 64:
        assert msm.stats["path"] == "lockstep"
        assert msm.stats["windows"] == msm._num_windows(R.bit_length(), c) == 51


def test_pinned_pairing_bilinear(two_lanes):
    """e(g1, g2) is the pinned value, of order r, not 1, and
    e(a g1, g2) = e(g1, g2)^a."""
    _, _, e, _ = two_lanes
    assert e[0] == GT_G1_G2
    assert not H12.equal(e[0], H12.one())
    assert H12.pow(e[0], R) == H12.one()
    assert e[1] == H12.pow(e[0], A)


def test_prepared_path_and_infinity(two_lanes):
    """pairing(p, prepare_g2(q)) equals the unprepared lanes, a lane with
    either point at infinity gives 1, and e(g1, a g2) = e(a g1, g2)."""
    ps, qs, e, _ = two_lanes
    g2 = bn254.g2("cpu")
    prepared = entry.prepare_g2(qs + [qs[0], None, g2.host_mul(qs[0], A)], curve="bn254",
                                device="cpu")
    assert isinstance(prepared, BnG2Prepared)
    got = entry.pairing(ps + [None, ps[0], ps[0]], prepared, curve="bn254", device="cpu")
    one = H12.one()
    assert bn254.fq12("cpu").to_int(got) == [e[0], e[1], one, one, e[1]]


def test_multi_pairing(two_lanes):
    """e(g1, g2) e(-g1, g2) e(a g1, g2) through one final exponentiation:
    the pair and its negation cancel, the product is lane 1's pairing."""
    ps, qs, e, _ = two_lanes
    neg = (ps[0][0], P - ps[0][1])
    got = entry.multi_pairing([ps[0], neg, ps[1]], [qs[0]] * 3, curve="bn254", device="cpu")
    assert bn254.fq12("cpu").to_int(got) == e[1]


def test_entry_points_take_reference_arrays(two_lanes):
    """``entry.pairing`` and ``g1_msm`` with ``curve="bn254"`` on the
    reference's affine triples (16-limb Fq, Fq2 pairs); the MSM on 70
    points and 64-bit scalars, through the lockstep rounds at the
    planner's c."""
    ps, qs, e, _ = two_lanes
    g1, g2 = bn254.g1("cpu"), bn254.g2("cpu")
    p = convert.points_to_reference(g1.from_host(ps[1:]))
    q = convert.points_to_reference(g2.from_host(qs[1:]))
    assert p[0].shape == (16, 1) and p[0].dtype == np.uint32
    got = entry.pairing(p, q, curve="bn254", device="cpu")
    assert bn254.fq12("cpu").to_int(got) == e[1:]
    pts, ks, want = _msm_inputs(70, "entry-msm", limbs=4)
    bases = convert.points_to_reference(g1.from_host(pts))
    res = entry.g1_msm(bases, ks, curve="bn254", device="cpu")
    assert res[0].shape == (16,) and g1.to_host(res) == want
    assert msm.stats["path"] == "lockstep" and msm.stats["n"] == 70


def test_entry_curve_and_device_rules(two_lanes):
    """An unknown curve raises ``ValueError`` naming the accepted ones; a
    prepared batch of one curve is refused by the other; the default device
    is "cuda", with no fallback."""
    ps, qs, _, _ = two_lanes
    for fn, args in ((entry.pairing, (ps, qs)), (entry.multi_pairing, (ps, qs)),
                     (entry.prepare_g2, (qs,)), (entry.g1_msm, (None, None))):
        with pytest.raises(ValueError, match="bls12_381.*bn254"):
            fn(*args, curve="bn255", device="cpu")
    empty = [torch.zeros(0)]
    bn_prep = BnG2Prepared(empty, empty, (), (), torch.zeros(1, dtype=torch.bool))
    with pytest.raises(ValueError, match="another curve"):
        entry.pairing(ps, bn_prep, curve="bls12_381", device="cpu")
    with pytest.raises(ValueError, match="another curve"):
        entry.pairing(ps, G2Prepared(empty, empty, bn_prep.inf), curve="bn254", device="cpu")
    if torch.cuda.is_available():
        return
    for fn, args in ((entry.pairing, (ps, qs)), (entry.multi_pairing, (ps, qs)),
                     (entry.prepare_g2, (qs,))):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(*args, curve="bn254")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.g1_msm(None, None, curve="bn254")
