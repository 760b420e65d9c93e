"""The port's scalar multiplications (algebra_tpu_torch ``ops/glv.py``,
``ops/wnaf.py``, ``ops/fixed_base.py``, ``curves/te.py`` with the Jubjub
instance) and the entry points over them, held against the JAX package on
the same seeded inputs.

The port runs on the CPU here, so the group-law and field kernels take
their plain versions.  The JAX side gives what it computes without a scan:
the host decompositions, ``decompose_traced`` (eagerly), the twisted
Edwards doubling and addition (jitted together once; fused bilinear forms there,
which compute the same field values as the port's plain formulas), and its
host oracles (``host_mul``, ``host_add``) for every scalar multiplication:
no JAX ``glv_mul``, wNAF, fixed-base or double-and-add scan is compiled.
Points compare in affine where the order of additions differs, as
extended coordinates where it does not.  Tolerance: exact, everywhere.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algebra_tpu.bigint import batch_int_to_limbs
from algebra_tpu.curves.instances import bls12_381 as ref_bls
from algebra_tpu.curves.instances import ed_on_bls12_381 as ref_ed, secp256k1 as ref_secp
from algebra_tpu.ops import glv as ref_glv, wnaf as ref_wnaf

from algebra_tpu_torch import config, convert, entry
from algebra_tpu_torch.curves.instances import bls12_381, ed_on_bls12_381, secp256k1
from algebra_tpu_torch.ops import fixed_base, glv, wnaf

from test_torch_rows import FAST_COMPILE

R = secp256k1.R


def ks_with_signs(rng, n: int) -> list:
    """n scalars below r: 0, r - 1, one whose k1 < 0, one whose k2 < 0,
    the rest random."""
    g = secp256k1.g1("cpu").glv
    ks, want = [0, R - 1], {1: None, 2: None}
    while any(v is None for v in want.values()) or len(ks) < n:
        k = rng.randrange(R)
        k1, k2 = glv.decompose(g, R, k)
        for i, neg in ((1, k1 < 0), (2, k2 < 0)):
            if neg and want[i] is None:
                want[i] = k
                ks.append(k)
        if len(ks) < n and k not in ks:
            ks.append(k)
    return ks[:n]


def test_glv_decompose_vs_reference():
    rng = random.Random("glv-host")
    ks = ks_with_signs(rng, 64)
    g = secp256k1.g1("cpu").glv
    assert g == ref_secp.g1().glv
    for k in ks:
        k1, k2 = glv.decompose(g, R, k)
        assert (k1, k2) == ref_glv.decompose(ref_secp.g1().glv, R, k)
        assert (k1 + k2 * g["lam"]) % R == k and max(abs(k1), abs(k2)) < 1 << 130


def test_decompose_traced_vs_reference():
    """64 scalars as 16 limbs (0, r - 1, negative k1 and k2 among them):
    the signs and magnitude limbs are the reference's, and they give k."""
    rng = random.Random("glv-traced")
    ks = ks_with_signs(rng, 64)
    sc = batch_int_to_limbs(ks, 16)
    g = secp256k1.g1("cpu").glv
    want = [np.asarray(a) for a in ref_glv.decompose_traced(g, R, jnp.asarray(sc))]
    got = glv.decompose_traced(g, R, convert.from_reference(sc, "cpu"))
    for gt, w in zip(got, want):
        assert np.array_equal(gt.numpy().astype(w.dtype), w)
    neg1, mag1, neg2, mag2 = (t.numpy() for t in got)
    to_int = lambda mag, j: sum(int(mag[i, j]) << (16 * i) for i in range(mag.shape[0]))  # noqa: E731
    for j, k in enumerate(ks):
        k1 = -to_int(mag1, j) if neg1[j] else to_int(mag1, j)
        k2 = -to_int(mag2, j) if neg2[j] else to_int(mag2, j)
        assert (k1 + k2 * g["lam"]) % R == k
    assert neg1.any() and neg2.any() and not neg1.all()


def test_glv_scalar_mul_entry_vs_host():
    """``entry.scalar_mul`` on secp256k1 (full-width scalars: the GLV route)
    on 4 lanes, one at infinity, with k = 0, r - 1 and negative k1 and k2,
    against the reference's host oracle."""
    rc, pc = ref_secp.g1(), secp256k1.g1("cpu")
    rng = random.Random("glv-mul")
    pts = rc.random_host(rng, 4)
    ks = ks_with_signs(rng, 4)
    pts[3] = None
    bases = tuple(np.asarray(a) for a in rc.from_host(pts))
    got = entry.scalar_mul(bases, batch_int_to_limbs(ks, 16), device="cpu")
    assert pc.to_host(got) == [rc.host_mul(p, k) if p else None for p, k in zip(pts, ks)]


def test_glv_mul_host_and_endomorphism():
    """phi(P) = lambda P, and ``glv_mul_host`` with a scalar whose parts are
    short (k = k1 + k2 lambda, |k1|, |k2| < 2^20, k2 < 0), against the host."""
    rc, pc = ref_secp.g1(), secp256k1.g1("cpu")
    rng = random.Random("glv-host-mul")
    pt = rc.random_host(rng, 1)[0]
    P = pc.from_affine(pc.from_host([pt]))
    assert pc.to_host(glv.endomorphism(pc, P)) == [rc.host_mul(pt, pc.glv["lam"])]
    k1, k2 = rng.randrange(1 << 20), -rng.randrange(1 << 20)
    k = (k1 + k2 * pc.glv["lam"]) % R
    assert glv.decompose(pc.glv, R, k) == (k1, k2)
    P0 = pc.index_point(P, 0)
    assert pc.to_host(glv.glv_mul_host(pc, P0, k)) == rc.host_mul(pt, k)


def test_wnaf_vs_reference():
    """The digits are the reference's; ``WnafContext.mul`` (w = 3, a 40-bit
    scalar) on 2 lanes against the host."""
    rng = random.Random("wnaf")
    for w in (2, 3, 5):
        for _ in range(10):
            k = rng.randrange(1 << 64)
            assert wnaf.wnaf_digits(k, w) == ref_wnaf.wnaf_digits(k, w)
    rc, pc = ref_secp.g1(), secp256k1.g1("cpu")
    pts = rc.random_host(rng, 2)
    k = rng.randrange(1 << 40)
    got = wnaf.WnafContext(pc, 3).mul(pc.from_affine(pc.from_host(pts)), k)
    assert pc.to_host(got) == [rc.host_mul(p, k) for p in pts]
    assert pc.to_host(wnaf.WnafContext(pc, 3).mul(pc.from_affine(pc.from_host(pts)), 0)) \
        == [None, None]


def test_fixed_base_vs_host():
    """c = 4 and 32-bit scalars: every table entry is d 2^(4w) base, and the
    products of 5 scalars (0 among them) are the host's."""
    rc, pc = ref_secp.g1(), secp256k1.g1("cpu")
    rng = random.Random("fixed-base")
    base_pt = rc.random_host(rng, 1)[0]
    base = pc.index_point(pc.from_affine(pc.from_host([base_pt])), 0)
    table = fixed_base.window_table(pc, base, 4, 32)
    assert table[0].shape == (16, 8, 16)
    flat = tuple(c.reshape(16, -1) for c in table)
    assert pc.to_host(flat) == [rc.host_mul(base_pt, d << (4 * w))
                                for w in range(8) for d in range(16)]
    ks = [0] + [rng.randrange(1 << 32) for _ in range(4)]
    sc = convert.from_reference(batch_int_to_limbs(ks, 2), "cpu")
    got = fixed_base.msm(pc, table, sc, 4)
    assert pc.to_host(got) == [rc.host_mul(base_pt, k) for k in ks]


@functools.lru_cache(maxsize=None)
def te_operands():
    """8 Jubjub point pairs in extended coordinates with Z != 1 (lanes: P =
    Q, P = -Q, P = identity, Q = identity, then random), as reference
    arrays, and their host affine points."""
    rc = ref_ed.curve()
    q = rc.base.spec.modulus
    rng = random.Random("te")
    ps, qs = rc.random_host(rng, 8), rc.random_host(rng, 8)
    qs[0] = ps[0]
    qs[1] = ((q - ps[1][0]) % q, ps[1][1])
    ps[2], qs[3] = (0, 1), (0, 1)

    def extended(pts):
        zs = [rng.randrange(1, q) for _ in pts]
        cols = ([x * z % q for (x, _), z in zip(pts, zs)], [y * z % q for (_, y), z in zip(pts, zs)],
                [x * y * z % q for (x, y), z in zip(pts, zs)], zs)
        R_ = rc.base.spec.R
        return tuple(batch_int_to_limbs([v * R_ % q for v in c], 16) for c in cols)
    return extended(ps), extended(qs), ps, qs


def test_te_group_law_vs_reference():
    """double, add, neg, add_mixed on 8 lanes with planted cases, exact in
    extended coordinates against the reference's jitted laws; to_affine,
    is_on_curve, equal and is_zero against the host."""
    rc, pc = ref_ed.curve(), ed_on_bls12_381.curve("cpu")
    P_np, Q_np, ps, qs = te_operands()

    laws = jax.jit(lambda P, Q: (rc.double(P), rc.add(P, Q)))  # one compile
    want = (*laws.lower(P_np, Q_np).compile(compiler_options=FAST_COMPILE)(P_np, Q_np),
            rc.neg(P_np))
    P, Q = convert.points_from_reference(P_np, "cpu"), convert.points_from_reference(Q_np, "cpu")
    got = (pc.double(P), pc.add(P, Q), pc.neg(P))
    for g, w in zip(got, want):
        assert len(g) == 4 and all(np.array_equal(convert.to_reference(a), np.asarray(b))
                                   for a, b in zip(g, w))
    both = tuple(torch.cat([a, b], dim=1) for a, b in zip(got[1], got[0]))  # one inversion
    aff = pc.to_affine(both)
    host = list(zip(pc.base.to_int(aff[0]), pc.base.to_int(aff[1])))
    assert host == [rc.host_add(p, q) for p, q in zip(ps, qs)] + [rc.host_add(p, p) for p in ps]
    assert bool(pc.is_on_curve(aff).all())
    assert pc.equal(pc.add_mixed(P, pc.from_host(qs)), got[1]).all()
    assert pc.is_zero(got[1]).tolist() == [i == 1 for i in range(8)]
    assert pc.equal(pc.add(P, P), got[0]).all() and not pc.equal(P, Q)[4]
    assert pc.is_zero(pc.zero((2,))).all()


def test_te_scalar_mul_entry_vs_host():
    """``entry.scalar_mul`` on Jubjub (32-bit scalars, 0 among them) on 4
    lanes against the host oracle; clear_cofactor and the host subgroup
    check on points outside the subgroup (P + (0, -1), of order 2r)."""
    rc, pc = ref_ed.curve(), ed_on_bls12_381.curve("cpu")
    q = rc.base.spec.modulus
    rng = random.Random("te-mul")
    pts = rc.random_host(rng, 4)
    ks = [0] + [rng.randrange(1 << 32) for _ in range(3)]
    bases = tuple(np.asarray(a) for a in rc.from_host(pts))
    got = entry.scalar_mul(bases, batch_int_to_limbs(ks, 2), curve="ed_on_bls12_381",
                           device="cpu")
    assert pc.to_host(got) == [rc.host_mul(p, k) for p, k in zip(pts, ks)]
    off = [rc.host_add(p, (0, q - 1)) for p in pts[:2]]
    assert not any(pc.host_is_in_correct_subgroup(p) for p in off)
    assert all(pc.host_is_in_correct_subgroup(p) for p in pts)
    cleared = pc.to_host(pc.clear_cofactor(pc.from_affine(pc.from_host(off))))
    assert cleared == [rc.host_mul_raw(p, 8) for p in off]
    assert all(rc.host_is_in_correct_subgroup(p) for p in cleared)
    u, v = pc.to_montgomery_host(pts[0])
    assert (u, v) == rc.to_montgomery_host(pts[0])
    A, B = ed_on_bls12_381.MONT_COEFF_A, ed_on_bls12_381.MONT_COEFF_B
    assert (B * v * v - u * (u * u + A * u + 1)) % q == 0  # on B v^2 = u^3 + A u^2 + u


def test_entry_points_cpu_and_device_rule():
    """``batch_affine_add`` (secp256k1 with a mask, BLS12-381 G1) and
    ``fixed_base_msm`` (c = 4, 32-bit scalars) on the CPU against the host;
    without a device argument the entry points run on "cuda", and raise
    where there is no card."""
    rc, pc = ref_secp.g1(), secp256k1.g1("cpu")
    rng = random.Random("entry")
    ps, qs = rc.random_host(rng, 4), rc.random_host(rng, 4)
    qs[1], ps[2] = ps[1], None
    neg = np.asarray([False, False, False, True])
    P = tuple(np.asarray(a) for a in rc.from_host(ps))
    Q = tuple(np.asarray(a) for a in rc.from_host(qs))
    x, y, inf = entry.batch_affine_add(P, Q, neg2=neg, device="cpu")
    p = rc.base.spec.modulus
    qs_neg = [(q_[0], p - q_[1]) if m else q_ for q_, m in zip(qs, neg)]
    want = [rc.host_add(a, b) for a, b in zip(ps, qs_neg)]
    assert [None if i else pt for pt, i in zip(zip(pc.base.to_int(x), pc.base.to_int(y)),
                                              inf.tolist())] == want
    bg = ref_bls.g1()
    gp = bg.random_host(rng, 2)
    G = tuple(np.asarray(a) for a in bg.from_host(gp))
    gx, gy, gi = entry.batch_affine_add(G, G, curve="bls12_381_g1", device="cpu")
    F = bls12_381.g1("cpu").base
    assert list(zip(F.to_int(gx), F.to_int(gy))) == [bg.host_double(a) for a in gp]
    ks = [rng.randrange(1 << 32) for _ in range(3)]
    got = entry.fixed_base_msm(batch_int_to_limbs(ks, 2), 4, device="cpu")
    assert pc.to_host(got) == [rc.host_mul(rc.generator_host, k) for k in ks]
    with pytest.raises(ValueError):
        entry.batch_affine_add(P, Q, curve="bn254", device="cpu")
    if not torch.cuda.is_available():
        assert config.default_device == "cuda"
        for call in (lambda: entry.batch_affine_add(P, Q),
                     lambda: entry.scalar_mul(P, batch_int_to_limbs(ks + [1], 2)),
                     lambda: entry.fixed_base_msm(batch_int_to_limbs(ks, 2), 4)):
            with pytest.raises(RuntimeError):
                call()


@pytest.mark.cuda
def test_entry_points_on_card_vs_cpu():
    """On a CUDA device each entry point (K9/K10 and the inversion; GLV on
    K6/K7/K1; fixed-base; Jubjub on K1) equals the CPU run bit for bit: the
    same operations in the same order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")
    rc, ed = ref_secp.g1(), ref_ed.curve()
    rng = random.Random("card")
    ps, qs = rc.random_host(rng, 40), rc.random_host(rng, 40)
    qs[1], qs[2], ps[3] = ps[1], (ps[2][0], rc.base.spec.modulus - ps[2][1]), None
    P = tuple(np.asarray(a) for a in rc.from_host(ps))
    Q = tuple(np.asarray(a) for a in rc.from_host(qs))
    neg = np.asarray([rng.randrange(2) == 0 for _ in range(40)])
    ks = batch_int_to_limbs([rng.randrange(R) for _ in range(40)], 16)
    jp = ed.random_host(rng, 8)
    jb = tuple(np.asarray(a) for a in ed.from_host(jp))
    jk = batch_int_to_limbs([rng.randrange(1 << 64) for _ in range(8)], 4)
    calls = [lambda d: entry.batch_affine_add(P, Q, neg1=neg, device=d),
             lambda d: entry.scalar_mul(P, ks, device=d),
             lambda d: entry.fixed_base_msm(ks, 8, device=d),
             lambda d: entry.scalar_mul(jb, jk, curve="ed_on_bls12_381", device=d)]
    for call in calls:
        want, got = call("cpu"), call("cuda")
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
