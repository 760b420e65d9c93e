"""The port's batched affine addition on coordinate arrays
(algebra_tpu_torch ``SWCurve.affine_add``: the plain versions of the kernels
K9 ``aff_denom`` and K10 ``aff_post`` in ``ops/sw_kernels.py``, around an
inversion), and the plain field ops of secp256k1, whose p and r use all 256
bits, held against the JAX package on the same seeded inputs.

The port runs on the CPU here, so the wrappers take their plain versions.
The JAX side is the reference's ``SWCurve.affine_add`` on its jnp path
(Pallas off), with both y-negation masks, jitted once a curve at XLA's
lowest optimisation level (``test_torch_rows.ref_affine_add``); without
masks the port is called with none and the reference with masks that are
all false.  The pairs are those of
``test_torch_rows.planted_pairs``: infinity on either side and both,
tangents (a lane and a run of 32), opposite points, equal y, repeated
points.  The reference's inversion hook gives its denominators, which are
inverted on the host; the port must ask for the same denominators once,
and gets the same inverses.  MNT4-753 (a = 2) has no JAX curve compiled
here: it is held against the host group law.  Tolerance: exact,
everywhere.
"""

import functools
import random

import jax
import numpy as np
import pytest
import torch

from algebra_tpu.bigint import batch_int_to_limbs as ref_limbs
from algebra_tpu.curves.instances import mnt4_753 as ref_mnt, secp256k1 as ref_secp
from algebra_tpu.ops import mont as ref_mont

from algebra_tpu_torch import convert
from algebra_tpu_torch.curves.instances import bls12_381, mnt4_753, secp256k1
from algebra_tpu_torch.curves.sw import SWCurve
from algebra_tpu_torch.ops import mont, sw_kernels as swk

from test_torch_rows import (FAST_COMPILE, REF_CURVES, assert_same_coords, host_inverse,
                             planted_pairs, ref_affine_add)

N = 128  # pairs

CURVES = {"bls12_381_g1": bls12_381.g1, "secp256k1": secp256k1.g1}


@functools.lru_cache(maxsize=None)
def operands(ref_curve, seed: str, n_pairs: int, pool_size: int = 16):
    """The planted pairs as reference arrays P, Q (x, y, inf) and seeded
    negation masks (about one lane in three)."""
    pts = planted_pairs(ref_curve, seed, 2 * n_pairs, pool_size)
    x, y, inf = (np.asarray(a) for a in ref_curve.from_host(pts))
    P, Q = ((x[:, k::2], y[:, k::2], inf[k::2]) for k in (0, 1))
    rng = random.Random(seed + "-neg")
    negs = [np.asarray([rng.randrange(3) == 0 for _ in range(n_pairs)]) for _ in range(2)]
    return pts, P, Q, negs


def to_port(pt):
    return convert.points_from_reference(pt, "cpu")


@pytest.mark.parametrize("masks", [False, True], ids=["no_masks", "masks"])
@pytest.mark.parametrize("name", CURVES)
def test_affine_add_vs_reference(name, masks):
    rc, pc = REF_CURVES[name](), CURVES[name]("cpu")
    spec = pc.base.spec
    _, P, Q, negs = operands(rc, f"aff-{name}", N)
    if not masks:
        negs = [np.zeros(N, bool)] * 2
    ref = ref_affine_add(name)
    den = convert.from_reference(np.asarray(ref(P, Q, neg1=negs[0], neg2=negs[1])[3]), "cpu")
    inv = host_inverse(spec, den)
    want = ref(P, Q, convert.to_reference(inv), *negs)[:3]

    calls = []

    def inv_fn(d):
        calls.append(d)
        assert torch.equal(d, den)
        return inv

    port_negs = [torch.from_numpy(m) for m in negs] if masks else [None, None]
    got = pc.affine_add(to_port(P), to_port(Q), inv_fn, *port_negs)
    assert len(calls) == 1
    assert_same_coords(got, want)
    wi = np.asarray(want[2])
    assert wi.any() and not wi.all()


@pytest.mark.parametrize("masks", [False, True], ids=["no_masks", "masks"])
def test_affine_add_a_nonzero_vs_host(masks):
    """MNT4-753 G1 (a = 2, 48 limbs): the tangent's 3 x^2 + a, against the
    reference's host group law pair by pair (y negated on the host where
    masked).  The results compare as points: the flag, and x, y where it
    is clear."""
    rc = ref_mnt.g1()
    spec = mnt4_753.fq_spec
    pc = SWCurve(mnt4_753.Fq.to("cpu"), a_host=rc.a_host, b_host=rc.b_host,
                 generator_host=rc.generator_host, cofactor=rc.cofactor,
                 scalar_modulus=rc.scalar_modulus, name="mnt4_753.G1")
    pts, P, Q, negs = operands(rc, "aff-mnt4", 32, pool_size=6)
    if not masks:
        negs = [np.zeros(32, bool)] * 2
    p = spec.modulus
    flip = lambda pt, m: pt if pt is None or not m else (pt[0], (p - pt[1]) % p)  # noqa: E731
    want = [rc.host_add(flip(a, m1), flip(b, m2))
            for a, b, m1, m2 in zip(pts[0::2], pts[1::2], *negs)]
    wx, wy, wi = (np.asarray(a) for a in rc.from_host(want))
    port_negs = [torch.from_numpy(m) for m in negs] if masks else [None, None]
    gx, gy, gi = pc.affine_add(to_port(P), to_port(Q), lambda d: host_inverse(spec, d),
                               *port_negs)
    assert np.array_equal(gi.numpy(), wi) and wi.any() and not wi.all()
    fin = ~wi
    assert np.array_equal(convert.to_reference(gx)[:, fin], wx[:, fin])
    assert np.array_equal(convert.to_reference(gy)[:, fin], wy[:, fin])


def test_affine_add_batch_shapes_and_broadcast():
    """A [4, 8] batch, Q one point broadcast over it, and a mask of shape
    [8]: the same sums as the flat batch, lane by lane."""
    pc = secp256k1.g1("cpu")
    rc = ref_secp.g1()
    pts = planted_pairs(rc, "aff-shapes", 66, pool_size=8)[:33]
    aff = pc.from_host(pts)
    P = tuple(c[..., :32].reshape(c.shape[:-1] + (4, 8)) for c in aff)
    Q = tuple(c[..., 32] for c in aff)  # batch ()
    neg = torch.tensor([True, False] * 4)
    inv_fn = lambda d: host_inverse(pc.base.spec, d.reshape(16, -1)).reshape(d.shape)  # noqa: E731
    x3, y3, i3 = pc.affine_add(P, Q, inv_fn, neg1=neg)
    assert x3.shape == (16, 4, 8) and i3.shape == (4, 8)
    flat = tuple(c[..., :32] for c in aff)
    Qf = tuple(c.unsqueeze(-1).expand(c.shape + (32,)) for c in Q)
    want = pc.affine_add(flat, Qf, inv_fn, neg1=neg.repeat(4))
    for g, w in zip((x3, y3, i3), want):
        assert torch.equal(g.reshape(w.shape), w)


@pytest.mark.cuda
def test_aff_kernels_on_card_2d_broadcast():
    """On a CUDA device: K9 and K10 on a [16, 16] batch from P [L, 1, 16],
    Q [L, 16, 1] and masks [16, 1], [1, 16], whose batch axes do not
    collapse to one stride, so that the wrappers copy every operand; bit
    for bit the CPU run (the plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")
    spec = secp256k1.fq_spec
    _, P, Q, negs = operands(ref_secp.g1(), "aff-card", 16)

    def run(device):
        Pd = tuple(t[..., None, :] for t in to_port(P))
        Qd = tuple(t[..., :, None] for t in to_port(Q))
        n1, n2 = (torch.from_numpy(negs[0])[:, None], torch.from_numpy(negs[1])[None, :])
        Pd, Qd = (tuple(t.to(device) for t in X) for X in (Pd, Qd))
        n1, n2 = n1.to(device), n2.to(device)
        den = swk.aff_denom(spec, Pd, Qd, n1, n2)
        inv = host_inverse(spec, den.cpu().reshape(16, -1)).reshape(den.shape).to(device)
        return (den, *swk.aff_post(spec, None, Pd, Qd, inv, n1, n2))

    want, got = run("cpu"), run("cuda")
    assert got[0].shape == (16, 16, 16) and got[3].shape == (16, 16)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_affine_add_checks_its_operands():
    spec = secp256k1.fq_spec
    x = torch.zeros((16, 4), dtype=torch.int32)
    inf = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        swk.aff_denom(spec, (x, x, inf.int()), (x, x, inf))
    with pytest.raises(ValueError):
        swk.aff_denom(spec, (x[:8], x, inf), (x, x, inf))
    with pytest.raises(ValueError):
        swk.aff_post(spec, None, (x, x, inf), (x, x, inf), x[:, :3])


def test_secp256k1_field_ops_near_p():
    """secp256k1's Fq and Fr fill all 256 bits: add, sub, neg, mul, square
    of the plain field ops on planted values near the modulus (0, 1, p - 1,
    p - 2, R mod p and its neighbours, 2^255) crossed with each other,
    against the reference's jnp ops (one compile for both fields) and the
    host."""
    pairs = ((ref_secp.fq_spec, secp256k1.fq_spec), (ref_secp.fr_spec, secp256k1.fr_spec))
    operands = []
    for _, spec in pairs:
        p = spec.modulus
        r_mod = spec.R % p
        vals = [0, 1, 2, p - 1, p - 2, r_mod, r_mod - 1, r_mod + 1, p - r_mod, 1 << 255]
        a = [u for u in vals for _ in vals]
        b = [v for _ in vals for v in vals]
        operands.append((a, b, ref_limbs(a, 16), ref_limbs(b, 16)))

    def ref_ops(xy):
        return [(ref_mont.add(s, x, y), ref_mont.sub(s, x, y), ref_mont.neg(s, x),
                 ref_mont.mul(s, x, y), ref_mont.square(s, x))
                for (s, _), (x, y) in zip(pairs, xy)]

    xy = [(A, B) for _, _, A, B in operands]
    wants = jax.jit(ref_ops).lower(xy).compile(compiler_options=FAST_COMPILE)(xy)
    for (_, spec), (a, b, A, B), want in zip(pairs, operands, wants):
        p = spec.modulus
        ta, tb = convert.from_reference(A, "cpu"), convert.from_reference(B, "cpu")
        got = (mont.add(spec, ta, tb), mont.sub(spec, ta, tb), mont.neg(spec, ta),
               mont.mul(spec, ta, tb), mont.square(spec, ta))
        for g, w in zip(got, want):
            assert np.array_equal(convert.to_reference(g), np.asarray(w))
        r_inv = pow(spec.R, -1, p)
        prods = [int(v) for v in convert.to_reference(got[3]).astype(object).T.dot(
            [1 << (16 * i) for i in range(16)])]
        assert prods == [u * v * r_inv % p for u, v in zip(a, b)]
