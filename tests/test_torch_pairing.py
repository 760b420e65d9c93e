"""The port's BLS12-381 pairing (``pairing/common.py``, ``pairing/bls12.py``,
``pairing/gt.py``, the entry points ``entry.pairing``, ``multi_pairing``
and ``prepare_g2``) held against the JAX package, a pinned value and the
host Fq12 tower, on the CPU (every tower product through K17's plain
version).

The JAX side is ``bls12_381.pairing().pairing`` compiled once at XLA's
lowest optimisation level on the same 2 lanes, (g1, g2) and (a g1, g2),
inside ``test_pairing_vs_reference`` alone, so that one xdist worker pays
for it; the port's pairing must give the same Montgomery words.  e(g1, g2)
must also equal the pinned value below.  The multi-pairing, the lanes at
infinity, the prepared path and GT's group operations are then checked
against those two lanes and the host tower, with no further JAX compile
(a JAX GT exponentiation would be one of the costliest compiles of the
suite).  Every comparison is exact (tolerance 0).
"""

import jax
import numpy as np
import pytest
import torch

from algebra_tpu.curves.instances import bls12_381 as ref_bls

from algebra_tpu_torch import convert, entry
from algebra_tpu_torch.bigint import batch_int_to_limbs
from algebra_tpu_torch.curves.instances import bls12_381
from algebra_tpu_torch.fields.host_tower import HostCubicExt, HostQuadExt
from algebra_tpu_torch.pairing.gt import GTGroup

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}

# e(g1, g2) over BLS12-381, canonical Fq coordinates in the order
# ((c0.c0, c0.c1), (c1.c0, c1.c1), (c2.c0, c2.c1)) of Fq12's c0 then c1:
# computed by the JAX package (algebra_tpu.curves.instances.bls12_381
# .pairing().pairing on the two generators, on the CPU).
GT_G1_G2 = (
    ((0x1250EBD871FC0A92A7B2D83168D0D727272D441BEFA15C503DD8E90CE98DB3E7B6D194F60839C508A84305AACA1789B6,
      0x089A1C5B46E5110B86750EC6A532348868A84045483C92B7AF5AF689452EAFABF1A8943E50439F1D59882A98EAA0170F),
     (0x1368BB445C7C2D209703F239689CE34C0378A68E72A6B3B216DA0E22A5031B54DDFF57309396B38C881C4C849EC23E87,
      0x193502B86EDB8857C273FA075A50512937E0794E1E65A7617C90D8BD66065B1FFFE51D7A579973B1315021EC3C19934F),
     (0x01B2F522473D171391125BA84DC4007CFBF2F8DA752F7C74185203FCCA589AC719C34DFFBBAAD8431DAD1C1FB597AAA5,
      0x018107154F25A764BD3C79937A45B84546DA634B8F6BE14A8061E55CCEBA478B23F7DACAA35C8CA78BEAE9624045B4B6)),
    ((0x19F26337D205FB469CD6BD15C3D5A04DC88784FBB3D0B2DBDEA54D43B2B73F2CBB12D58386A8703E0F948226E47EE89D,
      0x06FBA23EB7C5AF0D9F80940CA771B6FFD5857BAAF222EB95A7D2809D61BFE02E1BFD1B68FF02F0B8102AE1C2D5D5AB1A),
     (0x11B8B424CD48BF38FCEF68083B0B0EC5C81A93B330EE1A677D0D15FF7B984E8978EF48881E32FAC91B93B47333E2BA57,
      0x03350F55A7AEFCD3C31B4FCB6CE5771CC6A0E9786AB5973320C806AD360829107BA810C5A09FFDD9BE2291A0C25A99A2),
     (0x04C581234D086A9902249B64728FFD21A189E87935A954051C7CDBA7B3872629A4FAFC05066245CB9108F0242D0FE3EF,
      0x0F41E58663BF08CF068672CBD01A7EC73BACA4D72CA93544DEFF686BFD6DF543D48EAA24AFE47E1EFDE449383B676631)),
)

H6 = HostCubicExt(bls12_381.host_fq2, bls12_381.FQ6_NONRESIDUE)
H12 = HostQuadExt(H6, ((0, 0), (1, 0), (0, 0)))
A = 0x2B1E_0D51  # the scalar of lane 1


@pytest.fixture(scope="module")
def two_lanes():
    """(host G1 points, host G2 points, the port's pairing as host ints,
    the port's raw tensors)."""
    g1, g2 = bls12_381.g1("cpu"), bls12_381.g2("cpu")
    P, Q = g1.generator_host, g2.generator_host
    ps, qs = [P, g1.host_mul(P, A)], [Q, Q]
    got = entry.pairing(ps, qs, device="cpu")
    return ps, qs, bls12_381.fq12("cpu").to_int(got), got


def _same(got, want) -> bool:
    if isinstance(want, tuple):
        return all(_same(g, w) for g, w in zip(got, want))
    return np.array_equal(convert.to_reference(got), want)


def test_pairing_vs_reference(two_lanes):
    """The file's one JAX compile: the reference's pairing on the same two
    lanes, word for word."""
    ps, qs, _, got = two_lanes
    rg1, rg2 = ref_bls.g1(), ref_bls.g2()
    rp, rq = rg1.from_host(ps), rg2.from_host(qs)
    ref_fn = jax.jit(ref_bls.pairing().pairing).lower(rp, rq).compile(FAST_COMPILE)
    ref_e = convert.tower_to_reference(convert.tower_from_reference(ref_fn(rp, rq), "cpu"))
    assert _same(got, ref_e)


def test_pairing_of_generators_is_pinned(two_lanes):
    _, _, e, _ = two_lanes
    assert e[0] == GT_G1_G2
    assert not H12.equal(e[0], H12.one())
    assert H12.pow(e[0], bls12_381.R) == H12.one()  # an element of order r
    assert e[1] == H12.pow(e[0], A)  # e(a g1, g2) = e(g1, g2)^a


def test_entry_takes_reference_arrays(two_lanes):
    """The same pairs as the reference's affine triples."""
    ps, qs, e, _ = two_lanes
    p = convert.points_to_reference(bls12_381.g1("cpu").from_host(ps[:1]))
    q = convert.points_to_reference(bls12_381.g2("cpu").from_host(qs[:1]))
    assert bls12_381.fq12("cpu").to_int(entry.pairing(p, q, device="cpu")) == e[:1]


def test_multi_pairing(two_lanes):
    """e(g1, g2) e(-g1, g2) e(a g1, g2) through one final exponentiation:
    the pair and its negation cancel, the product is lane 1's pairing."""
    ps, qs, e, _ = two_lanes
    g1 = bls12_381.g1("cpu")
    neg = (ps[0][0], bls12_381.P - ps[0][1])
    got = entry.multi_pairing([ps[0], neg, ps[1]], [qs[0]] * 3, device="cpu")
    assert bls12_381.fq12("cpu").to_int(got) == e[1]
    assert g1.host_add(ps[0], neg) is None


def test_prepared_path_and_infinity(two_lanes):
    """pairing(p, prepare_g2(q)) equals the unprepared lanes, and a lane
    with either point at infinity gives 1."""
    ps, qs, e, _ = two_lanes
    prepared = entry.prepare_g2(qs + [qs[0], None], device="cpu")
    got = entry.pairing(ps + [None, ps[0]], prepared, device="cpu")
    one = H12.one()
    assert bls12_381.fq12("cpu").to_int(got) == [e[0], e[1], one, one]


def test_entry_device_rule():
    """The pairing entry points run on the default device ("cuda") unless
    asked, and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g1, g2 = bls12_381.g1("cpu"), bls12_381.g2("cpu")
    for fn in (entry.pairing, entry.multi_pairing):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn([g1.generator_host], [g2.generator_host])
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.prepare_g2([g2.generator_host])


def test_gt_group_vs_host_tower(two_lanes):
    """GTGroup over the two pairing values: add (the product), neg (the
    conjugate, the inverse there), double, zero, mul_int, per-lane
    scalar_mul and msm against host Fq12 powers."""
    _, _, e, got = two_lanes
    F12 = bls12_381.fq12("cpu")
    gt = GTGroup(F12, bls12_381.R)
    g0 = gt.index(got, slice(0, 1))
    g1 = gt.index(got, slice(1, 2))
    assert F12.to_int(gt.add(g0, g1)) == [H12.mul(e[0], e[1])]
    assert F12.to_int(gt.neg(g0)) == [H12.inv(e[0])]
    assert F12.to_int(gt.double(g0)) == [H12.mul(e[0], e[0])]
    assert gt.is_zero(gt.sub(g0, g0)).tolist() == [True]
    assert gt.is_zero(gt.zero((2,))).tolist() == [True, True]
    assert F12.to_int(gt.mul_int(g0, 77)) == [H12.pow(e[0], 77)]
    ks = [0xBEEF, 0x1234_5678]
    sc = convert.from_reference(batch_int_to_limbs(ks, 2), "cpu")
    assert F12.to_int(gt.scalar_mul(got, sc)) == [H12.pow(v, k) for v, k in zip(e, ks)]
    want = H12.mul(H12.pow(e[0], ks[0]), H12.pow(e[1], ks[1]))
    assert F12.to_int(gt.msm(got, sc)) == want
    swapped = gt.select(torch.tensor([True, False]), gt.neg(got), got)
    assert F12.to_int(swapped) == [H12.inv(e[0]), e[1]]
