"""The port's packed point rows (algebra_tpu_torch ``ops/rows.py``: the plain
versions of the kernels K13 pack, K14 unpack, K15 negate_y, K16
expand_units) and one halving level of the MSM's affine tree
(``ops/sw_kernels.affine_add_rows``: K11, K12 around the batched
inversion), held against the JAX package on the same seeded inputs.

The port runs on the CPU here, so the wrappers take their plain versions;
the JAX side runs ``ops/rows_pallas``'s jnp paths (Pallas off), un-jitted,
and ``SWCurve.affine_add`` jitted once at XLA's lowest optimisation level
(5 s to compile, against 20 s for its first un-jitted call, which compiles
each field operation on its own).  The port's rows are
2L + 4 words wide and the reference's 128, so rows compare through their
coordinates (each side's ``unpack``), never through padding words.
Tolerance: exact, everywhere.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algebra_tpu.bigint import batch_int_to_limbs, batch_limbs_to_int
from algebra_tpu.curves.instances import bls12_381 as ref_bls, mnt4_753 as ref_mnt
from algebra_tpu.curves.instances import secp256k1 as ref_secp
from algebra_tpu.ops import rows_pallas

from algebra_tpu_torch import convert
from algebra_tpu_torch.curves.instances import bls12_381, mnt4_753
from algebra_tpu_torch.ops import rows, sw_kernels

N = 130  # ragged: not a multiple of the reference's blocks or of 32
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}

FIELDS = {
    "bls12_381.Fr-16limb": (bls12_381.fr_spec, 36),
    "bls12_381.Fq-24limb": (bls12_381.fq_spec, 52),
    "mnt4_753.Fq-48limb": (mnt4_753.fq_spec, 100),
}


def coords(spec, seed, n=N):
    """Seeded (x, y, inf) as numpy (uint32 [L, n] twice, bool [n]): values
    below p, lane 0 with y = 0 and lane 1 with x = 0."""
    rng = random.Random(seed)
    p, L = spec.modulus, spec.n_limbs
    x = [rng.randrange(p) for _ in range(n)]
    y = [rng.randrange(p) for _ in range(n)]
    x[1], y[0] = 0, 0
    inf = np.asarray([rng.randrange(4) == 0 for _ in range(n)])
    return batch_int_to_limbs(x, L), batch_int_to_limbs(y, L), inf


def port(*arrays):
    return tuple(torch.tensor(a) if a.dtype == np.bool_
                 else convert.from_reference(a, "cpu") for a in arrays)


def assert_same_coords(got, want):
    """Port (x, y, inf) tensors equal reference (x, y, inf) arrays."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy() if g.dtype == torch.bool else convert.to_reference(g)
        assert g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("field", FIELDS)
def test_pack_unpack_vs_reference(field):
    spec, width = FIELDS[field]
    assert rows.row_width(spec) == width
    x, y, inf = coords(spec, f"pack-{field}")
    got = rows.pack(spec, *port(x, y, inf))
    assert got.shape == (N, width) and got.dtype == torch.int32
    assert not got[:, 2 * spec.n_limbs + 1 :].any()  # padding words are zero
    want = rows_pallas.pack(spec, jnp.asarray(x), jnp.asarray(y), jnp.asarray(inf))
    assert_same_coords(rows.unpack(spec, got), rows_pallas.unpack(spec, want))
    assert_same_coords(rows.unpack(spec, got), (x, y, inf))
    # the reference's rows, cut to the port's width, unpack to the same points
    cut = convert.from_reference(np.asarray(want)[:, :width], "cpu")
    assert_same_coords(rows.unpack(spec, cut), (x, y, inf))


@pytest.mark.parametrize("field", FIELDS)
def test_negate_y_vs_reference(field):
    """y := p - y where masked (lane 0 has y = 0 and is masked: it stays 0)."""
    spec, _ = FIELDS[field]
    x, y, inf = coords(spec, f"neg-{field}")
    neg = np.arange(N) % 3 != 1
    got = rows.negate_y(spec, rows.pack(spec, *port(x, y, inf)), torch.from_numpy(neg))
    ref_rows = rows_pallas.pack(spec, jnp.asarray(x), jnp.asarray(y), jnp.asarray(inf))
    want = rows_pallas.negate_y(spec, ref_rows, jnp.asarray(neg))
    assert_same_coords(rows.unpack(spec, got), rows_pallas.unpack(spec, want))
    gy = convert.to_reference(rows.unpack(spec, got)[1])
    assert not gy[:, 0].any()
    p = spec.modulus
    yi = [int.from_bytes(c.astype("<u2").tobytes(), "little") for c in y.T]
    gi = [int.from_bytes(c.astype("<u2").tobytes(), "little") for c in gy.T]
    assert gi == [(p - v) % p if s else v for v, s in zip(yi, neg)]


@pytest.mark.parametrize("U", [1, 2, 8, 16])
@pytest.mark.parametrize("field", FIELDS)
def test_expand_units_vs_reference(field, U):
    """Units of U rows from random starts, the last unit ending at the last
    row of src, against the reference's jnp gather and a numpy gather; a
    row index out of range is clipped to [0, S - 1], so a unit that starts
    on the last row keeps that row first."""
    spec, width = FIELDS[field]
    rng = np.random.default_rng(U * 1000 + spec.n_limbs)
    S = 3 * N + 1
    src_np = rng.integers(0, 2**31, (S, width), dtype=np.int64).astype(np.uint32)
    us = rng.integers(0, S - U + 1, 97)
    us[-1] = S - U
    got = rows.expand_units(convert.from_reference(src_np, "cpu"), torch.from_numpy(us), U)
    idx = (us[:, None] + np.arange(U)[None, :]).reshape(-1)
    assert np.array_equal(convert.to_reference(got), src_np[idx])
    ref_src = np.zeros((S, 128), np.uint32)
    ref_src[:, :width] = src_np
    want = rows_pallas.expand_units(jnp.asarray(ref_src), jnp.asarray(us, jnp.int32), U)
    assert np.array_equal(convert.to_reference(got), np.asarray(want)[:, :width])
    wild = torch.tensor([-5, S, S - U + 1, S - 1, 0])
    got = rows.expand_units(convert.from_reference(src_np, "cpu"), wild, U)
    idx = np.clip(wild.numpy()[:, None] + np.arange(U), 0, S - 1).reshape(-1)
    assert np.array_equal(convert.to_reference(got), src_np[idx])
    assert np.array_equal(convert.to_reference(got)[3 * U], src_np[S - 1])


def planted_pairs(curve, seed: str, n_rows: int, pool_size: int = 32):
    """Host points for n_rows row slots, pairs (2i, 2i + 1) planted: P + inf,
    inf + P, inf + inf, P + P (a tangent; also a run of 32 of them from pair
    40), P + (-P), and for a = 0 a P + Q with equal y (Q = (w x, y), w a
    cube root of one); then random pairs, some with a repeated point."""
    rng = random.Random(seed)
    pool = curve.random_host(rng, pool_size)
    p = curve.base.spec.modulus
    out = []
    for i in range(n_rows // 2):
        P, Q = pool[rng.randrange(pool_size)], pool[rng.randrange(pool_size)]
        kind = i if i < 6 else (3 if 40 <= i < 72 else 6 + rng.randrange(4))
        if kind == 0:
            Q = None
        elif kind == 1:
            P = None
        elif kind == 2:
            P = Q = None
        elif kind == 3:
            Q = P
        elif kind == 4:
            Q = (P[0], (p - P[1]) % p)
        elif kind == 5 and int(curve.a_host) == 0:
            w = 1
            while w == 1:
                w = pow(rng.randrange(2, p), (p - 1) // 3, p)
            Q = (P[0] * w % p, P[1])
        elif kind == 6:
            Q = pool[3]
            P = pool[3] if rng.random() < 0.5 else P
        out += [P, Q]
    return out


def host_inverse(spec, den: torch.Tensor) -> torch.Tensor:
    """Inverses of a Montgomery-form [L, m] batch by host big integers, zero
    to zero: the inversion a level takes as ``inv_fn`` (the port's own,
    ``mont.batch_inverse``, is held against the reference in its tests and
    costs a ladder of ~570 plain products here)."""
    p, r2 = spec.modulus, spec.R * spec.R % spec.modulus
    vals = batch_limbs_to_int(convert.to_reference(den))
    inv = [r2 * pow(int(v), -1, p) % p if v else 0 for v in vals]
    return convert.from_reference(batch_int_to_limbs(inv, spec.n_limbs), "cpu")


def level_rows(ref_curve, spec, pts, with_valid, seed):
    """The packed rows of ``pts`` (from the reference's own conversion), the
    reference's affine arrays, and a seeded valid mask (1 in 5 invalid)."""
    x, y, inf = (np.asarray(a) for a in ref_curve.from_host(pts))
    rng = random.Random(seed)
    valid = np.asarray([rng.random() > 0.2 for _ in pts]) if with_valid else None
    V = rows.pack(spec, *port(x, y, inf))
    return V, (torch.from_numpy(valid) if with_valid else None), (x, y, inf), valid


REF_CURVES = {"bls12_381_g1": ref_bls.g1, "secp256k1": ref_secp.g1}


@functools.lru_cache(maxsize=None)
def ref_affine_add(name: str):
    """The reference's ``affine_add`` of one curve on [L, 128] batches with
    both y-negation masks, compiled once: called with (P, Q) it returns
    (x3, y3, inf3, its denominators), the inverses taken as ones and no
    mask set; called with the denominators' inverses (and masks) as well
    it returns the sum that those give."""
    curve = REF_CURVES[name]()
    spec = curve.base.spec
    shape = jax.ShapeDtypeStruct((spec.n_limbs, 128), jnp.uint32)
    flag = jax.ShapeDtypeStruct((128,), jnp.bool_)
    pt = (shape, shape, flag)

    def run(P, Q, inv, neg1, neg2):
        seen = []

        def inv_fn(den):
            seen.append(den)
            return inv
        return (*curve.affine_add(P, Q, inv_fn, neg1=neg1, neg2=neg2), seen[0])

    ones = jnp.asarray(np.tile(spec.one_mont_limbs.astype(np.uint32)[:, None], (1, 128)))
    none = np.zeros(128, np.bool_)
    fn = jax.jit(run).lower(pt, pt, shape, flag, flag).compile(compiler_options=FAST_COMPILE)
    return lambda P, Q, inv=ones, neg1=none, neg2=none: fn(P, Q, jnp.asarray(inv), neg1, neg2)


@pytest.mark.parametrize("with_valid", [True, False])
def test_affine_add_rows_vs_reference(with_valid):
    """BLS12-381 G1 (a = 0), 256 rows: infinity on either side and both,
    tangents (a lane and a run of 32), opposite points, equal y, repeated
    points, invalid slots.  The oracle is the reference's ``affine_add``
    over the unpacked even/odd halves with the valid masks OR-ed into the
    flags.  The reference's denominators come out of its inversion hook and
    are inverted on the host; the port's level must ask for the same
    denominators, and gets the same inverses.  Exact on x, y, inf and the
    denominators."""
    spec = bls12_381.fq_spec
    pts = planted_pairs(ref_bls.g1(), "level-g1", 256)
    V, valid_t, (x, y, inf), valid = level_rows(ref_bls.g1(), spec, pts, with_valid,
                                                "valid")
    seen = {}
    halves = []
    for par in (0, 1):
        i = jnp.asarray(inf[par::2])
        if with_valid:
            i = i | ~jnp.asarray(valid[par::2])
        halves.append((jnp.asarray(x[:, par::2]), jnp.asarray(y[:, par::2]), i))
    want = ref_affine_add("bls12_381_g1")(*halves)
    seen["den"] = convert.from_reference(np.asarray(want[3]), "cpu")
    seen["inv"] = host_inverse(spec, seen["den"])
    want = ref_affine_add("bls12_381_g1")(*halves, convert.to_reference(seen["inv"]))[:3]

    def port_inv(den):
        assert torch.equal(den, seen["den"])
        return seen["inv"]

    out = sw_kernels.affine_add_rows(spec, None, V, valid_t, port_inv)
    assert out.shape == (128, rows.row_width(spec))
    assert_same_coords(rows.unpack(spec, out), want)
    if not with_valid:
        wi = np.asarray(want[2])
        assert wi[2] and wi[4] and not wi[3]  # inf + inf, P + (-P); P + P is finite


def test_affine_add_rows_a_nonzero_vs_host():
    """MNT4-753 G1 (a = 2, 48 limbs): the tangent's 3 x^2 + a, 64 rows with
    invalid slots, against the reference's host group law pair by pair.
    The results compare as points: the flag, and x, y where it is clear."""
    ref_curve, spec = ref_mnt.g1(), mnt4_753.fq_spec
    a_mont = tuple(int(v) for v in batch_int_to_limbs(
        [ref_curve.a_host * spec.R % spec.modulus], spec.n_limbs)[:, 0])
    pts = planted_pairs(ref_curve, "level-mnt4", 64, pool_size=6)
    V, valid_t, _, valid = level_rows(ref_curve, spec, pts, True, "valid-mnt4")
    live = [p if ok else None for p, ok in zip(pts, valid)]
    want = [ref_curve.host_add(P, Q) for P, Q in zip(live[0::2], live[1::2])]
    wx, wy, wi = (np.asarray(a) for a in ref_curve.from_host(want))
    out = sw_kernels.affine_add_rows(spec, a_mont, V, valid_t,
                                     lambda d: host_inverse(spec, d))
    gx, gy, gi = rows.unpack(spec, out)
    assert np.array_equal(gi.numpy(), wi) and wi.any() and not wi.all()
    fin = ~wi
    assert np.array_equal(convert.to_reference(gx)[:, fin], wx[:, fin])
    assert np.array_equal(convert.to_reference(gy)[:, fin], wy[:, fin])


def test_row_functions_check_their_operands():
    spec = bls12_381.fq_spec
    x, y, inf = port(*coords(spec, "checks", 8))
    with pytest.raises(ValueError):
        rows.pack(spec, x, y, inf.to(torch.int32))
    with pytest.raises(ValueError):
        rows.unpack(spec, torch.zeros((8, 36), dtype=torch.int32))
    with pytest.raises(ValueError):
        rows.expand_units(torch.zeros((4, 52), dtype=torch.int32),
                          torch.zeros(2, dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        sw_kernels.affr_denom(spec, torch.zeros((3, 52), dtype=torch.int32))
