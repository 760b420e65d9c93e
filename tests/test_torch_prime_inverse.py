"""The port's blocked batched inversion (algebra_tpu_torch.ops.mont_kernels
``batch_inverse`` and its three kernels' plain versions, ``ops.mont``,
``PrimeField.inverse``) and the rest of the prime-field surface (``sqrt``,
``legendre``, ``from_*_bytes_mod_order``) held bit-exact against the JAX
package on the same seeded inputs.

The port runs on the CPU here, so every wrapper takes its kernel's plain
version; the JAX side runs its Pallas kernels in interpret mode and its jnp
scan.  Outputs are canonical integers: every comparison is exact (tolerance
0).  A host big-integer oracle (``pow(x, -1, p)``) stands beside the JAX
values; MNT4-753 Fq and a modulus with no spare top bit are held against the
oracle alone.  Each JAX value costs a compile, so the Pallas reference is
built for Fr (the field of the division path) and the scan for Fq, on a
short scan axis.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algebra_tpu import config as ref_config
from algebra_tpu.curves.instances import bls12_381 as ref_bls
from algebra_tpu.ops import mont as ref_mont, mont_pallas as ref_pallas

from algebra_tpu_torch import config, convert
from algebra_tpu_torch.bigint import batch_int_to_limbs, batch_limbs_to_int
from algebra_tpu_torch.curves.instances import bls12_381, mnt4_753
from algebra_tpu_torch.fields.spec import field_spec
from algebra_tpu_torch.ops import mont, mont_kernels as mk

REF_FIELDS = {
    "bls12_381.Fr": (ref_bls.Fr, bls12_381.Fr.to("cpu")),
    "bls12_381.Fq": (ref_bls.Fq, bls12_381.Fq.to("cpu")),
}
SPECS = {
    "bls12_381.Fr": bls12_381.fr_spec,
    "bls12_381.Fq": bls12_381.fq_spec,
    "mnt4_753.Fq": mnt4_753.fq_spec,
    "full_width_256": field_spec(2**256 - 189, name="full_width_256"),
}


def seeded(spec, n, tag, zeros=()):
    """n Montgomery-form values of the field as (host ints, uint32 limbs)."""
    rng = random.Random(f"inverse-{spec.name}-{tag}")
    vals = [rng.randrange(1, spec.modulus) for _ in range(n)]
    for i in zeros:
        vals[i] = 0
    return vals, batch_int_to_limbs(vals, spec.n_limbs)


def host_inverse(spec, vals):
    """Montgomery-form inverses of Montgomery-form host ints; zero to zero."""
    p = spec.modulus
    r_inv = pow(spec.R, -1, p)
    return [pow(x * r_inv % p, -1, p) * spec.R % p if x else 0 for x in vals]


def ints(t):
    return batch_limbs_to_int(convert.to_reference(t))


def same(port_tensor, ref_array):
    got = convert.to_reference(port_tensor)
    return got.dtype == np.uint32 and np.array_equal(got, np.asarray(ref_array))


@pytest.fixture
def interpret():
    """Pallas interpret mode on for the body, restored afterwards."""
    ref_config.pallas_interpret = True
    try:
        yield
    finally:
        ref_config.pallas_interpret = False


@pytest.mark.parametrize("name,n", [
    (name, n) for name in SPECS for n in (1, 129, 260)
    if n == 260 or name != "mnt4_753.Fq"])  # 48 limbs: one size is enough here
def test_batch_inverse_vs_host_oracle(name, n):
    spec = SPECS[name]
    vals, a_np = seeded(spec, n, f"oracle-{n}", zeros=(n // 2,) if n > 1 else ())
    a = convert.from_reference(a_np, "cpu")
    want = host_inverse(spec, vals)
    assert ints(mk.batch_inverse(spec, a, group=5, bottom=7)) == want
    if n == 129:  # the per-element ladder alone
        assert ints(mk.batch_inverse(spec, a)) == want
        assert mk.level_plan(n) == []


@pytest.mark.parametrize("name", ["bls12_381.Fr", "full_width_256"])
def test_single_plain_kernels_vs_host(name):
    """Prefix, ladder and backward kernels' plain versions, each against a
    host-int loop: 23 elements as 4 rows of 6 columns, the last row ragged,
    with a zero in the first row, in the middle and at the end."""
    spec = SPECS[name]
    p = spec.modulus
    r_inv = pow(spec.R, -1, p)
    n, group, m = 23, 4, 6
    vals, a_np = seeded(spec, n, "single", zeros=(2, 9, 22))
    a = convert.from_reference(a_np, "cpu")

    def mont_prod(x, y):
        return x * y * r_inv % p

    one = spec.R % p
    safe = [v or one for v in vals]
    want_pref, want_tails = list(safe), []
    for j in range(m):
        for i in range(1, group):
            if i * m + j < n:
                want_pref[i * m + j] = mont_prod(want_pref[(i - 1) * m + j], safe[i * m + j])
        want_tails.append(want_pref[max(i * m + j for i in range(group) if i * m + j < n)])
    pref, tails = mk.inv_prefix(spec, a, group)
    assert tuple(pref.shape) == (spec.n_limbs, n) and tuple(tails.shape) == (spec.n_limbs, m)
    assert ints(pref) == want_pref and ints(tails) == want_tails

    tinv = mk.inv_fermat(spec, tails)
    assert ints(tinv) == host_inverse(spec, want_tails)
    cube = [mont_prod(mont_prod(v, v), v) for v in vals]
    assert ints(mk.inv_fermat(spec, a, 3)) == cube
    assert torch.equal(mk.inv_fermat(spec, a, 2), mk.mul(spec, a, a))
    assert torch.equal(mk.inv_fermat(spec, a, 1), a)

    out = mk.inv_backward(spec, a, pref, tinv, group)
    assert ints(out) == host_inverse(spec, vals)


def test_level_plan():
    assert mk.level_plan(1 << 24) == [(1 << 24, 32, 1 << 19), (1 << 19, 32, 1 << 14)]
    assert mk.level_plan(mk.INV_BOTTOM) == []
    assert mk.level_plan(mk.INV_BOTTOM + 1) == [(mk.INV_BOTTOM + 1, 2, mk.INV_BOTTOM // 2 + 1)]
    for n in (2, 9, 260, 4097, (1 << 16) + 3):
        width = n
        for elements, rows, cols in mk.level_plan(n, 4, 8):
            assert elements == width and 2 <= rows <= 4 and cols == -(-width // rows)
            width = cols
        assert 1 <= width <= 8
    with pytest.raises(ValueError):
        mk.level_plan(100, group=1)


def test_wrappers_refuse_bad_operands():
    spec = SPECS["bls12_381.Fr"]
    _, a_np = seeded(spec, 12, "refuse")
    a = convert.from_reference(a_np, "cpu")
    pref, tails = mk.inv_prefix(spec, a, 4)
    with pytest.raises(ValueError):
        mk.inv_backward(spec, a, pref, tails[:, :2], 4)
    with pytest.raises(ValueError):
        mk.inv_prefix(spec, a.reshape(16, 3, 4), 4)
    with pytest.raises(ValueError):
        mk.batch_inverse(spec, a.to(torch.int64))
    with pytest.raises(ValueError):
        mk.inv_fermat(spec, a, 0)
    empty = mont.batch_inverse(spec, a[:, :0])
    assert tuple(empty.shape) == (16, 0)


def test_prime_field_inverse_either_side_of_the_threshold():
    """A batch goes through the blocked inversion, a single element through
    the ladder; moving the threshold moves the route, not the result."""
    F = REF_FIELDS["bls12_381.Fr"][1]
    vals, a_np = seeded(F.spec, 40, "threshold", zeros=(3,))
    a = convert.from_reference(a_np, "cpu")
    want = host_inverse(F.spec, vals)
    assert config.inverse_min_batch == 2
    blocked = F.inverse(a)
    assert ints(blocked) == want
    assert torch.equal(F.batch_inverse(a, axis=0), blocked)
    try:
        config.inverse_min_batch = 41
        ladder = F.inverse(a)
    finally:
        config.inverse_min_batch = 2
    assert torch.equal(ladder, blocked) and torch.equal(ladder, mont.inv(F.spec, a))
    assert ints(F.inverse(a[:, 5])) == want[5]


@pytest.mark.parametrize("name", list(REF_FIELDS))
def test_bytes_mod_order_vs_reference(name):
    ref_F, F = REF_FIELDS[name]
    p = F.spec.modulus
    data = bytes(random.Random(f"bytes-{name}").randrange(256) for _ in range(70))
    for short in (data, data[:5], b""):
        le, be = F.from_le_bytes_mod_order(short), F.from_be_bytes_mod_order(short)
        assert same(le, ref_F.from_le_bytes_mod_order(short))
        assert same(be, ref_F.from_be_bytes_mod_order(short))
        assert F.to_int(le) == int.from_bytes(short, "little") % p
        assert F.to_int(be) == int.from_bytes(short, "big") % p


def test_batch_inverse_vs_jnp_scan():
    """Against the reference's scan along the second axis of a [43, 3]
    batch of 129 elements with zero lanes: the port inverts every element
    whatever the axis, so the flat batch gives the same values."""
    name = "bls12_381.Fq"
    ref_spec, spec = REF_FIELDS[name][0].spec, SPECS[name]
    vals, a_np = seeded(spec, 129, "scan", zeros=(0, 128))
    a2_np = a_np.reshape(spec.n_limbs, 43, 3)
    ref = np.asarray(jax.jit(lambda x: ref_mont.batch_inverse(ref_spec, x, axis=1))(
        jnp.asarray(a2_np)))
    got = mont.batch_inverse(spec, convert.from_reference(a2_np, "cpu"), axis=1)
    assert got.shape == a2_np.shape and same(got, ref)
    a = convert.from_reference(a_np, "cpu")
    assert same(mont.batch_inverse(spec, a), ref.reshape(a_np.shape))
    assert batch_limbs_to_int(ref.reshape(a_np.shape)) == host_inverse(spec, vals)
    with pytest.raises(ValueError):
        mont.batch_inverse(spec, a, axis=1)


@pytest.mark.parametrize("name", list(REF_FIELDS))
def test_sqrt_and_legendre_vs_reference(name):
    """Fr takes Tonelli-Shanks, Fq the p = 3 mod 4 exponent: squares, zero
    and non-squares through both packages."""
    ref_F, F = REF_FIELDS[name]
    spec, p = F.spec, F.spec.modulus
    rng = random.Random(f"sqrt-{name}")
    non_residue = next(x for x in range(2, 50) if pow(x, (p - 1) // 2, p) == p - 1)
    squares = [pow(rng.randrange(1, p), 2, p) for _ in range(5)]
    vals = squares + [0, non_residue, non_residue * squares[0] % p]
    a = F.from_int(vals)
    ref_a = ref_F.from_int(vals)
    assert same(a, ref_a)

    leg = F.legendre(a)
    assert leg.dtype == torch.int8 and leg.tolist() == [1] * 5 + [0, -1, -1]

    ok, root = F.sqrt(a)
    ref_ok, ref_root = ref_F.sqrt(ref_a)
    assert ok.tolist() == [True] * 6 + [False] * 2
    assert np.array_equal(ok.numpy(), np.asarray(ref_ok))
    # the same root of the two, as the reference's precomputation gives it
    assert same(root[:, :6], np.asarray(ref_root)[:, :6])
    assert [r * r % p for r in F.to_int(root[:, :6])] == vals[:6]
    assert spec.sqrt_mode == ("tonelli_shanks" if name.endswith("Fr") else "case3mod4")


def test_batch_inverse_vs_pallas_interpret(interpret):
    """n = 260 (not a multiple of any block) with a zero lane, against the
    reference's blocked Pallas inversion; the port with its own levels and
    with small ones that fold the batch three times."""
    name = "bls12_381.Fr"
    ref_spec, spec = REF_FIELDS[name][0].spec, SPECS[name]
    vals, a_np = seeded(spec, 260, "pallas", zeros=(17,))
    ref = np.asarray(jax.jit(lambda x: ref_pallas.batch_inverse(ref_spec, x))(
        jnp.asarray(a_np)))
    a = convert.from_reference(a_np, "cpu")
    assert same(mont.batch_inverse(spec, a), ref)
    assert len(mk.level_plan(260, 4, 8)) == 3
    assert same(mk.batch_inverse(spec, a, group=4, bottom=8), ref)
    assert not ref[:, 17].any()
    assert batch_limbs_to_int(ref) == host_inverse(spec, vals)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SPECS))
def test_kernels_vs_plain_on_card(name):
    """On a CUDA device: the three kernels and the whole inversion against
    their plain versions (the chip smoke script does the same at full
    size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")
    spec = SPECS[name]
    _, a_np = seeded(spec, 4097, "card", zeros=(0, 700, 4096))
    a = convert.from_reference(a_np, "cuda")
    pref, tails = mk.inv_prefix(spec, a, 5)
    p_pref, p_tails = mk.inv_prefix_plain(spec, a, 5)
    assert torch.equal(pref, p_pref) and torch.equal(tails, p_tails)
    tinv = mk.inv_fermat(spec, tails)
    assert torch.equal(tinv, mk.inv_fermat_plain(spec, tails))
    assert torch.equal(mk.inv_fermat(spec, a, 2), mk.mul(spec, a, a))
    out = mk.inv_backward(spec, a, pref, tinv, 5)
    assert torch.equal(out, mk.inv_backward_plain(spec, a, pref, tinv, 5))
    assert torch.equal(mk.batch_inverse(spec, a, 4, 64),
                       mk.batch_inverse_plain(spec, a, 4, 64))
    assert torch.equal(out.cpu(), mk.batch_inverse(spec, a.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SPECS))
def test_inv_gcd_vs_plain_on_card(name):
    """On a CUDA device: the safegcd bottom against the ladder's plain
    version and the host, at n = 1 and on 4097 lanes with planted zeros
    and the edge values 1, 2, p - 1, p - 2, (p - 1) / 2, R mod p, R^2 mod p."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")
    spec = SPECS[name]
    p, R = spec.modulus, spec.R
    vals, _ = seeded(spec, 4097, "gcd-card", zeros=(0, 700, 4096))
    vals[1:8] = [1, 2, p - 1, p - 2, (p - 1) // 2, R % p, R * R % p]
    a = convert.from_reference(batch_int_to_limbs(vals, spec.n_limbs), "cuda")
    got = mk.inv_gcd(spec, a)
    assert torch.equal(got, mk.inv_fermat_plain(spec, a))
    assert ints(got) == host_inverse(spec, vals)
    one = a[:, 5:6].contiguous()
    assert torch.equal(mk.inv_gcd(spec, one), got[:, 5:6])
