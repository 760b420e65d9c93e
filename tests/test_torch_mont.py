"""The port's Montgomery field layer (algebra_tpu_torch.ops.mont and the
kernel module ops.mont_kernels) held bit-exact against the JAX package on
the same seeded inputs, per field: BLS12-381 Fr (16 limbs), Fq (24) and
MNT4-753 Fq (48).

The port runs on the CPU here, so ``mul`` takes the kernel's plain version;
the JAX side runs both its jnp path and its Pallas kernel in interpret
mode.  Outputs are canonical integers: every comparison is exact
(tolerance 0).  A host big-integer oracle stands beside the JAX values so
the two implementations cannot be wrong together.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algebra_tpu import config as ref_config
from algebra_tpu.bigint import batch_int_to_limbs, batch_limbs_to_int
from algebra_tpu.curves.instances import bls12_381 as ref_bls, mnt4_753 as ref_mnt
from algebra_tpu.ops import mont as ref_mont, mont_pallas as ref_pallas

from algebra_tpu_torch import convert
from algebra_tpu_torch.curves.instances import bls12_381, mnt4_753
from algebra_tpu_torch.ops import mont, mont_kernels

N = 130  # not a multiple of the reference kernel's 128-lane block

FIELDS = {
    "bls12_381.Fr-16limb": (ref_bls.fr_spec, bls12_381.fr_spec),
    "bls12_381.Fq-24limb": (ref_bls.fq_spec, bls12_381.fq_spec),
    "mnt4_753.Fq-48limb": (ref_mnt.fq_spec, mnt4_753.fq_spec),
}


class Case:
    """Seeded operands of one field, as host ints, reference arrays and
    port tensors; lanes 0..3 carry the edge values 0, 1, p-1, R mod p."""

    def __init__(self, name):
        self.ref_spec, self.spec = FIELDS[name]
        p = self.spec.modulus
        rng = random.Random(f"mont-{name}")
        edge = [0, 1, p - 1, self.spec.R % p]
        self.a_int = edge + [rng.randrange(p) for _ in range(N - 4)]
        self.b_int = edge[::-1] + [rng.randrange(p) for _ in range(N - 4)]
        L = self.spec.n_limbs
        self.a_np = batch_int_to_limbs(self.a_int, L)
        self.b_np = batch_int_to_limbs(self.b_int, L)
        self.a = convert.from_reference(self.a_np, "cpu")
        self.b = convert.from_reference(self.b_np, "cpu")

    def ref(self, fn, *arrays):
        """Run a JAX-package function (jitted once) on numpy limb arrays."""
        out = jax.jit(fn)(*[jnp.asarray(x) for x in arrays])
        return np.asarray(out)


@pytest.fixture(scope="module", params=list(FIELDS))
def case(request):
    return Case(request.param)


@pytest.fixture
def interpret():
    """Pallas interpret mode on for the body, restored afterwards."""
    ref_config.pallas_interpret = True
    try:
        yield
    finally:
        ref_config.pallas_interpret = False


def same(port_tensor, ref_array):
    got = convert.to_reference(port_tensor)
    return got.dtype == np.uint32 and np.array_equal(got, np.asarray(ref_array))


def test_spec_constants_match(case):
    ref, spec = case.ref_spec, case.spec
    for attr in ("modulus", "n_limbs", "R", "R2", "inv16", "two_adicity",
                 "two_adic_root_of_unity", "generator"):
        assert getattr(spec, attr) == getattr(ref, attr), attr
    assert np.array_equal(spec.p_limbs, ref.p_limbs)
    assert np.array_equal(spec.one_mont_limbs, ref.one_mont_limbs)
    # the 32-bit constants are the same integers, repacked
    p = spec.modulus
    assert (spec.inv32 * p + 1) % (1 << 32) == 0
    assert sum(w << (32 * k) for k, w in enumerate(spec.p_words)) == p
    assert spec.n_words * 2 == spec.n_limbs


def test_mul_vs_pallas_interpret(case, interpret):
    ref = np.asarray(ref_pallas.mul(
        case.ref_spec, jnp.asarray(case.a_np), jnp.asarray(case.b_np), block=128))
    assert same(mont_kernels.mul(case.spec, case.a, case.b), ref)
    assert same(mont.mul(case.spec, case.a, case.b), ref)


def test_mul_vs_jnp(case):
    ref = case.ref(lambda a, b: ref_mont.mul(case.ref_spec, a, b), case.a_np, case.b_np)
    assert same(mont.mul(case.spec, case.a, case.b), ref)


def test_mul_vs_host_oracle(case):
    p = case.spec.modulus
    r_inv = pow(case.spec.R, -1, p)
    want = [x * y * r_inv % p for x, y in zip(case.a_int, case.b_int)]
    got = batch_limbs_to_int(convert.to_reference(mont.mul(case.spec, case.a, case.b)))
    assert got == want


def test_square(case):
    ref = case.ref(lambda a: ref_mont.square(case.ref_spec, a), case.a_np)
    assert same(mont.square(case.spec, case.a), ref)
    assert same(mont.mul(case.spec, case.a, case.a), ref)


@pytest.mark.parametrize("op", ["add", "sub"])
def test_add_sub(case, op):
    ref = case.ref(lambda a, b: getattr(ref_mont, op)(case.ref_spec, a, b),
                   case.a_np, case.b_np)
    assert same(getattr(mont, op)(case.spec, case.a, case.b), ref)
    p = case.spec.modulus
    sign = 1 if op == "add" else -1
    want = [(x + sign * y) % p for x, y in zip(case.a_int, case.b_int)]
    assert batch_limbs_to_int(ref) == want


@pytest.mark.parametrize("op", ["neg", "double"])
def test_neg_double(case, op):
    ref = case.ref(lambda a: getattr(ref_mont, op)(case.ref_spec, a), case.a_np)
    assert same(getattr(mont, op)(case.spec, case.a), ref)


def test_to_from_mont(case):
    ref_to = case.ref(lambda a: ref_mont.to_mont(case.ref_spec, a), case.a_np)
    ref_from = case.ref(lambda a: ref_mont.from_mont(case.ref_spec, a), case.a_np)
    assert same(mont.to_mont(case.spec, case.a), ref_to)
    assert same(mont.from_mont(case.spec, case.a), ref_from)
    back = mont.from_mont(case.spec, mont.to_mont(case.spec, case.a))
    assert torch.equal(back, case.a)


def test_inv_vs_host(case):
    spec, p = case.spec, case.spec.modulus
    lanes = [0, 2, 5, 9]  # 0 -> 0; p-1; two random values
    a = case.a[:, lanes].contiguous()
    got = batch_limbs_to_int(convert.to_reference(mont.inv(spec, a)))
    want = []
    for i in lanes:
        x = spec.from_mont(case.a_int[i])
        want.append(spec.to_mont(pow(x, -1, p)) if x else 0)
    assert got == want


def test_mul_by_u32(case):
    ref = case.ref(lambda a: ref_mont.mul_by_u32(case.ref_spec, a, 13), case.a_np)
    assert same(mont.mul_by_u32(case.spec, case.a, 13), ref)
    assert torch.equal(mont.mul_by_u32(case.spec, case.a, 1), case.a)
    assert not mont.mul_by_u32(case.spec, case.a, 0).any()


def test_is_zero_equal_select(case):
    spec = case.spec
    z = mont.is_zero(spec, case.a)
    assert z.tolist() == [x == 0 for x in case.a_int]
    eq = mont.equal(spec, case.a, case.b)
    assert eq.tolist() == [x == y for x, y in zip(case.a_int, case.b_int)]
    sel = mont.select(z, case.b, case.a)
    want = np.where(np.asarray(z)[None, :], case.b_np, case.a_np)
    assert same(sel, want)


def test_mixed_rank_broadcast(case):
    """[L, 5, 26] x [L, 26] and x [L]: expand/_align insert batch axes
    right after the limb axis, as the reference does."""
    rs, spec = case.ref_spec, case.spec
    L = spec.n_limbs
    a3_np = case.a_np.reshape(L, 5, 26)
    row_np = case.b_np[:, :26]
    one_np = case.b_np[:, 7]
    a3, row, one = (convert.from_reference(x, "cpu") for x in (a3_np, row_np, one_np))
    for op in ("mul", "add", "sub"):
        ref = case.ref(lambda x, y, z: jnp.stack([
            getattr(ref_mont, op)(rs, x, y), getattr(ref_mont, op)(rs, x, z)]),
            a3_np, row_np, one_np)
        assert same(getattr(mont, op)(spec, a3, row), ref[0]), op
        assert same(getattr(mont, op)(spec, a3, one), ref[1]), op
    assert mont.expand(row, 3).shape == (L, 1, 1, 26)
    c = mont.bconst(spec.one_mont_limbs, (3, 2), "cpu")
    assert c.shape == (L, 3, 2) and same(c[:, 1, 1], spec.one_mont_limbs)


def test_wrapper_refuses_bad_operands(case):
    spec = case.spec
    with pytest.raises(ValueError):
        mont_kernels.mul(spec, case.a.to(torch.int64), case.b)
    with pytest.raises(ValueError):
        mont_kernels.mul(spec, case.a[:-1], case.b[:-1])


def test_full_width_modulus_vs_host_oracle():
    """A modulus with no spare top bit (2^256 - 189): sums and products pass
    2^256, so the conditional subtraction must look at the carry."""
    from algebra_tpu_torch.fields.spec import field_spec

    spec = field_spec(2**256 - 189, name="full_width_256")
    assert not spec.modulus_has_spare_bit and spec.n_limbs == 16
    p = spec.modulus
    rng = random.Random("full-width")
    a_int = [p - 1, p - 2, 1, 0] + [p - 1 - rng.randrange(1 << 200) for _ in range(60)]
    b_int = [p - 1, p - 1, p - 1, 5] + [p - 1 - rng.randrange(1 << 200) for _ in range(60)]
    a = convert.from_reference(batch_int_to_limbs(a_int, 16), "cpu")
    b = convert.from_reference(batch_int_to_limbs(b_int, 16), "cpu")
    r_inv = pow(spec.R, -1, p)

    def ints(t):
        return batch_limbs_to_int(convert.to_reference(t))

    assert ints(mont.mul(spec, a, b)) == [x * y * r_inv % p for x, y in zip(a_int, b_int)]
    assert ints(mont.add(spec, a, b)) == [(x + y) % p for x, y in zip(a_int, b_int)]
    assert ints(mont.sub(spec, a, b)) == [(x - y) % p for x, y in zip(a_int, b_int)]
    assert ints(mont.neg(spec, a)) == [(-x) % p for x in a_int]


@pytest.mark.cuda
def test_kernel_vs_plain_on_card(case):
    """On a CUDA device: the kernel against its plain version (the chip
    smoke script does the same at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")
    a, b = case.a.cuda(), case.b.cuda()
    got = mont_kernels.mul(case.spec, a, b)
    assert torch.equal(got, mont_kernels.mul_plain(case.spec, a, b))
    assert torch.equal(got.cpu(), mont_kernels.mul_plain(case.spec, case.a, case.b))
