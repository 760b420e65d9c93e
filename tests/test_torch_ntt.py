"""The port's NTT layer (algebra_tpu_torch.ops.ntt and the butterfly kernel
module) held bit-exact against the JAX package over BLS12-381 Fr, on the
same seeded inputs and the same twiddle tables.

The port runs on the CPU here (the butterfly kernel's plain version); the
JAX side runs its Pallas butterfly kernel in interpret mode where it has
one.  Every comparison is exact (tolerance 0).  JAX reference values are
computed once per module and never above n = 256.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algebra_tpu import config as ref_config
from algebra_tpu.curves.instances import bls12_381 as ref_bls
from algebra_tpu.ops import mont_pallas as ref_pallas, ntt as ref_ntt
from algebra_tpu.poly.domain import Radix2EvaluationDomain as RefDomain

from algebra_tpu_torch import convert
from algebra_tpu_torch.curves.instances import bls12_381
from algebra_tpu_torch.ops import mont_kernels, ntt

REF = ref_bls.fr_spec
SPEC = bls12_381.fr_spec
L = SPEC.n_limbs


def rand_limbs(seed, *shape):
    """uint32 [L, *shape] limbs of values below r (top limb below r's)."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 1 << 16, size=(L,) + shape, dtype=np.uint32)
    out[L - 1] = rng.integers(0, SPEC.modulus >> (16 * (L - 1)), size=shape,
                              dtype=np.uint32)
    return out


def port(x):
    return convert.from_reference(x, "cpu")


def same(port_tensor, ref_array):
    return np.array_equal(convert.to_reference(port_tensor), np.asarray(ref_array))


class pallas_interpret:
    """JAX package: route through the Pallas kernels, interpreted on the CPU."""

    def __enter__(self):
        ref_config.use_pallas = True
        ref_config.pallas_interpret = True

    def __exit__(self, *exc):
        ref_config.use_pallas = None
        ref_config.pallas_interpret = False


@pytest.fixture(scope="module")
def ref256():
    """The JAX package's size-256 domain: twiddle tables, one input and its
    transform by the staged path (domain.fft) and by the four-step path
    through the interpreted Pallas butterfly kernel."""
    dom = RefDomain(ref_bls.Fr, 256)
    roots, roots_inv = (np.asarray(t) for t in dom._root_tables())
    x = rand_limbs(11, 256)
    staged = np.asarray(dom.fft(jnp.asarray(x)))
    with pallas_interpret():
        four = np.asarray(jax.jit(
            lambda c, r: ref_ntt.fft_four_step(REF, c, r))(jnp.asarray(x), jnp.asarray(roots)))
    return {"roots": roots, "roots_inv": roots_inv, "x": x, "staged": staged,
            "four_step": four}


@pytest.mark.parametrize("half", [1, 32, 128, 256])
def test_butterfly_stage_vs_pallas_interpret(half):
    n_half = 256
    lo, hi, w = rand_limbs(505, n_half), rand_limbs(606, n_half), rand_limbs(707, half)
    ref_config.pallas_interpret = True
    try:
        ref_lo, ref_hi = ref_pallas.butterfly_stage(
            REF, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(w), block=128)
    finally:
        ref_config.pallas_interpret = False
    got_lo, got_hi = mont_kernels.butterfly_stage(SPEC, port(lo), port(hi), port(w))
    assert same(got_lo, ref_lo) and same(got_hi, ref_hi)


@pytest.mark.parametrize("B", [1, 8])
def test_butterfly_stage_major_is_the_flat_stage(B):
    """The in-array stage on x[L, n1, B] equals the reference's route:
    flatten the halves, repeat the twiddles B times, concatenate."""
    n1 = 32
    x = port(rand_limbs(21, n1, B))
    roots = port(rand_limbs(22, n1 // 2))
    for s in range(1, 6):
        m, half = 1 << s, 1 << (s - 1)
        w = roots[:, :: n1 // m] if m < n1 else roots
        got = mont_kernels.butterfly_stage_major(SPEC, x, w)
        xv = x.reshape(L, n1 // m, m, B)
        lo, hi = xv[:, :, :half], xv[:, :, half:]
        olo, ohi = mont_kernels.butterfly_stage(
            SPEC, lo.reshape(L, -1), hi.reshape(L, -1),
            torch.repeat_interleave(w, B, dim=1))
        want = torch.cat([olo.reshape(lo.shape), ohi.reshape(hi.shape)], dim=2)
        assert torch.equal(got, want.reshape(L, n1, B)), (s, B)


def test_butterfly_wrappers_refuse_bad_shapes():
    x = port(rand_limbs(1, 8, 2))
    with pytest.raises(ValueError):
        mont_kernels.butterfly_stage_major(SPEC, x, port(rand_limbs(2, 3)))
    with pytest.raises(ValueError):
        mont_kernels.butterfly_stage(SPEC, x[:, :, 0], x[:, :, 1], port(rand_limbs(2, 3)))


def test_fft_stages_major(ref256):
    x = rand_limbs(31, 16, 16)
    roots16 = ref256["roots"][:, ::16][:, :8]  # powers of the 16th root
    ref = jax.jit(lambda a, r: ref_ntt.fft_stages_major(REF, a, r))(
        jnp.asarray(x), jnp.asarray(roots16))
    got = ntt.fft_stages_major(SPEC, port(x), port(ref256["roots"])[:, ::16][:, :8])
    assert same(got, ref)


def test_fft_four_step_vs_pallas_interpret(ref256):
    got = ntt.fft_four_step(SPEC, port(ref256["x"]), port(ref256["roots"]))
    assert same(got, ref256["four_step"])


def test_fft_four_step_vs_domain_fft(ref256):
    got = ntt.fft_four_step(SPEC, port(ref256["x"]), port(ref256["roots"]))
    assert same(got, ref256["staged"])


def test_fft_staged_path(ref256):
    """ntt.fft below the four-step threshold: bit reversal + fft_stages."""
    got = ntt.fft(SPEC, port(ref256["x"]), port(ref256["roots"]))
    assert same(got, ref256["staged"])
    # inverse table and 1/n scaling bring the input back
    back = ntt.fft(SPEC, got, port(ref256["roots_inv"]))
    n_inv = bls12_381.Fr.to("cpu").constant(pow(256, -1, SPEC.modulus))
    from algebra_tpu_torch.ops import mont
    assert same(mont.mul(SPEC, back, n_inv), ref256["x"])


def test_fft_n64_batched(ref256):
    """A batch of three size-64 transforms through the staged path, against
    the definition X[k] = sum x[i] w^(i k) at a few points (host ints)."""
    from algebra_tpu_torch.bigint import batch_limbs_to_int

    x = rand_limbs(41, 3, 64)
    roots64 = np.ascontiguousarray(ref256["roots"][:, ::4])
    got = ntt.fft(SPEC, port(x), port(roots64))
    assert got.shape == (L, 3, 64)
    p, w = SPEC.modulus, SPEC.get_root_of_unity(64)
    x_int = batch_limbs_to_int(x)  # Montgomery values: the transform is linear
    got_int = batch_limbs_to_int(convert.to_reference(got))
    for row in range(3):
        for k in (0, 1, 37):
            want = sum(v * pow(w, i * k, p) for i, v in enumerate(x_int[row])) % p
            assert got_int[row][k] == want
    assert np.array_equal(ntt.bit_reverse_indices(64), ref_ntt.bit_reverse_indices(64))


def test_fft_degree_aware(ref256):
    d, n = 16, 64
    x = rand_limbs(51, d)
    roots64 = np.ascontiguousarray(ref256["roots"][:, ::4])
    ref = jax.jit(lambda a, r: ref_ntt.fft_degree_aware(REF, a, n, r))(
        jnp.asarray(x), jnp.asarray(roots64))
    got = ntt.fft_degree_aware(SPEC, port(x), n, port(roots64))
    assert same(got, ref)
    padded = np.concatenate([x, np.zeros((L, n - d), np.uint32)], axis=1)
    assert torch.equal(got, ntt.fft(SPEC, port(padded), port(roots64)))
    with pytest.raises(ValueError):
        ntt.fft_degree_aware(SPEC, port(x[:, :12]), n, port(roots64))


def test_four_step_low_degree(ref256):
    n1 = n2 = 16
    x = rand_limbs(61, 10)  # d < n2: zero-padded to one row
    ref = jax.jit(lambda a, r: ref_ntt._four_step_low_degree(REF, a, n1, n2, r))(
        jnp.asarray(x), jnp.asarray(ref256["roots"]))
    got = ntt._four_step_low_degree(SPEC, port(x), n1, n2, port(ref256["roots"]))
    assert same(got, ref)
    padded = np.concatenate([x, np.zeros((L, 256 - 10), np.uint32)], axis=1)
    assert torch.equal(got, ntt.fft(SPEC, port(padded), port(ref256["roots"])))


def test_powers_tables(ref256):
    w = ref_bls.fr_spec.get_root_of_unity(256)
    got = ntt.powers_from_int(SPEC, w, 128, "cpu")
    assert same(got, ref256["roots"])
    # host oracle, and the device-base variant
    want = [SPEC.to_mont(pow(w, i, SPEC.modulus)) for i in range(128)]
    from algebra_tpu_torch.bigint import batch_limbs_to_int
    assert batch_limbs_to_int(convert.to_reference(got)) == want
    assert torch.equal(ntt.powers_from_device(SPEC, got[:, 1], 100), got[:, :100])
    assert same(ntt.scale(SPEC, got, got), np.asarray(
        jax.jit(lambda t: ref_ntt.scale(REF, t, t))(jnp.asarray(ref256["roots"]))))
