"""The "field compiler": host-side derivation of all per-modulus constants.

A ``FieldSpec`` fully describes one prime field, from Python big-ints:
  * 16-bit-limb layout (L = 4 * ceil(bits/64), so R = 2^(16 L) is also
    the radix of a 32-bit-word or 64-bit-word Montgomery form),
  * Montgomery constants R, R^2, and the reduction constants
    ``inv16 = -p^-1 mod 2^16`` (plain versions, 16-bit limbs) and
    ``inv32 = -p^-1 mod 2^32`` (CUDA kernels, limbs packed in pairs),
  * FFT constants: two-adicity s, trace t (p - 1 = 2^s * t), the 2^s-th
    root of unity g^t, and optional small-subgroup constants,
  * square-root precomputation mode and exponent.
"""

from __future__ import annotations

import functools

import numpy as np

from ..bigint import LIMB_BITS, int_to_limbs, n_limbs_for_bits


def _two_adic_split(n: int):
    """Return (s, t) with n = 2^s * t, t odd."""
    s = 0
    while n % 2 == 0:
        n //= 2
        s += 1
    return s, n


def _k_adicity(k: int, n: int):
    """Largest e with k^e | n."""
    e = 0
    while n % k == 0:
        n //= k
        e += 1
    return e, n


class FieldSpec:
    """Immutable description of a prime field.

    Hashable by identity; created once per field (module level)."""

    def __init__(
        self,
        modulus: int,
        generator: int | None = None,
        small_subgroup_base: int | None = None,
        small_subgroup_power: int | None = None,
        name: str = "Fp",
    ):
        p = int(modulus)
        if p < 3 or p % 2 == 0:
            raise ValueError("modulus must be an odd prime > 2")
        self.name = name
        self.modulus = p
        self.modulus_bit_size = p.bit_length()
        self.n_limbs = n_limbs_for_bits(self.modulus_bit_size)
        self.limb_bits = LIMB_BITS

        # Montgomery constants.
        self.R = pow(2, LIMB_BITS * self.n_limbs, p)
        self.R2 = (self.R * self.R) % p
        self.R3 = (self.R2 * self.R) % p
        self.inv16 = (-pow(p, -1, 1 << 16)) % (1 << 16)
        self.inv32 = (-pow(p, -1, 1 << 32)) % (1 << 32)
        self.modulus_has_spare_bit = self.modulus_bit_size < 64 * (
            (self.modulus_bit_size + 63) // 64
        )

        self.modulus_minus_one_div_two = (p - 1) // 2

        # FFT constants.
        self.two_adicity, self.trace = _two_adic_split(p - 1)
        self.trace_minus_one_div_two = (self.trace - 1) // 2
        self.generator = int(generator) if generator is not None else None
        if self.generator is not None:
            self.two_adic_root_of_unity = pow(self.generator, self.trace, p)
        else:
            self.two_adic_root_of_unity = None

        # Mixed-radix (small subgroup) constants.
        self.small_subgroup_base = small_subgroup_base
        self.small_subgroup_base_adicity = None
        self.large_subgroup_root_of_unity = None
        if small_subgroup_base is not None:
            if small_subgroup_power is not None:
                self.small_subgroup_base_adicity = int(small_subgroup_power)
            else:
                self.small_subgroup_base_adicity, _ = _k_adicity(
                    small_subgroup_base, p - 1
                )
            if self.generator is not None:
                q_pow = small_subgroup_base**self.small_subgroup_base_adicity
                cofactor = (p - 1) // ((1 << self.two_adicity) * q_pow)
                self.large_subgroup_root_of_unity = pow(self.generator, cofactor, p)

        # Square-root precomputation.
        if p % 4 == 3:
            self.sqrt_mode = "case3mod4"
            self.sqrt_exp = (p + 1) // 4
        else:
            self.sqrt_mode = "tonelli_shanks"
            self.sqrt_exp = (self.trace - 1) // 2

        # ---- constant limb arrays (np.uint32, 16-bit limbs) ----
        L = self.n_limbs
        self.p_limbs = int_to_limbs(p, L)
        self.zero_limbs = np.zeros((L,), np.uint32)
        self.one_mont_limbs = int_to_limbs(self.R % p, L)  # 1 in Montgomery form
        self.r2_limbs = int_to_limbs(self.R2, L)
        self.two_mont_limbs = int_to_limbs((2 * self.R) % p, L)
        # unit vector [1, 0, ...]: multiplying by it performs a Montgomery
        # reduction (from-Montgomery conversion).
        self.unit_limbs = int_to_limbs(1, L)

        # ---- 32-bit-word view for the CUDA kernels ----
        self.n_words = L // 2
        self.p_words = tuple(
            (p >> (32 * k)) & 0xFFFFFFFF for k in range(self.n_words)
        )

    # -- representation helpers (host) ------------------------------------

    def to_mont(self, x: int) -> int:
        return (int(x) * self.R) % self.modulus

    def from_mont(self, x: int) -> int:
        return (int(x) * pow(self.R, -1, self.modulus)) % self.modulus

    def get_root_of_unity(self, n: int) -> int | None:
        """n-th root of unity in canonical form, or None if unsupported:
        sizes 2^k and, when a small subgroup exists, 2^k * q^j."""
        p = self.modulus
        if n <= 0:
            return None
        two_adic, rest = _two_adic_split(n)
        if self.small_subgroup_base is not None:
            q_adic, rest2 = _k_adicity(self.small_subgroup_base, rest)
            if rest2 != 1:
                return None
            if (
                two_adic > self.two_adicity
                or q_adic > self.small_subgroup_base_adicity
            ):
                return None
            if self.large_subgroup_root_of_unity is None:
                return None
            # omega = large_root ^ (2^(s - two_adic) * q^(Q - q_adic))
            exp = (1 << (self.two_adicity - two_adic)) * (
                self.small_subgroup_base ** (self.small_subgroup_base_adicity - q_adic)
            )
            return pow(self.large_subgroup_root_of_unity, exp, p)
        if rest != 1 or two_adic > self.two_adicity:
            return None
        if self.two_adic_root_of_unity is None:
            return None
        return pow(self.two_adic_root_of_unity, 1 << (self.two_adicity - two_adic), p)

    def __repr__(self):
        return f"FieldSpec({self.name}, bits={self.modulus_bit_size}, L={self.n_limbs})"


@functools.cache
def _spec_cache(modulus: int, generator, ssb, ssp, name):
    return FieldSpec(modulus, generator, ssb, ssp, name)


def field_spec(
    modulus: int,
    generator: int | None = None,
    small_subgroup_base: int | None = None,
    small_subgroup_power: int | None = None,
    name: str = "Fp",
) -> FieldSpec:
    """Memoized FieldSpec constructor (one canonical instance per modulus)."""
    return _spec_cache(
        int(modulus), generator, small_subgroup_base, small_subgroup_power, name
    )
