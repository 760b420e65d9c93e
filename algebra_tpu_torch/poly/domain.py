"""FFT evaluation domains over prime fields.

A domain is a host object holding the subgroup constants and the twiddle
tables on its field's device; fft/ifft are staged butterfly pipelines over
limb tensors (the trailing axis is the coefficient index).

Supported: radix-2 subgroups and cosets (inputs shorter than the domain
are zero-padded), vanishing polynomials, element tables, and all Lagrange
coefficients at a point (one batched inversion).
GeneralEvaluationDomain picks the radix-2 domain when the field has one;
mixed-radix domains are not here yet.
"""

from __future__ import annotations

import torch

from ..fields.prime import PrimeField
from ..ops import mont, ntt


class Radix2EvaluationDomain:
    """Multiplicative subgroup <g> of size 2^k (optionally shifted by a
    coset offset h), with natural-order fft/ifft."""

    def __init__(self, field: PrimeField, size: int, offset: int = 1):
        if size < 1 or size & (size - 1):
            raise ValueError("Radix2 domain size must be a power of two")
        spec = field.spec
        w = spec.get_root_of_unity(size)
        if w is None:
            raise ValueError(
                f"field {spec.name} has no subgroup of order {size} "
                f"(two-adicity {spec.two_adicity})"
            )
        self.field = field
        self.spec = spec
        self.size = size
        self.log_size = size.bit_length() - 1
        p = spec.modulus
        self.group_gen = w
        self.group_gen_inv = pow(w, -1, p)
        self.size_as_field_element = size % p
        self.size_inv = pow(size, -1, p)
        self.offset = offset % p
        self.offset_inv = pow(self.offset, -1, p)
        self.offset_pow_size = pow(self.offset, size, p)
        self._roots = None  # built on the device on first use
        self._roots_inv = None

    # ------------------------------------------------------------------ setup
    def _root_tables(self):
        """Build (once) the twiddle tables [L, size/2] of g^i and g^-i."""
        if self._roots is None:
            half = max(self.size // 2, 1)
            dev = self.field.device
            self._roots = ntt.powers_from_int(self.spec, self.group_gen, half, dev)
            self._roots_inv = ntt.powers_from_int(
                self.spec, self.group_gen_inv, half, dev
            )
        return self._roots, self._roots_inv

    def get_coset(self, offset: int) -> "Radix2EvaluationDomain":
        d = Radix2EvaluationDomain(self.field, self.size, offset)
        d._roots, d._roots_inv = self._root_tables()  # share tables
        return d

    # ------------------------------------------------------------------- fft
    def _pad(self, coeffs: torch.Tensor) -> torch.Tensor:
        n = coeffs.shape[-1]
        if n > self.size:
            raise ValueError(f"input length {n} exceeds domain size {self.size}")
        if n < self.size:
            coeffs = torch.nn.functional.pad(coeffs, (0, self.size - n))
        return coeffs

    def fft(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Evaluate the polynomial with the given coefficients over the
        domain (natural order h*g^0, h*g^1, ...); zero-pads short inputs.

        Inputs much shorter than the domain take the degree-aware
        O(n log d) path."""
        roots, _ = self._root_tables()
        n_in = coeffs.shape[-1]
        d = 1 << (n_in - 1).bit_length() if n_in > 1 else 1
        if d * 4 <= self.size:
            if n_in < d:
                coeffs = torch.nn.functional.pad(coeffs, (0, d - n_in))
            if self.offset != 1:
                table = ntt.powers_from_int(self.spec, self.offset, d, coeffs.device)
                coeffs = ntt.scale(self.spec, coeffs, table)
            return ntt.fft_degree_aware(self.spec, coeffs, self.size, roots)
        coeffs = self._pad(coeffs)
        if self.offset != 1:
            table = ntt.powers_from_int(self.spec, self.offset, self.size, coeffs.device)
            coeffs = ntt.scale(self.spec, coeffs, table)
        return ntt.fft(self.spec, coeffs, roots)

    def ifft(self, evals: torch.Tensor) -> torch.Tensor:
        """Interpolate evaluations over the domain back to coefficients."""
        if evals.shape[-1] != self.size:
            raise ValueError("ifft input must have domain size")
        _, roots_inv = self._root_tables()
        x = ntt.fft(self.spec, evals, roots_inv)
        x = mont.mul(self.spec, x, self.field.constant(self.size_inv))
        if self.offset != 1:
            table = ntt.powers_from_int(self.spec, self.offset_inv, self.size, x.device)
            x = ntt.scale(self.spec, x, table)
        return x

    # --------------------------------------------------------------- elements
    def element(self, i: int) -> int:
        """i-th domain element (host int, canonical form)."""
        return (self.offset * pow(self.group_gen, i, self.spec.modulus)) % (
            self.spec.modulus
        )

    def elements(self) -> torch.Tensor:
        """[L, size] device table of all domain elements (Montgomery)."""
        table = ntt.powers_from_int(
            self.spec, self.group_gen, self.size, self.field.device
        )
        if self.offset != 1:
            table = mont.mul(self.spec, table, self.field.constant(self.offset))
        return table

    # --------------------------------------------------- vanishing polynomial
    def evaluate_vanishing_polynomial(self, tau):
        """Z_H(tau) = tau^size - offset^size, batched over tau."""
        t = mont.pow_fixed(self.spec, tau, self.size)
        return mont.sub(
            self.spec,
            t,
            self.field.constant(self.offset_pow_size, self.field.batch_shape(tau)),
        )

    def vanishing_polynomial(self):
        """Sparse representation [(degree, coeff_int)] of x^n - h^n."""
        return [(self.size, 1), (0, (-self.offset_pow_size) % self.spec.modulus)]

    # ------------------------------------------------- Lagrange coefficients
    def evaluate_all_lagrange_coefficients(self, tau: torch.Tensor) -> torch.Tensor:
        """[L, size] of L_i(tau) for one point tau (a [L] element): O(n)
        with one batched inversion.  A tau inside the domain gives the
        exact one-hot row."""
        spec, F = self.spec, self.field
        n = self.size
        g_pows = ntt.powers_from_int(spec, self.group_gen, n, F.device)
        elements = g_pows
        if self.offset != 1:
            elements = mont.mul(spec, g_pows, F.constant(self.offset))
        u = mont.sub(spec, tau.reshape(spec.n_limbs, 1), elements)  # tau - h g^i
        in_domain = mont.is_zero(spec, u)
        if bool(in_domain.any()):
            return mont.select(in_domain, F.one((n,)), F.zero((n,)))
        u_inv = mont.batch_inverse(spec, u, axis=0)
        # L_i(tau) = Z(tau) g^i / (n h^(n-1) (tau - h g^i)), Z(tau) = tau^n - h^n
        z_tau = self.evaluate_vanishing_polynomial(tau)
        c = (self.size_inv * pow(self.offset_inv, n - 1, spec.modulus)) % spec.modulus
        scale = mont.mul(spec, z_tau, F.constant(c))
        return mont.mul(spec, mont.mul(spec, g_pows, scale), u_inv)

    # --------------------------------------------------------------- misc API
    def reindex_by_subdomain(self, other_size: int, index: int) -> int:
        """Map an index of a subdomain of size ``other_size`` into this
        domain: subgroup elements interleave with period |G|/|S|."""
        if self.size < other_size:
            raise ValueError("other domain must be a subdomain (smaller)")
        period = self.size // other_size
        if index < other_size:
            return index * period
        i = index - other_size
        x = period - 1
        return i + (i // x) + 1

    def mul_polynomials_in_evaluation_domain(self, a_evals, b_evals):
        return mont.mul(self.spec, a_evals, b_evals)

    def __repr__(self):
        return (
            f"Radix2EvaluationDomain(size=2^{self.log_size}, "
            f"field={self.spec.name}, offset={'1' if self.offset == 1 else 'coset'})"
        )


def GeneralEvaluationDomain(field: PrimeField, num_coeffs: int, offset: int = 1):
    """Pick the best supported domain of size >= num_coeffs: the radix-2
    domain when the field has a subgroup of that size."""
    size = 1 << (num_coeffs - 1).bit_length()
    if field.spec.get_root_of_unity(size) is not None:
        return Radix2EvaluationDomain(field, size, offset)
    raise NotImplementedError(
        f"no radix-2 domain of size >= {num_coeffs} for {field.spec.name}; "
        "mixed-radix domains are not ported yet"
    )
