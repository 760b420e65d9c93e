"""Dense univariate polynomials over a field kind.

Coefficients are a batched field value whose leading batch axis is the
coefficient index (ascending degree).  Evaluation is a powers-of-x inner
product; products go through evaluation domains (FFT mul) when the field
has one and a schoolbook convolution otherwise; division by a vanishing
polynomial is the O(n) special case; long division is a host loop over
the quotient's coefficients.

There is no trailing-zero truncation invariant on the device;
``degree()`` reports the array degree and ``truncated()`` returns a
host-side canonical copy.
"""

from __future__ import annotations

import numpy as np

from ..fields.field import Field


class DensePolynomial:
    """coeffs: field value with leading batch axis = coefficient index."""

    def __init__(self, field: Field, coeffs):
        self.field = field
        self.coeffs = coeffs

    # ------------------------------------------------------------- structure
    @property
    def num_coeffs(self) -> int:
        return self.coeffs.shape[1]

    def degree(self) -> int:
        """Array degree (len - 1)."""
        return self.num_coeffs - 1

    @classmethod
    def from_ints(cls, field: Field, coeffs):
        return cls(field, field.from_int(np.asarray(coeffs, dtype=object)))

    @classmethod
    def zero(cls, field: Field, n: int = 1):
        return cls(field, field.zero((n,)))

    def _pad_to(self, n: int):
        m = self.num_coeffs
        if m >= n:
            return self.coeffs
        pad = self.field.zero((n - m,))
        return self.field.concatenate([self.coeffs, pad], axis=0)

    # ------------------------------------------------------------ arithmetic
    def add(self, other: "DensePolynomial") -> "DensePolynomial":
        n = max(self.num_coeffs, other.num_coeffs)
        return DensePolynomial(
            self.field, self.field.add(self._pad_to(n), other._pad_to(n))
        )

    def sub(self, other: "DensePolynomial") -> "DensePolynomial":
        n = max(self.num_coeffs, other.num_coeffs)
        return DensePolynomial(
            self.field, self.field.sub(self._pad_to(n), other._pad_to(n))
        )

    def neg(self) -> "DensePolynomial":
        return DensePolynomial(self.field, self.field.neg(self.coeffs))

    def scale(self, k) -> "DensePolynomial":
        """Multiply by a scalar field value (batch shape ())."""
        return DensePolynomial(
            self.field,
            self.field.mul(self.coeffs, self.field.broadcast_to(k, (self.num_coeffs,))),
        )

    def naive_mul(self, other: "DensePolynomial") -> "DensePolynomial":
        """Schoolbook product, as a sum of shifted scaled copies."""
        F = self.field
        n, m = self.num_coeffs, other.num_coeffs
        out = F.zero((n + m - 1,))
        for i in range(n):
            ci = F.index(self.coeffs, i)  # scalar coeff
            term = F.mul(other.coeffs, F.broadcast_to(ci, (m,)))
            out[:, i : i + m] = F.add(F.index(out, slice(i, i + m)), term)
        return DensePolynomial(F, out)

    def mul(self, other: "DensePolynomial") -> "DensePolynomial":
        """FFT product over a shared evaluation domain when the field
        supports it, else schoolbook."""
        from .domain import GeneralEvaluationDomain

        F = self.field
        n = self.num_coeffs + other.num_coeffs - 1
        if getattr(F, "spec", None) is None or F.spec.get_root_of_unity(
            1 << (n - 1).bit_length()
        ) is None:
            return self.naive_mul(other)
        domain = GeneralEvaluationDomain(F, n)
        a = domain.fft(self._pad_to(domain.size))
        b = domain.fft(other._pad_to(domain.size))
        return DensePolynomial(F, domain.ifft(F.mul(a, b)))

    # ------------------------------------------------------------ evaluation
    def evaluate(self, x):
        """Evaluate at a (batched) point: powers-of-x inner product.

        For a batch of points x with batch shape S, returns values with
        batch shape S; log(n) doublings build the power table."""
        F = self.field
        n = self.num_coeffs
        shape = F.batch_shape(x)
        idx_pows = _all_powers(F, x, n)  # [n, ...batch]
        coeffs = self.coeffs
        if shape:
            coeffs = coeffs.reshape(coeffs.shape[:2] + (1,) * len(shape))
        terms = F.mul(F.broadcast_to(coeffs, (n,) + shape), idx_pows)
        return F.sum(terms, axis=0)

    # ------------------------------------------------------------- division
    def divide_with_q_and_r(self, divisor: "DensePolynomial"):
        """Long division: (quotient, remainder) with self = q * divisor + r
        and r shorter than the divisor.  One step of the host loop per
        quotient coefficient, from the top; the divisor's leading
        coefficient must not be zero."""
        F = self.field
        n, m = self.num_coeffs, divisor.num_coeffs
        if n < m:
            return DensePolynomial.zero(F, 1), self
        d_lead_inv = F.inverse(F.index(divisor.coeffs, m - 1))
        rem = self.coeffs.clone()
        q_parts = []
        for k in range(n - m, -1, -1):
            qk = F.mul(F.index(rem, k + m - 1), d_lead_inv)
            q_parts.append(qk)
            sub_term = F.mul(divisor.coeffs, F.broadcast_to(qk, (m,)))
            rem[:, k : k + m] = F.sub(F.index(rem, slice(k, k + m)), sub_term)
        q = F.stack(q_parts[::-1], axis=0)
        r = F.index(rem, slice(0, m - 1)) if m > 1 else F.zero((1,))
        return DensePolynomial(F, q), DensePolynomial(F, r)

    def divide_by_vanishing_poly(self, domain):
        """O(n) synthetic division by Z_H = x^n - h^n.

        From  c_i = q_{i-n} - h^n q_i + [i < n] r_i  the quotient satisfies
        q_j = c_{j+n} + h^n q_{j+n}  and the remainder  r_i = c_i + h^n q_i,
        so q is computed block-of-n at a time from the top — each block is
        one vectorized multiply-add of the block above.
        """
        F = self.field
        n = domain.size
        total = self.num_coeffs
        if total <= n:
            return DensePolynomial.zero(F, 1), self
        q_len = total - n
        hn = F.constant(domain.offset_pow_size)
        hn_blk = F.broadcast_to(hn, (n,))
        nblocks = -(-q_len // n)
        prev = F.zero((n,))  # q block strictly above the current one
        blocks = [None] * nblocks
        for k in range(nblocks - 1, -1, -1):
            lo = k * n + n
            hi = min(lo + n, total)
            cblk = F.index(self.coeffs, slice(lo, hi))
            if hi - lo < n:
                cblk = F.concatenate([cblk, F.zero((n - (hi - lo),))], axis=0)
            blk = F.add(cblk, F.mul(prev, hn_blk))
            blocks[k] = blk
            prev = blk
        q_padded = F.concatenate(blocks, axis=0)  # length nblocks*n >= n
        q = F.index(q_padded, slice(0, q_len))
        r = F.add(
            F.index(self.coeffs, slice(0, n)),
            F.mul(F.index(q_padded, slice(0, n)), hn_blk),
        )
        return DensePolynomial(F, q), DensePolynomial(F, r)

    def mul_by_vanishing_poly(self, domain) -> "DensePolynomial":
        """self * (x^n - h^n)."""
        F = self.field
        m = self.num_coeffs
        shifted = F.concatenate([F.zero((domain.size,)), self.coeffs], axis=0)
        hn = F.constant(domain.offset_pow_size)
        low = F.mul(self.coeffs, F.broadcast_to(hn, (m,)))
        low_padded = F.concatenate(
            [F.neg(low), F.zero((domain.size,))], axis=0
        )
        return DensePolynomial(F, F.add(shifted, low_padded))

    # ------------------------------------------------------------- host I/O
    def to_ints(self):
        out = self.field.to_int(self.coeffs)
        return out if isinstance(out, list) else [out]

    def truncated(self):
        """Host-side copy with trailing zero coefficients removed."""
        ints = self.to_ints()
        while len(ints) > 1 and ints[-1] == 0:
            ints.pop()
        return ints

    def __repr__(self):
        return f"DensePolynomial(n={self.num_coeffs}, field={self.field.name})"


def _all_powers(field: Field, x, n: int):
    """[n, ...batch] table of x^i via repeated doubling (log rounds)."""
    shape = field.batch_shape(x)
    table = field.stack([field.one(shape)], axis=0)
    factor = x
    k = 1
    while k < n:
        w = table.shape[1]
        fac_b = field.broadcast_to(factor, (w,) + shape)
        nxt = field.mul(table, fac_b)
        table = field.concatenate([table, nxt], axis=0)
        factor = field.square(factor)
        k *= 2
    return field.index(table, slice(0, n))
