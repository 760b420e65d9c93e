"""Generic quadratic extension field kind: base[u]/(u^2 - nonresidue).

The port of the JAX package's ``fields/quadratic.py``: values are (c0, c1)
tuples of base-field values.  Products and squares go through the
bilinear-form compiler (``fields/dot.py``: one K17 launch) where the tower
has an integer multiplication tensor, else through stacked Karatsuba;
norm-based inversion, coefficient-table Frobenius, the two-case square
root, and exponentiation in the cyclotomic subgroup by signed NAF digits.
"""

from __future__ import annotations

import torch

from .field import Field


class QuadExtField(Field):
    def __init__(self, base: Field, nonresidue_host, frobenius_coeffs_c1_host, name: str,
                 mul_by_nonresidue_fn=None):
        """``nonresidue_host`` / coefficient entries are host tower values
        (nested ints) in the base field; ``mul_by_nonresidue_fn(base, x)``
        is an optional fast form (e.g. negation when nr = -1)."""
        self.base = base
        self.name = name
        self.nonresidue_host = nonresidue_host
        self._frob_host = list(frobenius_coeffs_c1_host)
        self._mul_by_nr_fn = mul_by_nonresidue_fn
        self.degree_over_prime = 2 * base.extension_degree()

    @property
    def device(self) -> torch.device:
        return self.prime_kind().device

    # --- constants ---------------------------------------------------------
    def constant(self, host_value, batch_shape=()):
        c0, c1 = host_value
        return (self.base.constant(c0, batch_shape), self.base.constant(c1, batch_shape))

    def zero(self, batch_shape=()):
        return (self.base.zero(batch_shape), self.base.zero(batch_shape))

    def one(self, batch_shape=()):
        return (self.base.one(batch_shape), self.base.zero(batch_shape))

    def characteristic(self) -> int:
        return self.base.characteristic()

    def extension_degree(self) -> int:
        return self.degree_over_prime

    def mul_by_nonresidue(self, x):
        if self._mul_by_nr_fn is not None:
            return self._mul_by_nr_fn(self.base, x)
        return self.base.mul(
            x, self.base.constant(self.nonresidue_host, self.base.batch_shape(x)))

    # --- arithmetic ---------------------------------------------------------
    def add(self, a, b):
        return (self.base.add(a[0], b[0]), self.base.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.base.sub(a[0], b[0]), self.base.sub(a[1], b[1]))

    def neg(self, a):
        return (self.base.neg(a[0]), self.base.neg(a[1]))

    def mul(self, a, b):
        from . import dot as dot_mod

        out = dot_mod.dot(self, [(1, a, b)])
        if out is not None:
            return out
        B = self.base
        sa = B.stack([a[0], a[1], B.add(a[0], a[1])])
        sb = B.stack([b[0], b[1], B.add(b[0], b[1])])
        prod = B.mul(sa, sb)
        v0 = B.index(prod, 0)
        v1 = B.index(prod, 1)
        t = B.index(prod, 2)
        c0 = B.add(v0, self.mul_by_nonresidue(v1))
        c1 = B.sub(B.sub(t, v0), v1)
        return (c0, c1)

    def square(self, a):
        from . import dot as dot_mod

        out = dot_mod.dot(self, [(1, a, a)])
        if out is not None:
            return out
        # (a0 + a1 u)^2 = (a0 + a1)(a0 + nr*a1) - v - nr*v + (2 a0 a1) u
        B = self.base
        sa = B.stack([a[0], B.add(a[0], a[1])])
        sb = B.stack([a[1], B.add(a[0], self.mul_by_nonresidue(a[1]))])
        prod = B.mul(sa, sb)
        v = B.index(prod, 0)
        t = B.index(prod, 1)
        c0 = B.sub(B.sub(t, v), self.mul_by_nonresidue(v))
        c1 = B.double(v)
        return (c0, c1)

    def inverse(self, a):
        B = self.base
        norm = B.sub(B.square(a[0]), self.mul_by_nonresidue(B.square(a[1])))
        ninv = B.inverse(norm)
        return (B.mul(a[0], ninv), B.neg(B.mul(a[1], ninv)))

    def conjugate(self, a):
        return (a[0], self.base.neg(a[1]))

    def mul_by_base(self, a, b0):
        """Multiply by an element of the base field."""
        return (self.base.mul(a[0], b0), self.base.mul(a[1], b0))

    def norm(self, a):
        B = self.base
        return B.sub(B.square(a[0]), self.mul_by_nonresidue(B.square(a[1])))

    def frobenius(self, a, power: int = 1):
        k = power % self.degree_over_prime
        c0 = self.base.frobenius(a[0], power)
        c1 = self.base.frobenius(a[1], power)
        coeff = self.base.constant(self._frob_host[k], self.base.batch_shape(c1))
        return (c0, self.base.mul(c1, coeff))

    # --- predicates ----------------------------------------------------------
    def is_zero(self, a):
        return self.base.is_zero(a[0]) & self.base.is_zero(a[1])

    def equal(self, a, b):
        return self.base.equal(a[0], b[0]) & self.base.equal(a[1], b[1])

    # --- cyclotomic subgroup ops ----------------------------------------------
    def cyclotomic_inverse(self, a):
        """For elements of the cyclotomic subgroup (norm 1) the inverse is
        the conjugate."""
        return self.conjugate(a)

    def cyclotomic_square(self, a):
        """Default: plain squaring; Fp12 has its own."""
        return self.square(a)

    def cyclotomic_exp(self, a, e: int):
        """a^e for a cyclotomic-subgroup a and a host-constant e, by signed
        NAF digits (the inverse is a conjugate, so digit -1 costs what 1
        does).  The reference runs a ``lax.scan`` over the digits and
        multiplies by 1, a or a^-1 in every step; here the digit is known on
        the host, so a step squares and multiplies only where the digit is
        not 0, from the top digit down: the same value."""
        from ..bigint import signed_naf

        e = int(e)
        if e < 0:
            return self.cyclotomic_exp(self.cyclotomic_inverse(a), -e)
        if e == 0:
            return self.one(self.batch_shape(a))
        a_inv = self.cyclotomic_inverse(a)
        res = None
        for d in reversed(signed_naf(e)):
            if res is not None:
                res = self.cyclotomic_square(res)
            if d:
                f = a if d == 1 else a_inv
                res = f if res is None else self.mul(res, f)
        return res

    # --- square roots (two-case algorithm) ------------------------------------
    def legendre(self, a):
        return self.base.legendre(self.norm(a))

    def sqrt(self, a):
        """Batched square root: (ok mask, root).

        a1 == 0: sqrt(a0) in the base if it is a square, else
        sqrt(a0 / nr) * u.  Otherwise alpha = norm(a) must be a square in
        the base; delta = (a0 + sqrt(alpha)) / 2, or (a0 - sqrt(alpha)) / 2
        where that is not a square; c0 = sqrt(delta), c1 = a1 / (2 c0).
        Zero gives (True, 0)."""
        B = self.base
        shape = self.batch_shape(a)
        a0, a1 = a
        two_inv = B.constant(pow(2, -1, self.characteristic()), shape)

        # generic branch
        alpha = self.norm(a)
        alpha_ok, alpha_sqrt = B.sqrt(alpha)
        delta = B.mul(B.add(a0, alpha_sqrt), two_inv)
        delta_is_qr = B.legendre(delta) >= 0
        delta = B.select(delta_is_qr, delta, B.mul(B.sub(a0, alpha_sqrt), two_inv))
        c0_ok, c0 = B.sqrt(delta)
        c0_inv = B.inverse(c0)
        c1 = B.mul(B.mul(a1, c0_inv), two_inv)
        gen_root = (c0, c1)
        gen_ok = alpha_ok & c0_ok

        # a1 == 0 branch
        a0_ok, a0_sqrt = B.sqrt(a0)
        nr_inv = B.constant(self.nonresidue_host, shape)
        a0_div_nr = B.mul(a0, B.inverse(nr_inv))
        alt_ok, alt_sqrt = B.sqrt(a0_div_nr)
        z = B.zero(shape)
        branch0 = self.select(a0_ok, (a0_sqrt, z), (z, alt_sqrt))
        branch0_ok = a0_ok | alt_ok

        a1_zero = B.is_zero(a1)
        ok = torch.where(a1_zero, branch0_ok, gen_ok)
        root = self.select(a1_zero, branch0, gen_root)
        is_z = self.is_zero(a)
        ok = ok | is_z
        root = self.select(is_z, self.zero(shape), root)
        return ok, root

    # --- host conversions ----------------------------------------------------
    def from_int(self, x, batch_shape=None):
        """Host tower value (c0, c1) or list of such tuples -> device value."""
        if isinstance(x, tuple):
            return tuple(self.base.from_int(c) for c in x)
        cs = list(zip(*x))
        return tuple(self.base.from_int(list(c)) for c in cs)

    def to_int(self, a):
        parts = [self.base.to_int(c) for c in a]
        if not isinstance(parts[0], list):
            return tuple(parts)
        return [tuple(t) for t in zip(*parts)]

    def random(self, rng, batch_shape=()):
        return (self.base.random(rng, batch_shape), self.base.random(rng, batch_shape))

    def __repr__(self):
        return f"QuadExtField({self.name}, device={self.device})"
