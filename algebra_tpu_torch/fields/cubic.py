"""Generic cubic extension field kind: base[v]/(v^3 - nonresidue).

The port of the JAX package's ``fields/cubic.py``: values are (c0, c1, c2)
tuples of base-field values; products and squares through the
bilinear-form compiler (one K17 launch) where the tower has an integer
multiplication tensor, else Toom/Karatsuba-style; norm-based inversion and
two-table Frobenius.
"""

from __future__ import annotations

import torch

from .field import Field


class CubicExtField(Field):
    def __init__(
        self,
        base: Field,
        nonresidue_host,
        frobenius_coeffs_c1_host,
        frobenius_coeffs_c2_host,
        name: str,
        mul_by_nonresidue_fn=None,
    ):
        self.base = base
        self.name = name
        self.nonresidue_host = nonresidue_host
        self._frob_c1_host = list(frobenius_coeffs_c1_host)
        self._frob_c2_host = list(frobenius_coeffs_c2_host)
        self._mul_by_nr_fn = mul_by_nonresidue_fn
        self.degree_over_prime = 3 * base.extension_degree()

    @property
    def device(self) -> torch.device:
        return self.prime_kind().device

    # --- constants ---------------------------------------------------------
    def constant(self, host_value, batch_shape=()):
        return tuple(self.base.constant(c, batch_shape) for c in host_value)

    def zero(self, batch_shape=()):
        z = self.base.zero(batch_shape)
        return (z, z, z)

    def one(self, batch_shape=()):
        return (
            self.base.one(batch_shape),
            self.base.zero(batch_shape),
            self.base.zero(batch_shape),
        )

    def characteristic(self) -> int:
        return self.base.characteristic()

    def extension_degree(self) -> int:
        return self.degree_over_prime

    def mul_by_nonresidue(self, x):
        if self._mul_by_nr_fn is not None:
            return self._mul_by_nr_fn(self.base, x)
        return self.base.mul(
            x, self.base.constant(self.nonresidue_host, self.base.batch_shape(x))
        )

    # --- arithmetic ---------------------------------------------------------
    def add(self, a, b):
        return tuple(self.base.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        return tuple(self.base.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        return tuple(self.base.neg(x) for x in a)

    def mul(self, a, b):
        # One K17 launch via the bilinear-form compiler (fields/dot.py);
        # stacked Karatsuba fallback.
        from . import dot as dot_mod

        out = dot_mod.dot(self, [(1, a, b)])
        if out is not None:
            return out
        B = self.base
        a0, a1, a2 = a
        b0, b1, b2 = b
        sa = B.stack([a0, a1, a2, B.add(a1, a2), B.add(a0, a1), B.add(a0, a2)])
        sb = B.stack([b0, b1, b2, B.add(b1, b2), B.add(b0, b1), B.add(b0, b2)])
        prod = B.mul(sa, sb)
        v0, v1, v2 = (B.index(prod, i) for i in range(3))
        m12, m01, m02 = (B.index(prod, i) for i in range(3, 6))
        t0 = B.sub(B.sub(m12, v1), v2)
        c0 = B.add(v0, self.mul_by_nonresidue(t0))
        t1 = B.sub(B.sub(m01, v0), v1)
        c1 = B.add(t1, self.mul_by_nonresidue(v2))
        t2 = B.sub(B.sub(m02, v0), v2)
        c2 = B.add(t2, v1)
        return (c0, c1, c2)

    def square(self, a):
        from . import dot as dot_mod

        out = dot_mod.dot(self, [(1, a, a)])
        if out is not None:
            return out
        # CH-SQR2 squaring, products stacked into one base-mul call.
        B = self.base
        a0, a1, a2 = a
        t = B.add(B.sub(a0, a1), a2)
        sa = B.stack([a0, a0, t, a1, a2])
        sb = B.stack([a0, a1, t, a2, a2])
        prod = B.mul(sa, sb)
        s0 = B.index(prod, 0)
        s1 = B.double(B.index(prod, 1))
        s2 = B.index(prod, 2)
        s3 = B.double(B.index(prod, 3))
        s4 = B.index(prod, 4)
        c0 = B.add(s0, self.mul_by_nonresidue(s3))
        c1 = B.add(s1, self.mul_by_nonresidue(s4))
        c2 = B.sub(B.add(B.add(s1, s2), s3), B.add(s0, s4))  # s1+s2+s3-s0-s4
        return (c0, c1, c2)

    def inverse(self, a):
        B = self.base
        a0, a1, a2 = a
        t0 = B.sub(B.square(a0), self.mul_by_nonresidue(B.mul(a1, a2)))
        t1 = B.sub(self.mul_by_nonresidue(B.square(a2)), B.mul(a0, a1))
        t2 = B.sub(B.square(a1), B.mul(a0, a2))
        norm = B.add(
            B.mul(a0, t0),
            self.mul_by_nonresidue(B.add(B.mul(a2, t1), B.mul(a1, t2))),
        )
        ninv = B.inverse(norm)
        return (B.mul(t0, ninv), B.mul(t1, ninv), B.mul(t2, ninv))

    def mul_by_base(self, a, b0):
        return tuple(self.base.mul(x, b0) for x in a)

    def mul_by_01(self, a, c0, c1):
        """Sparse multiply by c0 + c1*v."""
        B = self.base
        a0, a1, a2 = a
        a_a = B.mul(a0, c0)
        b_b = B.mul(a1, c1)
        o0 = B.add(a_a, self.mul_by_nonresidue(B.sub(B.mul(B.add(a1, a2), c1), b_b)))
        o1 = B.sub(B.sub(B.mul(B.add(a0, a1), B.add(c0, c1)), a_a), b_b)
        o2 = B.add(B.sub(B.mul(B.add(a0, a2), c0), a_a), b_b)
        return (o0, o1, o2)

    def mul_by_1(self, a, c1):
        """Sparse multiply by c1*v."""
        B = self.base
        a0, a1, a2 = a
        return (self.mul_by_nonresidue(B.mul(a2, c1)), B.mul(a0, c1), B.mul(a1, c1))

    def frobenius(self, a, power: int = 1):
        k = power % self.degree_over_prime
        shape = self.base.batch_shape(a[1])
        c0 = self.base.frobenius(a[0], power)
        c1 = self.base.mul(
            self.base.frobenius(a[1], power),
            self.base.constant(self._frob_c1_host[k], shape),
        )
        c2 = self.base.mul(
            self.base.frobenius(a[2], power),
            self.base.constant(self._frob_c2_host[k], shape),
        )
        return (c0, c1, c2)

    # --- predicates ----------------------------------------------------------
    def is_zero(self, a):
        return self.base.is_zero(a[0]) & self.base.is_zero(a[1]) & self.base.is_zero(a[2])

    def equal(self, a, b):
        return (self.base.equal(a[0], b[0]) & self.base.equal(a[1], b[1])
                & self.base.equal(a[2], b[2]))

    # --- host conversions ----------------------------------------------------
    def from_int(self, x, batch_shape=None):
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
        return tuple(self.base.random(rng, batch_shape) for _ in range(3))

    def __repr__(self):
        return f"CubicExtField({self.name}, device={self.device})"
