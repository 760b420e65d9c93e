"""Twisted Edwards curves: batched extended-coordinate group law.

Counterpart of the JAX package's ``curves/te.py``: a x^2 + y^2 =
1 + d x^2 y^2 in extended coordinates (X : Y : T : Z), x = X/Z, y = Y/Z,
T = X Y / Z (Hisil-Wong-Carter-Dawson 2008: dbl-2008-hwcd and the unified
add-2008-hwcd).  The identity (0 : 1 : 0 : 1) is representable and the
unified law has no exceptional case on the complete curves used here, so
nothing is masked.

Every product is a field product of the port (``PrimeField.mul``: kernel
K1 on a CUDA tensor), every sum plain tensor code.  The reference runs its
laws as fused bilinear forms (``fields/dot.py``) where the base field has a
multiplication tensor; those compute the same field values as the plain
formulas here, and outputs are canonical, so the words agree.  Loops the
reference runs as ``lax.scan`` are Python loops over launches.
"""

from __future__ import annotations

import torch

from ..fields.host import HostPrime
from ..fields.prime import PrimeField
from .sw import scalar_bits_le


class TECurve:
    """a x^2 + y^2 = 1 + d x^2 y^2 over a prime field kind."""

    def __init__(self, base: PrimeField, a_host: int, d_host: int, generator_host,
                 cofactor: int, scalar_modulus: int, name: str = "TE"):
        if not isinstance(base, PrimeField):
            raise TypeError(f"the port's curves take a prime base field, not {base}")
        self.base = base
        self.name = name
        self.a_host = int(a_host)
        self.d_host = int(d_host)
        self.generator_host = generator_host
        self.cofactor = int(cofactor)
        self.scalar_modulus = int(scalar_modulus)

    @property
    def device(self) -> torch.device:
        return self.base.device

    # ------------------------------------------------------------ constants
    def _a(self, shape):
        return self.base.constant(self.a_host, shape)

    def _d(self, shape):
        return self.base.constant(self.d_host, shape)

    def zero(self, batch_shape=()):
        B = self.base
        return (B.zero(batch_shape), B.one(batch_shape), B.zero(batch_shape),
                B.one(batch_shape))

    # ----------------------------------------------------------- predicates
    def is_zero(self, P):
        return self.base.is_zero(P[0]) & self.base.equal(P[1], P[3])

    def batch_shape(self, P):
        return self.base.batch_shape(P[0])

    def select(self, mask, P, Q):
        return tuple(self.base.select(mask, p, q) for p, q in zip(P, Q))

    def equal(self, P, Q):
        """x1 z2 == x2 z1 and y1 z2 == y2 z1."""
        B = self.base
        return (B.equal(B.mul(P[0], Q[3]), B.mul(Q[0], P[3]))
                & B.equal(B.mul(P[1], Q[3]), B.mul(Q[1], P[3])))

    # ------------------------------------------------------------ group law
    def neg(self, P):
        B = self.base
        return (B.neg(P[0]), P[1], B.neg(P[2]), P[3])

    def double(self, P):
        """dbl-2008-hwcd: 4 squarings and 5 products."""
        B = self.base
        X1, Y1, T1, Z1 = P
        shape = B.batch_shape(X1)
        A = B.square(X1)
        Bv = B.square(Y1)
        C = B.double(B.square(Z1))
        D = B.mul(self._a(shape), A)
        E = B.sub(B.sub(B.square(B.add(X1, Y1)), A), Bv)
        G = B.add(D, Bv)
        F = B.sub(G, C)
        H = B.sub(D, Bv)
        return (B.mul(E, F), B.mul(G, H), B.mul(E, H), B.mul(F, G))

    def add(self, P, Q):
        """Unified add-2008-hwcd (P = Q and the identity included): 10
        products."""
        B = self.base
        X1, Y1, T1, Z1 = P
        X2, Y2, T2, Z2 = Q
        shape = B.batch_shape(X1)
        A = B.mul(X1, X2)
        Bv = B.mul(Y1, Y2)
        C = B.mul(B.mul(self._d(shape), T1), T2)
        D = B.mul(Z1, Z2)
        E = B.sub(B.sub(B.mul(B.add(X1, Y1), B.add(X2, Y2)), A), Bv)
        F = B.sub(D, C)
        G = B.add(D, C)
        H = B.sub(Bv, B.mul(self._a(shape), A))
        return (B.mul(E, F), B.mul(G, H), B.mul(E, H), B.mul(F, G))

    def add_mixed(self, P, aff):
        """P + affine Q (Z2 = 1, T2 = x2 y2)."""
        B = self.base
        x2, y2 = aff
        return self.add(P, (x2, y2, B.mul(x2, y2), B.one(B.batch_shape(x2))))

    # ------------------------------------------------------- representation
    def from_affine(self, aff):
        B = self.base
        x, y = aff
        return (x, y, B.mul(x, y), B.one(B.batch_shape(x)))

    def to_affine(self, P):
        B = self.base
        X, Y, _, Z = P
        zinv = B.inverse(Z)
        return (B.mul(X, zinv), B.mul(Y, zinv))

    def is_on_curve(self, aff):
        """a x^2 + y^2 == 1 + d x^2 y^2."""
        B = self.base
        x, y = aff
        shape = B.batch_shape(x)
        x2, y2 = B.square(x), B.square(y)
        lhs = B.add(B.mul(self._a(shape), x2), y2)
        rhs = B.add(B.one(shape), B.mul(B.mul(self._d(shape), x2), y2))
        return B.equal(lhs, rhs)

    # ----------------------------------------------------------- scalar mul
    def scalar_mul(self, P, scalars: torch.Tensor):
        """P * scalar for per-lane scalars (int32 [Ls, *batch] canonical
        16-bit limbs): MSB-first double-and-add over all 16 Ls bits."""
        bits = scalar_bits_le(scalars)
        acc = self.zero(self.batch_shape(P))
        for i in range(bits.shape[0] - 1, -1, -1):
            acc = self.double(acc)
            acc = self.select(bits[i], self.add(acc, P), acc)
        return acc

    def mul_int(self, P, k: int):
        """P * k for a host-constant k (no reduction mod r): the bit is the
        same in every lane, so the reference's select is a host branch."""
        k = int(k)
        if k == 0:
            return self.zero(self.batch_shape(P))
        if k < 0:
            return self.neg(self.mul_int(P, -k))
        acc = self.zero(self.batch_shape(P))
        for bit in bin(k)[2:]:
            acc = self.double(acc)
            if bit == "1":
                acc = self.add(acc, P)
        return acc

    def clear_cofactor(self, P):
        return self.mul_int(P, self.cofactor)

    def is_in_correct_subgroup(self, P):
        return self.is_zero(self.mul_int(P, self.scalar_modulus))

    # ------------------------------------------------------------- host side
    def _hf(self) -> HostPrime:
        return HostPrime(self.base.spec.modulus)

    def host_is_in_correct_subgroup(self, pt) -> bool:
        """[r] pt == (0, 1) for a host affine point."""
        if self.cofactor == 1:
            return True
        return self.host_mul_raw(pt, self.scalar_modulus) == (0, 1)

    def host_add(self, P, Q):
        hf = self._hf()
        x1, y1 = P
        x2, y2 = Q
        a, d = hf.from_base_prime(self.a_host), hf.from_base_prime(self.d_host)
        dxy = hf.mul(hf.mul(d, hf.mul(x1, x2)), hf.mul(y1, y2))
        x3 = hf.mul(hf.add(hf.mul(x1, y2), hf.mul(y1, x2)), hf.inv(hf.add(1, dxy)))
        y3 = hf.mul(hf.sub(hf.mul(y1, y2), hf.mul(a, hf.mul(x1, x2))),
                    hf.inv(hf.sub(1, dxy)))
        return (x3, y3)

    def host_mul_raw(self, P, k: int):
        """Host scalar mul WITHOUT reduction mod r (for points outside the
        subgroup)."""
        acc = (0, 1)
        for bit in bin(int(k))[2:] if k else "":
            acc = self.host_add(acc, acc)
            if bit == "1":
                acc = self.host_add(acc, P)
        return acc

    def host_mul(self, P, k: int):
        return self.host_mul_raw(P, int(k) % self.scalar_modulus)

    def to_montgomery_host(self, pt):
        """TE (x, y) -> the Montgomery curve's (u, v) = ((1 + y)/(1 - y),
        (1 + y)/((1 - y) x)), away from the exceptional points."""
        hf = self._hf()
        x, y = pt
        u = hf.mul(hf.add(1, y), hf.inv(hf.sub(1, y)))
        return (u, hf.mul(u, hf.inv(x)))

    def from_host(self, points):
        """Host affine points ((x, y) ints) -> affine batch [n]."""
        return (self.base.from_int([p[0] for p in points]),
                self.base.from_int([p[1] for p in points]))

    def to_host(self, P):
        """Projective batch -> host affine points; a bare point for batch ()."""
        x, y = self.to_affine(P)
        xs, ys = self.base.to_int(x), self.base.to_int(y)
        if not isinstance(xs, list):
            return (xs, ys)
        return list(zip(xs, ys))

    def __repr__(self):
        return f"TECurve({self.name}, device={self.device})"
