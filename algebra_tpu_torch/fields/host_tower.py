"""Host-side (Python big-int) tower-field arithmetic: the port's own copy of
the JAX package's ``fields/host_tower.py``.

It derives the towers' constants (Frobenius coefficients, the G2
endomorphism's coefficients) when a tower kind is made, gives the curves
over a tower their host oracles (``SWCurve.host_*``), and feeds
``fields/dot.mul_tensor`` the products of unit vectors.

Representation: an element of a tower is a nested tuple/int --
  Fp element:   int
  Fp2 element:  (c0, c1)            with u^2 = nonresidue (in base)
  Fp6 element:  ((..),(..),(..))    cubic over Fp2, v^3 = nonresidue (Fp2)
and so on.  Each host field carries its base field and nonresidue.
"""

from __future__ import annotations

from .host import HostPrime

__all__ = ["HostPrime", "HostQuadExt", "HostCubicExt", "frobenius_coeffs_quad",
           "frobenius_coeffs_cubic"]


class HostQuadExt:
    """base[u]/(u^2 - nonresidue)."""

    def __init__(self, base, nonresidue):
        self.base = base
        self.nr = nonresidue
        self.degree_over_prime = 2 * base.degree_over_prime

    def zero(self):
        return (self.base.zero(), self.base.zero())

    def one(self):
        return (self.base.one(), self.base.zero())

    def add(self, a, b):
        return (self.base.add(a[0], b[0]), self.base.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.base.sub(a[0], b[0]), self.base.sub(a[1], b[1]))

    def neg(self, a):
        return (self.base.neg(a[0]), self.base.neg(a[1]))

    def mul(self, a, b):
        v0 = self.base.mul(a[0], b[0])
        v1 = self.base.mul(a[1], b[1])
        c0 = self.base.add(v0, self.base.mul(self.nr, v1))
        c1 = self.base.sub(
            self.base.sub(
                self.base.mul(self.base.add(a[0], a[1]), self.base.add(b[0], b[1])),
                v0,
            ),
            v1,
        )
        return (c0, c1)

    def inv(self, a):
        norm = self.base.sub(
            self.base.mul(a[0], a[0]), self.base.mul(self.nr, self.base.mul(a[1], a[1]))
        )
        ninv = self.base.inv(norm)
        return (self.base.mul(a[0], ninv), self.base.neg(self.base.mul(a[1], ninv)))

    def equal(self, a, b):
        return self.base.equal(a[0], b[0]) and self.base.equal(a[1], b[1])

    def from_base_prime(self, x: int):
        return (self.base.from_base_prime(x), self.base.zero())

    def pow(self, a, e: int):
        res = self.one()
        for bit in bin(int(e))[2:]:
            res = self.mul(res, res)
            if bit == "1":
                res = self.mul(res, a)
        return res


class HostCubicExt:
    """base[v]/(v^3 - nonresidue)."""

    def __init__(self, base, nonresidue):
        self.base = base
        self.nr = nonresidue
        self.degree_over_prime = 3 * base.degree_over_prime

    def zero(self):
        z = self.base.zero()
        return (z, z, z)

    def one(self):
        return (self.base.one(), self.base.zero(), self.base.zero())

    def add(self, a, b):
        return tuple(self.base.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        return tuple(self.base.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        return tuple(self.base.neg(x) for x in a)

    def mul(self, a, b):
        B = self.base
        a0, a1, a2 = a
        b0, b1, b2 = b
        v0, v1, v2 = B.mul(a0, b0), B.mul(a1, b1), B.mul(a2, b2)
        c0 = B.add(
            v0,
            B.mul(
                self.nr,
                B.sub(
                    B.sub(B.mul(B.add(a1, a2), B.add(b1, b2)), v1),
                    v2,
                ),
            ),
        )
        c1 = B.add(
            B.sub(B.sub(B.mul(B.add(a0, a1), B.add(b0, b1)), v0), v1),
            B.mul(self.nr, v2),
        )
        c2 = B.add(
            B.sub(B.sub(B.mul(B.add(a0, a2), B.add(b0, b2)), v0), v2), v1
        )
        return (c0, c1, c2)

    def inv(self, a):
        B = self.base
        a0, a1, a2 = a
        t0 = B.sub(B.mul(a0, a0), B.mul(self.nr, B.mul(a1, a2)))
        t1 = B.sub(B.mul(self.nr, B.mul(a2, a2)), B.mul(a0, a1))
        t2 = B.sub(B.mul(a1, a1), B.mul(a0, a2))
        norm = B.add(
            B.mul(a0, t0),
            B.mul(self.nr, B.add(B.mul(a2, t1), B.mul(a1, t2))),
        )
        ninv = B.inv(norm)
        return (B.mul(t0, ninv), B.mul(t1, ninv), B.mul(t2, ninv))

    def equal(self, a, b):
        return all(self.base.equal(x, y) for x, y in zip(a, b))

    def from_base_prime(self, x: int):
        return (self.base.from_base_prime(x), self.base.zero(), self.base.zero())

    def pow(self, a, e: int):
        res = self.one()
        for bit in bin(int(e))[2:]:
            res = self.mul(res, res)
            if bit == "1":
                res = self.mul(res, a)
        return res


def frobenius_coeffs_quad(base_host, nonresidue, p: int, degree_over_prime: int):
    """Frobenius coefficients for base[u]/(u^2 - nr):
    coeff[i] = nr^((p^i - 1) / 2), i in 0..degree_over_prime-1.

    (Derivation of the tables in e.g. fq2.rs/fq12.rs of the reference.)
    """
    out = []
    for i in range(degree_over_prime):
        e = (pow(p, i) - 1) // 2
        out.append(base_host.pow(nonresidue, e))
    return out


def frobenius_coeffs_cubic(base_host, nonresidue, p: int, degree_over_prime: int):
    """Frobenius coefficients for base[v]/(v^3 - nr):
    c1[i] = nr^((p^i - 1) / 3), c2[i] = nr^((2p^i - 2) / 3)."""
    c1, c2 = [], []
    for i in range(degree_over_prime):
        e = (pow(p, i) - 1) // 3
        c1.append(base_host.pow(nonresidue, e))
        c2.append(base_host.pow(nonresidue, 2 * e))
    return c1, c2
