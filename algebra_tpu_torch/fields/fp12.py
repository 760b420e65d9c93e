"""Fp12 = quadratic over Fp6 (= cubic over Fp2) with the pairing's fast ops.

The port of the JAX package's ``fields/fp12.py``: the sparse line
products ``mul_by_014`` / ``mul_by_034`` (one K17 launch each over the
nonzero slice of the bilinear form), the cyclotomic squaring of the final
exponentiation (a full squaring in one K17 launch where the tower has a
multiplication tensor, Granger-Scott otherwise) and the Frobenius map.
All ops batched.
"""

from __future__ import annotations

from .cubic import CubicExtField
from .quadratic import QuadExtField


class Fp12Field(QuadExtField):
    """base must be a CubicExtField over a QuadExtField (Fp6 over Fp2)."""

    def __init__(self, fp6: CubicExtField, frobenius_coeffs_c1_host, name="Fp12"):
        # nonresidue is v (the cubic generator): (0, 1, 0) in Fp6-over-Fp2
        fp2 = fp6.base
        nr_host = ((0, 0), (1, 0), (0, 0))

        def mul_by_v(base, x):
            # (c0, c1, c2) * v = (nr6 * c2, c0, c1)
            return (fp6.mul_by_nonresidue(x[2]), x[0], x[1])

        super().__init__(
            fp6,
            nr_host,
            frobenius_coeffs_c1_host,
            name,
            mul_by_nonresidue_fn=mul_by_v,
        )
        self.fp6 = fp6
        self.fp2 = fp2

    # Frobenius: the coefficients are Fp2 values applied to each Fp2
    # coordinate of c1.
    def frobenius(self, a, power: int = 1):
        k = power % 12
        fp6, fp2 = self.fp6, self.fp2
        c0 = fp6.frobenius(a[0], power)
        c1 = fp6.frobenius(a[1], power)
        shape = fp2.batch_shape(c1[0])
        coeff = fp2.constant(self._frob_host[k], shape)
        c1 = tuple(fp2.mul(x, coeff) for x in c1)
        return (c0, c1)

    # --- sparse multiplications ------------------------------------------------
    # Sparse Fp2-slot masks over the 12 prime coordinates (flatten order
    # c0.(0,1,2) then c1.(0,1,2), two prime coords per Fp2 slot).
    @staticmethod
    def _slot_mask(slots):
        m = [False] * 12
        for s in slots:
            m[2 * s] = m[2 * s + 1] = True
        return tuple(m)

    def _sparse_mul(self, f, g, slots):
        from . import dot as dot_mod

        out = dot_mod.dot(self, [(1, f, g, None, self._slot_mask(slots))])
        if out is not None:
            return out
        return self.mul(f, g)

    def mul_by_014(self, f, c0, c1, c4):
        """f * (c0 + c1*v + c4*v*w) with c_i in Fp2 (M-twist line
        evaluation): one K17 launch over the 12x36 nonzero slice of the
        bilinear form."""
        z = self.fp2.zero(self.fp2.batch_shape(c0))
        g = ((c0, c1, z), (z, c4, z))
        return self._sparse_mul(f, g, (0, 1, 4))

    def mul_by_034(self, f, c0, c3, c4):
        """f * (c0 + c3*w + c4*v*w) with c_i in Fp2 (D-twist line
        evaluation)."""
        z = self.fp2.zero(self.fp2.batch_shape(c0))
        g = ((c0, z, z), (c3, c4, z))
        return self._sparse_mul(f, g, (0, 3, 4))

    # --- cyclotomic squaring (Granger-Scott) -----------------------------------
    def _fp4_square(self, a, b):
        fp2, fp6 = self.fp2, self.fp6
        t0 = fp2.square(a)
        t1 = fp2.square(b)
        out0 = fp2.add(fp6.mul_by_nonresidue(t1), t0)
        out1 = fp2.sub(fp2.sub(fp2.square(fp2.add(a, b)), t0), t1)
        return out0, out1

    def cyclotomic_square(self, f):
        # With the bilinear-form compiler a FULL squaring is one K17
        # launch (78 prime products), where Granger-Scott takes ~9 Fp2
        # squares and ~20 Fp2 sums; Granger-Scott remains the path for
        # towers without a small-integer multiplication tensor.
        from . import dot as dot_mod

        out = dot_mod.dot(self, [(1, f, f)])
        if out is not None:
            return out
        fp2, fp6 = self.fp2, self.fp6
        (z0, z4, z3), (z2, z1, z5) = f

        t0, t1 = self._fp4_square(z0, z1)
        # z0 = 3*t0 - 2*z0 ; z1 = 3*t1 + 2*z1
        z0n = fp2.sub(t0, z0)
        z0n = fp2.add(fp2.double(z0n), t0)
        z1n = fp2.add(t1, z1)
        z1n = fp2.add(fp2.double(z1n), t1)

        t0, t1 = self._fp4_square(z2, z3)
        t2, t3 = self._fp4_square(z4, z5)

        z4n = fp2.sub(t0, z4)
        z4n = fp2.add(fp2.double(z4n), t0)
        z5n = fp2.add(t1, z5)
        z5n = fp2.add(fp2.double(z5n), t1)

        t3nr = fp6.mul_by_nonresidue(t3)
        z2n = fp2.add(t3nr, z2)
        z2n = fp2.add(fp2.double(z2n), t3nr)
        z3n = fp2.sub(t2, z3)
        z3n = fp2.add(fp2.double(z3n), t2)

        return ((z0n, z4n, z3n), (z2n, z1n, z5n))
