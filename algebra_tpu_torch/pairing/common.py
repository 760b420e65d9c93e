"""Shared pairing machinery for the BLS12 family.

The port of the JAX package's ``pairing/common.py``: the
homogeneous-projective G2 line-coefficient steps (eprint 2013/722), the
sparse line product dispatched by twist type, the easy part of the final
exponentiation, and the multi-pairing (the product of Miller loops, one
final exponentiation).  All operations are batched over pairs.

Each step is hand-decomposed into a few ``dot_multi`` "waves": a wave is
ONE K17 launch computing several linear combinations of Fq2 products.
The unfused steps remain as the path for towers without a small-integer
multiplication tensor.
"""

from __future__ import annotations

import torch

from ..fields import dot as dot_mod
from ..fields.field import tree_leaves, tree_map
from ..fields.fp12 import Fp12Field


class PairingEngine:
    def __init__(self, g1, g2, fq12: Fp12Field, twist_type: str = "M"):
        self.g1 = g1
        self.g2 = g2
        self.fq12 = fq12
        self.fq2 = fq12.fp2
        self.fq = g1.base
        self.twist_type = twist_type
        p = self.fq.spec.modulus
        self.two_inv_host = pow(2, -1, p)
        self.twist_b_host = g2.b_host

    @property
    def device(self) -> torch.device:
        return self.fq.device

    # ----------------------------------------------------- G2 prepare steps

    def _double_step(self, r, shape):
        F2, F = self.fq2, self.fq
        x, y, z = r
        # wave 1: raw input products
        w1 = dot_mod.dot_multi(F2, [[(1, x, y)], [(1, y, y)], [(1, z, z)], [(1, y, z)],
                                    [(1, x, x)]])
        if w1 is None:
            return self._double_step_generic(r, shape)
        xy, b, c, yz, j = w1
        one2 = F2.one(())
        two_inv_c = F2.constant((self.two_inv_host, 0))
        twist_b_c = F2.constant(self.twist_b_host)
        p_mod = F.spec.modulus
        tb_half_c = F2.constant(tuple(v * self.two_inv_host % p_mod for v in self.twist_b_host))
        m0 = (True, False)  # base-field constants live in coordinate 0
        # wave 2: a = xy/2, e = 3*b_twist*c, g = b/2 + (9/2)*b_twist*c
        a, e, g = dot_mod.dot_multi(F2, [
            [(1, two_inv_c, xy, m0, None)],
            [(3, twist_b_c, c)],
            [(1, two_inv_c, b, m0, None), (9, tb_half_c, c)],
        ])
        # wave 3: outputs and line coefficients
        new_x, new_y, new_z, i, j3, neg_h = dot_mod.dot_multi(F2, [
            [(1, a, b), (-3, a, e)],          # new_x = a(b - 3e)
            [(1, g, g), (-3, e, e)],          # new_y = g^2 - 3e^2
            [(2, b, yz)],                     # new_z = b * h, h = 2yz
            [(1, e, one2), (-1, b, one2)],    # i = e - b
            [(3, j, one2)],                   # 3j
            [(-2, yz, one2)],                 # -h
        ])
        coeffs = (i, j3, neg_h) if self.twist_type == "M" else (neg_h, j3, i)
        return (new_x, new_y, new_z), coeffs

    def _double_step_generic(self, r, shape):
        F2, F = self.fq2, self.fq
        x, y, z = r
        two_inv = F.constant(self.two_inv_host, shape)
        a = F2.mul_by_base(F2.mul(x, y), two_inv)
        b = F2.square(y)
        c = F2.square(z)
        three_c = F2.add(F2.double(c), c)
        e = F2.mul(F2.constant(self.twist_b_host, shape), three_c)
        f = F2.add(F2.double(e), e)
        g = F2.mul_by_base(F2.add(b, f), two_inv)
        h = F2.sub(F2.square(F2.add(y, z)), F2.add(b, c))
        i = F2.sub(e, b)
        j = F2.square(x)
        e_sq = F2.square(e)
        new_x = F2.mul(a, F2.sub(b, f))
        new_y = F2.sub(F2.square(g), F2.add(F2.double(e_sq), e_sq))
        new_z = F2.mul(b, h)
        j3 = F2.add(F2.double(j), j)
        coeffs = (i, j3, F2.neg(h)) if self.twist_type == "M" else (F2.neg(h), j3, i)
        return (new_x, new_y, new_z), coeffs

    def _add_step(self, r, q_aff):
        F2 = self.fq2
        x, y, z = r
        qx, qy = q_aff
        one2 = F2.one(())
        # wave 1: theta = y - qy z, lam = x - qx z
        w1 = dot_mod.dot_multi(F2, [[(1, y, one2), (-1, qy, z)],
                                    [(1, x, one2), (-1, qx, z)]])
        if w1 is None:
            return self._add_step_generic(r, q_aff)
        theta, lam = w1
        # wave 2: c = theta^2, d = lam^2
        c, d = dot_mod.dot_multi(F2, [[(1, theta, theta)], [(1, lam, lam)]])
        # wave 3: e = lam d, f = z c, g = x d, j = theta qx - lam qy
        e, f, g, jc = dot_mod.dot_multi(F2, [
            [(1, lam, d)],
            [(1, z, c)],
            [(1, x, d)],
            [(1, theta, qx), (-1, lam, qy)],
        ])
        # wave 4: with h = e + f - 2g: new_x = lam h;
        #   new_y = theta (g - h) - e y = 3 theta g - theta e - theta f - e y;
        #   new_z = z e; -theta
        new_x, new_y, new_z, neg_theta = dot_mod.dot_multi(F2, [
            [(1, lam, e), (1, lam, f), (-2, lam, g)],
            [(3, theta, g), (-1, theta, e), (-1, theta, f), (-1, e, y)],
            [(1, z, e)],
            [(-1, theta, one2)],
        ])
        coeffs = (jc, neg_theta, lam) if self.twist_type == "M" else (lam, neg_theta, jc)
        return (new_x, new_y, new_z), coeffs

    def _add_step_generic(self, r, q_aff):
        F2 = self.fq2
        x, y, z = r
        qx, qy = q_aff
        theta = F2.sub(y, F2.mul(qy, z))
        lam = F2.sub(x, F2.mul(qx, z))
        c = F2.square(theta)
        d = F2.square(lam)
        e = F2.mul(lam, d)
        f = F2.mul(z, c)
        g = F2.mul(x, d)
        h = F2.sub(F2.add(e, f), F2.double(g))
        new_x = F2.mul(lam, h)
        new_y = F2.sub(F2.mul(theta, F2.sub(g, h)), F2.mul(e, y))
        new_z = F2.mul(z, e)
        j = F2.sub(F2.mul(theta, qx), F2.mul(lam, qy))
        coeffs = (j, F2.neg(theta), lam) if self.twist_type == "M" else (lam, F2.neg(theta), j)
        return (new_x, new_y, new_z), coeffs

    def _ell(self, f, coeffs, px, py):
        F2 = self.fq2
        c0, c1, c2 = coeffs
        if self.twist_type == "M":
            c2 = F2.mul_by_base(c2, py)
            c1 = F2.mul_by_base(c1, px)
            return self.fq12.mul_by_014(f, c0, c1, c2)
        c0 = F2.mul_by_base(c0, py)
        c1 = F2.mul_by_base(c1, px)
        return self.fq12.mul_by_034(f, c0, c1, c2)

    # ------------------------------------------------------------ easy part
    def _easy_part(self, f):
        """f^((p^6 - 1)(p^2 + 1)): one Fp12 inversion (down to the batched
        inversion of Fq, kernels K2-K4), a conjugate, two products and a
        Frobenius map."""
        F12 = self.fq12
        f1 = F12.conjugate(f)
        f2 = F12.inverse(f)
        r = F12.mul(f1, f2)
        f2 = r
        r = F12.frobenius(r, 2)
        return F12.mul(r, f2)

    # ------------------------------------------------------------- public API
    def miller_loop(self, p_aff, q_aff):
        raise NotImplementedError

    def final_exponentiation(self, f):
        raise NotImplementedError

    def pairing(self, p_aff, q_aff):
        return self.final_exponentiation(self.miller_loop(p_aff, q_aff))

    def multi_miller_loop(self, p_aff, q_aff, axis=0):
        f = self.miller_loop(p_aff, q_aff)
        return field_prod(self.fq12, f, axis=axis)

    def multi_pairing(self, p_aff, q_aff, axis=0):
        return self.final_exponentiation(self.multi_miller_loop(p_aff, q_aff, axis=axis))


def field_prod(field, value, axis=0):
    """Product of a batched field value along one BATCH axis, by a pairwise
    tree of products (tensors are limb-major, so batch axis k is tensor
    axis k + 1)."""
    axis = axis + 1 if axis >= 0 else axis
    n = tree_leaves(value)[0].shape[axis]
    while n > 1:
        half = n // 2
        lo = tree_map(lambda a: a.narrow(axis, 0, half), value)
        hi = tree_map(lambda a: a.narrow(axis, half, half), value)
        combined = field.mul(lo, hi)
        if n % 2:
            combined = tree_map(lambda c, a: torch.cat([c, a.narrow(axis, n - 1, 1)], dim=axis),
                                combined, value)
            n = half + 1
        else:
            n = half
        value = combined
    return tree_map(lambda a: a.squeeze(axis), value)
