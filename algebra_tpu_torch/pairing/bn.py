"""BN-family (Barreto-Naehrig) optimal-ate pairing, batched over pairs.

The port of the JAX package's ``pairing/bn.py``: the Miller loop runs over
the NAF digits of |6X + 2| (digits in {-1, 0, 1}), then two Frobenius-twisted
add steps with q1 = pi(Q) and q2 = -pi^2(Q); the final exponentiation's
hard part is the Fuentes-Castaneda et al. chain.  Every tower product goes
through the ``dot_multi`` waves of ``pairing/common.py`` (one K17 launch
each), with the D-twist's line coefficients and ``Fp12Field.mul_by_034``.

The reference runs the add step on every digit, adding Q or -Q by the
digit's sign, and selects its result where the digit is not 0, because a
``lax.scan`` body must be the same at every step; the digits are known on
the host, so here the add step runs only where the digit is not 0, with
-Q where it is -1.  The result is the same integer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .common import PairingEngine


class BnG2Prepared(NamedTuple):
    """The line coefficients of a G2 batch (``Bn.prepare_g2``): one (c0, c1,
    c2) of Fq2 values for each doubling step (a digit of the ate loop count
    below the top one) and one for each add step (a digit that is not 0),
    the two Frobenius-twisted tail steps', and the batch's infinity mask."""

    dbl: list
    add: list
    c1: tuple
    c2: tuple
    inf: torch.Tensor


class Bn(PairingEngine):
    def __init__(self, g1, g2, fq12, x_abs: int, x_is_negative: bool, ate_loop_count,
                 twist_mul_by_q_x_host, twist_mul_by_q_y_host, twist_type: str = "D"):
        """ate_loop_count: the little-endian digits in {-1, 0, 1} of |6X + 2|;
        twist_mul_by_q_x_host, twist_mul_by_q_y_host: the Fq2 host values
        xi^((p-1)/3) and xi^((p-1)/2)."""
        super().__init__(g1, g2, fq12, twist_type)
        self.x_abs = int(x_abs)
        self.x_is_negative = bool(x_is_negative)
        self.ate_loop_count = [int(d) for d in ate_loop_count]
        self.twist_mul_by_q_x_host = twist_mul_by_q_x_host
        self.twist_mul_by_q_y_host = twist_mul_by_q_y_host

    def _digits(self) -> list:
        """The digits below the top one, most significant first."""
        return self.ate_loop_count[-2::-1]

    def _mul_by_char(self, q_aff, shape):
        """q -> the Frobenius-twisted point pi(q)."""
        F2 = self.fq2
        x, y = q_aff
        x = F2.mul(F2.frobenius(x, 1), F2.constant(self.twist_mul_by_q_x_host, shape))
        y = F2.mul(F2.frobenius(y, 1), F2.constant(self.twist_mul_by_q_y_host, shape))
        return (x, y)

    def _tail_points(self, q_aff, shape):
        """q1 = pi(Q) and q2 = -pi^2(Q), the tail steps' points."""
        q1 = self._mul_by_char(q_aff, shape)
        q2 = self._mul_by_char(q1, shape)
        return q1, (q2[0], self.fq2.neg(q2[1]))

    def _finish_loop(self, f, p_inf, q_inf, shape):
        """Lanes where either point is infinity give 1."""
        F12 = self.fq12
        return F12.select(p_inf | q_inf, F12.one(shape), f)

    # ------------------------------------------------------------ miller loop
    def miller_loop(self, p_aff, q_aff):
        """Batched optimal-ate Miller loop: p_aff an affine G1 batch (x, y,
        inf), q_aff an affine G2 batch of the same shape.  Lanes where
        either input is infinity yield 1."""
        F2, F12 = self.fq2, self.fq12
        px, py, p_inf = p_aff
        qx, qy, q_inf = q_aff
        shape = self.fq.batch_shape(px)
        r = (qx, qy, F2.one(shape))
        f = F12.one(shape)
        neg_qy = F2.neg(qy)
        for d in self._digits():
            f = F12.square(f)  # harmless on the first step (f == 1)
            r, coeffs = self._double_step(r, shape)
            f = self._ell(f, coeffs, px, py)
            if d:
                r, coeffs = self._add_step(r, (qx, qy if d > 0 else neg_qy))
                f = self._ell(f, coeffs, px, py)
        if self.x_is_negative:
            f = F12.cyclotomic_inverse(f)
            r = (r[0], F2.neg(r[1]), r[2])
        for q in self._tail_points((qx, qy), shape):
            r, coeffs = self._add_step(r, q)
            f = self._ell(f, coeffs, px, py)
        return self._finish_loop(f, p_inf, q_inf, shape)

    # ------------------------------------------------------------ prepared G2
    def prepare_g2(self, q_aff) -> BnG2Prepared:
        """The line coefficients of every step for a G2 batch, for reuse
        across Miller loops with the same Q (fixed verification keys)."""
        F2 = self.fq2
        qx, qy, q_inf = q_aff
        shape = self.fq.batch_shape(qx[0])
        r = (qx, qy, F2.one(shape))
        c_dbl, c_add = [], []
        neg_qy = F2.neg(qy)
        for d in self._digits():
            r, coeffs = self._double_step(r, shape)
            c_dbl.append(coeffs)
            if d:
                r, coeffs = self._add_step(r, (qx, qy if d > 0 else neg_qy))
                c_add.append(coeffs)
        if self.x_is_negative:
            r = (r[0], F2.neg(r[1]), r[2])
        q1, q2 = self._tail_points((qx, qy), shape)
        r, c1 = self._add_step(r, q1)
        _, c2 = self._add_step(r, q2)
        return BnG2Prepared(c_dbl, c_add, c1, c2, q_inf)

    def miller_loop_prepared(self, p_aff, prepared: BnG2Prepared):
        """Miller loop from ``prepare_g2``'s coefficients: the same output
        as ``miller_loop``, with only the line products a step."""
        F12 = self.fq12
        px, py, p_inf = p_aff
        c_dbl, c_add, c1, c2, q_inf = prepared
        shape = self.fq.batch_shape(px)
        f = F12.one(shape)
        adds = iter(c_add)
        for d, coeffs in zip(self._digits(), c_dbl):
            f = F12.square(f)
            f = self._ell(f, coeffs, px, py)
            if d:
                f = self._ell(f, next(adds), px, py)
        if self.x_is_negative:
            f = F12.cyclotomic_inverse(f)
        f = self._ell(f, c1, px, py)
        f = self._ell(f, c2, px, py)
        return self._finish_loop(f, p_inf, q_inf, shape)

    # ----------------------------------------------------- final exponentiation
    def _exp_by_neg_x(self, f):
        r = self.fq12.cyclotomic_exp(f, self.x_abs)
        if not self.x_is_negative:
            r = self.fq12.cyclotomic_inverse(r)
        return r

    def final_exponentiation(self, f):
        F12 = self.fq12
        r = self._easy_part(f)
        # hard part: Fuentes-Castaneda et al.
        y0 = self._exp_by_neg_x(r)
        y1 = F12.cyclotomic_square(y0)
        y2 = F12.cyclotomic_square(y1)
        y3 = F12.mul(y2, y1)
        y4 = self._exp_by_neg_x(y3)
        y5 = F12.cyclotomic_square(y4)
        y6 = self._exp_by_neg_x(y5)
        y3 = F12.cyclotomic_inverse(y3)
        y6 = F12.cyclotomic_inverse(y6)
        y7 = F12.mul(y6, y4)
        y8 = F12.mul(y7, y3)
        y9 = F12.mul(y8, y1)
        y10 = F12.mul(y8, y4)
        y11 = F12.mul(y10, r)
        y12 = F12.frobenius(y9, 1)
        y13 = F12.mul(y12, y11)
        y8f = F12.frobenius(y8, 2)
        y14 = F12.mul(y8f, y13)
        r = F12.cyclotomic_inverse(r)
        y15 = F12.mul(r, y9)
        y15 = F12.frobenius(y15, 3)
        return F12.mul(y15, y14)
