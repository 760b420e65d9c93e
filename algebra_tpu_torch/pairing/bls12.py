"""BLS12-family pairings, batched over pairs.

The port of the JAX package's ``pairing/bls12.py``: the Miller loop runs
over the bits of the curve parameter |X| (a host constant) and in parallel
over the pairs; every step is a batched Fp12 square and sparse line product
over all lanes at once, with G2's line-coefficient recurrence fused into
the loop (or taken from ``prepare_g2``'s table).  The final exponentiation
is the easy part f^((p^6 - 1)(p^2 + 1)) and the eprint 2020/875 hard-part
chain.

The reference runs the add step on every bit and selects its result by the
bit, because a ``lax.scan`` body must be the same at every step; the bits
of |X| are known on the host, so here the add step runs only where the bit
is 1.  The result is the same integer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .common import PairingEngine


class G2Prepared(NamedTuple):
    """The line coefficients of a G2 batch (``Bls12.prepare_g2``): one
    (c0, c1, c2) of Fq2 values for each doubling step (a bit of |X| below
    the top one) and one for each add step (a set bit), and the batch's
    infinity mask."""

    dbl: list
    add: list
    inf: torch.Tensor


class Bls12(PairingEngine):
    def __init__(self, g1, g2, fq12, x_abs: int, x_is_negative: bool, twist_type: str = "M"):
        super().__init__(g1, g2, fq12, twist_type)
        self.x_abs = int(x_abs)
        self.x_is_negative = bool(x_is_negative)

    def _bits(self) -> list:
        """The bits of |X| below its top bit, most significant first."""
        return [b == "1" for b in bin(self.x_abs)[3:]]

    def _finish_loop(self, f, p_inf, q_inf, shape):
        """Conjugate for a negative X; lanes where either point is infinity
        give 1."""
        F12 = self.fq12
        if self.x_is_negative:
            f = F12.cyclotomic_inverse(f)
        return F12.select(p_inf | q_inf, F12.one(shape), f)

    # ------------------------------------------------------------ miller loop
    def miller_loop(self, p_aff, q_aff):
        """Batched Miller loop over the bits of |X|: p_aff an affine G1
        batch (x, y, inf), q_aff an affine G2 batch of the same shape.
        Lanes where either input is infinity yield 1."""
        F2, F12 = self.fq2, self.fq12
        px, py, p_inf = p_aff
        qx, qy, q_inf = q_aff
        shape = self.fq.batch_shape(px)
        r = (qx, qy, F2.one(shape))
        f = F12.one(shape)
        for bit in self._bits():
            f = F12.square(f)
            r, coeffs = self._double_step(r, shape)
            f = self._ell(f, coeffs, px, py)
            if bit:
                r, coeffs = self._add_step(r, (qx, qy))
                f = self._ell(f, coeffs, px, py)
        return self._finish_loop(f, p_inf, q_inf, shape)

    # ------------------------------------------------------------ prepared G2
    def prepare_g2(self, q_aff):
        """The line coefficients of every step for a G2 batch, for reuse
        across Miller loops with the same Q (fixed verification keys).
        Returns a ``G2Prepared``."""
        F2 = self.fq2
        qx, qy, q_inf = q_aff
        shape = self.fq.batch_shape(qx[0])
        r = (qx, qy, F2.one(shape))
        c_dbl, c_add = [], []
        for bit in self._bits():
            r, coeffs = self._double_step(r, shape)
            c_dbl.append(coeffs)
            if bit:
                r, coeffs = self._add_step(r, (qx, qy))
                c_add.append(coeffs)
        return G2Prepared(c_dbl, c_add, q_inf)

    def miller_loop_prepared(self, p_aff, prepared: G2Prepared):
        """Miller loop from ``prepare_g2``'s coefficients: the same output
        as ``miller_loop``, with only the line products a step."""
        F12 = self.fq12
        px, py, p_inf = p_aff
        c_dbl, c_add, q_inf = prepared
        shape = self.fq.batch_shape(px)
        f = F12.one(shape)
        adds = iter(c_add)
        for bit, coeffs in zip(self._bits(), c_dbl):
            f = F12.square(f)
            f = self._ell(f, coeffs, px, py)
            if bit:
                f = self._ell(f, next(adds), px, py)
        return self._finish_loop(f, p_inf, q_inf, shape)

    # ----------------------------------------------------- final exponentiation
    def _exp_by_x(self, f):
        r = self.fq12.cyclotomic_exp(f, self.x_abs)
        if self.x_is_negative:
            r = self.fq12.cyclotomic_inverse(r)
        return r

    def final_exponentiation(self, f):
        F12 = self.fq12
        r = self._easy_part(f)
        # hard part (eprint 2020/875 chain)
        y0 = F12.cyclotomic_square(r)
        y1 = self._exp_by_x(r)
        y2 = F12.cyclotomic_inverse(r)
        y1 = F12.mul(y1, y2)
        y2 = self._exp_by_x(y1)
        y1 = F12.cyclotomic_inverse(y1)
        y1 = F12.mul(y1, y2)
        y2 = self._exp_by_x(y1)
        y1 = F12.frobenius(y1, 1)
        y1 = F12.mul(y1, y2)
        r = F12.mul(r, y0)
        y0 = self._exp_by_x(y1)
        y2 = self._exp_by_x(y0)
        y0 = F12.frobenius(y1, 2)
        y1 = F12.cyclotomic_inverse(y1)
        y1 = F12.mul(y1, y2)
        y1 = F12.mul(y1, y0)
        r = F12.mul(r, y1)
        return r

