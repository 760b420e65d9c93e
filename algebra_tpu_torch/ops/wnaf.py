"""wNAF scalar multiplication by a host scalar.

Counterpart of the JAX package's ``ops/wnaf.py``: a table of the odd
multiples [1, 3, 5, ...] * base and the scalar's signed w-NAF digits, most
significant first, each step a doubling and, for a nonzero digit, the
addition of a table entry or its negative.  The digits are host values, the
same in every lane, so the reference's ``lax.scan`` with per-step selects
is a Python loop with host branches here (the same group operations on the
lanes).  Any curve kind with ``double``/``add``/``neg`` serves.
"""

from __future__ import annotations


def wnaf_digits(k: int, w: int) -> list:
    """Signed w-NAF digits of k (little-endian): odd, |d| < 2^(w-1)."""
    out = []
    while k != 0:
        if k & 1:
            d = k % (1 << w)
            if d >= 1 << (w - 1):
                d -= 1 << w
            k -= d
        else:
            d = 0
        out.append(d)
        k >>= 1
    return out


class WnafContext:
    def __init__(self, curve, window_size: int):
        if window_size < 2:
            raise ValueError(f"a w-NAF window has at least 2 bits, not {window_size}")
        self.curve = curve
        self.w = window_size

    def table(self, base) -> list:
        """The 2^(w-1) odd multiples [1, 3, 5, ...] * base."""
        c = self.curve
        double_base = c.double(base)
        entries = [base]
        for _ in range((1 << (self.w - 1)) - 1):
            entries.append(c.add(entries[-1], double_base))
        return entries

    def mul(self, base, k: int):
        """base * k for a host scalar k, lane by lane over base's batch."""
        c = self.curve
        digits = wnaf_digits(int(k) % c.scalar_modulus, self.w)
        acc = c.zero(c.batch_shape(base))
        if not digits:
            return acc
        tbl = self.table(base)
        for d in reversed(digits):
            acc = c.double(acc)
            if d:
                entry = tbl[(abs(d) - 1) // 2]
                acc = c.add(acc, c.neg(entry) if d < 0 else entry)
        return acc
