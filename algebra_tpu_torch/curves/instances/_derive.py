"""Host-side derivation helpers for pairing-curve instances: the port's own
copy of the part of the JAX package's ``curves/instances/_derive.py`` that
BN254 needs.

Twist orders (for the G2 cofactor) and the non-adjacent form of the ate
loop count, recomputed from p, t and r with Python ints when an instance is
made.  Plain int code, with no device work.
"""

from __future__ import annotations

import math


def trace_power(t: int, p: int, k: int) -> int:
    """Trace of Frobenius of E(F_{p^k}) from the base trace t:
    t_k satisfies the Lucas recurrence t_{i+1} = t * t_i - p * t_{i-1}."""
    t_prev, t_cur = 2, t  # t_0 = 2, t_1 = t
    for _ in range(k - 1):
        t_prev, t_cur = t_cur, t * t_cur - p * t_prev
    return t_cur


def quadratic_twist_order(p: int, t: int, k: int) -> int:
    """#E'(F_{p^k}) of the quadratic twist of E over F_{p^k}."""
    tk = trace_power(t, p, k)
    return p**k + 1 + tk


def sextic_twist_orders(p: int, t: int) -> list[int]:
    """The six possible orders of sextic twists of E over F_{p^2}
    (Hess-Smart-Vercauteren): computed from t2, f2 with
    t2^2 - 4 p^2 = -3 f2^2."""
    t2 = t * t - 2 * p
    d = 4 * p * p - t2 * t2
    assert d % 3 == 0
    f2 = _isqrt_exact(d // 3)
    q = p * p
    return [
        q + 1 - t2,
        q + 1 + t2,
        q + 1 - (t2 + 3 * f2) // 2,
        q + 1 - (t2 - 3 * f2) // 2,
        q + 1 + (t2 + 3 * f2) // 2,
        q + 1 + (t2 - 3 * f2) // 2,
    ]


def _isqrt_exact(n: int) -> int:
    r = math.isqrt(n)
    assert r * r == n, "not a perfect square"
    return r


def pick_twist_order(orders, r: int) -> int:
    """The unique candidate order divisible by r."""
    hits = [o for o in orders if o % r == 0]
    assert hits, "no twist order divisible by r"
    return hits[0]


def naf_digits_le(n: int) -> list[int]:
    """Non-adjacent form of n (little-endian digits in {-1, 0, 1})."""
    assert n > 0
    out = []
    while n:
        if n & 1:
            d = 2 - (n % 4)
            out.append(d)
            n -= d
        else:
            out.append(0)
        n >>= 1
    return out
