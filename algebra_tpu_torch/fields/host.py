"""Host-side (Python big-int) prime-field arithmetic, for constant
derivation and the curves' host oracles (``SWCurve.host_*``).

The port's own copy of the prime part of the JAX package's
``fields/host_tower.py``; the extension towers join when the port's towers
do.  An element is a Python int in [0, p).
"""

from __future__ import annotations


class HostPrime:
    degree_over_prime = 1

    def __init__(self, p: int):
        self.p = p

    def zero(self):
        return 0

    def one(self):
        return 1

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def neg(self, a):
        return (-a) % self.p

    def mul(self, a, b):
        return (a * b) % self.p

    def inv(self, a):
        return pow(a, -1, self.p)

    def equal(self, a, b):
        return a % self.p == b % self.p

    def from_base_prime(self, x: int):
        return x % self.p

    def pow(self, a, e: int):
        return pow(a, int(e), self.p)

    def frobenius(self, a, power=1):
        return a
