"""secp256k1: y^2 = x^3 + 7, with GLV endomorphism parameters.

The port's own copy of the JAX package's ``curves/instances/secp256k1.py``:
the standard public secp256k1 constants, the endomorphism constants
(beta^3 = 1 mod p, lambda^3 = 1 mod r) and the LLL-reduced decomposition
basis from the literature (GLV 2001).  Both p and r use all 256 bits, so
the Montgomery radix R = 2^256 leaves no spare top bit.
"""

from __future__ import annotations

import functools

import torch

from ... import config
from ...fields.prime import prime_field
from ...fields.spec import field_spec
from ..sw import SWCurve

P = 115792089237316195423570985008687907853269984665640564039457584007908834671663
R = 115792089237316195423570985008687907852837564279074904382605163141518161494337

fq_spec = field_spec(P, generator=3, name="secp256k1.Fq")
fr_spec = field_spec(R, generator=7, name="secp256k1.Fr")

# Field kinds on the default device; ``Fq.to("cpu")`` gives the CPU kind.
Fq = prime_field(fq_spec)
Fr = prime_field(fr_spec)

G_GENERATOR_X = 55066263022277343669578718895168534326250603453777594175500187360389116729240
G_GENERATOR_Y = 32670510020758816978083085130507043184471273380659243275938904335757337482424

# GLV endomorphism phi(x, y) = (beta * x, y) acts as multiplication by
# lambda on the prime-order group.
GLV_BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
GLV_LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
# LLL-reduced lattice basis for the decomposition k = k1 + k2*lambda:
# rows (a1, b1), (a2, b2) with a_i + b_i*lambda = 0 (mod r).
GLV_A1 = 0x3086D221A7D46BCDE86C90E49284EB15
GLV_B1 = -0xE4437ED6010E88286F547FA90ABFE4C3
GLV_A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
GLV_B2 = 0x3086D221A7D46BCDE86C90E49284EB15


def g1(device=None) -> SWCurve:
    """The secp256k1 group on ``device`` (the default device when None)."""
    return _g1(torch.device(device if device is not None else config.default_device))


@functools.cache
def _g1(device: torch.device) -> SWCurve:
    return SWCurve(Fq.to(device), a_host=0, b_host=7,
                   generator_host=(G_GENERATOR_X, G_GENERATOR_Y), cofactor=1,
                   scalar_modulus=R, name="secp256k1.G1",
                   glv=dict(beta=GLV_BETA, lam=GLV_LAMBDA,
                            basis=((GLV_A1, GLV_B1), (GLV_A2, GLV_B2))))
