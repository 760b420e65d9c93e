"""BN254 (alt_bn128), the Barreto-Naehrig curve of Ethereum's pairing and
curve precompiles (EIP-196/197): the base and scalar prime fields, the
Fq2/Fq6/Fq12 tower, the G1 and G2 curves and the optimal-ate pairing.

The port's own copy of the JAX package's ``curves/instances/bn254.py``:
the published EIP-196/197 constants, and every derived quantity (Frobenius
coefficients, the D-twist's b, the G2 cofactor, the ate loop's NAF digits)
recomputed on the host from p, r and the BN seed; the G2 generator is
checked on the twist and in the r-torsion when G2 is made.  Every kind is
made per device: ``fq12("cpu")`` is the tower on the CPU.

Family equations (Barreto-Naehrig, eprint 2005/133):
    p(x) = 36x^4 + 36x^3 + 24x^2 + 6x + 1
    r(x) = 36x^4 + 36x^3 + 18x^2 + 6x + 1
    t(x) = 6x^2 + 1, with the optimal-ate loop over 6x + 2.
"""

from __future__ import annotations

import functools

import torch

from ... import config
from ...fields.cubic import CubicExtField
from ...fields.fp12 import Fp12Field
from ...fields.host_tower import (HostPrime, HostQuadExt, frobenius_coeffs_cubic,
                                  frobenius_coeffs_quad)
from ...fields.prime import prime_field
from ...fields.quadratic import QuadExtField
from ...fields.spec import field_spec
from ..sw import SWCurve
from . import _derive

X = 4965661367192848881  # BN parameter; 6X + 2 is the ate loop length
P = 36 * X**4 + 36 * X**3 + 24 * X**2 + 6 * X + 1
R = 36 * X**4 + 36 * X**3 + 18 * X**2 + 6 * X + 1
T = 6 * X**2 + 1  # trace of Frobenius: #E(Fp) = p + 1 - t = r

assert P == 21888242871839275222246405745257275088696311157297823662689037894645226208583
assert R == 21888242871839275222246405745257275088548364400416034343698204186575808495617
assert P + 1 - T == R

G1_GENERATOR = (1, 2)

# The standard G2 generator (EIP-197 order: x = x0 + x1 u).
G2_GENERATOR_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GENERATOR_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

fq_spec = field_spec(P, generator=3, name="bn254.Fq")
fr_spec = field_spec(R, generator=5, name="bn254.Fr")

# Field kinds on the default device; ``Fq.to("cpu")`` gives the CPU kind.
Fq = prime_field(fq_spec)
Fr = prime_field(fr_spec)

# host tower mirrors (for constant derivation)
host_fq = HostPrime(P)
FQ2_NONRESIDUE = P - 1  # u^2 = -1
host_fq2 = HostQuadExt(host_fq, FQ2_NONRESIDUE)
FQ6_NONRESIDUE = (9, 1)  # xi = 9 + u

# The D-twist E'/Fq2: y^2 = x^3 + b / xi.
G2_B = host_fq2.mul(host_fq2.from_base_prime(3), host_fq2.inv(FQ6_NONRESIDUE))
G2_COFACTOR = _derive.pick_twist_order(_derive.sextic_twist_orders(P, T), R) // R

# The optimal-ate loop count 6X + 2 in NAF, least significant digit first.
ATE_LOOP_COUNT = _derive.naf_digits_le(6 * X + 2)

# The Frobenius twist of G2 (``Bn._mul_by_char``): xi^((p-1)/3), xi^((p-1)/2).
TWIST_MUL_BY_Q_X = host_fq2.pow(FQ6_NONRESIDUE, (P - 1) // 3)
TWIST_MUL_BY_Q_Y = host_fq2.pow(FQ6_NONRESIDUE, (P - 1) // 2)


def _device(device) -> torch.device:
    return torch.device(device if device is not None else config.default_device)


def _mul_fq_by_neg1(base, x):
    """Nonresidue product in Fq2: nr = -1."""
    return base.neg(x)


def _mul_fq2_by_xi(fq2_kind, x):
    """Nonresidue product in Fq6: (c0 + c1 u)(9 + u) = (9 c0 - c1) + (c0 + 9 c1) u."""
    fq = fq2_kind.base

    def times9(v):
        v4 = fq.double(fq.double(v))
        return fq.add(fq.double(v4), v)

    c0, c1 = x
    return (fq.sub(times9(c0), c1), fq.add(c0, times9(c1)))


def fq2(device=None) -> QuadExtField:
    """Fq2 = Fq[u] / (u^2 + 1) on ``device`` (the default device when None)."""
    return _fq2(_device(device))


@functools.cache
def _fq2(device: torch.device) -> QuadExtField:
    coeffs = frobenius_coeffs_quad(host_fq, FQ2_NONRESIDUE, P, 2)
    return QuadExtField(Fq.to(device), FQ2_NONRESIDUE, coeffs, name="bn254.Fq2",
                        mul_by_nonresidue_fn=_mul_fq_by_neg1)


def fq6(device=None) -> CubicExtField:
    """Fq6 = Fq2[v] / (v^3 - (9 + u))."""
    return _fq6(_device(device))


@functools.cache
def _fq6(device: torch.device) -> CubicExtField:
    c1, c2 = frobenius_coeffs_cubic(host_fq2, FQ6_NONRESIDUE, P, 6)
    return CubicExtField(_fq2(device), FQ6_NONRESIDUE, c1, c2, name="bn254.Fq6",
                         mul_by_nonresidue_fn=_mul_fq2_by_xi)


def fq12(device=None) -> Fp12Field:
    """Fq12 = Fq6[w] / (w^2 - v)."""
    return _fq12(_device(device))


@functools.cache
def _fq12(device: torch.device) -> Fp12Field:
    coeffs = [host_fq2.pow(FQ6_NONRESIDUE, (pow(P, i) - 1) // 6) for i in range(12)]
    return Fp12Field(_fq6(device), coeffs, name="bn254.Fq12")


def g1(device=None) -> SWCurve:
    """BN254 G1, y^2 = x^3 + 3 over Fq, cofactor 1, on ``device``."""
    return _g1(_device(device))


@functools.cache
def _g1(device: torch.device) -> SWCurve:
    x, y = G1_GENERATOR
    assert (y * y - (x * x * x + 3)) % P == 0
    return SWCurve(Fq.to(device), a_host=0, b_host=3, generator_host=G1_GENERATOR,
                   cofactor=1, scalar_modulus=R, name="bn254.G1")


def g2(device=None) -> SWCurve:
    """BN254 G2, y^2 = x^3 + 3 / (9 + u) over Fq2 (the D-twist), on
    ``device``; its generator is checked on the twist and in the r-torsion
    when it is made."""
    return _g2(_device(device))


@functools.cache
def _g2(device: torch.device) -> SWCurve:
    c = SWCurve(_fq2(device), a_host=(0, 0), b_host=G2_B,
                generator_host=(G2_GENERATOR_X, G2_GENERATOR_Y), cofactor=G2_COFACTOR,
                scalar_modulus=R, name="bn254.G2")
    gx, gy = G2_GENERATOR_X, G2_GENERATOR_Y
    rhs = host_fq2.add(host_fq2.mul(host_fq2.mul(gx, gx), gx), G2_B)
    assert host_fq2.equal(host_fq2.mul(gy, gy), rhs), "BN254 G2 generator not on the twist"
    assert c.host_mul_raw((gx, gy), R) is None, "BN254 G2 generator not r-torsion"
    return c


def pairing(device=None):
    """The BN254 optimal-ate pairing (D-twist, positive seed) on ``device``."""
    return _pairing(_device(device))


@functools.cache
def _pairing(device: torch.device):
    from ...pairing.bn import Bn

    return Bn(_g1(device), _g2(device), _fq12(device), x_abs=X, x_is_negative=False,
              ate_loop_count=ATE_LOOP_COUNT, twist_mul_by_q_x_host=TWIST_MUL_BY_Q_X,
              twist_mul_by_q_y_host=TWIST_MUL_BY_Q_Y, twist_type="D")
