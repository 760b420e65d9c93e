"""BLS12-381: the base and scalar prime fields, the Fq2/Fq6/Fq12 tower,
the G1 and G2 curves and the pairing.

Parameters are the standard public BLS12-381 constants, as the JAX
package's ``curves/instances/bls12_381.py`` holds them; every derived
constant (Montgomery constants, Frobenius coefficients, the G2
endomorphism's coefficients) comes from the field compiler or the host
tower and is computed here.  Every kind is made per device: ``fq12("cpu")``
is the tower on the CPU.
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

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# BLS parameter X: p, r and the curve family come from it.
# X = -0xd201000000010000.
X_ABS = 0xD201000000010000
X_IS_NEGATIVE = True

G1_COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB
# (x - 1): the effective cofactor for G1 clearing (eprint 2019/403 section 5).
G1_H_EFF = 0xD201000000010001

G2_COFACTOR = 0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5

G1_GENERATOR_X = 3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507
G1_GENERATOR_Y = 1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569

G2_GENERATOR_X_C0 = 0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8
G2_GENERATOR_X_C1 = 0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E
G2_GENERATOR_Y_C0 = 0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801
G2_GENERATOR_Y_C1 = 0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE

# The nontrivial cube root of unity in Fq whose GLV eigenvalue on the
# r-subgroup is -X^2 (the 2^((p-1)/3) branch), for the fast subgroup check.
G1_BETA = pow(2, (P - 1) // 3, P)

# host tower mirrors (for constant derivation)
host_fq = HostPrime(P)
FQ2_NONRESIDUE = P - 1  # -1
host_fq2 = HostQuadExt(host_fq, FQ2_NONRESIDUE)
FQ6_NONRESIDUE = (1, 1)  # u + 1

# G2's psi (untwist-Frobenius-twist) coefficients: (u+1)^(-(p-1)/3) and
# (u+1)^(-(p-1)/2).
G2_PSI_X = host_fq2.inv(host_fq2.pow(FQ6_NONRESIDUE, (P - 1) // 3))
G2_PSI_Y = host_fq2.inv(host_fq2.pow(FQ6_NONRESIDUE, (P - 1) // 2))

fq_spec = field_spec(P, generator=2, name="bls12_381.Fq")
fr_spec = field_spec(
    R, generator=7, small_subgroup_base=3, small_subgroup_power=1, name="bls12_381.Fr"
)

# Field kinds on the default device; ``Fr.to("cpu")`` gives the CPU kind.
Fq = prime_field(fq_spec)
Fr = prime_field(fr_spec)


def g1(device=None) -> SWCurve:
    """BLS12-381 G1, y^2 = x^3 + 4 over Fq, on ``device`` (the default
    device when None), with the fast cofactor clearing and subgroup checks
    installed."""
    return _g1(torch.device(device if device is not None else config.default_device))


@functools.cache
def _g1(device: torch.device) -> SWCurve:
    F = Fq.to(device)
    c = SWCurve(F, a_host=0, b_host=4, generator_host=(G1_GENERATOR_X, G1_GENERATOR_Y),
                cofactor=G1_COFACTOR, scalar_modulus=R, name="bls12_381.G1")

    # Cofactor clearing by the effective cofactor x - 1.
    def clear_cofactor(P_):
        return c.mul_int(P_, G1_H_EFF)

    c.clear_cofactor = clear_cofactor

    # P is in the r-subgroup iff sigma(P) == -[X^2]P, with the endomorphism
    # sigma(x, y) = (BETA x, y) (eprint 2021/1130 section 6): two 64-bit
    # scalar multiplications instead of one by r.
    def check_host(curve, pt):
        sigma = (G1_BETA * pt[0] % P, pt[1])
        x2p = curve.host_mul_raw(curve.host_mul_raw(pt, X_ABS), X_ABS)
        if x2p is None:
            return False
        return sigma == (x2p[0], (P - x2p[1]) % P)

    def check_device(curve, Pt):
        beta = F.constant(G1_BETA, F.batch_shape(Pt[0]))
        sigma = (F.mul(beta, Pt[0]), Pt[1], Pt[2])
        x2p = curve.mul_int(curve.mul_int(Pt, X_ABS), X_ABS)
        return curve.equal(sigma, curve.neg(x2p))

    c.subgroup_check_host = check_host
    c.subgroup_check_device = check_device
    return c


def _device(device) -> torch.device:
    return torch.device(device if device is not None else config.default_device)


def _mul_fq_by_neg1(base, x):
    """Nonresidue product in Fq2: nr = -1."""
    return base.neg(x)


def _mul_fq2_by_u_plus_1(fq2_kind, x):
    """Nonresidue product in Fq6: (c0 + c1 u)(1 + u) = (c0 - c1) + (c0 + c1) u."""
    fq = fq2_kind.base
    c0, c1 = x
    return (fq.sub(c0, c1), fq.add(c0, c1))


def fq2(device=None) -> QuadExtField:
    """Fq2 = Fq[u] / (u^2 + 1) on ``device`` (the default device when None)."""
    return _fq2(_device(device))


@functools.cache
def _fq2(device: torch.device) -> QuadExtField:
    coeffs = frobenius_coeffs_quad(host_fq, FQ2_NONRESIDUE, P, 2)
    return QuadExtField(Fq.to(device), FQ2_NONRESIDUE, coeffs, name="bls12_381.Fq2",
                        mul_by_nonresidue_fn=_mul_fq_by_neg1)


def fq6(device=None) -> CubicExtField:
    """Fq6 = Fq2[v] / (v^3 - (u + 1))."""
    return _fq6(_device(device))


@functools.cache
def _fq6(device: torch.device) -> CubicExtField:
    c1, c2 = frobenius_coeffs_cubic(host_fq2, FQ6_NONRESIDUE, P, 6)
    return CubicExtField(_fq2(device), FQ6_NONRESIDUE, c1, c2, name="bls12_381.Fq6",
                         mul_by_nonresidue_fn=_mul_fq2_by_u_plus_1)


def fq12(device=None) -> Fp12Field:
    """Fq12 = Fq6[w] / (w^2 - v)."""
    return _fq12(_device(device))


@functools.cache
def _fq12(device: torch.device) -> Fp12Field:
    # w^2 = v, v^3 = u + 1, so the Frobenius coefficient c1[i] is
    # (u + 1)^((p^i - 1) / 6), an Fq2 value.
    coeffs = [host_fq2.pow(FQ6_NONRESIDUE, (pow(P, i) - 1) // 6) for i in range(12)]
    return Fp12Field(_fq6(device), coeffs, name="bls12_381.Fq12")


def g2(device=None) -> SWCurve:
    """BLS12-381 G2, y^2 = x^3 + 4 (u + 1) over Fq2 (the M-twist), with the
    endomorphism ``psi`` (on affine batches) and the subgroup checks by it
    installed; cofactor clearing multiplies by the cofactor, as the
    reference's does."""
    return _g2(_device(device))


def psi_host(pt):
    """psi(x, y) = (frob(x) PSI_X, frob(y) PSI_Y) on a host affine point."""
    def frob(v):
        return (v[0], (P - v[1]) % P)

    return (host_fq2.mul(frob(pt[0]), G2_PSI_X), host_fq2.mul(frob(pt[1]), G2_PSI_Y))


@functools.cache
def _g2(device: torch.device) -> SWCurve:
    F2 = _fq2(device)
    c = SWCurve(F2, a_host=(0, 0), b_host=(4, 4),  # 4 (u + 1)
                generator_host=((G2_GENERATOR_X_C0, G2_GENERATOR_X_C1),
                                (G2_GENERATOR_Y_C0, G2_GENERATOR_Y_C1)),
                cofactor=G2_COFACTOR, scalar_modulus=R, name="bls12_381.G2")

    def psi(aff):
        """psi on an affine batch (x, y, inf): (frob(x) PSI_X,
        frob(y) PSI_Y, inf)."""
        ax, ay, inf = aff
        shape = F2.batch_shape(ax)
        return (F2.mul(F2.frobenius(ax, 1), F2.constant(G2_PSI_X, shape)),
                F2.mul(F2.frobenius(ay, 1), F2.constant(G2_PSI_Y, shape)), inf)

    c.psi = psi

    # Q is in the r-subgroup iff psi(Q) == [x]Q (eprint 2021/1130 section 4),
    # x = -X_ABS.
    def check_host(curve, pt):
        xq = curve.host_mul_raw(pt, X_ABS)
        if xq is None:
            return False
        return psi_host(pt) == (xq[0], host_fq2.neg(xq[1]))

    def check_device(curve, Qt):
        # psi acts on affine coordinates: normalise first
        aff = curve.to_affine(Qt)
        xq = curve.mul_int(curve.from_affine(aff), X_ABS)
        return curve.equal(curve.from_affine(psi(aff)), curve.neg(xq))

    c.subgroup_check_host = check_host
    c.subgroup_check_device = check_device
    return c


def pairing(device=None):
    """The BLS12-381 pairing (M-twist, X = -0xd201000000010000) on
    ``device``."""
    return _pairing(_device(device))


@functools.cache
def _pairing(device: torch.device):
    from ...pairing.bls12 import Bls12

    return Bls12(_g1(device), _g2(device), _fq12(device), X_ABS, X_IS_NEGATIVE,
                 twist_type="M")
