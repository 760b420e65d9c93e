"""BLS12-381: the base and scalar prime fields and the G1 curve.

Parameters are the standard public BLS12-381 constants, as the JAX
package's ``curves/instances/bls12_381.py`` holds them; every derived
constant comes from the field compiler or is computed here.  G2, the towers
and the pairing parameters are not here yet.
"""

from __future__ import annotations

import functools

import torch

from ... import config
from ...fields.prime import prime_field
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

G1_GENERATOR_X = 3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507
G1_GENERATOR_Y = 1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569

# The nontrivial cube root of unity in Fq whose GLV eigenvalue on the
# r-subgroup is -X^2 (the 2^((p-1)/3) branch), for the fast subgroup check.
G1_BETA = pow(2, (P - 1) // 3, P)

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
