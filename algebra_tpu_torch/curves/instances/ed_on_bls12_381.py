"""ed-on-BLS12-381 (Jubjub): the twisted Edwards curve over BLS12-381's Fr.

The port's own copy of the JAX package's
``curves/instances/ed_on_bls12_381.py``: a = -1, d = -(10240/10241),
cofactor 8, and the birationally equivalent Montgomery curve
(A, B) = (40962, -40964).  The base field is the port's BLS12-381 Fr
(16 limbs, W = 8).
"""

from __future__ import annotations

import functools

import torch

from ... import config
from ...fields.prime import prime_field
from ...fields.spec import field_spec
from ..te import TECurve
from .bls12_381 import R as FQ_MODULUS, fr_spec as fq_spec

# the scalar field of the prime-order subgroup
FR_MODULUS = 6554484396890773809930967563523245729705921265872317281365359162392183254199
fr_spec = field_spec(FR_MODULUS, generator=6, name="ed_on_bls12_381.Fr")

Fq = prime_field(fq_spec)  # BLS12-381 Fr
Fr = prime_field(fr_spec)

COEFF_A = FQ_MODULUS - 1  # -1
COEFF_D = 19257038036680949359750312669786877991949435402254120286184196891950884077233
COFACTOR = 8

GENERATOR_X = 8076246640662884909881801758704306714034609987455869804520522091855516602923
GENERATOR_Y = 13262374693698910701929044844600465831413122818447359594527400194675274060458

MONT_COEFF_A = 40962
MONT_COEFF_B = FQ_MODULUS - 40964


def curve(device=None) -> TECurve:
    """Jubjub on ``device`` (the default device when None)."""
    return _curve(torch.device(device if device is not None else config.default_device))


@functools.cache
def _curve(device: torch.device) -> TECurve:
    return TECurve(Fq.to(device), a_host=COEFF_A, d_host=COEFF_D,
                   generator_host=(GENERATOR_X, GENERATOR_Y), cofactor=COFACTOR,
                   scalar_modulus=FR_MODULUS, name="ed_on_bls12_381")
