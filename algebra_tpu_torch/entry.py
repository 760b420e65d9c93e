"""The port's entry points: polynomial product, exact quotient, G1 MSM.

``poly_product`` is the counterpart of the JAX package's flagship step
(BLS12-381 Fr: fft, fft, pointwise multiply, inverse fft, scale by 1/n) —
the core of every polynomial-commitment workload — run through
``DensePolynomial.mul`` and ``Radix2EvaluationDomain``.

``poly_quotient`` divides in evaluation form, the way a prover forms its
quotient polynomial: both inputs are evaluated over a coset, divided
pointwise through the field's batched inversion, and interpolated.  It
composes ``Radix2EvaluationDomain.get_coset``, ``fft``, ``Evaluations.div``
and ``interpolate`` and adds nothing to them.
"""

from __future__ import annotations

import torch

from . import config, convert
from .curves.instances import bls12_381
from .ops import msm
from .poly.dense import DensePolynomial
from .poly.domain import Radix2EvaluationDomain
from .poly.evaluations import Evaluations


def poly_product(a, b, device=None) -> torch.Tensor:
    """Product of two BLS12-381 Fr polynomials given by their coefficients.

    a, b: [16, n_a], [16, n_b] Montgomery-form limb arrays — int32 tensors,
    or uint32 arrays in the reference's format.  Returns the int32
    [16, size] coefficients of a*b on ``device``, size the power of two
    >= n_a + n_b - 1.  ``device`` defaults to ``config.default_device``
    ("cuda"); there is no fallback to another device.
    """
    F = _field_on(device, "poly_product")
    pa = DensePolynomial(F, _as_tensor(a, F.device))
    pb = DensePolynomial(F, _as_tensor(b, F.device))
    return pa.mul(pb).coeffs


def poly_quotient(num, den, device=None) -> torch.Tensor:
    """Quotient num / den of two BLS12-381 Fr polynomials, for a ``den``
    that divides ``num`` exactly.

    num, den: [16, n_num], [16, n_den] Montgomery-form limb arrays, as for
    ``poly_product``; n_den <= n_num.  Both are evaluated over the coset
    g * H, H the radix-2 subgroup of the power-of-two size >= n_num and g
    the field's multiplicative generator (so a divisor that vanishes on H
    still divides), divided pointwise and interpolated.  Returns the int32
    [16, size] coefficients on ``device``.  Where ``den`` does not divide
    ``num`` the result is the polynomial that agrees with num / den on the
    coset, not a quotient with remainder.  Same device rule as
    ``poly_product``.
    """
    F = _field_on(device, "poly_quotient")
    num_t, den_t = _as_tensor(num, F.device), _as_tensor(den, F.device)
    n = num_t.shape[1]
    if den_t.shape[1] > n:
        raise ValueError("the divisor has more coefficients than the dividend")
    size = 1 << (n - 1).bit_length() if n > 1 else 1
    coset = Radix2EvaluationDomain(F, size).get_coset(F.spec.generator)
    num_e = Evaluations(F, coset, coset.fft(num_t))
    den_e = Evaluations(F, coset, coset.fft(den_t))
    return num_e.div(den_e).interpolate().coeffs


def g1_msm(bases, scalars, device=None):
    """sum_i scalars[i] * bases[i] over BLS12-381 G1.

    bases: the affine triple in the reference's format, (x, y, inf): x, y
    uint32 [24, n] Montgomery-form Fq limbs, inf bool [n] (numpy arrays or
    tensors).  scalars: uint32 [16, n] canonical limbs, each below r.
    Returns the Jacobian point (x, y, z), int32 [24] each, on ``device``.
    Same device rule as ``poly_product``.
    """
    device = _device_for(device, "g1_msm")
    curve = bls12_381.g1(device)
    return msm.msm(curve, convert.points_from_reference(bases, device),
                   _as_tensor(scalars, device))


def _device_for(device, caller: str) -> torch.device:
    """``device`` (``config.default_device`` when None); there is no
    fallback to another device."""
    device = torch.device(device if device is not None else config.default_device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}(device='cuda') needs a CUDA device")
    return device


def _field_on(device, caller: str):
    """BLS12-381 Fr on ``device``, by the rule of ``_device_for``."""
    return bls12_381.Fr.to(_device_for(device, caller))


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return convert.from_reference(x, device)
