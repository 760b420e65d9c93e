"""The port's entry points: polynomial product, exact quotient, G1 MSM,
batched affine point addition, scalar multiplication (GLV on secp256k1,
double-and-add on Jubjub), fixed-base multiplication, and the BLS12-381
and BN254 pairings (a batch of pairings, the multi-pairing, prepared G2
points).

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
from .curves.instances import bls12_381, bn254, ed_on_bls12_381, secp256k1
from .ops import fixed_base, msm
from .pairing.bls12 import G2Prepared
from .pairing.bn import BnG2Prepared
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


# The pairing-friendly curves of ``g1_msm`` and the pairing entry points:
# each name's instance module and the type of its prepared G2 points.
_PAIRING_CURVES = {"bls12_381": (bls12_381, G2Prepared), "bn254": (bn254, BnG2Prepared)}


def _pairing_curve(curve: str, caller: str):
    if curve not in _PAIRING_CURVES:
        raise ValueError(f"{caller}: curve must be one of {sorted(_PAIRING_CURVES)}, "
                         f"not {curve!r}")
    return _PAIRING_CURVES[curve]


def g1_msm(bases, scalars, curve: str = "bls12_381", device=None):
    """sum_i scalars[i] * bases[i] over G1 of ``curve``, "bls12_381" or
    "bn254".

    bases: the affine triple in the reference's format, (x, y, inf): x, y
    uint32 [L, n] Montgomery-form Fq limbs (L = 24 for BLS12-381, 16 for
    BN254), inf bool [n] (numpy arrays or tensors).  scalars: uint32
    [16, n] canonical limbs, each below r.  Returns the Jacobian point
    (x, y, z), int32 [L] each, on ``device``.  Same device rule as
    ``poly_product``.
    """
    inst, _ = _pairing_curve(curve, "g1_msm")
    device = _device_for(device, "g1_msm")
    c = inst.g1(device)
    return msm.msm(c, convert.points_from_reference(bases, device),
                   _as_tensor(scalars, device))


_SW_CURVES = {"secp256k1": secp256k1.g1, "bls12_381_g1": bls12_381.g1}


def _sw_curve(curve: str, device: torch.device, caller: str):
    if curve not in _SW_CURVES:
        raise ValueError(f"{caller}: curve must be one of {sorted(_SW_CURVES)}, not {curve!r}")
    return _SW_CURVES[curve](device)


def batch_affine_add(P, Q, curve: str = "secp256k1", neg1=None, neg2=None, device=None):
    """P + Q lane by lane for batches of affine points, by the chord/tangent
    law with every exceptional case (``SWCurve.affine_add``: kernel K9, the
    blocked batched inversion K2-K4, kernel K10).

    P, Q: affine triples (x, y, inf) in the reference's format: x, y uint32
    [L, *batch] Montgomery-form limbs (L = 16 for secp256k1, 24 for
    BLS12-381 G1), inf bool [*batch]; numpy arrays or tensors.  neg1, neg2:
    optional bool [*batch] masks that negate the y of P, Q first.  Returns
    (x3, y3, inf3): int32 [L, *batch] twice and bool [*batch] on
    ``device``.  Same device rule as ``poly_product``.
    """
    device = _device_for(device, "batch_affine_add")
    c = _sw_curve(curve, device, "batch_affine_add")
    P = convert.points_from_reference(P, device)
    Q = convert.points_from_reference(Q, device)
    neg1, neg2 = (None if m is None else torch.as_tensor(m, device=device)
                  for m in (neg1, neg2))
    return c.affine_add(P, Q, c.base.batch_inverse, neg1=neg1, neg2=neg2)


def scalar_mul(bases, scalars, curve: str = "secp256k1", device=None):
    """scalars[i] * bases[i] lane by lane.

    secp256k1: bases an affine triple (x, y, inf) as for
    ``batch_affine_add``; full-width scalars take the GLV split
    (``ops/glv.glv_mul``).  ed_on_bls12_381 (Jubjub): bases an affine pair
    (x, y) of uint32 [16, *batch] Montgomery-form limbs; double-and-add.
    scalars: uint32 [Ls, *batch] canonical limbs, each below the curve's
    scalar modulus (GLV takes Ls = 16, the full width).  Returns the
    projective points (Jacobian (x, y, z) or extended (x, y, t, z)), int32
    [L, *batch] each, on ``device``.  Same device rule as ``poly_product``.
    """
    device = _device_for(device, "scalar_mul")
    if curve == "ed_on_bls12_381":
        c = ed_on_bls12_381.curve(device)
    else:
        c = _sw_curve(curve, device, "scalar_mul")
    P = c.from_affine(convert.points_from_reference(bases, device))
    return c.scalar_mul(P, _as_tensor(scalars, device))


def fixed_base_msm(scalars, c: int, curve: str = "secp256k1", device=None):
    """scalars[i] * G for the curve's generator G: the window table of G
    for c-bit windows (``ops/fixed_base.window_table``), then one gather and
    one addition a window over the batch (``fixed_base.msm``).

    scalars: uint32 [Ls, n] canonical limbs.  Returns the Jacobian points
    [n], int32 [L, n] each, on ``device``.  Same device rule as
    ``poly_product``.
    """
    device = _device_for(device, "fixed_base_msm")
    g = _sw_curve(curve, device, "fixed_base_msm")
    sc = _as_tensor(scalars, device)
    table = fixed_base.window_table(g, g.generator(), c, 16 * sc.shape[0])
    return fixed_base.msm(g, table, sc, c)


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


def _affine(curve, pts, device):
    """An affine batch on ``device`` from the reference's affine triple or
    from a list of host points."""
    if isinstance(pts, list):
        return curve.from_host(pts)
    return convert.points_from_reference(pts, device)


def _pairing_inputs(ctx, prepared_type, p, q, device, caller: str):
    """G1 and G2 affine batches (or prepared G2 points) on ``device``; a
    prepared batch of another curve is refused."""
    other = tuple(t for _, t in _PAIRING_CURVES.values() if t is not prepared_type)
    if isinstance(q, other):
        raise ValueError(f"{caller}: the prepared G2 points are of another curve")
    return (_affine(ctx.g1, p, device),
            q if isinstance(q, prepared_type) else _affine(ctx.g2, q, device))


def pairing(p, q, curve: str = "bls12_381", device=None):
    """e(p[i], q[i]) lane by lane over ``curve``, "bls12_381" or "bn254": a
    batched Miller loop and one batched final exponentiation.

    p: G1 affine points, the reference's triple (x, y, inf) (x, y uint32
    [L, n] Montgomery-form Fq limbs, L = 24 for BLS12-381 and 16 for BN254,
    inf bool [n]) or a list of host points ((x, y) ints, None for
    infinity).  q: G2 affine points the same way (x, y as (c0, c1) pairs of
    [L, n] arrays; host points ((x0, x1), (y0, y1))), or ``prepare_g2``'s
    result for the same curve.  Returns the Fq12 values as nested tuples
    ((c0, c1, c2), (c0, c1, c2)) of (c0, c1) int32 [L, n] Montgomery-form
    tensors on ``device``; a lane with a point at infinity gives 1.  Same
    device rule as ``poly_product``.
    """
    inst, prepared_type = _pairing_curve(curve, "pairing")
    device = _device_for(device, "pairing")
    ctx = inst.pairing(device)
    p, q = _pairing_inputs(ctx, prepared_type, p, q, device, "pairing")
    if isinstance(q, prepared_type):
        return ctx.final_exponentiation(ctx.miller_loop_prepared(p, q))
    return ctx.pairing(p, q)


def multi_pairing(p, q, curve: str = "bls12_381", device=None):
    """prod_i e(p[i], q[i]) over ``curve``, "bls12_381" or "bn254": the
    lanes' Miller loops, their product, and ONE final exponentiation.  p, q
    as for ``pairing`` (q not prepared), batch [n].  Returns one Fq12 value
    (int32 [L] tensors)."""
    inst, prepared_type = _pairing_curve(curve, "multi_pairing")
    device = _device_for(device, "multi_pairing")
    ctx = inst.pairing(device)
    p, q = _pairing_inputs(ctx, prepared_type, p, q, device, "multi_pairing")
    if isinstance(q, prepared_type):
        raise ValueError("multi_pairing takes G2 points, not prepared ones")
    return ctx.multi_pairing(p, q)


def prepare_g2(q, curve: str = "bls12_381", device=None):
    """The line coefficients of the Miller loop for a batch of G2 points of
    ``curve`` (given as for ``pairing``), to pair with many G1 batches of
    the same shape: ``pairing(p, prepare_g2(q, curve), curve)`` equals
    ``pairing(p, q, curve)``.  A ``G2Prepared`` for BLS12-381, a
    ``BnG2Prepared`` for BN254."""
    inst, _ = _pairing_curve(curve, "prepare_g2")
    device = _device_for(device, "prepare_g2")
    ctx = inst.pairing(device)
    return ctx.prepare_g2(_affine(ctx.g2, q, device))
