"""The port's entry point: the flagship polynomial-product step.

``poly_product`` is the counterpart of the JAX package's flagship step
(BLS12-381 Fr: fft, fft, pointwise multiply, inverse fft, scale by 1/n) —
the core of every polynomial-commitment workload — run through
``DensePolynomial.mul`` and ``Radix2EvaluationDomain``.
"""

from __future__ import annotations

import torch

from . import config, convert
from .curves.instances import bls12_381
from .poly.dense import DensePolynomial


def poly_product(a, b, device=None) -> torch.Tensor:
    """Product of two BLS12-381 Fr polynomials given by their coefficients.

    a, b: [16, n_a], [16, n_b] Montgomery-form limb arrays — int32 tensors,
    or uint32 arrays in the reference's format.  Returns the int32
    [16, size] coefficients of a*b on ``device``, size the power of two
    >= n_a + n_b - 1.  ``device`` defaults to ``config.default_device``
    ("cuda"); there is no fallback to another device.
    """
    device = torch.device(device if device is not None else config.default_device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("poly_product(device='cuda') needs a CUDA device")
    F = bls12_381.Fr.to(device)
    pa = DensePolynomial(F, _as_tensor(a, device))
    pb = DensePolynomial(F, _as_tensor(b, device))
    return pa.mul(pb).coeffs


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return convert.from_reference(x, device)
