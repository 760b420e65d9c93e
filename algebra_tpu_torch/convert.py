"""The one place that knows how the JAX package's arrays relate to the
port's tensors.

Today the two formats coincide: limb-major [L, *batch], little-endian
16-bit limbs, one limb per 32-bit word, Montgomery form, canonical.  The
reference holds them as numpy/JAX ``uint32``; the port as ``torch.int32``
(limbs are < 2^16, so the sign bit never matters, and int32 is the type
torch computes with on every device).  Every test crosses here, so the
stored format can change later without touching them.

What crosses: field-element arrays (``from_reference``/``to_reference``),
which is all that the inputs and outputs of the field layer, batched
inversion, the polynomial classes and the polynomial entry points are;
curve points (``points_from_reference``/``points_to_reference``): affine
``(x, y, inf)`` triples with a bool mask and Jacobian ``(x, y, z)``
triples, twisted Edwards ``(x, y)`` pairs and extended ``(x, y, t, z)``
points, the inputs and outputs of the group laws, the MSM and the curve
entry points; and a domain's twiddle tables
(``domain_from_reference``).  Other masks and int8 results (``is_zero``,
``legendre``, ``sqrt``'s ok) compare as plain numpy arrays and need
nothing here.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .fields.prime import PrimeField
from .poly.domain import Radix2EvaluationDomain


def from_reference(arr, device=None) -> torch.Tensor:
    """uint32 [L, *batch] limb array (numpy, or anything ``np.asarray``
    takes) -> int32 tensor on ``device`` (the default device when None)."""
    device = torch.device(device if device is not None else config.default_device)
    a = np.array(arr, dtype=np.uint32, order="C")  # a copy the tensor may own
    return torch.from_numpy(a.view(np.int32)).to(device)


def to_reference(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor (any device) -> numpy uint32 [L, *batch]."""
    a = t.detach().cpu().contiguous().numpy()
    return a.view(np.uint32)


def points_from_reference(pt, device=None) -> tuple:
    """A point's coordinates as reference arrays (or tensors), e.g. an
    affine (x, y, inf) or Jacobian (x, y, z) triple or a twisted Edwards
    (x, y) pair -> a tuple of tensors on ``device``: limb arrays as
    ``from_reference``, a bool inf mask as a bool tensor."""
    device = torch.device(device if device is not None else config.default_device)
    return tuple(_coord_from_reference(c, device) for c in pt)


def points_to_reference(pt) -> tuple:
    """A point's tensors -> numpy: limb arrays as ``to_reference``, a
    bool mask as a numpy bool array, a tower coordinate as a tuple of
    them."""
    return tuple(_coord_to_reference(c) for c in pt)


def tower_from_reference(value, device=None):
    """A tower value in the reference's form, nested tuples of uint32
    [L, *batch] arrays (e.g. an Fq12 value: two tuples of three tuples of
    two), -> the same nesting of int32 tensors on ``device``."""
    device = torch.device(device if device is not None else config.default_device)
    return _coord_from_reference(value, device)


def tower_to_reference(value):
    """A tower value's nested tuples of tensors -> nested tuples of numpy
    uint32 arrays."""
    return _coord_to_reference(value)


def _coord_to_reference(c):
    if isinstance(c, tuple):
        return tuple(_coord_to_reference(x) for x in c)
    return c.detach().cpu().numpy() if c.dtype == torch.bool else to_reference(c)


def _coord_from_reference(c, device: torch.device):
    if isinstance(c, tuple):
        return tuple(_coord_from_reference(x, device) for x in c)
    if isinstance(c, torch.Tensor):
        return c.to(device)
    a = np.asarray(c)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    return from_reference(a, device)


def domain_from_reference(field: PrimeField, size: int, offset, roots,
                          roots_inv) -> Radix2EvaluationDomain:
    """A port domain over ``field`` that computes from a reference domain's
    twiddle tables (``roots``, ``roots_inv``: uint32 [L, size/2] arrays),
    so both sides start from the same state."""
    d = Radix2EvaluationDomain(field, size, offset)
    d._roots = from_reference(roots, field.device)
    d._roots_inv = from_reference(roots_inv, field.device)
    return d
