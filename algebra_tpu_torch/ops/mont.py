"""Batched multi-limb Montgomery arithmetic on torch tensors.

Layout: **limb-major** — element batches are ``int32[L, *batch]`` with the
limb axis FIRST (little-endian 16-bit limbs, one per 32-bit word) and batch
axes trailing; values are in Montgomery form and canonical (< p).  Limb
values stay below 2^16, so the sign bit of int32 never matters.  Binary ops
auto-align mixed batch ranks by inserting singleton axes right after the
limb axis (the limb-major analogue of right-aligned broadcasting).

``mul``, ``square`` and ``batch_inverse`` go through the CUDA kernels for
CUDA tensors and through their plain versions for CPU tensors
(``ops/mont_kernels.py``); ``add``/``sub``/``neg`` are plain tensor code on
either device.
"""

from __future__ import annotations

import functools

import torch

from ..fields.spec import FieldSpec
from . import mont_kernels


@functools.lru_cache(maxsize=256)
def _const(limbs: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(limbs, dtype=torch.int32, device=device)


def expand(x: torch.Tensor, batch_ndim: int) -> torch.Tensor:
    """Insert singleton batch axes after the limb axis so a [L, *b] value
    broadcasts against a higher-rank [L, *B, *b] batch."""
    missing = batch_ndim - (x.ndim - 1)
    if missing <= 0:
        return x
    return x.reshape(x.shape[:1] + (1,) * missing + x.shape[1:])


def _align(a: torch.Tensor, b: torch.Tensor):
    """Auto-align two limb-major values of different batch rank."""
    if a.ndim < b.ndim:
        a = expand(a, b.ndim - 1)
    elif b.ndim < a.ndim:
        b = expand(b, a.ndim - 1)
    return a, b


def bconst(spec_limbs, batch_shape=(), device=None) -> torch.Tensor:
    """Host limb list -> [L, *batch] broadcast constant (a view: one element
    of storage) on ``device`` (the default device when None)."""
    from .. import config

    device = torch.device(device if device is not None else config.default_device)
    v = _const(tuple(int(x) for x in spec_limbs), device)
    batch_shape = tuple(batch_shape)
    return v.reshape(v.shape + (1,) * len(batch_shape)).expand(v.shape + batch_shape)


# ---------------------------------------------------------------------------
# ring operations (inputs/outputs: int32[L, ...], Montgomery form, < p)
# ---------------------------------------------------------------------------


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _align(a, b)
    return mont_kernels.add_plain(spec, a, b)


def double(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return add(spec, a, a)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _align(a, b)
    return mont_kernels.sub_plain(spec, a, b)


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """p - a, with 0 staying 0."""
    zero = torch.zeros_like(a)
    return mont_kernels.sub_plain(spec, zero, a)


def is_zero(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=0)


def equal(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _align(a, b)
    return (a == b).all(dim=0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise select over the batch (mask broadcasts right-aligned
    against the trailing batch axes)."""
    return torch.where(mask, a, b)


def mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * R^-1 mod p."""
    a, b = _align(a, b)
    return mont_kernels.mul(spec, _contig(a), _contig(b))


def square(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    a = _contig(a)
    return mont_kernels.mul(spec, a, a)


def _contig(x: torch.Tensor) -> torch.Tensor:
    """Limb-major contiguous storage for the kernel.  A broadcast view of
    ONE element (e.g. ``bconst``) shrinks back to that element, which the
    kernel reads with stride 0; any other strided view is materialised."""
    if x.is_contiguous():
        return x
    if all(s == 0 for s in x.stride()[1:]):
        return x[(slice(None),) + (slice(0, 1),) * (x.ndim - 1)].contiguous()
    return x.contiguous()


def to_mont(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Canonical limbs -> Montgomery form (multiply by R^2)."""
    return mul(spec, x, bconst(spec.r2_limbs, (), x.device))


def from_mont(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical limbs (multiply by 1 = reduce)."""
    return mul(spec, x, bconst(spec.unit_limbs, (), x.device))


# ---------------------------------------------------------------------------
# exponentiation / inversion
# ---------------------------------------------------------------------------


def pow_fixed(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a host-constant exponent: 4-bit fixed windows, MSB first —
    per window 4 squarings and (for a nonzero digit) one multiply by a
    table entry.  The loop runs on the host; every square and multiply is
    one call of ``mul``."""
    e = int(e)
    if e < 0:
        raise ValueError("negative exponents not supported; invert first")
    one = bconst(spec.one_mont_limbs, a.shape[1:], a.device).clone(
        memory_format=torch.contiguous_format
    )
    if e == 0:
        return one
    w = 4
    n_dig = -(-e.bit_length() // w)
    digits = [(e >> (w * (n_dig - 1 - i))) & ((1 << w) - 1) for i in range(n_dig)]
    table = [one, a]
    for _ in range(2, min(1 << w, e + 1)):
        table.append(mul(spec, table[-1], a))
    res = table[digits[0]]
    for d in digits[1:]:
        for _ in range(w):
            res = square(spec, res)
        if d:
            res = mul(spec, res, table[d])
    return res


def inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery-form inverse via Fermat's little theorem; inv(0) = 0."""
    return pow_fixed(spec, a, spec.modulus - 2)


def batch_inverse(spec: FieldSpec, a: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inverse of every element of a [L, *batch] value, zero to zero, by
    blocked batched inversion: about three products an element and one
    inversion of a short batch (``mont_kernels.batch_inverse``).

    The reference has two of these, a scan along one batch axis and a
    blocked one over the flattened batch.  Inverses are unique and
    canonical, so this one serves both: it inverts every element whatever
    ``axis`` (a batch axis, as in the reference) is, and the argument stays
    so that call sites read the same."""
    batch_ndim = a.ndim - 1
    if batch_ndim and not -batch_ndim <= axis < batch_ndim:
        raise ValueError(f"axis {axis} out of range for batch shape {tuple(a.shape[1:])}")
    if a.numel() == 0:
        return a.clone()
    flat = a.reshape(a.shape[0], -1).contiguous()
    return mont_kernels.batch_inverse(spec, flat).reshape(a.shape)


def mul_by_u32(spec: FieldSpec, a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small host constant via double-and-add."""
    k = int(k)
    if k == 0:
        return torch.zeros_like(a)
    bits = bin(k)[2:]
    res = a
    for bit in bits[1:]:
        res = add(spec, res, res)
        if bit == "1":
            res = add(spec, res, a)
    return res
