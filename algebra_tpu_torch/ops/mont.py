"""Batched multi-limb Montgomery arithmetic on torch tensors.

Layout: **limb-major** — element batches are ``int32[L, *batch]`` with the
limb axis FIRST (little-endian 16-bit limbs, one per 32-bit word) and batch
axes trailing; values are in Montgomery form and canonical (< p).  Limb
values stay below 2^16, so the sign bit of int32 never matters.  Binary ops
auto-align mixed batch ranks by inserting singleton axes right after the
limb axis (the limb-major analogue of right-aligned broadcasting).

``mul``, ``square``, ``dot_stacked`` and ``batch_inverse`` go through the CUDA kernels for
CUDA tensors and through their plain versions for CPU tensors
(``ops/mont_kernels.py``); ``add``/``sub``/``neg`` are plain tensor code on
either device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..bigint import LIMB_BITS
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


# ---------------------------------------------------------------------------
# weighted sums of products (kernel K17)
# ---------------------------------------------------------------------------


def dot_mass_limit(spec: FieldSpec) -> int:
    """Largest sum_k |W[o, k]| that ``dot_stacked`` takes: the reference's
    column-headroom limit for its 16-bit-limb accumulators (every column
    below 2^31 through one shared reduction), 681 for BLS12-381 Fq.  The
    kernel needs no such limit; it is kept so that ``fields/dot.dot_multi``
    takes its generic path at exactly the call sites where the reference
    does."""
    L = spec.n_limbs
    colmax = 2 * L * (1 << LIMB_BITS)
    slack = (L + 1) * (1 << (LIMB_BITS + 1)) + (1 << (LIMB_BITS - 1))
    return ((1 << 31) - slack) // colmax


def dot_stacked(spec: FieldSpec, A: torch.Tensor, B: torch.Tensor, W,
                square_mask=None) -> torch.Tensor:
    """sum_k W[o, k] * A[k] * B[k] * R^-1 mod p for every output row o.

    A, B: int32 [L, K, *batch] Montgomery-form elements (< p).
    W: host integers [n_out, K] (negative allowed), each row's
    sum_k |W[o, k]| at most ``dot_mass_limit(spec)``.
    square_mask: optional host bool [K] marking pairs whose operands are
    the same value (A[k] = B[k]); the kernel squares there.
    Returns int32 [L, n_out, *batch], canonical: the same words as the
    reference's single-reduction form.  Kernel K17 on a CUDA tensor
    (``mont_kernels.dot``), ``dot_plain`` on a CPU tensor."""
    K = A.shape[1]
    W = np.asarray(W, np.int64)
    if W.ndim != 2 or W.shape[1] != K:
        raise ValueError(f"weights must be [n_out, {K}], got {W.shape}")
    wmass = int(np.abs(W).sum(axis=1).max()) if K and W.shape[0] else 0
    if wmass > dot_mass_limit(spec):
        raise ValueError(f"dot weight mass {wmass} exceeds limit {dot_mass_limit(spec)}")
    return mont_kernels.dot(spec, A, B, W, square_mask)


def sum_of_products(spec: FieldSpec, a_list, b_list) -> torch.Tensor:
    """sum_i a_i * b_i as one ``dot_stacked`` (one launch), or a mul/add
    fold where the term count exceeds ``dot_mass_limit``."""
    k = len(a_list)
    if 0 < k <= dot_mass_limit(spec):
        L = spec.n_limbs
        batch = torch.broadcast_shapes(*[x.shape[1:] for x in (*a_list, *b_list)])

        def bc(x):
            return expand(x, len(batch)).expand((L,) + tuple(batch))

        A = torch.stack([bc(a) for a in a_list], dim=1)
        B = torch.stack([bc(b) for b in b_list], dim=1)
        mask = [a is b for a, b in zip(a_list, b_list)]
        return dot_stacked(spec, A, B, np.ones((1, k), np.int64), square_mask=mask)[:, 0]
    acc = None
    for a, b in zip(a_list, b_list):
        t = mul(spec, a, b)
        acc = t if acc is None else add(spec, acc, t)
    return acc


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
