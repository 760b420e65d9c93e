"""Staged radix-2 NTT butterflies and power tables.

Layout: limb-major — coefficient arrays are int32[L, ..., n] with the
coefficient index on the MINOR axis.

Two formulations:

  * ``fft_stages`` — classic in-order DIT over the trailing axis, one
    butterfly-kernel launch per stage.  Early stages pair neighbouring
    words (stride-2 access), which is fine for small transforms.
  * ``fft_four_step`` — Bailey decomposition n = n1*n2: column FFTs along
    a MAJOR axis with the other factor riding the minor axis (every
    butterfly stage reads and writes whole contiguous rows), one twiddle
    multiply, one [n1, n2] transpose.

Every butterfly stage, on either path, is one call of
``mont_kernels.butterfly_stage_major``: the CUDA kernel for CUDA tensors,
its plain version for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..bigint import int_to_limbs
from ..fields.spec import FieldSpec
from . import mont, mont_kernels

_FOUR_STEP_MIN = 1 << 15  # below this the plain staged path is used


def bit_reverse_indices(n: int) -> np.ndarray:
    """Host-side bit-reversal permutation table for size n = 2^k."""
    k = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros_like(idx)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev.astype(np.int32)


@functools.lru_cache(maxsize=8)
def _bitrev(n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(bit_reverse_indices(n), device=device)


def _mont_const(spec: FieldSpec, x: int, device) -> torch.Tensor:
    """[L, 1] Montgomery form of the canonical host integer x."""
    limbs = int_to_limbs(spec.to_mont(x), spec.n_limbs).astype(np.int32)
    return torch.as_tensor(limbs, device=device)[:, None]


def powers_from_int(spec: FieldSpec, base: int, n: int, device=None) -> torch.Tensor:
    """[L, n] table of base^i (Montgomery form) by doubling on the device.

    Each round doubles the table length with one batched multiply by the
    host-computed constant base^(2^k); log2(n) multiplies total.
    """
    from .. import config

    device = torch.device(device if device is not None else config.default_device)
    p = spec.modulus
    table = _mont_const(spec, 1, device)
    k = 1
    while k < n:
        factor = _mont_const(spec, pow(base, k, p), device)
        table = torch.cat([table, mont.mul(spec, table, factor)], dim=1)
        k *= 2
    return table[:, :n].contiguous()


def powers_from_device(spec: FieldSpec, base: torch.Tensor, n: int) -> torch.Tensor:
    """[L, n] table of base^i for a base held on the device (same doubling)."""
    table = mont.bconst(spec.one_mont_limbs, (1,), base.device)
    factor = base[:, None] if base.ndim == 1 else base
    k = 1
    while k < n:
        table = torch.cat([table, mont.mul(spec, table, factor)], dim=1)
        factor = mont.square(spec, factor)
        k *= 2
    return table[:, :n].contiguous()


def fft_stages(spec: FieldSpec, x: torch.Tensor, roots: torch.Tensor,
               start_stage: int = 1) -> torch.Tensor:
    """In-order DIT butterflies; x must already be bit-reversed.

    x: int32[L, ..., n]; roots: int32[L, n/2] table of omega^j.
    Stage s uses the stride-(n/m) subsample of the root table.
    ``start_stage`` resumes mid-pipeline (the degree-aware path skips the
    stages a zero-padded input renders trivial).
    """
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    shape = x.shape
    # groups of m consecutive coefficients never straddle two transforms,
    # so all leading batch axes fold into the group axis
    x = x.reshape(shape[0], -1, 1)
    for s in range(start_stage, log_n + 1):
        m = 1 << s
        w = roots[:, :: n // m] if m < n else roots  # [L, half]
        x = mont_kernels.butterfly_stage_major(spec, x, w)
    return x.reshape(shape)


def fft_stages_major(spec: FieldSpec, x: torch.Tensor,
                     roots: torch.Tensor) -> torch.Tensor:
    """DIT butterflies along AXIS 1 of x: int32[L, n1, B]; x must already
    be bit-reversed along axis 1.  roots: [L, n1/2] (may be a strided view
    of a longer table).  The batch axis B stays minor throughout, so every
    stage reads and writes contiguous rows; the kernel addresses the halves
    and the twiddles in place of the array, with no repeat or concatenate."""
    n1 = x.shape[1]
    log_n = n1.bit_length() - 1
    for s in range(1, log_n + 1):
        m = 1 << s
        w = roots[:, :: n1 // m] if m < n1 else roots  # [L, half]
        x = mont_kernels.butterfly_stage_major(spec, x, w)
    return x


def _split_sizes(n: int):
    """n = n1 * n2 with n1 <= n2, both powers of two."""
    log_n = n.bit_length() - 1
    l1 = log_n // 2
    return 1 << l1, 1 << (log_n - l1)


def _four_step_twiddles(spec: FieldSpec, roots: torch.Tensor, n1: int,
                        n2: int) -> torch.Tensor:
    """[L, n1, n2] table of w^(k1*i2) from the [L, n/2] root table:
    exponents reduce mod n, and w^(j + n/2) = -w^j covers the upper half.
    The exponent table is built on the device."""
    n = n1 * n2
    half = n // 2
    device = roots.device
    k1 = torch.arange(n1, dtype=torch.int64, device=device)[:, None]
    i2 = torch.arange(n2, dtype=torch.int64, device=device)[None, :]
    e = (k1 * i2) % n
    sign_flip = e >= half
    e_lo = torch.where(sign_flip, e - half, e).reshape(-1)
    del e
    tw = torch.index_select(roots, 1, e_lo).reshape(spec.n_limbs, n1, n2)
    del e_lo
    return torch.where(sign_flip, mont.neg(spec, tw), tw)


def fft_four_step(spec: FieldSpec, coeffs: torch.Tensor,
                  roots: torch.Tensor) -> torch.Tensor:
    """Natural-order forward NTT via the Bailey four-step decomposition.

    coeffs: int32[L, n]; roots: [L, n/2] powers of the transform root w.
    X[k1 + n1*k2] = FFT_n2 over i2 of ( w^(k1*i2) * FFT_n1 over i1 )
    with x laid out as [n1, n2] (i = i1*n2 + i2).
    """
    L, n = coeffs.shape
    n1, n2 = _split_sizes(n)

    x = coeffs.reshape(L, n1, n2)

    # --- step 1: length-n1 FFT down the columns (root w^n2)
    x = torch.index_select(x, 1, _bitrev(n1, x.device))
    x = fft_stages_major(spec, x, roots[:, ::n2][:, : n1 // 2])

    # --- step 2: twiddle by w^(k1*i2)
    x = mont.mul(spec, x, _four_step_twiddles(spec, roots, n1, n2))

    # --- step 3 + bit reversal of step 4, in one gather: transpose so the
    # i2-transform runs along a major axis
    x = x.permute(0, 2, 1)  # [L, n2, n1] view
    x = torch.index_select(x, 1, _bitrev(n2, x.device))  # contiguous copy

    # --- step 4: length-n2 FFT down the columns (root w^n1)
    x = fft_stages_major(spec, x, roots[:, ::n1][:, : n2 // 2])

    # output element [k2, k1] is X[k1 + n1*k2]: flat row-major == natural
    return x.reshape(L, n)


def fft(spec: FieldSpec, coeffs: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    """Forward NTT, natural-order in and out: four-step for one long
    transform, bit reversal + staged butterflies otherwise."""
    n = coeffs.shape[-1]
    if coeffs.ndim == 2 and n >= _FOUR_STEP_MIN:
        return fft_four_step(spec, coeffs, roots)
    x = torch.index_select(coeffs, -1, _bitrev(n, coeffs.device))
    return fft_stages(spec, x, roots)


def fft_degree_aware(spec: FieldSpec, coeffs: torch.Tensor, n: int,
                     roots: torch.Tensor) -> torch.Tensor:
    """Size-n forward NTT of a degree-< d polynomial given only its d
    coefficients (d a power of two, d < n): O(n log d) instead of
    O(n log n).

    With the input zero beyond d, the first log(n/d) DIT stages of the
    bit-reversed array merely broadcast each nonzero value across its
    length-(n/d) block (the DFT of (x, 0, .., 0) is constant x).  So:
    bit-reverse the d real coefficients, repeat each n/d times, and resume
    the butterfly pipeline at stage log(n/d)+1.

    coeffs: int32[L, ..., d]; roots: [L, n/2] over the size-n root.
    """
    d = coeffs.shape[-1]
    if d & (d - 1) or n % d:
        raise ValueError("degree-aware fft needs power-of-two d | n")
    if d == n:
        return fft(spec, coeffs, roots)
    stride = n // d

    if coeffs.ndim == 2 and n >= _FOUR_STEP_MIN:
        n1, n2 = _split_sizes(n)
        if d <= n2:
            return _four_step_low_degree(spec, coeffs, n1, n2, roots)

    x = torch.index_select(coeffs, -1, _bitrev(d, coeffs.device))
    x = torch.repeat_interleave(x, stride, dim=-1)
    return fft_stages(spec, x, roots,
                      start_stage=stride.bit_length())  # log2(stride)+1


def _four_step_low_degree(spec: FieldSpec, coeffs: torch.Tensor, n1: int,
                          n2: int, roots: torch.Tensor) -> torch.Tensor:
    """Four-step NTT when every nonzero coefficient sits in row i1 = 0 of
    the [n1, n2] layout (d <= n2): the column FFTs of step 1 reduce to a
    broadcast of row 0, so only the twiddle and the length-n2 transforms
    remain — O(n log n2)."""
    L, d = coeffs.shape
    n = n1 * n2
    row0 = coeffs if d == n2 else torch.nn.functional.pad(coeffs, (0, n2 - d))

    # step 1 (broadcast) fused into step 2's twiddle multiply: the
    # "column FFT" output is row0 at every k1.
    x = mont.mul(spec, row0[:, None, :], _four_step_twiddles(spec, roots, n1, n2))

    x = x.permute(0, 2, 1)  # [L, n2, n1] view
    x = torch.index_select(x, 1, _bitrev(n2, x.device))
    x = fft_stages_major(spec, x, roots[:, ::n1][:, : n2 // 2])
    return x.reshape(L, n)


def scale(spec: FieldSpec, x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Pointwise multiply coefficients by a per-index table."""
    return mont.mul(spec, x, table)
