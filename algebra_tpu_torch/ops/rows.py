"""Packed point rows for the MSM's affine halving tree: the format, four
CUDA kernels, their plain versions.

Counterpart of the JAX package's ``ops/rows_pallas.py``.  A row holds one
affine point of a prime field: int32 words [x | y | inf | 0 ...], x and y
as L 16-bit limbs each (one limb a word, as in every array of the port),
the infinity flag 0 or 1 in word 2L, zero padding after it.  The width is
``row_width(spec)`` = 2L + 4, the 2L + 1 words rounded up to a multiple of
four so that rows and coordinates start on 16-byte boundaries: 36 words for
BLS12-381 Fr, 52 for Fq, 100 for MNT4-753 Fq.  The TPU's rows are 128
words wide because its (8, 128) tile is; that width is not the
mathematics', and nothing compares the padding words.

The kernels are CUDA C++ (``csrc/rows_kernels.cu`` over ``csrc/rows.cuh``),
all bound by device memory:

``pack``  (K13)
    Replaces ``_pack_kernel`` (``ops/rows_pallas.py:36``, wrapper ``pack``
    :65): (x, y [L, n], inf [n]) -> rows [n, RW], a transpose through a
    shared-memory tile of 32 points.
``unpack``  (K14)
    Replaces ``_unpack_kernel`` (``rows_pallas.py:86``, wrapper ``unpack``
    :117): the inverse, with inf = (word 2L != 0).
``negate_y``  (K15)
    Replaces ``_neg_kernel`` (``rows_pallas.py:131``, wrapper ``negate_y``
    :246): y := p - y in the masked rows; zero stays zero.
``expand_units``  (K16)
    Replaces ``_expand_kernel`` (``rows_pallas.py:166``, wrapper
    ``expand_units`` :228): out[j U + t] = src[us[j] + t], a copy of units
    of U consecutive rows, one warp a unit; each row index is clipped to
    [0, S - 1], in the kernel and in the plain version alike.

The reference pads every batch to a bucketed width; here the kernels bound
their own ragged ends.  Dispatch has no switch: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.  Launch counts
are kept in ``mont_kernels.launches`` (``pack``, ``unpack``, ``negate_y``,
``expand_units``).
"""

from __future__ import annotations

import torch

from ..fields.spec import FieldSpec
from . import mont_kernels as mk
from .mont_kernels import launches


def row_width(spec: FieldSpec) -> int:
    """Words a row: 2L + 1 rounded up to a multiple of four."""
    return -(-(2 * spec.n_limbs + 1) // 4) * 4


def _words_of_width(rw: int) -> int:
    """The word count W whose rows are ``rw`` words wide (rw = 4 W + 4)."""
    return (rw - 4) // 4


# --------------------------------------------------------------------------
# plain versions (any device)
# --------------------------------------------------------------------------


def pack_plain(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor,
               inf: torch.Tensor) -> torch.Tensor:
    L = spec.n_limbs
    rows = torch.zeros((x.shape[1], row_width(spec)), dtype=torch.int32, device=x.device)
    rows[:, :L] = x.T
    rows[:, L : 2 * L] = y.T
    rows[:, 2 * L] = inf.to(torch.int32)
    return rows


def unpack_plain(spec: FieldSpec, rows: torch.Tensor):
    L = spec.n_limbs
    return (rows[:, :L].T.contiguous(), rows[:, L : 2 * L].T.contiguous(),
            rows[:, 2 * L] != 0)


def negate_y_plain(spec: FieldSpec, rows: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    L = spec.n_limbs
    y = rows[:, L : 2 * L].T
    ny = mk.sub_plain(spec, torch.zeros_like(y), y)
    out = rows.clone()
    out[:, L : 2 * L] = torch.where(neg, ny, y).T
    return out


def expand_units_plain(src: torch.Tensor, us: torch.Tensor, U: int) -> torch.Tensor:
    idx = us[:, None] + torch.arange(U, dtype=us.dtype, device=us.device)
    return src[idx.reshape(-1).clamp(0, src.shape[0] - 1)]


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _launch(name: str, words: int, device, *args) -> None:
    from ..kernels import build

    lib = build.library("rows_kernels", words)
    with torch.cuda.device(device):
        code = getattr(lib, f"{name}_launch")(
            *args, torch.cuda.current_stream().cuda_stream)
    launches[name] += 1
    mk._raise_on_error(code, name)


def _check_rows(spec: FieldSpec | None, rows: torch.Tensor) -> torch.device:
    rw = rows.shape[-1] if rows.ndim == 2 else -1
    if rows.dtype != torch.int32 or rows.ndim != 2 or rw % 4 \
            or (spec is not None and rw != row_width(spec)):
        want = row_width(spec) if spec is not None else "4 W + 4"
        raise ValueError(f"expected int32 rows [n, {want}], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")
    return rows.device


def _check_mask(name: str, mask: torch.Tensor, n: int, device) -> None:
    if mask.dtype != torch.bool or tuple(mask.shape) != (n,) or mask.device != device:
        raise ValueError(f"{name} must be a bool [{n}] mask on {device}")


def pack(spec: FieldSpec, x: torch.Tensor, y: torch.Tensor,
         inf: torch.Tensor) -> torch.Tensor:
    """(x, y int32 [L, n], inf bool [n]) -> rows int32 [n, row_width(spec)]."""
    device = mk._check_elems(spec, x, y)
    if x.ndim != 2 or y.shape != x.shape:
        raise ValueError(f"x and y must be [{spec.n_limbs}, n], got {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    n = x.shape[1]
    _check_mask("inf", inf, n, device)
    if device.type == "cpu":
        return pack_plain(spec, x, y, inf)
    out = torch.empty((n, row_width(spec)), dtype=torch.int32, device=device)
    if n:
        x, y, inf = x.contiguous(), y.contiguous(), inf.contiguous()
        _launch("pack", spec.n_words, device, x.data_ptr(), y.data_ptr(), inf.data_ptr(),
                out.data_ptr(), n)
    return out


def unpack(spec: FieldSpec, rows: torch.Tensor):
    """rows [n, row_width(spec)] -> (x [L, n], y [L, n], inf bool [n])."""
    device = _check_rows(spec, rows)
    if device.type == "cpu":
        return unpack_plain(spec, rows)
    n, L = rows.shape[0], spec.n_limbs
    x = torch.empty((L, n), dtype=torch.int32, device=device)
    y = torch.empty_like(x)
    inf = torch.empty(n, dtype=torch.bool, device=device)
    if n:
        rows = rows.contiguous()
        _launch("unpack", spec.n_words, device, rows.data_ptr(), x.data_ptr(), y.data_ptr(),
                inf.data_ptr(), n)
    return x, y, inf


def negate_y(spec: FieldSpec, rows: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """New rows with y := p - y where ``neg`` (bool [n]); zero stays zero."""
    device = _check_rows(spec, rows)
    n = rows.shape[0]
    _check_mask("neg", neg, n, device)
    if device.type == "cpu":
        return negate_y_plain(spec, rows, neg)
    out = torch.empty_like(rows, memory_format=torch.contiguous_format)
    if n:
        rows, neg = rows.contiguous(), neg.contiguous()
        _launch("negate_y", spec.n_words, device, rows.data_ptr(), neg.data_ptr(),
                out.data_ptr(), n, mk._p_words_arg(spec), spec.inv32)
    return out


def expand_units(src: torch.Tensor, us: torch.Tensor, U: int) -> torch.Tensor:
    """out[j U + t] = src[us[j] + t] for t < U, each row index clipped to
    [0, S - 1]: src rows [S, RW], us int64 [mu] unit starts -> rows
    [mu U, RW].  A unit that runs past the end repeats the last row there
    and keeps its own first rows."""
    device = _check_rows(None, src)
    S, rw = src.shape
    if us.dtype != torch.int64 or us.ndim != 1 or us.device != device:
        raise ValueError(f"us must be an int64 [mu] tensor on {device}")
    if U < 1 or S < 1:
        raise ValueError(f"units of {U} rows from {S} source rows")
    if device.type == "cpu":
        return expand_units_plain(src, us, U)
    mu = us.shape[0]
    out = torch.empty((mu * U, rw), dtype=torch.int32, device=device)
    if mu:
        src, us = src.contiguous(), us.contiguous()
        _launch("expand_units", _words_of_width(rw), device, src.data_ptr(), us.data_ptr(),
                out.data_ptr(), mu, U, S)
    return out
