"""The CUDA field kernels: wrappers, plain versions, launch counters.

Counterpart of the JAX package's ``ops/mont_pallas.py`` for the NTT path.
Two kernels, both CUDA C++ (``csrc/mont.cuh``, ``csrc/mont_kernels.cu``):

``mont_mul``  (wrapper ``mul``)
    Replaces the TPU kernel ``_mul_kernel`` (``ops/mont_pallas.py:189``,
    wrapper ``mul`` :485): the batched Montgomery product a*b*R^-1 mod p.
    One thread per element holds both operands as W = L/2 packed 32-bit
    words in registers and runs a word-level CIOS (2 W^2 + W 32-bit
    multiply-adds).  Bound: it must move 3 * L * 4 bytes per element (two
    reads, one write in the one-limb-per-word storage format), which at
    L = 16 is 192 B for ~136 multiply-adds: far under the card's
    operations-per-byte line, so device memory bounds it.  The design
    keeps every intermediate in registers (nothing but the three arrays
    touches memory), reads limb-major so a warp's loads are contiguous,
    and takes a one-element operand by a zero stride instead of a
    materialised broadcast.

``butterfly``  (wrappers ``butterfly_stage``, ``butterfly_stage_major``)
    Replaces the TPU kernel ``_butterfly_kernel`` (``ops/mont_pallas.py:417``,
    wrapper ``butterfly_stage`` :468): one decimation-in-time NTT stage,
    t = hi*w, out = (lo + t, lo - t).  One thread per butterfly.  Bound:
    ~4 * L * 4 bytes per butterfly (lo, hi read; two outputs written; the
    twiddles are a small table that stays in cache) for one multiply, one
    add and one subtract, so device memory bounds it too.  The TPU version
    flattens the halves, repeats the twiddles to the block width and
    concatenates the outputs every stage, because its block specs need
    rectangles; here the kernel computes its own offsets into x[L, n1, B]
    and reads the twiddles through a strided view of the root table, so a
    stage moves the array once and nothing else.  Fusing several stages
    per launch in shared memory is the next step, not taken here.

Dispatch has no switch: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises.  The plain versions do the same
arithmetic on 16-bit limbs in int64 and are device-agnostic, so they can
be run on the card to hold the kernels against.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..bigint import LIMB_BITS, LIMB_MASK
from ..fields.spec import FieldSpec

# Number of kernel launches, by kernel.  A wrapper adds one where it
# launches its kernel and nowhere else.
launches = {"mont_mul": 0, "butterfly": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# --------------------------------------------------------------------------
# plain versions (any device)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _modulus_limbs(spec: FieldSpec, device: torch.device, dtype: torch.dtype):
    return torch.tensor(spec.p_limbs.astype("int64"), dtype=dtype, device=device)


def _modulus(spec: FieldSpec, like: torch.Tensor) -> torch.Tensor:
    """[L, 1, ...] modulus limbs broadcastable against ``like``."""
    p = _modulus_limbs(spec, like.device, like.dtype)
    return p.reshape((spec.n_limbs,) + (1,) * (like.ndim - 1))


def _add_limbs(a: torch.Tensor, b: torch.Tensor):
    """(a + b) over 16-bit limbs -> (sum limbs, carry in {0,1})."""
    s = a + b
    out = torch.empty_like(s)
    carry = torch.zeros_like(s[0])
    for k in range(s.shape[0]):
        v = s[k] + carry
        out[k] = v & LIMB_MASK
        carry = v >> LIMB_BITS
    return out, carry


def _sub_limbs(a: torch.Tensor, b: torch.Tensor):
    """(a - b) over 16-bit limbs -> (difference limbs, borrow in {0,1})."""
    d = a - b
    out = torch.empty_like(d)
    borrow = torch.zeros_like(d[0])
    for k in range(d.shape[0]):
        v = d[k] - borrow
        out[k] = v & LIMB_MASK
        borrow = (v >> LIMB_BITS) & 1
    return out, borrow


def _cond_sub_modulus(spec: FieldSpec, x: torch.Tensor, carry: torch.Tensor):
    """x - p if (carry:x) >= p else x, for (carry:x) < 2p."""
    d, borrow = _sub_limbs(x, _modulus(spec, x))
    ge = (carry != 0) | (borrow == 0)
    return torch.where(ge, d, x)


def add_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod p on canonical limbs (shapes broadcast)."""
    s, carry = _add_limbs(a, b)
    return _cond_sub_modulus(spec, s, carry)


def sub_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p on canonical limbs (shapes broadcast)."""
    d, borrow = _sub_limbs(a, b)
    d_plus_p, _ = _add_limbs(d, _modulus(spec, d))
    return torch.where(borrow != 0, d_plus_p, d)


def mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p on 16-bit limbs, in int64.

    Schoolbook columns accumulate lazily (a column holds at most L products
    of 32 bits, < 2^38 for L <= 48), the interleaved reduction clears one
    limb per round with m = cols[i] * inv16 mod 2^16, and carries are
    resolved once at the end.  a, b: int32 [L, *batch], shapes broadcast."""
    L = spec.n_limbs
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a64 = a.to(torch.int64)
    b64 = b.to(torch.int64)
    cols = torch.zeros((2 * L,) + tuple(batch), dtype=torch.int64, device=a.device)
    for i in range(L):
        cols[i : i + L] += a64[i] * b64
    p64 = _modulus(spec, cols)
    inv = int(spec.inv16)
    for i in range(L):
        m = ((cols[i] & LIMB_MASK) * inv) & LIMB_MASK
        cols[i : i + L] += m * p64
        cols[i + 1] += cols[i] >> LIMB_BITS
    res = torch.empty((L,) + tuple(batch), dtype=torch.int64, device=a.device)
    carry = torch.zeros_like(res[0])
    for k in range(L):
        v = cols[L + k] + carry
        res[k] = v & LIMB_MASK
        carry = v >> LIMB_BITS
    return _cond_sub_modulus(spec, res, carry).to(torch.int32)


def butterfly_stage_plain(spec: FieldSpec, lo: torch.Tensor, hi: torch.Tensor,
                          w: torch.Tensor):
    """(lo + hi*w, lo - hi*w) for flat halves lo, hi [L, n_half] and
    twiddles w [L, half] with period ``half`` along the flat axis."""
    n_half, half = lo.shape[1], w.shape[1]
    t = mul_plain(spec, hi, w.repeat(1, n_half // half))
    return add_plain(spec, lo, t), sub_plain(spec, lo, t)


def butterfly_stage_major_plain(spec: FieldSpec, x: torch.Tensor,
                                w: torch.Tensor) -> torch.Tensor:
    """One DIT stage along axis 1 of x [L, n1, B] with twiddles w [L, half]:
    groups of 2*half rows, row j of the upper half times w[j]."""
    L, n1, B = x.shape
    half = w.shape[1]
    xv = x.reshape(L, n1 // (2 * half), 2, half, B)
    lo = xv[:, :, 0]
    hi = xv[:, :, 1]
    t = mul_plain(spec, hi, w[:, None, :, None])
    out = torch.stack([add_plain(spec, lo, t), sub_plain(spec, lo, t)], dim=2)
    return out.reshape(L, n1, B)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _p_words_arg(spec: FieldSpec):
    return (ctypes.c_uint32 * spec.n_words)(*spec.p_words)


def _check_elems(spec: FieldSpec, *tensors: torch.Tensor) -> torch.device:
    """Every operand is an int32 [L, ...] tensor, all on one device."""
    device = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int32 or t.ndim < 1 or t.shape[0] != spec.n_limbs:
            raise ValueError(
                f"expected int32 [{spec.n_limbs}, ...] limbs, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if t.device != device:
            raise ValueError(f"operands on different devices: {device}, {t.device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def _require_contiguous(name: str, t: torch.Tensor) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (limb-major); call .contiguous()")


def _log2_exact(name: str, v: int) -> int:
    if v < 1 or v & (v - 1):
        raise ValueError(f"{name} must be a power of two, got {v}")
    return v.bit_length() - 1


def _raise_on_error(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def _mul_operand(x: torch.Tensor, shape: tuple, n: int, L: int):
    """(tensor, limb stride, batch stride) for one multiply operand."""
    if tuple(x.shape) == shape:
        return x, n, 1
    if x.numel() == L:  # one element for the whole batch: stride 0
        return x, 1, 0
    return x.expand(shape).contiguous(), n, 1


def mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p; a, b: int32 [L, *batch] of equal
    rank, batch shapes broadcast.  CUDA tensors go through the kernel."""
    device = _check_elems(spec, a, b)
    if device.type == "cpu":
        return mul_plain(spec, a, b)
    from ..kernels import build

    L = spec.n_limbs
    _require_contiguous("a", a)
    _require_contiguous("b", b)
    shape = (L,) + tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
    n = math.prod(shape[1:])
    out = torch.empty(shape, dtype=torch.int32, device=device)
    if n == 0:
        return out
    a_t, a_ls, a_bs = _mul_operand(a, shape, n, L)
    b_t, b_ls, b_bs = _mul_operand(b, shape, n, L)
    lib = build.library(spec.n_words)
    with torch.cuda.device(device):
        code = lib.mont_mul_launch(
            a_t.data_ptr(), a_ls, a_bs, b_t.data_ptr(), b_ls, b_bs,
            out.data_ptr(), n, _p_words_arg(spec), spec.inv32,
            torch.cuda.current_stream().cuda_stream,
        )
    launches["mont_mul"] += 1
    _raise_on_error(code, "mont_mul")
    return out


def _launch_butterfly(spec, device, lo_ptr, hi_ptr, olo_ptr, ohi_ptr, ls, n_pairs,
                      span_log2, pitch_log2, b_log2, w):
    from ..kernels import build

    lib = build.library(spec.n_words)
    with torch.cuda.device(device):
        code = lib.butterfly_launch(
            lo_ptr, hi_ptr, olo_ptr, ohi_ptr, ls, n_pairs, span_log2, pitch_log2,
            b_log2, w.data_ptr(), w.stride(0), w.stride(1),
            _p_words_arg(spec), spec.inv32,
            torch.cuda.current_stream().cuda_stream,
        )
    launches["butterfly"] += 1
    _raise_on_error(code, "butterfly")


def butterfly_stage(spec: FieldSpec, lo: torch.Tensor, hi: torch.Tensor,
                    w: torch.Tensor):
    """Batched butterflies: returns (lo + hi*w, lo - hi*w).

    lo, hi: [L, n_half] flat butterfly operands; w: [L, half] twiddles
    with period ``half`` along the flat axis (n_half % half == 0).  w may
    be a strided view."""
    device = _check_elems(spec, lo, hi, w)
    if lo.shape != hi.shape or lo.ndim != 2 or w.ndim != 2:
        raise ValueError("butterfly_stage takes lo, hi [L, n_half] and w [L, half]")
    n_half, half = lo.shape[1], w.shape[1]
    if half < 1 or n_half % half:
        raise ValueError(f"twiddle period {half} does not divide {n_half}")
    if device.type == "cpu":
        return butterfly_stage_plain(spec, lo, hi, w)
    _require_contiguous("lo", lo)
    _require_contiguous("hi", hi)
    half_log2 = _log2_exact("twiddle period", half)
    olo = torch.empty_like(lo)
    ohi = torch.empty_like(hi)
    _launch_butterfly(
        spec, device, lo.data_ptr(), hi.data_ptr(), olo.data_ptr(), ohi.data_ptr(),
        n_half, n_half, half_log2, half_log2, 0, w,
    )
    return olo, ohi


def butterfly_stage_major(spec: FieldSpec, x: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """One DIT stage along axis 1 of x [L, n1, B], out of place: rows are
    taken in groups of 2*half (half = w.shape[1]); row j of a group's upper
    half is multiplied by w[:, j] and combined with row j of its lower half.
    w may be a strided view of a root table."""
    device = _check_elems(spec, x, w)
    if x.ndim != 3 or w.ndim != 2:
        raise ValueError("butterfly_stage_major takes x [L, n1, B] and w [L, half]")
    L, n1, B = x.shape
    half = w.shape[1]
    if half < 1 or n1 % (2 * half):
        raise ValueError(f"stage width {2 * half} does not divide {n1}")
    if device.type == "cpu":
        return butterfly_stage_major_plain(spec, x, w)
    _require_contiguous("x", x)
    out = torch.empty_like(x)
    if B == 0:
        return out
    b_log2 = _log2_exact("batch width", B)
    span_log2 = _log2_exact("stage half", half) + b_log2
    span_bytes = (half * B) * x.element_size()
    _launch_butterfly(
        spec, device, x.data_ptr(), x.data_ptr() + span_bytes, out.data_ptr(),
        out.data_ptr() + span_bytes, n1 * B, (n1 * B) // 2, span_log2,
        span_log2 + 1, b_log2, w,
    )
    return out
