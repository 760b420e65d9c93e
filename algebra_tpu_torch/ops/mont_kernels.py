"""The CUDA field kernels: wrappers, plain versions, launch counters.

Counterpart of the JAX package's ``ops/mont_pallas.py``, and of its
``ops/mont.dot_stacked`` fusion.  The kernels are CUDA C++ over the device
functions of ``csrc/mont.cuh``: two for the NTT path
(``csrc/mont_kernels.cu``), those of batched inversion
(``csrc/inverse_kernels.cu``) and the weighted sums of products that every
tower product runs (``csrc/dot_kernels.cu``):

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

``inv_prefix``, ``inv_gcd``, ``inv_backward``  (run by ``batch_inverse``)
    Replace the TPU kernels ``_prefix_kernel``, ``_fermat_kernel`` and
    ``_backward_kernel`` (``ops/mont_pallas.py:207``, ``:238``, ``:221``,
    run by ``batch_inverse`` :325): Montgomery's trick in blocks, about
    three products an element and one inversion of at most ``INV_BOTTOM``
    elements, whatever n.  A level sees its n elements as G rows of
    m = ceil(n / G) consecutive elements; one thread walks one column.
    ``inv_prefix`` writes the running products down every column and the
    column totals, which are the next level's batch; at the bottom
    ``inv_gcd`` inverts each element by Bernstein-Yang safegcd
    (``csrc/inverse.cuh``: a fixed count of divsteps from the paper's
    bound, in batches of 30 on 32-bit words, each batch's matrix applied
    to signed 30-bit limbs; one thread an element, no branch);
    ``inv_backward`` unwinds a level with two products an element.
    Bounds: the prefix kernel must read a and write the prefixes
    (2 * L * 4 bytes an element), the backward kernel must read a and the
    prefixes and write the inverses (3 * L * 4 bytes), each for one and
    two products an element, so device memory bounds both; the bottom is
    a chain of dependent steps on few threads, so its time is that
    chain's latency.  The TPU kernel at the bottom is a ladder of
    ~1.5 * bits(p) dependent Montgomery products (a^(p-2)); ``inv_fermat``
    is its counterpart here, a ladder over any launch-constant exponent
    (the dedicated squaring ``mont_sq`` with exponent 2), which nothing on
    the main path runs any more: safegcd runs ~2.9 bits(p) divsteps of
    ~26 word operations each, where the ladder's chain is ~1.5 bits(p)
    products of ~2 W^2 multiply-adds each.  The TPU version's 128-lane
    rows, groups of at most 32 and the one-row bottom are its tile, not
    the mathematics: here a level is one flat [G, m] view of the whole
    array, so a warp reads a row contiguously, two levels reach 2^24
    elements, and the bottom is wide enough to put a block on every
    multiprocessor.  The reference pads with ones by concatenation and
    masks zeros with whole-array selects before and after; here the
    kernels read an element past the end, or a zero, as one, and write
    zero where the input was zero, so nothing but the arrays named above
    touches memory.

``mont_dot``  (wrapper ``dot``, run by ``ops/mont.dot_stacked``)
    K17, which replaces no Pallas kernel: the reference's ``dot_stacked``
    (``ops/mont.py:536``) is one XLA fusion, the op that makes every tower
    product one kernel there.  out[:, o] = sum_k W[o, k] A[:, k] B[:, k]
    R^-1 mod p for a small signed [n_out, K] weight matrix, one thread per
    (lane, output row) over ``csrc/dot_kernels.cu`` and ``csrc/dot.cuh``:
    the row's non-zero weights in shared memory, one product an entry
    (the squaring where a pair is a square), |w| times it by
    double-and-add, added or subtracted.  Canonical outputs make any order
    of summation give the reference's words.  Bound: it must read A and B
    and write out, (2 K + n_out) L 4 bytes a lane, for K products; at an
    Fp12 product the bytes bound it.  A product two rows share is
    recomputed in each; one reduction a row, as the reference does, is
    for a later redesign.

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

# Number of kernel launches, by kernel, for this module's kernels, the
# group-law, affine-addition and MSM-tail kernels of ``ops/sw_kernels.py``
# and the row kernels of ``ops/rows.py``.  A wrapper adds one where it
# launches its kernel and nowhere else.
launches = {"mont_mul": 0, "butterfly": 0, "inv_prefix": 0, "inv_fermat": 0,
            "inv_gcd": 0, "inv_backward": 0, "jac_double": 0, "jac_add": 0,
            "jac_madd": 0, "jac_madd_round": 0, "bucket_reduce_inner": 0, "reduce_fold": 0,
            "aff_denom": 0, "aff_post": 0, "affr_denom": 0, "affr_post": 0, "pack": 0, "unpack": 0,
            "negate_y": 0, "expand_units": 0, "mont_dot": 0}

# Blocked inversion: a level folds at most INV_GROUP rows into one, and
# levels are added until at most INV_BOTTOM elements are left for the
# bottom's per-element inversion.  16384 elements are one 128-thread block
# for each of the card's multiprocessors: the bottom's time is the latency
# of its chain of steps up to about that width, so a narrower bottom would
# save nothing and cost a level.
INV_GROUP = 32
INV_BOTTOM = 16384


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


# Carries: a batch of up to this many lanes resolves them with one scan over
# the limbs (a dozen whole-array operations, ``_carries_in``), a larger one
# limb by limb (``_chain``: 3 L operations on single limbs, the least memory
# traffic).  The scan saves per-operation cost where the batch is small (the
# group law's narrow steps, the CPU); the chain keeps the wide arrays of the
# NTT path to the fewest bytes.
SCAN_MAX_LANES = 1 << 16


def _scan(v: torch.Tensor) -> bool:
    return v[0].numel() <= SCAN_MAX_LANES


def _chain(v: torch.Tensor):
    """Limb values of any size and sign -> (16-bit limbs, the carry out of
    the top limb), limb by limb (an arithmetic shift carries a borrow as
    -1)."""
    out = torch.empty_like(v)
    carry = torch.zeros_like(v[0])
    for k in range(v.shape[0]):
        x = v[k] + carry
        out[k] = x & LIMB_MASK
        carry = x >> LIMB_BITS
    return out, carry


def _carries_in(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """The 0/1 carry into every limb of a limb-wise sum, none into limb 0,
    and the carry out of the top limb, as [L + 1, *batch] of ``gen``'s
    dtype.  gen/prop: limb k makes a carry whatever comes in / passes on
    the one that comes in.  The carry out of limb k is gen[j] for the last
    j <= k that does not pass its carry on: a running maximum over the
    code 2 j + 2 + gen[j] (0 where limb j passes) finds it for every limb
    at once."""
    L = gen.shape[0]
    pos = torch.arange(2, 2 * L + 2, 2, dtype=torch.int32, device=gen.device)
    pos = pos.reshape((L,) + (1,) * (gen.ndim - 1))
    code = torch.where(prop, 0, pos + gen.to(torch.int32))
    out = (torch.cummax(code, dim=0).values & 1).to(gen.dtype)
    return torch.cat([torch.zeros_like(out[:1]), out], dim=0)


def _add_limbs(a: torch.Tensor, b: torch.Tensor):
    """(a + b) over 16-bit limbs -> (sum limbs, carry in {0,1})."""
    s = a + b
    if not _scan(s):
        return _chain(s)
    c = _carries_in(s >> LIMB_BITS, s == LIMB_MASK)
    return (s + c[:-1]) & LIMB_MASK, c[-1]


def _sub_limbs(a: torch.Tensor, b: torch.Tensor):
    """(a - b) over 16-bit limbs -> (difference limbs, borrow in {0,1})."""
    d = a - b
    if not _scan(d):
        out, carry = _chain(d)
        return out, -carry
    c = _carries_in((d < 0).to(d.dtype), d == 0)
    return (d - c[:-1]) & LIMB_MASK, c[-1]


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
    resolved once at the end (for a scan: three rounds that move every
    column's bits above 16 into the next column leave each at most 2^16,
    since the columns stay below 2^39 for L <= 48).  a, b: int32
    [L, *batch], shapes broadcast."""
    L = spec.n_limbs
    batch = a.shape[1:]
    if b.shape[1:] != batch:
        batch = torch.broadcast_shapes(batch, b.shape[1:])
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
    v = cols[L:]
    if not _scan(v):
        return _cond_sub_modulus(spec, *_chain(v)).to(torch.int32)
    top = torch.zeros_like(v[0])
    for _ in range(3):
        hi = v >> LIMB_BITS
        top += hi[-1]
        v = (v & LIMB_MASK) + torch.cat([torch.zeros_like(hi[:1]), hi[:-1]], dim=0)
    c = _carries_in(v >> LIMB_BITS, v == LIMB_MASK)
    return _cond_sub_modulus(spec, (v + c[:-1]) & LIMB_MASK, top + c[-1]).to(torch.int32)


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


def _one_mont(spec: FieldSpec, like: torch.Tensor) -> torch.Tensor:
    """[L, 1] limbs of one in Montgomery form, on ``like``'s device."""
    one = torch.tensor(spec.one_mont_limbs.astype("int64"), dtype=like.dtype,
                       device=like.device)
    return one.reshape(spec.n_limbs, 1)


def _rows(x: torch.Tensor, group: int, m: int, fill: torch.Tensor) -> torch.Tensor:
    """x [L, n] as [L, group, m] rows of m consecutive elements, the end
    filled with ``fill`` [L, 1]."""
    L, n = x.shape
    pad = group * m - n
    if pad:
        x = torch.cat([x, fill.expand(L, pad)], dim=1)
    return x.reshape(L, group, m)


def inv_prefix_plain(spec: FieldSpec, a: torch.Tensor, group: int):
    """Running products down the ``group`` rows of a [L, n] seen as rows of
    m = ceil(n / group) consecutive elements, a zero element counting as
    one: (prefixes [L, n], column totals [L, m])."""
    n = a.shape[1]
    m = _columns(n, group)
    one = _one_mont(spec, a)
    safe = torch.where((a == 0).all(dim=0), one, a)
    rows = _rows(safe, group, m, one)
    acc = [rows[:, 0]]
    for i in range(1, group):
        acc.append(mul_plain(spec, acc[-1], rows[:, i]))
    pref = torch.stack(acc, dim=1).reshape(a.shape[0], group * m)[:, :n]
    return pref.contiguous(), acc[-1].contiguous()


def inv_backward_plain(spec: FieldSpec, a: torch.Tensor, pref: torch.Tensor,
                       tinv: torch.Tensor, group: int) -> torch.Tensor:
    """Element inverses [L, n] from the inverses ``tinv`` [L, m] of the
    column totals: two products a row, from the last row up; zero where
    ``a`` is zero."""
    n = a.shape[1]
    m = tinv.shape[1]
    one = _one_mont(spec, a)
    zero_mask = (a == 0).all(dim=0)
    rows = _rows(torch.where(zero_mask, one, a), group, m, one)
    prows = _rows(pref, group, m, one)
    out = [None] * group
    running = tinv
    for i in range(group - 1, 0, -1):
        out[i] = mul_plain(spec, running, prows[:, i - 1])
        running = mul_plain(spec, running, rows[:, i])
    out[0] = running
    flat = torch.stack(out, dim=1).reshape(a.shape[0], group * m)[:, :n]
    return torch.where(zero_mask, torch.zeros_like(flat), flat)


def inv_fermat_plain(spec: FieldSpec, a: torch.Tensor, exponent: int | None = None):
    """a^exponent (p - 2 when None) by square and multiply over the
    exponent's bits, most significant first; zero goes to zero.  With
    p - 2 it is the plain version of ``inv_gcd`` too: inverses are unique
    and canonical."""
    e = _check_exponent(spec, exponent)
    res = a
    for bit in bin(e)[3:]:
        res = mul_plain(spec, res, res)
        if bit == "1":
            res = mul_plain(spec, res, a)
    return res


def batch_inverse_plain(spec: FieldSpec, a: torch.Tensor, group: int = INV_GROUP,
                        bottom: int = INV_BOTTOM) -> torch.Tensor:
    """``batch_inverse`` on the plain versions of its three kernels (any
    device)."""
    return _blocked_inverse(spec, a, group, bottom, inv_prefix_plain,
                            inv_fermat_plain, inv_backward_plain)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _p_words_arg(spec: FieldSpec):
    return (ctypes.c_uint32 * spec.n_words)(*spec.p_words)


@functools.lru_cache(maxsize=None)
def _one_words_arg(spec: FieldSpec):
    one = spec.R % spec.modulus
    return (ctypes.c_uint32 * spec.n_words)(
        *[(one >> (32 * k)) & 0xFFFFFFFF for k in range(spec.n_words)])


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
    lib = build.library("mont_kernels", spec.n_words)
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

    lib = build.library("mont_kernels", spec.n_words)
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


# --------------------------------------------------------------------------
# blocked batched inversion
# --------------------------------------------------------------------------


def _check_exponent(spec: FieldSpec, exponent: int | None) -> int:
    e = spec.modulus - 2 if exponent is None else int(exponent)
    if not 1 <= e < 1 << (32 * spec.n_words):
        raise ValueError(f"exponent must be in [1, 2^{32 * spec.n_words})")
    return e


def _check_flat(spec: FieldSpec, a: torch.Tensor, *others) -> torch.device:
    device = _check_elems(spec, a, *others)
    if a.ndim != 2 or a.shape[1] < 1:
        raise ValueError(f"expected a non-empty [L, n] batch, got {tuple(a.shape)}")
    return device


def _columns(n: int, group: int) -> int:
    """Columns m = ceil(n / group) of n elements seen as ``group`` rows."""
    if group < 1:
        raise ValueError(f"group must be at least 1, got {group}")
    return -(-n // group)


def level_plan(n: int, group: int = INV_GROUP, bottom: int = INV_BOTTOM):
    """The levels of a blocked inversion of n elements, top first, as
    (elements, rows, columns): each level folds ``rows`` rows into one and
    hands ``columns`` totals to the next, until at most ``bottom`` are left
    for the bottom's per-element inversion.  A level takes no more rows
    than it needs to get there."""
    if group < 2 or bottom < 1:
        raise ValueError("group must be at least 2 and bottom at least 1")
    plan = []
    while n > bottom:
        rows = min(group, -(-n // bottom))
        cols = -(-n // rows)
        plan.append((n, rows, cols))
        n = cols
    return plan


def inv_prefix(spec: FieldSpec, a: torch.Tensor, group: int):
    """Running products down the ``group`` rows of a [L, n] (rows of
    m = ceil(n / group) consecutive elements; a zero counts as one).
    Returns (prefixes [L, n], column totals [L, m])."""
    device = _check_flat(spec, a)
    n = a.shape[1]
    m = _columns(n, group)
    if device.type == "cpu":
        return inv_prefix_plain(spec, a, group)
    from ..kernels import build

    _require_contiguous("a", a)
    pref = torch.empty_like(a)
    tails = torch.empty((spec.n_limbs, m), dtype=torch.int32, device=device)
    lib = build.library("inverse_kernels", spec.n_words)
    with torch.cuda.device(device):
        code = lib.inv_prefix_launch(
            a.data_ptr(), pref.data_ptr(), tails.data_ptr(), n, m, group,
            _p_words_arg(spec), spec.inv32, _one_words_arg(spec),
            torch.cuda.current_stream().cuda_stream,
        )
    launches["inv_prefix"] += 1
    _raise_on_error(code, "inv_prefix")
    return pref, tails


def inv_backward(spec: FieldSpec, a: torch.Tensor, pref: torch.Tensor,
                 tinv: torch.Tensor, group: int) -> torch.Tensor:
    """Inverses [L, n] of ``a`` from its prefixes (``inv_prefix``) and the
    inverses ``tinv`` [L, m] of its column totals; zero where a is zero."""
    device = _check_flat(spec, a, pref, tinv)
    n = a.shape[1]
    m = _columns(n, group)
    if pref.shape != a.shape or tuple(tinv.shape) != (spec.n_limbs, m):
        raise ValueError(
            f"inv_backward takes a, pref [L, {n}] and tinv [L, {m}], got "
            f"{tuple(pref.shape)} and {tuple(tinv.shape)}")
    if device.type == "cpu":
        return inv_backward_plain(spec, a, pref, tinv, group)
    from ..kernels import build

    for name, t in (("a", a), ("pref", pref), ("tinv", tinv)):
        _require_contiguous(name, t)
    out = torch.empty_like(a)
    lib = build.library("inverse_kernels", spec.n_words)
    with torch.cuda.device(device):
        code = lib.inv_backward_launch(
            a.data_ptr(), pref.data_ptr(), tinv.data_ptr(), out.data_ptr(), n, m,
            group, _p_words_arg(spec), spec.inv32, _one_words_arg(spec),
            torch.cuda.current_stream().cuda_stream,
        )
    launches["inv_backward"] += 1
    _raise_on_error(code, "inv_backward")
    return out


def inv_fermat(spec: FieldSpec, a: torch.Tensor, exponent: int | None = None):
    """Per-element inverse a^(p-2) of a [L, n], zero to zero: one thread an
    element, one launch.  The kernel is a ladder over a launch-constant
    exponent; another ``exponent`` than p - 2 is for holding it against
    other code (2 runs the dedicated squaring alone)."""
    device = _check_flat(spec, a)
    e = _check_exponent(spec, exponent)
    if device.type == "cpu":
        return inv_fermat_plain(spec, a, e)
    from ..kernels import build

    _require_contiguous("a", a)
    out = torch.empty_like(a)
    e_words = (ctypes.c_uint32 * spec.n_words)(
        *[(e >> (32 * k)) & 0xFFFFFFFF for k in range(spec.n_words)])
    lib = build.library("inverse_kernels", spec.n_words)
    with torch.cuda.device(device):
        code = lib.inv_fermat_launch(
            a.data_ptr(), out.data_ptr(), a.shape[1], e_words, e.bit_length(),
            _p_words_arg(spec), spec.inv32,
            torch.cuda.current_stream().cuda_stream,
        )
    launches["inv_fermat"] += 1
    _raise_on_error(code, "inv_fermat")
    return out


def gcd_batches(spec: FieldSpec) -> int:
    """Batches of 30 safegcd divsteps that invert any x < p: Bernstein and
    Yang's bound on the original divstep (TCHES 2019, Theorem 11.2), with
    d = bits(p), (49 d + 57) / 17 divsteps for d >= 46 and (49 d + 80) / 17
    below, its ceiling rounded up to whole batches."""
    d = spec.modulus.bit_length()
    steps = -(-(49 * d + (57 if d >= 46 else 80)) // 17)
    return -(-steps // 30)


@functools.lru_cache(maxsize=None)
def _r2_words_arg(spec: FieldSpec):
    r2 = spec.R * spec.R % spec.modulus
    return (ctypes.c_uint32 * spec.n_words)(
        *[(r2 >> (32 * k)) & 0xFFFFFFFF for k in range(spec.n_words)])


def inv_gcd(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Per-element inverse of a [L, n] (Montgomery form in and out), zero
    to zero, by safegcd: one thread an element, ``gcd_batches`` batches of
    30 divsteps each, one launch.  A CPU tensor takes ``inv_fermat_plain``,
    which computes the same function."""
    device = _check_flat(spec, a)
    if device.type == "cpu":
        return inv_fermat_plain(spec, a)
    from ..kernels import build

    _require_contiguous("a", a)
    out = torch.empty_like(a)
    lib = build.library("inverse_kernels", spec.n_words)
    with torch.cuda.device(device):
        code = lib.inv_gcd_launch(
            a.data_ptr(), out.data_ptr(), a.shape[1], _p_words_arg(spec), spec.inv32,
            _r2_words_arg(spec), gcd_batches(spec),
            torch.cuda.current_stream().cuda_stream,
        )
    launches["inv_gcd"] += 1
    _raise_on_error(code, "inv_gcd")
    return out


def _blocked_inverse(spec, a, group, bottom, prefix, invert, backward):
    stack = []
    cur = a
    for _, rows, _ in level_plan(a.shape[1], group, bottom):
        pref, tails = prefix(spec, cur, rows)
        stack.append((cur, pref, rows))
        cur = tails
    inv = invert(spec, cur)
    while stack:
        lvl, pref, rows = stack.pop()
        inv = backward(spec, lvl, pref, inv, rows)
    return inv


def batch_inverse(spec: FieldSpec, a: torch.Tensor, group: int = INV_GROUP,
                  bottom: int = INV_BOTTOM) -> torch.Tensor:
    """Inverse of every element of a [L, n] (Montgomery form), zero to
    zero: ``inv_prefix`` down the levels of ``level_plan``, one
    ``inv_gcd`` at the bottom, ``inv_backward`` up again.  Bit-identical
    to a per-element ladder, since inverses are unique and canonical.
    ``group`` and ``bottom`` shape the levels, not the result."""
    _check_flat(spec, a)
    return _blocked_inverse(spec, a, group, bottom, inv_prefix, inv_gcd,
                            inv_backward)


# --------------------------------------------------------------------------
# weighted sums of products (K17)
# --------------------------------------------------------------------------


def _dot_weights(W, square_mask, K: int):
    """(int64 [n_out, K] weights, bool [K] square mask) as numpy."""
    import numpy as np

    W = np.asarray(W, np.int64)
    if W.ndim != 2 or W.shape[1] != K:
        raise ValueError(f"weights must be [n_out, {K}], got {W.shape}")
    sq = (np.zeros(K, bool) if square_mask is None
          else np.asarray(square_mask, bool).reshape(K))
    return W, sq


def dot_plain(spec: FieldSpec, A: torch.Tensor, B: torch.Tensor, W,
              square_mask=None) -> torch.Tensor:
    """sum_k W[o, k] * A[:, k] * B[:, k] * R^-1 mod p for every output row
    o, on 16-bit limbs in int64 (any device).  A, B: int32 [L, K, *batch];
    W: integers [n_out, K] (negative allowed); ``square_mask``: bool [K],
    pairs whose product is A[k]^2 (B[k] is not read there).  The K
    canonical products are formed once; a row's weighted sum of them is
    taken limb by limb (signed, below 2^26 in magnitude), made
    non-negative by adding p times the row's negative weight mass, carried,
    and brought below p by subtracting p 2^j where it fits, j from the top
    of the row mass down.  Returns int32 [L, n_out, *batch]."""
    import numpy as np

    K = A.shape[1]
    W, sq = _dot_weights(W, square_mask, K)
    n_out = W.shape[0]
    L, p = spec.n_limbs, spec.modulus
    batch = tuple(A.shape[2:])
    if K == 0 or n_out == 0:
        return torch.zeros((L, n_out) + batch, dtype=torch.int32, device=A.device)
    if sq.any():
        m = torch.as_tensor(sq, device=A.device).reshape((1, K) + (1,) * len(batch))
        B = torch.where(m, A, B)
    T = mul_plain(spec, A, B).to(torch.int64)  # [L, K, *batch]
    neg_mass = np.maximum(-W, 0).sum(axis=1)
    n_bits = max(int(np.abs(W).sum(axis=1).max()).bit_length(), 1)
    width = L + (n_bits + 15) // 16 + 1
    rows = []
    for o in range(n_out):
        ks = np.nonzero(W[o])[0]
        w = torch.as_tensor(W[o, ks], device=A.device).reshape((1, ks.size) + (1,) * len(batch))
        s = (T[:, torch.as_tensor(ks, device=A.device)] * w).sum(dim=1)
        offset = torch.tensor(_limbs_of(int(neg_mass[o]) * p, width), dtype=torch.int64,
                              device=A.device).reshape((width,) + (1,) * len(batch))
        rows.append(torch.cat([s, torch.zeros_like(s[: width - L])], dim=0) + offset)
    v, _ = _chain(torch.stack(rows, dim=1))  # [width, n_out, *batch], < 2^n_bits p
    for j in reversed(range(n_bits)):
        pj = torch.tensor(_limbs_of(p << j, width), dtype=torch.int64, device=A.device)
        d, borrow = _sub_limbs(v, pj.reshape((width,) + (1,) * (v.ndim - 1)))
        v = torch.where(borrow != 0, v, d)
    return v[:L].to(torch.int32)


def _limbs_of(x: int, L: int) -> list:
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(L)]


# compressed weight tables by (weights, square mask), and their device copies
_dot_tables: dict = {}


def dot_table(W, square_mask, K: int):
    """The kernel's form of a weight matrix: (row starts int32 [n_out + 1],
    entries int32 [nnz, 2]) as numpy, entry = (pair index, with bit 30 set
    for a square pair; the weight), rows in order.  Cached by value."""
    import numpy as np

    W, sq = _dot_weights(W, square_mask, K)
    key = (W.shape, W.tobytes(), sq.tobytes())
    hit = _dot_tables.get(key)
    if hit is not None:
        return hit
    if np.abs(W).max(initial=0) >= 1 << 31:
        raise ValueError("dot weights must fit in 32 bits")
    rows, ks = np.nonzero(W)
    codes = ks.astype(np.int64) | (sq[ks].astype(np.int64) << 30)
    ent = np.stack([codes, W[rows, ks]], axis=1).astype(np.int32)
    starts = np.zeros(W.shape[0] + 1, np.int32)
    np.add.at(starts, rows + 1, 1)
    starts = np.cumsum(starts).astype(np.int32)
    hit = {"row_start": starts, "entries": np.ascontiguousarray(ent),
           "max_row": int(np.diff(starts).max(initial=0)), "devices": {}}
    _dot_tables[key] = hit
    return hit


def dot(spec: FieldSpec, A: torch.Tensor, B: torch.Tensor, W,
        square_mask=None) -> torch.Tensor:
    """K17: sum_k W[o, k] * A[:, k] * B[:, k] * R^-1 mod p, int32
    [L, n_out, *batch] from A, B int32 [L, K, *batch] (equal shapes) and
    integer weights W [n_out, K]; ``square_mask`` [K] marks pairs with
    A[k] = B[k].  CUDA tensors go through the kernel (strided operands are
    copied first), CPU tensors through ``dot_plain``."""
    device = _check_elems(spec, A, B)
    if A.shape != B.shape or A.ndim < 2:
        raise ValueError(f"dot takes A, B [L, K, *batch] of one shape, got "
                         f"{tuple(A.shape)} and {tuple(B.shape)}")
    if device.type == "cpu":
        return dot_plain(spec, A, B, W, square_mask)
    from ..kernels import build

    K = A.shape[1]
    table = dot_table(W, square_mask, K)
    n_out = table["row_start"].shape[0] - 1
    batch = tuple(A.shape[2:])
    n = math.prod(batch)
    out = torch.empty((spec.n_limbs, n_out) + batch, dtype=torch.int32, device=device)
    if n == 0 or n_out == 0:
        return out
    lib = build.library("dot_kernels", spec.n_words)
    if table["max_row"] > lib.dot_max_row():
        raise ValueError(f"a row of {table['max_row']} weights exceeds the kernel's "
                         f"{lib.dot_max_row()}")
    dev = table["devices"].get(device)
    if dev is None:
        dev = (torch.from_numpy(table["row_start"]).to(device),
               torch.from_numpy(table["entries"]).to(device))
        table["devices"][device] = dev
    # the contiguous copies stay referenced here until the launch is queued
    a_c, b_c = A.contiguous(), B.contiguous()
    with torch.cuda.device(device):
        code = lib.mont_dot_launch(
            a_c.data_ptr(), b_c.data_ptr(), out.data_ptr(), n, K, n_out,
            dev[0].data_ptr(), dev[1].data_ptr(), _p_words_arg(spec), spec.inv32,
            torch.cuda.current_stream().cuda_stream,
        )
    launches["mont_dot"] += 1
    _raise_on_error(code, "mont_dot")
    return out
