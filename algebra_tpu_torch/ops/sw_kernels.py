"""The CUDA group-law kernels: wrappers, plain versions.

Counterpart of the JAX package's ``ops/sw_pallas.py``.  Four kernels,
CUDA C++ over the device functions of ``csrc/sw.cuh``
(``csrc/sw_kernels.cu``), for short-Weierstrass curves with a = 0 over a
prime field:

``jac_double``  (wrapper ``double``)
    Replaces ``_double_kernel`` (``ops/sw_pallas.py:111``, wrapper
    ``double`` :567): dbl-2009-l, 5 squarings and 2 products a lane;
    infinity falls out as Z3 = 0.
``jac_add``  (wrapper ``add``)
    Replaces ``_add_kernel`` (``sw_pallas.py:120``, wrapper ``add`` :616):
    add-2007-bl, 5 squarings and 11 products for the generic sum; P = Q
    goes to the doubling, then Q = inf gives P, then P = inf gives Q.
``jac_madd``  (wrapper ``madd``)
    Replaces ``_madd_kernel`` (``sw_pallas.py:56``, wrapper ``madd`` :596):
    madd-2007-bl, Jacobian P plus affine Q with an infinity flag, 4
    squarings and 7 products for the generic sum; the same selects, and
    P = inf gives from_affine(Q).
``jac_madd_round``  (wrappers ``madd_round``, ``madd_rounds``)
    The same law as one lockstep round of the MSM's bucket phase: each lane
    reads its own row of the signed point table through the sorted order
    (the reference gathers the rows, negates y by the digit's sign and
    selects in jnp around ``_madd_kernel``), so a round is one launch;
    ``madd_rounds`` runs consecutive rounds with one operand check.

K7 and K6 have one more kernel each, for the MSM's tail
(``csrc/msm_reduce_kernels.cu``), which the reference runs as one call of
``_add_kernel`` or ``_double_kernel`` (``sw_pallas.py:120``, :111) a step,
~1,180 at 2^20:

``bucket_reduce_inner``  (wrapper ``bucket_reduce``)
    The weighted bucket reduction's inner scan, G steps of two adds on every
    (window, block) lane, in one launch: a pair of threads a lane, accT and
    accW one step apart, in registers.
``reduce_fold``  (wrapper ``reduce_fold``)
    Its outer scan (three threads a window), log2(G) doublings, and the
    Horner fold (one thread), in one launch of one block.

Their plain versions are the reference's loops (``inner_scan``,
``outer_fold``) over ``add_plain`` and ``double_plain``; the MSM runs the
same loops over a curve's own law where it has no kernels.

Four more add affine points by the chord/tangent law around a batched
inversion (a prime field, any a), two on coordinate arrays (wrapper
``affine_add``, behind ``SWCurve.affine_add``) and two on the packed rows of
the MSM's affine tree (``ops/rows.py``; wrapper ``affine_add_rows``):

``aff_denom``  (K9), ``affr_denom``  (K11)
    Replace ``_aff_denom_kernel`` (``sw_pallas.py:199``, wrapper
    ``affine_add`` :304) and ``_affr_denom_kernel`` (:373, wrapper
    ``affine_add_rows`` :477): the slope's denominator of each pair,
    limb-major [L, ...]: 2 y1 for a tangent, x2 - x1 for a chord, one for a
    degenerate lane (an infinity or opposite points).  K9 first negates y1,
    y2 where the optional masks ``neg1``/``neg2`` say (0 stays 0).
``aff_post``  (K10), ``affr_post``  (K12)
    Replace ``_aff_post_kernel`` (``sw_pallas.py:216``) and
    ``_affr_post_kernel`` (:391): lambda, x3, y3 and the infinity flag from
    the inverses, as coordinate arrays and a mask (K10) or as rows (K12).
    An infinity lane copies where the reference selects; an opposite-points
    lane computes with the inverse of one, as the reference does, so even
    its flagged coordinates are the reference's.

A lane branches where the TPU selects: an infinity lane copies, a P = Q
lane computes the doubling instead of the rest of the sum; the results are
the selects' results bit for bit (``csrc/sw.cuh``).  The reference pads
every batch to a bucketed width and broadcasts operands by copying; here a
bound in the grid-stride loop covers a ragged n, and every input coordinate
is read through a limb stride and a lane stride, so a broadcast element, a
strided slice of the weighted reduction or the MSM's point-major gathered
rows go in without a copy.  Where each kernel's time goes, and its bound,
is in ``PERF.md``.

Dispatch has no switch: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises.  The plain versions compose the field
kernels' plain versions (``mont_kernels.mul_plain``, ``add_plain``,
``sub_plain``) in the kernels' formulas and select like the reference,
and run on any device.  Launch counts are kept in ``mont_kernels.launches``
beside the field kernels' (``jac_double``, ``jac_add``, ``jac_madd``,
``jac_madd_round``, ``bucket_reduce_inner``, ``reduce_fold``, ``aff_denom``,
``aff_post``, ``affr_denom``, ``affr_post``), so one ``reset_launches()``
clears them all.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..fields.spec import FieldSpec
from . import mont_kernels as mk, rows
from .mont_kernels import launches

# --------------------------------------------------------------------------
# plain versions (any device)
# --------------------------------------------------------------------------


_add, _sub, _mul = mk.add_plain, mk.sub_plain, mk.mul_plain


def _sq(spec, a):
    return _mul(spec, a, a)


def _dbl(spec, a):
    return _add(spec, a, a)


def _is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=0)


def _sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask over the batch, a and b limb-major [L, *batch]."""
    return torch.where(mask, a, b)


def _one(spec: FieldSpec, like: torch.Tensor) -> torch.Tensor:
    """1 in Montgomery form as [L, 1, ...], broadcastable against ``like``."""
    return mk._one_mont(spec, like).reshape((spec.n_limbs,) + (1,) * (like.ndim - 1))


def double_plain(spec: FieldSpec, x1, y1, z1):
    """dbl-2009-l (a = 0) on limb-major coordinates (shapes broadcast)."""
    A = _sq(spec, x1)
    Bv = _sq(spec, y1)
    C = _sq(spec, Bv)
    t = _add(spec, x1, Bv)
    D = _dbl(spec, _sub(spec, _sub(spec, _sq(spec, t), A), C))
    E = _add(spec, _dbl(spec, A), A)
    F = _sq(spec, E)
    X3 = _sub(spec, F, _dbl(spec, D))
    Y3 = _sub(spec, _mul(spec, E, _sub(spec, D, X3)),
               _dbl(spec, _dbl(spec, _dbl(spec, C))))
    Z3 = _dbl(spec, _mul(spec, y1, z1))
    return X3, Y3, Z3


def add_plain(spec: FieldSpec, x1, y1, z1, x2, y2, z2):
    """add-2007-bl with the reference's selects, branchless: the generic sum
    and the doubling in every lane, then P = Q, Q = inf, P = inf."""
    Z1Z1 = _sq(spec, z1)
    Z2Z2 = _sq(spec, z2)
    U1 = _mul(spec, x1, Z2Z2)
    U2 = _mul(spec, x2, Z1Z1)
    S1 = _mul(spec, y1, _mul(spec, z2, Z2Z2))
    S2 = _mul(spec, y2, _mul(spec, z1, Z1Z1))
    H = _sub(spec, U2, U1)
    r = _dbl(spec, _sub(spec, S2, S1))
    I = _sq(spec, _dbl(spec, H))
    J = _mul(spec, H, I)
    V = _mul(spec, U1, I)
    X3 = _sub(spec, _sub(spec, _sq(spec, r), J), _dbl(spec, V))
    Y3 = _sub(spec, _mul(spec, r, _sub(spec, V, X3)),
               _dbl(spec, _mul(spec, S1, J)))
    zs = _add(spec, z1, z2)
    Z3 = _mul(spec, _sub(spec, _sub(spec, _sq(spec, zs), Z1Z1), Z2Z2), H)

    Xd, Yd, Zd = double_plain(spec, x1, y1, z1)
    same = _is_zero(H) & _is_zero(r)
    q_inf = _is_zero(z2)
    p_inf = _is_zero(z1)
    out = []
    for c3, cd, c1, c2 in ((X3, Xd, x1, x2), (Y3, Yd, y1, y2), (Z3, Zd, z1, z2)):
        c3 = _sel(same, cd, c3)
        c3 = _sel(q_inf, c1, c3)
        out.append(_sel(p_inf, c2, c3))
    return tuple(out)


def madd_plain(spec: FieldSpec, x1, y1, z1, x2, y2, inf2):
    """madd-2007-bl (P Jacobian, Q = (x2, y2) affine, ``inf2`` its bool
    infinity mask over the batch) with the reference's selects, branchless."""
    Z1Z1 = _sq(spec, z1)
    U2 = _mul(spec, x2, Z1Z1)
    S2 = _mul(spec, y2, _mul(spec, z1, Z1Z1))
    H = _sub(spec, U2, x1)
    r = _dbl(spec, _sub(spec, S2, y1))
    HH = _sq(spec, H)
    I = _dbl(spec, _dbl(spec, HH))
    J = _mul(spec, H, I)
    V = _mul(spec, x1, I)
    X3 = _sub(spec, _sub(spec, _sq(spec, r), J), _dbl(spec, V))
    Y3 = _sub(spec, _mul(spec, r, _sub(spec, V, X3)),
               _dbl(spec, _mul(spec, y1, J)))
    t = _add(spec, z1, H)
    Z3 = _sub(spec, _sub(spec, _sq(spec, t), Z1Z1), HH)

    Xd, Yd, Zd = double_plain(spec, x1, y1, z1)
    same = _is_zero(H) & _is_zero(r)
    p_inf = _is_zero(z1)
    one = _one(spec, X3)
    zero = torch.zeros_like(one)
    from_q = (_sel(inf2, one, x2), _sel(inf2, one, y2), _sel(inf2, zero, one))
    out = []
    for c3, cd, c1, cq in zip((X3, Y3, Z3), (Xd, Yd, Zd), (x1, y1, z1), from_q):
        c3 = _sel(same, cd, c3)
        c3 = _sel(inf2, c1, c3)
        out.append(_sel(p_inf, cq, c3))
    return tuple(out)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _batch(coords, masks=()) -> tuple:
    """The broadcast batch shape of limb-major coordinates and batch masks
    (the common case, one shape, without ``torch.broadcast_shapes``, which
    costs ~0.1 ms of host time a launch)."""
    shapes = {tuple(c.shape[1:]) for c in coords} | {tuple(m.shape) for m in masks}
    if len(shapes) == 1:
        return shapes.pop()
    return tuple(torch.broadcast_shapes(*shapes))


def _expand(x: torch.Tensor, batch: tuple) -> torch.Tensor:
    """A [L, *b] coordinate as a [L, *batch] view (batch axes right-aligned)."""
    if x.shape[1:] == batch:
        return x
    missing = len(batch) - (x.ndim - 1)
    if missing > 0:
        x = x.reshape(x.shape[:1] + (1,) * missing + x.shape[1:])
    return x.expand(x.shape[:1] + batch)


def _lane_stride(x: torch.Tensor):
    """The one stride that walks the batch axes of ``x`` in order, or None
    when they do not collapse into one (0 for a broadcast element)."""
    dims = [(d, s) for d, s in zip(x.shape[1:], x.stride()[1:]) if d != 1]
    if not dims:
        return 0
    expect = dims[-1][1]
    for d, s in reversed(dims):
        if s != expect:
            return None
        expect = s * d
    return dims[-1][1]


def _operand(x: torch.Tensor, batch: tuple):
    """(tensor, limb stride, lane stride) of a coordinate broadcast to
    ``batch``: a view where the strides allow it, else a contiguous copy."""
    xe = _expand(x, batch)
    bs = _lane_stride(xe)
    if bs is None:
        xe = xe.contiguous()
        return xe, math.prod(batch), 1
    return xe, xe.stride(0), bs


def _check_out(spec: FieldSpec, out, batch: tuple, device) -> tuple:
    """Output coordinates: new [L, *batch] arrays, or the caller's."""
    shape = (spec.n_limbs,) + batch
    if out is None:
        return tuple(torch.empty(shape, dtype=torch.int32, device=device)
                     for _ in range(3))
    for t in out:
        if tuple(t.shape) != shape or t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != device:
            raise ValueError(f"out must be three contiguous int32 {shape} tensors "
                             f"on {device}")
    return tuple(out)


def store(res, out):
    """``res`` as the caller's ``out`` arrays, when given."""
    if out is None:
        return tuple(res)
    for o, r in zip(out, res):
        o.copy_(r)
    return tuple(out)


def _launch(name: str, spec: FieldSpec, device, *args, extra=(),
            source: str = "sw_kernels") -> None:
    """Launch ``name`` of ``source``'s library: its operands, then the
    field's modulus and inv32, then ``extra`` constants, then the stream."""
    from ..kernels import build

    lib = build.library(source, spec.n_words)
    with torch.cuda.device(device):
        code = getattr(lib, f"{name}_launch")(
            *args, mk._p_words_arg(spec), spec.inv32, *extra,
            torch.cuda.current_stream().cuda_stream)
    launches[name] += 1
    mk._raise_on_error(code, name)


def _check_mask(name: str, m, device) -> None:
    if m is not None and (m.dtype != torch.bool or m.device != device):
        raise ValueError(f"{name} must be a bool mask on {device}")


def _mask_operand(m, batch: tuple):
    """(tensor or None, lane stride) of an optional bool batch mask
    broadcast to ``batch``: a view where the strides allow it."""
    if m is None:
        return None, 0
    mb = m.expand(batch)
    bs = _lane_stride(mb[None])
    if bs is None:
        mb, bs = mb.contiguous(), 1
    return mb, bs


def _ptr(t):
    """A tensor's device pointer, or null for None."""
    return t.data_ptr() if t is not None else None


def _flat_args(operands) -> list:
    args = []
    for t, ls, bs in operands:
        args += [t.data_ptr(), ls, bs]
    return args


def double(spec: FieldSpec, P, out=None):
    """Jacobian doubling (a = 0) of P = (x, y, z), int32 [L, *batch] each.
    ``out``: three contiguous [L, *batch] arrays to write (they may be P's
    own); new arrays when None."""
    device = mk._check_elems(spec, *P)
    batch = _batch(P)
    if device.type == "cpu":
        return store(double_plain(spec, *(_expand(c, batch) for c in P)), out)
    outs = _check_out(spec, out, batch, device)
    n = math.prod(batch)
    if n:
        ops = [_operand(c, batch) for c in P]
        _launch("jac_double", spec, device, *_flat_args(ops),
                *(o.data_ptr() for o in outs), n)
    return outs


def add(spec: FieldSpec, P, Q, out=None):
    """Full Jacobian addition P + Q (a = 0), with the reference's exceptional
    cases; coordinates int32 [L, ...], batch shapes broadcast.  ``out`` as
    for ``double``."""
    device = mk._check_elems(spec, *P, *Q)
    batch = _batch((*P, *Q))
    if device.type == "cpu":
        return store(add_plain(spec, *(_expand(c, batch) for c in (*P, *Q))), out)
    outs = _check_out(spec, out, batch, device)
    n = math.prod(batch)
    if n:
        ops = [_operand(c, batch) for c in (*P, *Q)]
        _launch("jac_add", spec, device, *_flat_args(ops),
                *(o.data_ptr() for o in outs), n)
    return outs


def madd(spec: FieldSpec, P, aff, out=None):
    """Mixed addition P + Q of a Jacobian P = (x, y, z) and an affine
    Q = (x2, y2, inf) with ``inf`` a bool batch mask, with the reference's
    exceptional cases; batch shapes broadcast.  ``out`` as for ``double``:
    the MSM's bucket rounds pass P's own arrays and accumulate in place."""
    x2, y2, inf = aff
    device = mk._check_elems(spec, *P, x2, y2)
    _check_mask("inf", inf, device)
    batch = _batch((*P, x2, y2), (inf,))
    if device.type == "cpu":
        coords = [_expand(c, batch) for c in (*P, x2, y2)]
        return store(madd_plain(spec, *coords, inf.expand(batch)), out)
    outs = _check_out(spec, out, batch, device)
    n = math.prod(batch)
    if n:
        ops = [_operand(c, batch) for c in (*P, x2, y2)]
        inf_b, inf_bs = _mask_operand(inf, batch)
        _launch("jac_madd", spec, device, *_flat_args(ops), inf_b.data_ptr(), inf_bs,
                *(o.data_ptr() for o in outs), n, extra=(mk._one_words_arg(spec),))
    return outs


def round_operand(spec: FieldSpec, table, order, first, count, r: int):
    """The affine operand (x2, y2, inf) of lockstep round r: lane i's row
    ``order[first[i] + r]`` of the signed table as [L, m] views, infinity
    where r >= count[i] (those lanes read a clamped row, which no law
    looks at)."""
    L = spec.n_limbs
    rows_r = table[order[(first + r).clamp_(max=order.shape[0] - 1)]]
    return rows_r[:, :L].T, rows_r[:, L:].T, count <= r


def madd_round_plain(spec: FieldSpec, acc, table, order, first, count, r: int):
    """``madd_round`` by gather, clamp, row index and ``madd_plain``,
    written into ``acc``; any device."""
    return store(madd_plain(spec, *acc, *round_operand(spec, table, order, first, count, r)),
                 acc)


def _check_round(spec: FieldSpec, acc, table, order, first, count) -> torch.device:
    L = spec.n_limbs
    device = acc[0].device
    m = acc[0].shape[-1]
    for t in acc:
        if t.dtype != torch.int32 or tuple(t.shape) != (L, m) or not t.is_contiguous() \
                or t.device != device:
            raise ValueError(f"acc must be three contiguous int32 [{L}, {m}] tensors "
                             f"on one device")
    if table.dtype != torch.int32 or table.ndim != 2 or table.shape[1] != 2 * L \
            or not table.is_contiguous() or table.device != device:
        raise ValueError(f"table must be a contiguous int32 [2n, {2 * L}] tensor on {device}")
    for name, t, size in (("order", order, None), ("first", first, m), ("count", count, m)):
        if t.dtype != torch.int64 or t.ndim != 1 or not t.is_contiguous() \
                or t.device != device or (size is not None and t.shape[0] != size):
            raise ValueError(f"{name} must be a contiguous int64 vector"
                             f"{'' if size is None else f' of {size}'} on {device}")
    return device


def madd_round(spec: FieldSpec, acc, table, order, first, count, r: int):
    """Round r of the MSM's lockstep bucket phase, in place (K8's round
    kernel ``jac_madd_round``): lane i of the accumulators ``acc`` (three
    contiguous int32 [L, m]) adds the affine point in row
    ``order[first[i] + r]`` of the signed table ``table`` (int32 [2n, 2L],
    ``msm.signed_table``) where r < count[i], and the point at infinity
    otherwise, with ``madd``'s exceptional cases.  ``order``, ``first``,
    ``count``: contiguous int64 vectors (``msm.lane_runs``);
    first[i] + count[i] <= len(order).  One launch and no other device
    work.  Returns ``acc``."""
    return madd_rounds(spec, acc, table, order, first, count, r, r + 1)


def madd_rounds(spec: FieldSpec, acc, table, order, first, count, r0: int, r1: int):
    """Rounds r0, ..., r1 - 1 of ``madd_round`` one after another, the
    operands checked once: a launch a round and nothing else."""
    device = _check_round(spec, acc, table, order, first, count)
    m = acc[0].shape[1]
    for r in range(r0, r1):
        if device.type == "cpu":
            madd_round_plain(spec, acc, table, order, first, count, r)
        elif m:
            _launch("jac_madd_round", spec, device, *(a.data_ptr() for a in acc), m,
                    table.data_ptr(), order.data_ptr(), first.data_ptr(), count.data_ptr(),
                    r, extra=(mk._one_words_arg(spec),))
    return acc


# --------------------------------------------------------------------------
# the affine chord/tangent addition: on coordinate arrays (K9, K10) and on
# one halving level of the MSM's affine tree, packed rows (K11, K12)
# --------------------------------------------------------------------------


def _aff_cases(spec: FieldSpec, x1, y1, i1, x2, y2, i2):
    """(d = x2 - x1, dbl, opp, degen) as ``csrc/sw.cuh`` ``aff_cases``."""
    d = _sub(spec, x2, x1)
    same_x = _is_zero(d)
    dbl = same_x & (y1 == y2).all(dim=0) & ~_is_zero(y1)
    opp = same_x & ~dbl
    return d, dbl, opp, i1 | i2 | opp


def _aff_neg(spec: FieldSpec, y, neg):
    """y -> 0 - y where ``neg`` (0 stays 0), the reference's ``_aff_neg``."""
    if neg is None:
        return y
    return _sel(neg, _sub(spec, torch.zeros_like(y), y), y)


def aff_denom_plain(spec: FieldSpec, x1, y1, i1, x2, y2, i2, neg1=None, neg2=None):
    """The slope denominators [L, *batch] of P + Q, y1/y2 negated first
    where ``neg1``/``neg2`` say: 2 y1 (tangent), x2 - x1 (chord), one (a
    degenerate lane).  Operands of one batch shape."""
    y1, y2 = _aff_neg(spec, y1, neg1), _aff_neg(spec, y2, neg2)
    d, dbl, _, degen = _aff_cases(spec, x1, y1, i1, x2, y2, i2)
    den = _sel(dbl, _dbl(spec, y1), d)
    return _sel(degen, _one(spec, den), den)


def aff_post_plain(spec: FieldSpec, a_mont, x1, y1, i1, x2, y2, i2, inv,
                   neg1=None, neg2=None):
    """(x3, y3, inf3) of P + Q from the inverted denominators ``inv``, with
    the reference's selects: computed in every lane, then
    x3 = i1 ? x2 : (i2 ? x1 : x3) (y3 alike),
    inf3 = (i1 and i2) or (not i1 and not i2 and opp)."""
    y1, y2 = _aff_neg(spec, y1, neg1), _aff_neg(spec, y2, neg2)
    _, dbl, opp, _ = _aff_cases(spec, x1, y1, i1, x2, y2, i2)
    x1sq = _sq(spec, x1)
    three = _add(spec, _dbl(spec, x1sq), x1sq)
    if a_mont is not None:
        a = torch.tensor(list(a_mont), dtype=three.dtype, device=three.device)
        three = _add(spec, three, a.reshape((-1,) + (1,) * (three.ndim - 1)))
    num = _sel(dbl, three, _sub(spec, y2, y1))
    lam = _mul(spec, num, inv)
    x3 = _sub(spec, _sub(spec, _sq(spec, lam), x1), x2)
    y3 = _sub(spec, _mul(spec, lam, _sub(spec, x1, x3)), y1)
    x3 = _sel(i1, x2, _sel(i2, x1, x3))
    y3 = _sel(i1, y2, _sel(i2, y1, y3))
    inf3 = (i1 & i2) | (~i1 & ~i2 & opp)
    return x3, y3, inf3


def _row_pairs(spec: FieldSpec, V: torch.Tensor, valid):
    """V [2m, RW] -> (x1, y1, i1, x2, y2, i2), the even and the odd rows
    as [L, m] coordinates and bool [m] flags; an invalid row is infinity."""
    x1, y1, i1 = rows.unpack_plain(spec, V[0::2])
    x2, y2, i2 = rows.unpack_plain(spec, V[1::2])
    if valid is not None:
        i1, i2 = i1 | ~valid[0::2], i2 | ~valid[1::2]
    return x1, y1, i1, x2, y2, i2


def affr_denom_plain(spec: FieldSpec, V: torch.Tensor, valid=None) -> torch.Tensor:
    """The slope denominators [L, m] of the pairs of V, as ``aff_denom``."""
    return aff_denom_plain(spec, *_row_pairs(spec, V, valid)).contiguous()


def affr_post_plain(spec: FieldSpec, a_mont, V: torch.Tensor, valid,
                    inv: torch.Tensor) -> torch.Tensor:
    """The level's result rows [m, RW] from the inverted denominators, as
    ``aff_post``."""
    return rows.pack_plain(spec, *aff_post_plain(spec, a_mont, *_row_pairs(spec, V, valid),
                                                 inv))


@functools.lru_cache(maxsize=None)
def _words_arg(limbs: tuple):
    """16-bit limbs -> the C array of their 32-bit words."""
    return (ctypes.c_uint32 * (len(limbs) // 2))(
        *[limbs[2 * k] | (limbs[2 * k + 1] << 16) for k in range(len(limbs) // 2)])


def _a_args(spec: FieldSpec, a_mont) -> tuple:
    """The curve's a (Montgomery-form 16-bit limbs, or None for a = 0) as
    the kernels' (words, has_a)."""
    return (_words_arg(tuple(a_mont) if a_mont is not None else (0,) * spec.n_limbs),
            int(a_mont is not None))


def _aff_check(spec: FieldSpec, P, Q, neg1, neg2):
    """(device, batch shape) of K9/K10's operands."""
    (x1, y1, i1), (x2, y2, i2) = P, Q
    device = mk._check_elems(spec, x1, y1, x2, y2)
    masks = {"inf1": i1, "inf2": i2, "neg1": neg1, "neg2": neg2}
    for name, m in masks.items():
        _check_mask(name, m, device)
    batch = _batch((x1, y1, x2, y2), [m for m in masks.values() if m is not None])
    return device, batch


def _aff_expanded(P, Q, neg1, neg2, batch: tuple) -> list:
    """The plain versions' operands, all of shape ``batch``."""
    (x1, y1, i1), (x2, y2, i2) = P, Q
    coords = [_expand(c, batch) for c in (x1, y1)] + [i1.expand(batch)]
    coords += [_expand(c, batch) for c in (x2, y2)] + [i2.expand(batch)]
    return coords + [None if m is None else m.expand(batch) for m in (neg1, neg2)]


def _aff_args(P, Q, neg1, neg2, batch: tuple) -> tuple:
    """(K9/K10's operand arguments, the tensors they point into): the
    coordinates as (pointer, limb stride, lane stride), the masks as
    (pointer, lane stride), a missing mask null.  The caller holds the
    tensors until the launch is queued: a copy freed before it would give
    its block to the next copy, which overwrites it first."""
    (x1, y1, i1), (x2, y2, i2) = P, Q
    args, held = [], []
    for x, y, i in ((x1, y1, i1), (x2, y2, i2)):
        ops = [_operand(x, batch), _operand(y, batch)]
        m, bs = _mask_operand(i, batch)
        args += _flat_args(ops) + [m.data_ptr(), bs]
        held += [t for t, _, _ in ops] + [m]
    for neg in (neg1, neg2):
        m, bs = _mask_operand(neg, batch)
        args += [_ptr(m), bs]
        held.append(m)
    return args, held


def aff_denom(spec: FieldSpec, P, Q, neg1=None, neg2=None) -> torch.Tensor:
    """K9: the slope denominators [L, *batch] of the affine sums P + Q.
    P, Q: (x, y, inf), coordinates int32 [L, ...] and bool inf masks, batch
    shapes broadcast; ``neg1``/``neg2``: optional bool masks that negate
    y1/y2 first."""
    device, batch = _aff_check(spec, P, Q, neg1, neg2)
    if device.type == "cpu":
        return aff_denom_plain(spec, *_aff_expanded(P, Q, neg1, neg2, batch))
    den = torch.empty((spec.n_limbs,) + batch, dtype=torch.int32, device=device)
    n = math.prod(batch)
    if n:
        args, held = _aff_args(P, Q, neg1, neg2, batch)
        _launch("aff_denom", spec, device, *args, den.data_ptr(), n,
                extra=(mk._one_words_arg(spec),))
        del held
    return den


def aff_post(spec: FieldSpec, a_mont, P, Q, inv: torch.Tensor, neg1=None, neg2=None):
    """K10: (x3, y3, inf3) of the affine sums P + Q, given the inverses
    ``inv`` [L, *batch] of ``aff_denom``'s denominators (the same operands).
    ``a_mont``: the curve's a as Montgomery-form 16-bit limbs, or None for
    a = 0."""
    device, batch = _aff_check(spec, P, Q, neg1, neg2)
    mk._check_elems(spec, inv)
    L = spec.n_limbs
    if tuple(inv.shape) != (L,) + batch or inv.device != device:
        raise ValueError(f"inv must be [{L}, {', '.join(map(str, batch))}] on {device}")
    if device.type == "cpu":
        ops = _aff_expanded(P, Q, neg1, neg2, batch)
        return aff_post_plain(spec, a_mont, *ops[:6], inv, *ops[6:])
    xo = torch.empty((L,) + batch, dtype=torch.int32, device=device)
    yo = torch.empty_like(xo)
    io = torch.empty(batch, dtype=torch.bool, device=device)
    n = math.prod(batch)
    if n:
        args, held = _aff_args(P, Q, neg1, neg2, batch)
        inv = inv.contiguous()
        _launch("aff_post", spec, device, *args, inv.data_ptr(), xo.data_ptr(),
                yo.data_ptr(), io.data_ptr(), n, extra=_a_args(spec, a_mont))
        del held
    return xo, yo, io


def affine_add(spec: FieldSpec, a_mont, P, Q, inv_fn, neg1=None, neg2=None):
    """Batched affine P + Q -> (x3, y3, inf3) by the chord/tangent law with
    every exceptional case: K9, ``inv_fn`` on the [L, *batch] denominators
    (``mont.batch_inverse``: zero to zero), K10.  Bit for bit the
    reference's ``sw_pallas.affine_add``, whose ``inv_fn`` sees the batch
    padded to a block with lanes whose denominator is one; here it sees
    the batch alone."""
    den = aff_denom(spec, P, Q, neg1, neg2)
    return aff_post(spec, a_mont, P, Q, inv_fn(den), neg1, neg2)


def _check_level(spec: FieldSpec, V: torch.Tensor, valid) -> torch.device:
    device = rows._check_rows(spec, V)
    if V.shape[0] % 2:
        raise ValueError(f"a level takes an even number of rows, not {V.shape[0]}")
    if valid is not None:
        rows._check_mask("valid", valid, V.shape[0], device)
    return device


def affr_denom(spec: FieldSpec, V: torch.Tensor, valid=None) -> torch.Tensor:
    """K11: the slope denominators [L, m] of the m pairs of V [2m, RW]
    (rows 2i and 2i + 1); ``valid``: optional bool [2m], an invalid row
    counts as infinity."""
    device = _check_level(spec, V, valid)
    if device.type == "cpu":
        return affr_denom_plain(spec, V, valid)
    m = V.shape[0] // 2
    den = torch.empty((spec.n_limbs, m), dtype=torch.int32, device=device)
    if m:
        V = V.contiguous()  # held until the launch is queued, as each copy here
        valid = valid.contiguous() if valid is not None else None
        _launch("affr_denom", spec, device, V.data_ptr(), _ptr(valid), den.data_ptr(), m,
                extra=(mk._one_words_arg(spec),))
    return den


def affr_post(spec: FieldSpec, a_mont, V: torch.Tensor, valid,
              inv: torch.Tensor) -> torch.Tensor:
    """K12: the result rows [m, RW] of the level, given the inverses
    ``inv`` [L, m] of ``affr_denom``'s denominators.  ``a_mont``: the
    curve's a as Montgomery-form 16-bit limbs, or None for a = 0."""
    device = _check_level(spec, V, valid)
    m = V.shape[0] // 2
    mk._check_elems(spec, inv)
    if tuple(inv.shape) != (spec.n_limbs, m) or inv.device != device:
        raise ValueError(f"inv must be [{spec.n_limbs}, {m}] on {device}")
    if device.type == "cpu":
        return affr_post_plain(spec, a_mont, V, valid, inv)
    out = torch.empty((m, V.shape[1]), dtype=torch.int32, device=device)
    if m:
        V, inv = V.contiguous(), inv.contiguous()
        valid = valid.contiguous() if valid is not None else None
        _launch("affr_post", spec, device, V.data_ptr(), _ptr(valid), inv.data_ptr(),
                out.data_ptr(), m, extra=_a_args(spec, a_mont))
    return out


def affine_add_rows(spec: FieldSpec, a_mont, V: torch.Tensor, valid,
                    inv_fn) -> torch.Tensor:
    """One halving level on packed rows: V [2m, RW] (pairs interleaved even,
    odd) -> result rows [m, RW], P + Q by the affine chord/tangent law with
    every exceptional case.  ``valid``: optional bool [2m] (the first level
    of a stage), an invalid slot counts as infinity.  ``inv_fn`` inverts an
    [L, m] batch, zero to zero (``mont.batch_inverse``).  Bit for bit the
    reference's ``sw_pallas.affine_add_rows``, and so its unpack, affine_add,
    pack: K11, the inversion (K2-K4), K12."""
    den = affr_denom(spec, V, valid)
    return affr_post(spec, a_mont, V, valid, inv_fn(den))


# --------------------------------------------------------------------------
# the MSM's tail: the weighted bucket reduction and the Horner fold (the
# general K7/K6 steps, kept in registers for a whole scan)
# --------------------------------------------------------------------------


def reduce_block(B: int) -> int:
    """G ~ sqrt(B), a power of two: the block of the weighted reduction's
    double scan over B buckets a window."""
    return min(B, 1 << (((B - 1).bit_length() + 1) // 2))


class PlainLaw:
    """The plain versions' group law (``add_plain``, ``double_plain``) on
    one device, with ``SWCurve``'s ``add``, ``double`` and ``zero``: what
    ``inner_scan`` and ``outer_fold`` run on for the plain versions."""

    def __init__(self, spec: FieldSpec, device):
        self.spec, self.device = spec, torch.device(device)

    def add(self, P, Q):
        return add_plain(self.spec, *P, *Q)

    def double(self, P):
        return double_plain(self.spec, *P)

    def zero(self, batch_shape=()):
        shape = (self.spec.n_limbs,) + tuple(batch_shape)
        one = mk._one_mont(self.spec, torch.empty(0, dtype=torch.int32, device=self.device))
        one = one.reshape((-1,) + (1,) * len(batch_shape)).expand(shape)
        return one, one, torch.zeros(shape, dtype=torch.int32, device=self.device)


def inner_scan(law, P, G: int):
    """The weighted reduction's inner scan over [L, W, B] buckets, block
    G: for i = G-1 ... 0, accT += P[b G + i], accW += accT on every
    (window, block) lane.  Returns (T, innerW), [L, W, B/G] each: block
    b's plain sum and its (i+1)-weighted sum.  ``law``: the group law
    (an ``SWCurve`` or a ``PlainLaw``)."""
    L, W, B = P[0].shape
    nb = B // G
    Pr = tuple(a.reshape(L, W, nb, G) for a in P)
    accT = accW = law.zero((W, nb))
    for i in range(G - 1, -1, -1):
        accT = law.add(accT, tuple(a[..., i] for a in Pr))  # suffix sum in the block
        accW = law.add(accW, accT)  # sum of suffixes = (i+1)-weighted
    return accT, accW


def outer_fold(law, T, innerW, G: int, c: int):
    """The weighted reduction's outer scan, then the Horner fold: for
    b = nb-1 ... 0 on every window, accB += accT (strictly later suffix:
    b T_b in all), accT += T[b], accI += innerW[b]; accB doubled log2(G)
    times, S_w = accI + accB; then from the top window down, c doublings
    and + S_w.  T, innerW: [L, W, nb] (``inner_scan``); with innerW None,
    T holds the window sums [L, W] themselves (one bucket a window).
    Returns the point, batch ()."""
    if innerW is None:
        sums = T
    else:
        W, nb = T[0].shape[1:]
        accT = accB = accI = law.zero((W,))
        for b in range(nb - 1, -1, -1):
            accB = law.add(accB, accT)
            accT = law.add(accT, tuple(a[..., b] for a in T))
            accI = law.add(accI, tuple(a[..., b] for a in innerW))
        for _ in range(G.bit_length() - 1):  # * G
            accB = law.double(accB)
        sums = law.add(accI, accB)
    total = law.zero(())
    for w in range(sums[0].shape[1] - 1, -1, -1):
        for _ in range(c):
            total = law.double(total)
        total = law.add(total, tuple(a[:, w] for a in sums))
    return total


def bucket_reduce_plain(spec: FieldSpec, P):
    """``bucket_reduce`` on the plain versions (any device)."""
    return inner_scan(PlainLaw(spec, P[0].device), P, reduce_block(P[0].shape[2]))


def reduce_fold_plain(spec: FieldSpec, T, innerW, G: int, c: int):
    """``reduce_fold`` on the plain versions (any device)."""
    return outer_fold(PlainLaw(spec, T[0].device), T, innerW, G, c)


def _check_points(spec: FieldSpec, name: str, P, ndim: int) -> torch.device:
    device = mk._check_elems(spec, *P)
    if len(P) != 3 or len({tuple(a.shape) for a in P}) != 1 or P[0].ndim != ndim:
        raise ValueError(f"{name} must be three int32 coordinates of one "
                         f"[{spec.n_limbs}{', ...' * (ndim - 1)}] shape")
    return device


def bucket_reduce(spec: FieldSpec, P):
    """The weighted reduction's inner scan (``inner_scan``) of the buckets
    P, three int32 [L, W, B] coordinates with B >= 2 a power of two, in one
    launch of ``bucket_reduce_inner`` (csrc/msm_reduce_kernels.cu): a pair
    of threads a (window, block) lane, accT and accW one step apart in
    registers.  Returns (T, innerW), three [L, W, B/G] coordinates each,
    G = ``reduce_block(B)``."""
    device = _check_points(spec, "P", P, 3)
    L, W, B = P[0].shape
    if B < 2 or B & (B - 1):
        raise ValueError(f"the buckets a window must be a power of two >= 2, not {B}")
    if device.type == "cpu":
        return bucket_reduce_plain(spec, P)
    G = reduce_block(B)
    nb = B // G
    P = tuple(a.contiguous() for a in P)
    out = torch.empty((6, L, W, nb), dtype=torch.int32, device=device)
    if W:
        _launch("bucket_reduce_inner", spec, device, *(a.data_ptr() for a in P),
                *(o.data_ptr() for o in out), W * nb, G,
                extra=(mk._one_words_arg(spec),), source="msm_reduce_kernels")
    return tuple(out[:3]), tuple(out[3:])


def reduce_fold(spec: FieldSpec, T, innerW, G: int, c: int):
    """The weighted reduction's outer scan and the Horner fold
    (``outer_fold``) in one launch of ``reduce_fold`` (one block: three
    threads a window for the outer scan, then one thread for the fold).
    T, innerW: three int32 [L, W, nb] coordinates each (``bucket_reduce``),
    G the block, c the window size; with innerW None, T holds the window
    sums [L, W].  Returns the point, three [L]."""
    direct = innerW is None
    device = _check_points(spec, "T", T, 2 if direct else 3)
    if not direct and (_check_points(spec, "innerW", innerW, 3) != device
                       or innerW[0].shape != T[0].shape):
        raise ValueError("innerW must match T in shape and device")
    if G < 1 or G & (G - 1) or c < 0:
        raise ValueError(f"G must be a power of two and c >= 0, not {G}, {c}")
    if device.type == "cpu":
        return reduce_fold_plain(spec, T, innerW, G, c)
    L, W = T[0].shape[:2]
    nb = 1 if direct else T[0].shape[2]
    T = tuple(a.contiguous() for a in T)
    iw = T if direct else tuple(a.contiguous() for a in innerW)
    sums = torch.empty((3, L, W), dtype=torch.int32, device=device)
    out = torch.empty((3, L), dtype=torch.int32, device=device)
    _launch("reduce_fold", spec, device, *(a.data_ptr() for a in (*T, *iw)),
            sums.data_ptr(), *(o.data_ptr() for o in out), W, nb, G.bit_length() - 1, c,
            int(direct), extra=(mk._one_words_arg(spec),), source="msm_reduce_kernels")
    return tuple(out)
