"""Pippenger multi-scalar multiplication: the lockstep bucket path.

Counterpart of the JAX package's ``ops/msm.py``, lockstep half (its
``msm`` on any backend but a TPU).  Sum_i s_i * P_i over n affine bases:

  * **Signed-digit recoding** of all windows at once by shifts over the
    16-bit scalar limbs (``signed_digits``), then per window a stable sort
    of the points by bucket and the run start and length of every bucket
    (``recode_group``), without a binary search: a scatter-min of first
    positions and a reversed running minimum.
  * **Bucket accumulation in lockstep**: round r adds the r-th point of
    every (window, bucket) at once, one batched mixed addition (kernel K8)
    of width windows x buckets, written over the accumulators in place.
    The rounds stop at the K-th largest bucket count of the full windows;
    the few buckets left run on a compacted K-wide batch
    (``_drain_bucket_tail``), and the top window, whose digits crowd into
    few buckets, finishes alone.
  * **Weighted bucket reduction** sum_k (k+1) S_k as a blocked double
    suffix scan (``_weighted_tree_reduce``: kernels K7 and K6), and the
    **Horner fold** over windows with c doublings each (K6, K7).

Where the reference negates the gathered y and selects by the digit's sign
in every round, the port folds the sign into the gather: one table of 2n
point-major rows (x | y, then x | -y) is built once per MSM, and the
recoded order carries +n for a negative digit, so a round is one row
gather that K8 reads through strides.  The result is the reference's point,
bit for bit in Jacobian coordinates.

Scalars are canonical 16-bit limbs (int32 [Ls, n]); ``msm_mont`` takes
Montgomery-form scalar-field elements.  The reference's affine halving
tree (``config.msm_affine_tree``, kernels K9-K16) is not ported yet.
"""

from __future__ import annotations

import math

import torch

from .. import config
from ..fields.spec import FieldSpec
from . import mont

# What the last ``msm`` call chose and ran, for reporting (window size,
# window count, buckets a window, rounds of each loop, compacted lanes).
stats: dict = {}


def ln_without_floats(n: int) -> int:
    """log2(n)*69/100 ~ ln(n)."""
    return max(int(math.log2(max(n, 1)) * 69 / 100), 1)


def default_window_size(n: int) -> int:
    """Window size heuristic c, capped to 16 so a digit never spans more
    than two 16-bit limbs."""
    c = 3 if n < 32 else ln_without_floats(n) + 2
    return min(c, 16)


def signed_digits(scalars: torch.Tensor, c: int, num_windows: int,
                  last_unsigned: bool = False, w_start: int = 0,
                  w_end: int | None = None) -> torch.Tensor:
    """Signed base-2^c digits of canonical limb scalars.

    scalars: int32 [Ls, n] (16-bit limbs, limb-major, little-endian).
    Returns int32 [w_end - w_start, n] with digits in [-2^(c-1), 2^(c-1)].
    With ``last_unsigned`` the final window keeps its raw value plus carry
    (the caller guarantees it fits 2^(c-1)).  ``w_start``/``w_end`` restrict
    the output to a window range; earlier windows run carry-only.  The
    arithmetic is int64: torch has no uint32 arithmetic on the CPU."""
    if w_end is None:
        w_end = num_windows
    L, n = scalars.shape
    s = scalars.to(torch.int64)
    padded = torch.cat([s, s.new_zeros((1, n))], dim=0)
    digits = []
    carry = s.new_zeros((n,))
    half, full, mask = 1 << (c - 1), 1 << c, (1 << c) - 1
    for w in range(w_end):
        k, off = divmod(w * c, 16)
        if k >= L:
            raw = s.new_zeros((n,))
        else:
            raw = padded[k] >> off
            if off:
                raw = raw | (padded[min(k + 1, L)] << (16 - off))
            raw = raw & mask
        d = raw + carry
        if last_unsigned and w == num_windows - 1:
            if w >= w_start:
                digits.append(d)
            continue
        carry = (d + half) >> c  # 1 iff d >= 2^(c-1)
        if w >= w_start:
            digits.append(d - carry * full)
    return torch.stack(digits, dim=0).to(torch.int32)


def plan_windows(scalar_bits: int, c0: int, n: int):
    """(c, W) minimising the reference's lockstep cost model: kernel
    launches at ~1 ms and lane-adds at ~22 ns, as it was fitted to XLA:CPU.
    c is capped at 16 and the final unsigned window must fit the signed
    bucket range (leftover <= c - 1).  Refitting the model to the H100 is
    later work; the MSM's result does not depend on it."""
    best = None
    for c in range(max(4, c0 - 3), min(16, c0 + 2) + 1):
        W = -(-scalar_bits // c)
        leftover = scalar_bits - c * (W - 1)
        if leftover > c - 1:
            continue  # the unsigned top value would overflow the bucket range
        B = 1 << (c - 1)
        launches = 1.3 * n / B + n / (1 << leftover) + 2 * (c - 1)
        lane_adds = 2 * n * W + 2 * (c - 1) * W * B + (n / (1 << leftover)) * B
        score = launches * 1e-3 + lane_adds * 22e-9
        if best is None or score < best[0]:
            best = (score, c, W)
    if best is None:  # pathological scalar_bits: c = 4
        c = 4
        W = -(-scalar_bits // c)
        while scalar_bits - c * (W - 1) > c - 1:
            W += 1
        return c, W
    return best[1], best[2]


def _num_windows(scalar_bits: int, c: int) -> int:
    num_windows = -(-scalar_bits // c)
    if scalar_bits - c * (num_windows - 1) > c - 1:
        num_windows += 1  # keep the unsigned top window in range
    return num_windows


def recode_group(scalars: torch.Tensor, inf: torch.Tensor, c: int, num_windows: int,
                 g0: int, g1: int):
    """Windows [g0, g1): (order, is_neg, sorted_key, start, counts).

    order [g, n]: the points sorted by bucket, stably (int64); is_neg
    [g, n]: the digit's sign, by point; sorted_key [g, n]: the bucket of
    each sorted point (magnitude - 1; n_buckets for a zero digit or a base
    at infinity, which sorts last); start, counts [g, n_buckets]: each
    bucket's run in the sorted order (an empty bucket starts where the
    next run does)."""
    n = scalars.shape[1]
    n_buckets = 1 << (c - 1)
    digits = signed_digits(scalars, c, num_windows, last_unsigned=True,
                           w_start=g0, w_end=g1)
    mags = digits.abs()
    is_neg = digits < 0
    key = torch.where((mags == 0) | inf[None, :], n_buckets, mags - 1).to(torch.int64)
    order = torch.argsort(key, dim=1, stable=True)
    sorted_key = torch.gather(key, 1, order)
    g = key.shape[0]
    first = torch.full((g, n_buckets + 2), n, dtype=torch.int64, device=key.device)
    positions = torch.arange(n, dtype=torch.int64, device=key.device).expand(g, n)
    first.scatter_reduce_(1, sorted_key, positions, reduce="amin")
    ext = torch.flip(torch.cummin(torch.flip(first, [1]), dim=1).values, [1])
    start = ext[:, :n_buckets]
    counts = ext[:, 1 : n_buckets + 1] - start
    return order, is_neg, sorted_key, start.contiguous(), counts.contiguous()


def recode(scalars: torch.Tensor, inf: torch.Tensor, c: int, num_windows: int):
    """All windows, in groups so the transients peak at O(group * n):
    (signed order [W, n], start [W, B], counts [W, B]).  The signed order
    is the sorted point index plus n where the point's digit is negative:
    its row in ``signed_table``."""
    n = scalars.shape[1]
    group = max(1, min(num_windows, (1 << 26) // max(n, 1)))
    orders, starts, counts = [], [], []
    for g0 in range(0, num_windows, group):
        order, is_neg, _, start, count = recode_group(
            scalars, inf, c, num_windows, g0, min(g0 + group, num_windows))
        orders.append(order + n * torch.gather(is_neg, 1, order))
        starts.append(start)
        counts.append(count)
    return torch.cat(orders), torch.cat(starts), torch.cat(counts)


def signed_table(curve, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Point-major rows [2n, 2L]: row i is x_i | y_i, row n + i is
    x_i | -y_i, so one row gather fetches a point with its digit's sign."""
    xr = x.T
    return torch.cat([torch.cat([xr, y.T], dim=1),
                      torch.cat([xr, curve.base.neg(y).T], dim=1)], dim=0).contiguous()


def _rows_affine(rows: torch.Tensor, L: int, inf: torch.Tensor):
    """Gathered rows [..., 2L] as an affine batch whose coordinates are
    strided views (limb stride 1, lane stride 2L): K8 reads them in place."""
    return (rows[..., :L].movedim(-1, 0), rows[..., L:].movedim(-1, 0), inf)


def _lockstep_rounds(curve, acc, table, order_s, start, counts, r0: int, r1: int):
    """Rounds [r0, r1) over [g, B] buckets: round r adds each bucket's r-th
    point (infinity past its count) into ``acc`` in place."""
    L = curve.base.spec.n_limbs
    n = order_s.shape[1]
    for r in range(r0, r1):
        idx = torch.gather(order_s, 1, (start + r).clamp_(max=n - 1))
        curve.add_mixed(acc, _rows_affine(table[idx], L, counts <= r), out=acc)


def _drain_bucket_tail(curve, acc, table, order_s, start, counts_f, W_full: int,
                       r0: int, r1: int, K: int):
    """Finish the <= K-1 overfull (window, bucket) pairs of the full windows
    that the capped lockstep loop left, on a compacted [K]-wide batch:
    gather their accumulators, run rounds [r0, r1), scatter them back.
    Entries picked only to fill K out add infinity."""
    L = curve.base.spec.n_limbs
    n_buckets = start.shape[1]
    n = order_s.shape[1]
    surv = torch.argsort(-counts_f)[:K]  # flat w * n_buckets + b
    w_off = (surv // n_buckets) * n
    start_c = start[:W_full].reshape(-1)[surv]
    counts_c = counts_f[surv]
    order_flat = order_s[:W_full].reshape(-1)
    flat = [a.reshape(L, -1) for a in acc]
    compact = tuple(f[:, surv] for f in flat)
    for r in range(r0, r1):
        idx = order_flat[w_off + (start_c + r).clamp_(max=n - 1)]
        curve.add_mixed(compact, _rows_affine(table[idx], L, counts_c <= r), out=compact)
    for f, comp in zip(flat, compact):
        f[:, surv] = comp


def bucket_sums(curve, table, order_s, start, counts):
    """Every bucket's sum, [L, W, B] a coordinate: lockstep rounds up to
    the K-th largest count of the full windows, the compacted drain, then
    the top window alone."""
    W, n_buckets = start.shape
    acc = tuple(a.contiguous() for a in curve.zero((W, n_buckets)))
    W_full = W - 1 if W > 1 else W
    counts_f = counts[:W_full].reshape(-1)
    WB = W_full * n_buckets
    K = min(max(64, WB // 16), WB)
    compact_tail = WB > 2 * K  # tiny problems: lockstep to the max
    rounds_max = counts_f.max()
    rounds_full = torch.sort(counts_f).values[WB - K] if compact_tail else rounds_max
    rounds_max, rounds_full, rounds_top = torch.stack(
        [rounds_max, rounds_full, counts[-1].max()]).tolist()  # one sync an MSM
    _lockstep_rounds(curve, acc, table, order_s, start, counts, 0, rounds_full)
    if compact_tail:
        _drain_bucket_tail(curve, acc, table, order_s, start, counts_f, W_full,
                           rounds_full, rounds_max, K)
    top_end = max(rounds_top, rounds_full)
    if W > 1:
        top = tuple(a[:, -1:].contiguous() for a in acc)
        _lockstep_rounds(curve, top, table, order_s[-1:], start[-1:], counts[-1:],
                         rounds_full, top_end)
        for a, t in zip(acc, top):
            a[:, -1:] = t
    stats.update(rounds_lockstep=rounds_full,
                 rounds_tail=rounds_max - rounds_full if compact_tail else 0,
                 tail_lanes=K if compact_tail else 0,
                 rounds_top=top_end - rounds_full if W > 1 else 0)
    return acc


def msm(curve, bases_aff, scalars: torch.Tensor, c: int | None = None,
        scalar_bits: int | None = None):
    """Variable-base MSM: sum_i scalars[i] * bases[i].

    curve: an ``SWCurve``; bases_aff: affine batch (x, y, inf) of n points;
    scalars: int32 [Ls, n] canonical 16-bit limbs (< 2^scalar_bits;
    default min(16 Ls, bits of r)), on the curve's device.  Returns one
    Jacobian point (batch shape ())."""
    x, y, inf = bases_aff
    n = scalars.shape[1]
    if n < 64:
        # tiny inputs: per-point scalar multiplication and a sequential sum
        P = curve.scalar_mul(curve.from_affine(bases_aff), scalars)
        return scan_sum(curve, P, axis=0)
    if config.msm_affine_tree:
        raise NotImplementedError("the MSM's affine halving tree (kernels K9-K16) "
                                  "is not ported yet; set config.msm_affine_tree = False")
    if scalar_bits is None:
        scalar_bits = min(16 * scalars.shape[0], curve.scalar_modulus.bit_length())
    if c is None:
        c, num_windows = plan_windows(scalar_bits, default_window_size(n), n)
    else:
        num_windows = _num_windows(scalar_bits, c)
    stats.clear()
    stats.update(n=n, c=c, windows=num_windows, buckets=1 << (c - 1))
    order_s, start, counts = recode(scalars, inf, c, num_windows)
    buckets = bucket_sums(curve, signed_table(curve, x, y), order_s, start, counts)
    del order_s, start, counts
    window_sums = _weighted_reduce(curve, buckets)  # [W]
    return _horner_fold(curve, window_sums, c)


def _weighted_reduce(curve, P):
    """Weighted bucket reduction entry point (the blocked double scan)."""
    return _weighted_tree_reduce(curve, P)


def _horner_fold(curve, window_sums, c: int):
    """Horner fold over the windows, most significant first: c doublings
    and one addition a window, at batch ()."""
    total = curve.zero(())
    for w in range(window_sums[0].shape[1] - 1, -1, -1):
        for _ in range(c):
            total = curve.double(total)
        total = curve.add(total, curve.index_point(window_sums, w))
    return total


def _weighted_tree_reduce(curve, P):
    """sum_k (k+1) * S_k along the last batch axis of [W, B] buckets (B a
    power of two), as a blocked double suffix scan.

    With k = b*G + i (blocks of G ~ sqrt(B) buckets),
        sum_k (k+1) S_k = sum_b innerW_b + G * sum_b b * T_b,
    T_b the plain sum of block b and innerW_b its (i+1)-weighted sum.  The
    inner scan (i descending, 2 adds a step on [W, B/G] lanes) gives T and
    innerW for every block at once; the outer scan (b descending, 3 adds a
    step on [W] lanes) sums b*T_b and innerW_b; log2(G) doublings apply G.
    ~2 W B lane-adds in all.  Returns the [W] window sums."""
    L, W, B = P[0].shape
    if B == 1:
        return curve.index_point(P, (slice(None), 0))
    G = min(B, 1 << (((B - 1).bit_length() + 1) // 2))  # ~sqrt(B), a power of 2
    nb = B // G
    Pr = tuple(a.reshape(L, W, nb, G) for a in P)
    accT = accW = curve.zero((W, nb))
    for i in range(G - 1, -1, -1):
        accT = curve.add(accT, tuple(a[..., i] for a in Pr))  # suffix sum in the block
        accW = curve.add(accW, accT)  # sum of suffixes = (i+1)-weighted
    T, innerW = accT, accW
    accT = accB = accI = curve.zero((W,))
    for b in range(nb - 1, -1, -1):
        accB = curve.add(accB, accT)  # += strictly later suffix -> b * T_b
        accT = curve.add(accT, tuple(a[..., b] for a in T))
        accI = curve.add(accI, tuple(a[..., b] for a in innerW))
    for _ in range(G.bit_length() - 1):  # * G
        accB = curve.double(accB)
    return curve.add(accI, accB)


def scan_sum(curve, P, axis: int = 0):
    """Sequential sum of a point batch along one batch axis: O(n) adds."""
    ax = axis + 1 if axis >= 0 else axis
    total = curve.zero(tuple(P[0].select(ax, 0).shape[1:]))
    for i in range(P[0].shape[ax]):
        total = curve.add(total, tuple(a.select(ax, i) for a in P))
    return total


def _tree_sum(curve, P, axis: int):
    """Pairwise tree sum of a point batch along one batch axis."""
    ax = axis + 1 if axis >= 0 else axis
    n = P[0].shape[ax]
    while n > 1:
        half = n // 2
        combined = curve.add(tuple(a.narrow(ax, 0, half) for a in P),
                             tuple(a.narrow(ax, half, half) for a in P))
        if n % 2:
            combined = tuple(torch.cat([c_, a.narrow(ax, n - 1, 1)], dim=ax)
                             for c_, a in zip(combined, P))
            n = half + 1
        else:
            n = half
        P = combined
    return tuple(a.squeeze(ax) for a in P)


def msm_chunks(curve, bases_aff, scalars: torch.Tensor, chunk: int = 1 << 20,
               c: int | None = None):
    """Streaming MSM: chunks of at most ``chunk`` points are MSM'd one after
    another and their partial points added.  The window size is planned on
    the chunk's size.  Each partial is one Jacobian point, so the chunks'
    transients never live together."""
    n = scalars.shape[1]
    if c is None:
        nc = min(n, chunk)
        scalar_bits = min(16 * scalars.shape[0], curve.scalar_modulus.bit_length())
        c, _ = plan_windows(scalar_bits, default_window_size(nc), nc)
    x, y, inf = bases_aff
    total = None
    for off in range(0, n, chunk):
        end = min(off + chunk, n)
        part = msm(curve, (x[:, off:end], y[:, off:end], inf[off:end]),
                   scalars[:, off:end], c=c)
        total = part if total is None else curve.add(total, part)
    return total


def msm_mont(curve, scalar_spec: FieldSpec, bases_aff, scalars_mont, c=None):
    """MSM with Montgomery-form scalar-field elements, converted to
    canonical limbs first."""
    return msm(curve, bases_aff, mont.from_mont(scalar_spec, scalars_mont), c=c)
