"""Pippenger multi-scalar multiplication: the lockstep bucket path.

Counterpart of the JAX package's ``ops/msm.py``, lockstep half (its
``msm`` on any backend but a TPU).  Sum_i s_i * P_i over n affine bases:

  * **Signed-digit recoding** of all windows at once by shifts over the
    16-bit scalar limbs (``signed_digits``), then per window a stable sort
    of the points by bucket and the run start and length of every bucket
    (``recode_group``), without a binary search: a scatter-min of first
    positions and a reversed running minimum.
  * **Bucket accumulation in lockstep**: round r adds the r-th point of
    every (window, bucket) at once, one launch of K8's round kernel
    (``sw_kernels.madd_rounds``) of width windows x buckets, written over
    the accumulators in place.  The rounds stop at the K-th largest bucket
    count of the full windows; the few buckets left run on a compacted
    K-wide batch (``_drain_bucket_tail``), and the top window, whose digits
    crowd into few buckets, finishes alone.
  * **Weighted bucket reduction** sum_k (k+1) S_k as a blocked double
    suffix scan and the **Horner fold** over windows with c doublings
    each, in two launches: the inner scan (``_weighted_reduce``,
    ``sw_kernels.bucket_reduce``), then the outer scan and the fold
    (``_horner_fold``, ``sw_kernels.reduce_fold``), each add and doubling
    the reference's (K7, K6) in its order.

Where the reference gathers the rows, negates y and selects by the digit's
sign in every round, the port folds the sign into the table: one table of
2n point-major rows (x | y, then x | -y) is built once per MSM, and the
recoded order carries +n for a negative digit.  Each lane's run in the
flat order (``first``, ``count``) is computed once per ``bucket_sums``, and
the round kernel reads its row itself, so a round is one launch and no
other device work.  The result is the reference's point, bit for bit in
Jacobian coordinates.

With ``config.msm_affine_tree`` the bucket phase is the reference's
**affine halving tree** instead (its TPU path), per group of windows
(``_tree_plan``): the bases are packed into rows once (K13); stage A
gathers the rows in sorted order and negates y by the digit's sign (K15);
every stage pads the runs to multiples of 2^ks, expands them into slot
units (K16) and halves them ks times with the affine chord/tangent law
(``sw_kernels.affine_add_rows``: K11, the batched inversion K2-K4, K12),
with extra one-level stages while they are cheaper than lockstep rounds
(``_extra_stages``); the few slots left finish in capped lockstep rounds
of K8 over unpacked rows (K14) and a compacted drain.  The tree needs a
prime base field: over any other it would need the reference's composed
level (unpack, the tower body of ``SWCurve.affine_add``, pack); that level
is not ported (the G2 MSM waits), and ``msm`` raises.  The result is
the same point as the lockstep path's, reached by another order of
additions, so the two compare in affine.

Scalars are canonical 16-bit limbs (int32 [Ls, n]); ``msm_mont`` takes
Montgomery-form scalar-field elements.
"""

from __future__ import annotations

import math

import torch

from .. import config
from ..bigint import int_to_limbs
from ..fields.prime import PrimeField
from ..fields.spec import FieldSpec
from . import mont, rows, sw_kernels

# What the last ``msm`` call chose and ran, for reporting (window size,
# window count, buckets a window, the bucket path; the lockstep path's
# rounds of each loop and compacted lanes; the tree's levels, stages,
# window group and, by group, its finishing rounds and drained lanes).
stats: dict = {}

# The reference's planner costs for the tree path, seconds a unit, measured
# on a TPU v5e (its ``config.msm_cost_*``); only their ratios matter.
# Refitting them to the H100 is later work; the MSM's result does not
# depend on them.
MSM_COST_RECODE = 36e-9  # a window-point: signed digits, sort, tables
MSM_COST_SLOT = 80e-9  # a padded tree slot: expansion, levels, lockstep share
MSM_COST_BUCKET = 5.0e-7  # a (window, bucket): reduction, metadata, sweeps


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


def plan_windows(scalar_bits: int, c0: int, n: int, tree: bool | None = None):
    """(c, W) minimising the reference's cost model of the bucket path:
    for the lockstep path (``tree`` False) kernel launches at ~1 ms and
    lane-adds at ~22 ns, as it was fitted to XLA:CPU; for the tree
    W (n recode + m0 slot + B bucket) with the v5e unit costs above.
    ``tree`` None follows ``config.msm_affine_tree``.  c is capped at 16 and
    the final unsigned window must fit the signed bucket range
    (leftover <= c - 1).  Refitting either model to the H100 is later work;
    the MSM's result does not depend on it."""
    if tree is None:
        tree = config.msm_affine_tree
    best = None
    for c in range(max(4, c0 - 3), min(16, c0 + 2) + 1):
        W = -(-scalar_bits // c)
        leftover = scalar_bits - c * (W - 1)
        if leftover > c - 1:
            continue  # the unsigned top value would overflow the bucket range
        B = 1 << (c - 1)
        if tree:
            _, m0, _ = _tree_plan(n, B, 1)
            score = W * (n * MSM_COST_RECODE + m0 * MSM_COST_SLOT + B * MSM_COST_BUCKET)
        else:
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


def lane_runs(order_s: torch.Tensor, start: torch.Tensor, counts: torch.Tensor):
    """The round kernel's operands from ``recode``'s: each (window, bucket)
    lane's run in the flat sorted order, (order [W n], first = w n + start,
    count), the lanes flat as w B + b."""
    W, n = order_s.shape
    first = (start + n * torch.arange(W, device=start.device)[:, None]).reshape(-1)
    return order_s.reshape(-1), first, counts.reshape(-1)


def _lockstep_rounds(curve, acc, table, order, first, count, r0: int, r1: int):
    """Rounds [r0, r1) in place: round r adds to lane i of ``acc`` (three
    contiguous [L, m]) the table row order[first[i] + r], or infinity where
    r >= count[i].  K8's round kernel for a = 0; a curve with a != 0 has no
    kernel, and runs the composed mixed addition over the same rows."""
    spec = curve.base.spec
    if curve.a_is_zero:
        sw_kernels.madd_rounds(spec, acc, table, order, first, count, r0, r1)
        return
    for r in range(r0, r1):
        curve.add_mixed(acc, sw_kernels.round_operand(spec, table, order, first, count, r),
                        out=acc)


def _drain_bucket_tail(curve, acc, table, order, first, counts_f, r0: int, r1: int,
                       K: int):
    """Finish the <= K-1 overfull (window, bucket) pairs of the full windows
    that the capped lockstep loop left, on a compacted [K]-wide batch:
    gather their accumulators, run rounds [r0, r1), scatter them back.
    ``counts_f`` covers the full windows; lanes picked only to fill K out
    add infinity."""
    surv = torch.argsort(-counts_f)[:K]  # flat w * n_buckets + b
    first_c, counts_c = first[surv], counts_f[surv]
    compact = tuple(f[:, surv] for f in acc)
    _lockstep_rounds(curve, compact, table, order, first_c, counts_c, r0, r1)
    for f, comp in zip(acc, compact):
        f[:, surv] = comp


def bucket_sums(curve, table, order_s, start, counts):
    """Every bucket's sum, [L, W, B] a coordinate: lockstep rounds up to
    the K-th largest count of the full windows, the compacted drain, then
    the top window alone.  Each (window, bucket) lane's run in the flat
    order (``lane_runs``) is built here once."""
    W, n_buckets = start.shape
    L = curve.base.spec.n_limbs
    acc = tuple(a.contiguous() for a in curve.zero((W, n_buckets)))
    flat = tuple(a.view(L, W * n_buckets) for a in acc)
    order, first, count = lane_runs(order_s, start, counts)
    W_full = W - 1 if W > 1 else W
    WB = W_full * n_buckets
    counts_f = count[:WB]
    K = min(max(64, WB // 16), WB)
    compact_tail = WB > 2 * K  # tiny problems: lockstep to the max
    rounds_max = counts_f.max()
    rounds_full = torch.sort(counts_f).values[WB - K] if compact_tail else rounds_max
    rounds_max, rounds_full, rounds_top = torch.stack(
        [rounds_max, rounds_full, counts[-1].max()]).tolist()  # one sync an MSM
    _lockstep_rounds(curve, flat, table, order, first, count, 0, rounds_full)
    if compact_tail:
        _drain_bucket_tail(curve, flat, table, order, first, counts_f, rounds_full,
                           rounds_max, K)
    top_end = max(rounds_top, rounds_full)
    if W > 1:
        top = tuple(a[:, -1].contiguous() for a in acc)
        _lockstep_rounds(curve, top, table, order, first[WB:], count[WB:],
                         rounds_full, top_end)
        for a, t in zip(acc, top):
            a[:, -1] = t
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
    default min(16 Ls, bits of r)), on the curve's device.  The bucket
    phase is the affine tree where ``config.msm_affine_tree`` is set, else
    the lockstep rounds.  Returns one Jacobian point (batch shape ())."""
    x, y, inf = bases_aff
    n = scalars.shape[1]
    if n < 64:
        # tiny inputs: per-point scalar multiplication and a sequential sum
        P = curve.scalar_mul(curve.from_affine(bases_aff), scalars)
        return scan_sum(curve, P, axis=0)
    tree = config.msm_affine_tree
    level_fn = _rows_level_fn(curve) if tree else None
    if tree and level_fn is None:
        raise NotImplementedError(
            "the MSM's affine tree over a base field that is not prime needs "
            "the composed level (unpack, SWCurve.affine_add over a tower, pack), "
            "which is not ported yet; set config.msm_affine_tree = False")
    if scalar_bits is None:
        scalar_bits = min(16 * scalars.shape[0], curve.scalar_modulus.bit_length())
    if c is None:
        c, num_windows = plan_windows(scalar_bits, default_window_size(n), n, tree=tree)
    else:
        num_windows = _num_windows(scalar_bits, c)
    stats.clear()
    stats.update(n=n, c=c, windows=num_windows, buckets=1 << (c - 1),
                 path="tree" if tree else "lockstep")
    if tree:
        buckets = tree_bucket_sums(curve, bases_aff, scalars, c, num_windows, level_fn)
    else:
        order_s, start, counts = recode(scalars, inf, c, num_windows)
        buckets = bucket_sums(curve, signed_table(curve, x, y), order_s, start, counts)
        del order_s, start, counts
    return _horner_fold(curve, _weighted_reduce(curve, buckets), c)


# --------------------------------------------------------------------------
# the affine halving tree
# --------------------------------------------------------------------------


def _pad_bucket(n: int, block: int) -> int:
    """The reference's ``mont_pallas.pad_bucket``: n rounded up to a multiple
    of ``block``, then to the nearest 2^k or 3 * 2^(k-2).  The port pads no
    kernel widths with it; ``_tree_plan`` keeps it so that its plan (k, m0,
    group) is the reference's."""
    n = max(n, block)
    k = (n - 1).bit_length()
    c2 = 3 << (k - 2) if k >= 2 else 0
    if c2 >= n and c2 % block == 0:
        return c2
    return 1 << k if (1 << k) % block == 0 else -(-n // block) * block


def _tree_plan(n: int, n_buckets: int, num_windows: int, budget_slots: int | None = None):
    """(k, m0, group), as the reference plans the tree: k halving levels in
    the first stage (while the mean occupancy exceeds 4, at most 4); m0 the
    padded level-0 slots a window; group the windows a group, from the
    reference's family of sizes, so that group * m0 stays within
    ``budget_slots`` (the reference's 6 * 2^20 by default).  On the H100 a
    slot is a row of ``rows.row_width`` words (208 B for BLS12-381 Fq) in
    each of the stage's arrays; the budget is the TPU's and is not refit
    here."""
    occ = max(1, n // n_buckets)
    k = 0
    while occ > 4 and k < 4:
        occ //= 2
        k += 1
    m0 = _pad_bucket(n + ((1 << k) - 1) * n_buckets, max(64 << k, 128))
    if budget_slots is None:
        budget_slots = 6 << 20
    allowed = [16, 12, 8, 6, 4, 3, 2, 1]
    if m0 % 3 == 0:
        allowed = [16, 8, 4, 2, 1]
    group = 1
    for g in allowed:
        if g <= num_windows and g * m0 <= budget_slots:
            group = g
            break
    return k, m0, group


# The reference's costs for the stage-versus-lockstep choice (v5e): a tree
# slot ~40 ns, a lockstep round ~110 ns a (window, bucket) lane, ~2 ms fixed
# each.  Not refit to the H100 here.
_STAGE_SLOT_NS = 40e-9
_ROUND_LANE_NS = 1.1e-7
_STAGE_FIXED_S = 2e-3
_ROUND_FIXED_S = 2e-3


def _extra_stages(n: int, n_buckets: int, k1: int) -> list[int]:
    """The one-level stages after the first k1-level stage, as the
    reference schedules them: another stage while re-halving costs less
    than the lockstep rounds it saves, scored against the ~94th-percentile
    count that the capped lockstep finish runs to.  Static; an unlucky
    digit distribution only leaves more finishing rounds."""
    occ = n / max(n_buckets, 1)
    cpct = int(occ + 1.6 * math.sqrt(occ) + 2)
    cpct = -(-cpct // (1 << k1))
    n_cur = (n + ((1 << k1) - 1) * n_buckets) // (1 << k1)
    ks = []
    while cpct > 2 and len(ks) < 4:
        m_s = n_cur + n_buckets  # U = 2 padded slot count (a window)
        stage_cost = m_s * _STAGE_SLOT_NS + _STAGE_FIXED_S
        rounds_saved = cpct - (cpct + 1) // 2
        saved = rounds_saved * (n_buckets * _ROUND_LANE_NS + _ROUND_FIXED_S)
        if saved <= stage_cost:
            break
        ks.append(1)
        cpct = (cpct + 1) // 2
        n_cur = m_s // 2
    return ks


def _batched_inv_fn(base):
    """The tree's batched inversion over its prime base field: the blocked
    one (K2-K4), zero to zero."""
    return lambda v: mont.batch_inverse(base.spec, v)


def _rows_level_fn(curve):
    """One halving level on packed rows (``sw_kernels.affine_add_rows``) for
    a prime base field; None otherwise (the reference composes unpack,
    ``SWCurve.affine_add`` over the tower, pack there: that level is not
    ported)."""
    B = curve.base
    if not isinstance(B, PrimeField):
        return None
    a_mont = None
    if not curve.a_is_zero:
        spec = B.spec
        a_mont = tuple(int(v) for v in int_to_limbs(
            (curve.a_host * spec.R) % spec.modulus, spec.n_limbs))
    return lambda V, valid, inv_fn: sw_kernels.affine_add_rows(B.spec, a_mont, V, valid,
                                                               inv_fn)


def tree_bucket_sums(curve, bases_aff, scalars: torch.Tensor, c: int, num_windows: int,
                     level_fn):
    """Every bucket's sum, [L, W, B] a coordinate, by the affine tree, one
    window group at a time (``_tree_plan``'s group): a group's slot arrays
    are freed when it ends, so the peak is one group's."""
    x, y, inf = bases_aff
    n = scalars.shape[1]
    n_buckets = 1 << (c - 1)
    k, _, group = _tree_plan(n, n_buckets, num_windows)
    stages = ([k] if k > 0 else []) + _extra_stages(n, n_buckets, k)
    stats.update(k=k, stages=stages, group=group, finish_rounds=[], finish_tail_rounds=[],
                 tail_lanes=[])
    xy_rows = rows.pack(curve.base.spec, x, y, inf)
    inv_fn = _batched_inv_fn(curve.base)
    parts = []
    for g0 in range(0, num_windows, group):
        order, is_neg, _, start, counts = recode_group(
            scalars, inf, c, num_windows, g0, min(g0 + group, num_windows))
        negs = torch.gather(is_neg, 1, order)
        parts.append(_affine_tree_buckets(curve, xy_rows, order, negs, start, counts,
                                          stages, level_fn, inv_fn))
        del order, is_neg, negs, start, counts
    return tuple(torch.cat(coord, dim=1) for coord in zip(*parts))


def _affine_tree_buckets(curve, xy_rows, order, negs, start, counts, stages, level_fn,
                         inv_fn):
    """Bucket sums [L, g, B] of one window group, by stages of aligned
    positional halving over the sorted rows, then a capped lockstep finish.

    Stage A gathers the rows in sorted order with y negated by the digit's
    sign (K15), so every later move is run-structured.  A stage of ks levels
    pads each bucket's run to a multiple of U = 2^ks slots, expands the runs
    unit by unit into the padded layout (K16; a pad slot reads a row that is
    not its own and is marked invalid), and halves it ks times (``level_fn``:
    K11, the inversion, K12; the first level reads the validity).  After a
    stage, unit j's U slots are one row, so the runs shrink by U.  The m_s
    slots a window are the port's padding: the least multiple of U that
    holds every padded run.

    Unit starts are not clipped to the source's last full unit, as the
    reference clips them: a unit that starts within U - 1 rows of the
    source's end (the group's last window has no zero digit, so its last
    run ends on the last row) would be shifted back, and its valid first
    slots would read rows of another bucket.  ``expand_units`` clips each
    row instead, so only pad slots read a repeated row."""
    spec = curve.base.spec
    g, n = order.shape
    n_buckets = counts.shape[1]
    device = order.device
    src = rows.negate_y(spec, xy_rows[order.reshape(-1)], negs.reshape(-1))  # [g n, RW]
    n_cur = n
    counts_c, start_c = counts, start
    bucket_ids = torch.arange(n_buckets, device=device).expand(g, n_buckets)
    for ks in stages:
        U = 1 << ks
        counts_p = ((counts_c + U - 1) >> ks) << ks
        start_p = torch.cumsum(counts_p, dim=1) - counts_p
        m_s = -(-(n_cur + (U - 1) * n_buckets) // U) * U
        mu = m_s // U
        # the run of every unit: the largest bucket starting at or before it
        # (a run that is empty occupies no unit, so where it shares a start
        # with the next run the larger id, the occupant, wins); a trailing
        # empty run may start at unit mu, which the extra column drops
        seed = torch.zeros((g, mu + 1), dtype=torch.int64, device=device)
        seed.scatter_reduce_(1, start_p >> ks, bucket_ids, reduce="amax")
        run_u = torch.cummax(seed[:, :mu], dim=1).values
        su = torch.gather(start_p, 1, run_u)
        sc = torch.gather(start_c, 1, run_u)
        cc = torch.gather(counts_c, 1, run_u)
        ju = torch.arange(mu, device=device)
        us = sc + (ju * U - su) + (torch.arange(g, device=device) * n_cur)[:, None]
        V = rows.expand_units(src, us.reshape(-1), U)
        del src
        slot = torch.arange(m_s, device=device).reshape(1, mu, U)
        valid = (slot < (su + cc)[:, :, None]).reshape(-1)  # [g m_s]
        del run_u, su, sc, cc, us
        for lvl in range(ks):
            V = level_fn(V, valid if lvl == 0 else None, inv_fn)
        del valid
        src = V
        n_cur = mu
        counts_c, start_c = counts_p >> ks, start_p >> ks
    return _finish_slots(curve, src, start_c, counts_c, n_cur)


def _finish_slots(curve, V, start, counts, mk: int):
    """Sum what the stages left: bucket b of window w holds counts[w, b]
    rows from V[w mk + start[w, b]].  Lockstep mixed-add rounds (K14, K8)
    up to the K-th largest count, then the compacted drain of the rest."""
    spec = curve.base.spec
    L = spec.n_limbs
    g, n_buckets = counts.shape
    goff = (torch.arange(g, device=counts.device) * mk)[:, None]
    acc = tuple(a.contiguous() for a in curve.zero((g, n_buckets)))
    counts_f = counts.reshape(-1)
    WB = g * n_buckets
    K = min(max(64, WB // 16), WB)
    compact_tail = WB > 2 * K
    rounds_max = counts_f.max()
    rounds_full = torch.sort(counts_f).values[WB - K] if compact_tail else rounds_max
    rounds_max, rounds_full = torch.stack([rounds_max, rounds_full]).tolist()
    for r in range(rounds_full):
        slots = (goff + (start + r).clamp_(max=mk - 1)).reshape(-1)
        gx, gy, ginf = rows.unpack(spec, V[slots])
        curve.add_mixed(acc, (gx.reshape(L, g, n_buckets), gy.reshape(L, g, n_buckets),
                              (ginf.reshape(g, n_buckets) | (counts <= r))), out=acc)
    if compact_tail:
        _drain_slot_tail(curve, acc, V, start, counts_f, mk, rounds_full, rounds_max, K)
    stats["finish_rounds"].append(rounds_full)
    stats["finish_tail_rounds"].append(rounds_max - rounds_full if compact_tail else 0)
    stats["tail_lanes"].append(K if compact_tail else 0)
    return acc


def _drain_slot_tail(curve, acc, V, start, counts_f, mk: int, r0: int, r1: int, K: int):
    """Finish the <= K-1 overfull (window, bucket) pairs that the capped
    rounds left, on a compacted [K]-wide batch: gather their accumulators,
    run rounds [r0, r1) over their rows, scatter them back.  Entries picked
    only to fill K out add infinity."""
    spec = curve.base.spec
    L = spec.n_limbs
    n_buckets = start.shape[1]
    surv = torch.argsort(-counts_f)[:K]  # flat w * n_buckets + b
    base_off = (surv // n_buckets) * mk
    start_c = start.reshape(-1)[surv]
    counts_c = counts_f[surv]
    flat = [a.reshape(L, -1) for a in acc]
    compact = tuple(f[:, surv] for f in flat)
    for r in range(r0, r1):
        gx, gy, ginf = rows.unpack(spec, V[base_off + (start_c + r).clamp_(max=mk - 1)])
        curve.add_mixed(compact, (gx, gy, ginf | (counts_c <= r)), out=compact)
    for f, comp in zip(flat, compact):
        f[:, surv] = comp


def _weighted_reduce(curve, P):
    """The weighted bucket reduction's first half, its inner scan, over
    [W, B] buckets (B a power of two): returns (T, innerW, G), what
    ``_horner_fold`` takes.

    sum_k (k+1) S_k is a blocked double suffix scan.  With k = b*G + i
    (blocks of G ~ sqrt(B) buckets),
        sum_k (k+1) S_k = sum_b innerW_b + G * sum_b b * T_b,
    T_b the plain sum of block b and innerW_b its (i+1)-weighted sum.  The
    inner scan (i descending, 2 adds a step on [W, B/G] lanes) gives T and
    innerW for every block at once; the outer scan (b descending, 3 adds a
    step on [W] lanes) sums b*T_b and innerW_b, and log2(G) doublings apply
    G (``_horner_fold``).  ~2 W B lane-adds in all, in the reference's
    order step for step.  Where ``curve.add`` runs kernels, the inner scan
    is one launch (``sw_kernels.bucket_reduce``); any other curve runs the
    loop over its own law.  With one bucket a window there is nothing to
    reduce: T is the window sums and innerW None."""
    L, W, B = P[0].shape
    if B == 1:
        return curve.index_point(P, (slice(None), 0)), None, 1
    G = sw_kernels.reduce_block(B)
    if curve._kernels:
        return (*sw_kernels.bucket_reduce(curve.base.spec, P), G)
    return (*sw_kernels.inner_scan(curve, P, G), G)


def _horner_fold(curve, partial, c: int):
    """The reduction's outer scan, then the Horner fold over the windows,
    most significant first: c doublings and one addition a window, at
    batch ().  ``partial``: ``_weighted_reduce``'s (T, innerW, G).  Where
    ``curve.add`` runs kernels, one launch (``sw_kernels.reduce_fold``)."""
    T, innerW, G = partial
    if curve._kernels:
        return sw_kernels.reduce_fold(curve.base.spec, T, innerW, G, c)
    return sw_kernels.outer_fold(curve, T, innerW, G, c)


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
