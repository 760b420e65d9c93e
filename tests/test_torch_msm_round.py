"""K8's round kernel (``sw_kernels.madd_round``): one lockstep round of the
MSM's bucket phase, each lane reading its own row of the signed table.

On the CPU the wrapper takes its plain version (gather, clamp, row index,
``madd_plain``); these tests hold it against the composition the rounds of
``ops/msm.py`` ran before the kernel existed, with the order, starts and
counts in their [windows, buckets] form, on BLS12-381 Fq and secp256k1 Fq
(a modulus with no spare top bit), with planted lanes: a round past the
bucket's count, an accumulator (X, Y, 0) with X, Y != one, the row equal
to the accumulator's point and to its negative, the drain's compacted runs
and the top window.  Then small MSMs through the new rounds against the
host group law, also on a curve with a != 0 (the composed law, no kernel).
No JAX function is compiled: the lockstep MSM is held against the JAX
``msm`` in ``test_torch_msm.py``.  The ``cuda``-marked test holds the
kernel against its plain version on a card.
"""

import random

import pytest
import torch

from algebra_tpu_torch import config, convert
from algebra_tpu_torch.bigint import batch_int_to_limbs
from algebra_tpu_torch.curves.instances import bls12_381, secp256k1
from algebra_tpu_torch.curves.sw import SWCurve
from algebra_tpu_torch.ops import msm, sw_kernels as swk

W_WIN, N_PTS, BUCKETS = 3, 40, 8  # windows, points a window, buckets a window


def limbs(spec, vals, device="cpu"):
    return convert.from_reference(batch_int_to_limbs(vals, spec.n_limbs), device)


def round_data(spec, seed: str, device="cpu"):
    """A round's operands in the [windows, buckets] form the rounds were
    built from: (acc [L, W, B] x3, table [2n, 2L], order_s [W, n], start,
    counts [W, B], r, planted lanes), random coordinates (the laws are
    polynomial identities).  A window's runs tile the front of its order;
    the entries after them stand for zero digits, as in ``msm.recode``.
    Planted lanes (flat w B + b) at round r = 2: a run too short (Z1 != 0,
    and Z1 = 0 with X, Y != one), Z1 = 0 with a point to add, the row
    equal to the accumulator's affine point, and to its negative."""
    rng = random.Random(seed)
    p, one = spec.modulus, spec.R % spec.modulus
    n, L, r = N_PTS, spec.n_limbs, 2
    lanes = dict(past=0, zero_past=9, zero_adds=10, eq=17, neg=20)
    short = {lanes["past"], lanes["zero_past"]}
    xs, ys = [rng.randrange(p) for _ in range(n)], [rng.randrange(p) for _ in range(n)]
    table = torch.cat([torch.cat([limbs(spec, xs).T, limbs(spec, ys).T], dim=1),
                       torch.cat([limbs(spec, xs).T, limbs(spec, [(-y) % p for y in ys]).T],
                                 dim=1)]).contiguous()
    order_s = [[rng.randrange(2 * n) for _ in range(n)] for _ in range(W_WIN)]
    counts = [[rng.randrange(6) for _ in range(BUCKETS)] for _ in range(W_WIN)]
    for lane in lanes.values():
        w, b = divmod(lane, BUCKETS)
        counts[w][b] = rng.randrange(r + 1) if lane in short else rng.randrange(r + 1, 6)
    start = [[sum(c[:b]) for b in range(BUCKETS)] for c in counts]
    m = W_WIN * BUCKETS
    X, Y, Z = ([rng.randrange(p) for _ in range(m)] for _ in range(3))
    Z[lanes["zero_past"]] = Z[lanes["zero_adds"]] = 0  # (X, Y, 0), X, Y != one
    for lane in (lanes["eq"], lanes["neg"]):
        w, b = divmod(lane, BUCKETS)
        row = order_s[w][start[w][b] + r]
        j = row % n
        yj = ys[j] if row < n else (-ys[j]) % p
        X[lane], Z[lane] = xs[j], one
        Y[lane] = yj if lane == lanes["eq"] else (-yj) % p
    acc = tuple(limbs(spec, v, device).reshape(L, W_WIN, BUCKETS) for v in (X, Y, Z))
    as_t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)  # noqa: E731
    return acc, table.to(device), as_t(order_s), as_t(start), as_t(counts), r, lanes


def composed_round(spec, acc, table, order_s, start, counts, r):
    """A round as ``ops/msm.py`` composed it before the round kernel: the
    gather of the order, the clamp, the row index, ``madd_plain`` with
    counts <= r, over [W, B] lanes."""
    L, n = spec.n_limbs, order_s.shape[1]
    idx = torch.gather(order_s, 1, (start + r).clamp_(max=n - 1))
    rows = table[idx]
    return swk.madd_plain(spec, *acc, rows[..., :L].movedim(-1, 0),
                          rows[..., L:].movedim(-1, 0), counts <= r)


SPECS = [pytest.param(bls12_381.fq_spec, id="bls12_381_fq"),
         pytest.param(secp256k1.fq_spec, id="secp256k1_fq")]


@pytest.mark.parametrize("spec", SPECS)
def test_round_matches_composition_with_planted_lanes(spec):
    acc, table, order_s, start, counts, r, lanes = round_data(spec, f"round-{spec.name}")
    L = spec.n_limbs
    want = composed_round(spec, acc, table, order_s, start, counts, r)
    got = tuple(a.reshape(L, -1).clone() for a in acc)
    out = swk.madd_round(spec, got, table, *msm.lane_runs(order_s, start, counts), r)
    assert out is got  # in place
    assert all(torch.equal(g, w.reshape(L, -1)) for g, w in zip(got, want))
    # the planted lanes, against what each case must give
    one = limbs(spec, [spec.R % spec.modulus])[:, 0]
    col = lambda t, i: t[:, i]  # noqa: E731
    P = tuple(a.reshape(L, -1) for a in acc)
    i = lanes["past"]
    assert all(torch.equal(col(g, i), col(a, i)) for g, a in zip(got, P))
    i = lanes["zero_past"]
    assert torch.equal(col(got[0], i), one) and torch.equal(col(got[1], i), one)
    assert not col(got[2], i).any()
    i = lanes["zero_adds"]  # from_affine(row): (x2, y2, one)
    assert torch.equal(col(got[2], i), one)
    i = lanes["eq"]  # P = Q: the doubling
    dbl = swk.double_plain(spec, *(col(a, i)[:, None] for a in P))
    assert all(torch.equal(col(g, i), d[:, 0]) for g, d in zip(got, dbl))
    i = lanes["neg"]  # P = -Q: Z3 = 0
    assert not col(got[2], i).any()


@pytest.mark.parametrize("spec", SPECS)
def test_round_drain_and_top_window(spec):
    """The drain's compacted lanes (runs from several windows, in the
    order of their counts) and the top window's lanes, over the rounds
    past the plain rounds, against the composition on the same lanes."""
    acc, table, order_s, start, counts, r, _ = round_data(spec, f"drain-{spec.name}")
    L, n = spec.n_limbs, order_s.shape[1]
    W_full = W_WIN - 1
    counts_f = counts[:W_full].reshape(-1)
    surv = torch.argsort(-counts_f)[:5]
    order, first, _ = msm.lane_runs(order_s, start, counts)
    flat = tuple(a.reshape(L, -1) for a in acc)
    compact = tuple(f[:, surv] for f in flat)
    want = tuple(c.clone() for c in compact)
    w_off = (surv // BUCKETS) * n
    order_flat = order_s[:W_full].reshape(-1)
    for rr in range(r, r + 4):
        idx = order_flat[w_off + (start[:W_full].reshape(-1)[surv] + rr).clamp_(max=n - 1)]
        rows = table[idx]
        want = swk.madd_plain(spec, *want, rows[:, :L].T, rows[:, L:].T,
                              counts_f[surv] <= rr)
        swk.madd_round(spec, compact, table, order, first[surv], counts_f[surv], rr)
    assert all(torch.equal(g, w) for g, w in zip(compact, want))
    top = tuple(a[:, -1].contiguous() for a in acc)
    want = tuple(a[:, -1:] for a in acc)
    for rr in range(r, r + 3):
        want = composed_round(spec, want, table, order_s[-1:], start[-1:], counts[-1:], rr)
        swk.madd_round(spec, top, table, order, first[-BUCKETS:], counts[-1], rr)
    assert all(torch.equal(g, w[:, 0]) for g, w in zip(top, want))


def test_round_rejects_bad_operands():
    spec = bls12_381.fq_spec
    acc, table, order_s, start, counts, r, _ = round_data(spec, "bad")
    L = spec.n_limbs
    flat = tuple(a.reshape(L, -1).clone() for a in acc)
    order, first, count = msm.lane_runs(order_s, start, counts)
    args = (table, order, first, count, r)
    with pytest.raises(ValueError):
        swk.madd_round(spec, tuple(a[:, ::2] for a in flat), *args)
    with pytest.raises(ValueError):
        swk.madd_round(spec, flat, table, order, first, count.to(torch.int32), r)
    with pytest.raises(ValueError):
        swk.madd_round(spec, flat, table[:, :L], *args[1:])


def host_msm(curve, pts, ks):
    acc = None
    for pt, k in zip(pts, ks):
        acc = curve.host_add(acc, curve.host_mul_raw(pt, k))
    return acc


def toy_curve():
    """y^2 = x^3 + 3x + 7 over BLS12-381 Fq: a != 0, so the rounds run the
    composed mixed addition (no kernel)."""
    p, a, b = bls12_381.fq_spec.modulus, 3, 7
    x = 2
    while True:
        rhs = (x ** 3 + a * x + b) % p
        y = pow(rhs, (p + 1) // 4, p)
        if y * y % p == rhs:
            break
        x += 1
    return SWCurve(bls12_381.Fq.to("cpu"), a, b, (x, y), cofactor=1,
                   scalar_modulus=bls12_381.R, name="toy")


@pytest.mark.parametrize("which", ["bls12_381", "a_nonzero"])
def test_small_msm_through_rounds_vs_host(which):
    """An MSM of 64 points (c = 5, 48-bit scalars: nine full windows whose
    144 buckets leave a compacted tail, and the top window) on the lockstep
    path, against the host group law; repeated bases and one at infinity
    make runs of several points, P = Q and P = -Q in the buckets."""
    curve = bls12_381.g1("cpu") if which == "bls12_381" else toy_curve()
    rng = random.Random(f"msm-{which}")
    g = curve.generator_host
    base = [curve.host_mul_raw(g, rng.randrange(1, 1 << 64)) for _ in range(6)]
    base[3] = None
    base[4] = (base[1][0], curve.base.spec.modulus - base[1][1])  # -base[1]
    n = 64
    pts = [base[i % 6] for i in range(n)]
    ks = [rng.randrange(1 << 48) for _ in range(n)]
    sc = convert.from_reference(batch_int_to_limbs(ks, 3), "cpu")
    saved = config.msm_affine_tree
    config.msm_affine_tree = False
    try:
        got = msm.msm(curve, curve.from_host(pts), sc, c=5, scalar_bits=48)
    finally:
        config.msm_affine_tree = saved
    assert msm.stats["path"] == "lockstep" and msm.stats["tail_lanes"] > 0
    assert msm.stats["rounds_top"] > 0
    assert curve.to_host(got) == host_msm(curve, pts, ks)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
def test_round_kernel_vs_plain_on_card(spec):
    """On a CUDA device: the round kernel against its plain version on the
    planted lanes, the drain's compacted lanes and the top window (the
    chip smoke script does the same at W = 8, 12 and 24 with whole warps
    of each case)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")
    acc, table, order_s, start, counts, r, _ = round_data(spec, "card", device="cuda")
    L = spec.n_limbs
    order, first, count = msm.lane_runs(order_s, start, counts)
    want = tuple(a.reshape(L, -1).clone() for a in acc)
    got = tuple(a.reshape(L, -1).clone() for a in acc)
    for rr in range(5):
        swk.madd_round_plain(spec, want, table, order, first, count, rr)
        swk.madd_round(spec, got, table, order, first, count, rr)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
