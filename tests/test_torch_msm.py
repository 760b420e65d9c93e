"""The port's G1 MSM (algebra_tpu_torch ``ops/msm.py``: the lockstep bucket
path and the affine halving tree) held against the JAX package's ``msm``
and a host oracle on the same seeded inputs.

The port runs on the CPU here (the kernels' plain versions); the JAX
``msm`` takes its lockstep path, as it does on any backend but a TPU.
Digits, plans and the recoded order, run starts and counts compare
exactly; MSM results compare in affine (tolerance 0) and, for the port's
lockstep path, which runs the same sequence of group laws as the JAX one,
bit-exact in Jacobian coordinates too.  The port's tree reaches the same
point by another order of additions, so it is held against the same JAX
value in affine and against the host oracle.  One JAX ``msm`` is compiled
for one shape (n = 96, c = 5, 64-bit scalars: twelve full windows whose
192 buckets leave a compacted tail, and a top window) and run on every
data set of that shape; its compile is most of this file's time, so XLA's
optimisation is turned down for it (the values do not depend on it).  No
test compiles the JAX tree: its planner is held against the reference's
as plain Python.
"""

import contextlib
import copy
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algebra_tpu.curves.instances import bls12_381 as ref_bls
from algebra_tpu.ops import msm as ref_msm

from algebra_tpu_torch import config, convert
from algebra_tpu_torch.bigint import batch_int_to_limbs
from algebra_tpu_torch.curves.instances import bls12_381
from algebra_tpu_torch.fields.spec import field_spec
from algebra_tpu_torch.ops import mont, msm

N, C, BITS = 96, 5, 64
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def curves():
    return ref_bls.g1(), bls12_381.g1("cpu")


@functools.lru_cache(maxsize=None)
def ref_msm_fn(n: int, limbs: int, c, scalar_bits):
    """The JAX msm, compiled once for (n, limbs, c, scalar_bits)."""
    rc = ref_bls.g1()
    aff = rc.generator_affine((n,))
    sc = jnp.zeros((limbs, n), jnp.uint32)
    fn = jax.jit(lambda b, s: ref_msm.msm(rc, b, s, c=c, scalar_bits=scalar_bits))
    return fn.lower(aff, sc).compile(compiler_options=FAST_COMPILE)


def host_msm(curve, pts, ks):
    acc = None
    for p, k in zip(pts, ks):
        acc = curve.host_add(acc, curve.host_mul(p, k))
    return acc


def tiled_bases(curve, n, seed, infinity=None):
    """n bases: 16 random subgroup points repeated; base ``infinity`` (and
    its repeats) at infinity."""
    base = curve.random_host(random.Random(seed), 16)
    if infinity is not None:
        base[infinity] = None
    return [base[i % 16] for i in range(n)]


@contextlib.contextmanager
def bucket_path(tree: bool):
    """Run the port's MSM with ``config.msm_affine_tree`` = tree."""
    saved = config.msm_affine_tree
    config.msm_affine_tree = tree
    try:
        yield
    finally:
        config.msm_affine_tree = saved


def both_sides(curves, pts, ks, limbs, c=C, scalar_bits=BITS):
    """(port lockstep result, JAX result, port tree result, the tree's
    ``msm.stats``) for the same bases and scalars.  The lockstep path runs
    last, so ``msm.stats`` is its own afterwards.  Below 64 points ``msm``
    takes its scalar-multiplication path before it reads the option, so
    the port runs once there, with the tree on, and stands for both."""
    rc, pc = curves
    sc = convert.from_reference(batch_int_to_limbs(ks, limbs), "cpu")
    runs, tree_stats = {}, {}
    for tree in (True, False) if len(ks) >= 64 else (True,):
        with bucket_path(tree):
            runs[tree] = msm.msm(pc, pc.from_host(pts), sc, c=c, scalar_bits=scalar_bits)
        if tree:
            tree_stats = dict(msm.stats)
    runs.setdefault(False, runs[True])
    want = ref_msm_fn(len(ks), limbs, c, scalar_bits)(rc.from_host(pts),
                                                      jnp.asarray(convert.to_reference(sc)))
    want = tuple(convert.from_reference(np.asarray(w), "cpu") for w in want)
    return runs[False], want, runs[True], tree_stats


def assert_same_msm(pc, got, want, oracle, tree=None):
    """The lockstep result bit-exact in Jacobian coordinates and in affine;
    the tree's result, where given, equal in affine; both equal the host."""
    assert all(torch.equal(g, w) for g, w in zip(got, want))  # Jacobian, bit-exact
    wa = pc.to_affine(want)
    for res in (got,) if tree is None else (got, tree):
        ra = pc.to_affine(res)
        assert all(torch.equal(g, w) for g, w in zip(ra, wa))  # affine
        assert pc.to_host(res) == oracle


def test_msm_vs_reference(curves):
    """Random 64-bit scalars (one zero, two equal) over tiled bases (each
    base repeated six times) with one base at infinity; then all-equal
    scalars, which put every point of a window into one bucket (the
    drain's worst case).  The first data set runs the lockstep rounds, the
    compacted drain and the top window, and the tree's two window groups,
    two one-level stages and its finishing rounds and drain; in the tree,
    repeated points make tangents and opposite digits P + (-P)."""
    _, pc = curves
    pts = tiled_bases(pc, N, "msm", infinity=5)
    rng = random.Random("msm-k")
    ks = [rng.randrange(1 << BITS) for _ in range(N)]
    ks[0], ks[1] = 0, ks[2]
    got, want, tree, tstats = both_sides(curves, pts, ks, 4)
    assert msm.stats["windows"] == 13 and msm.stats["buckets"] == 16
    assert msm.stats["path"] == "lockstep"
    assert msm.stats["rounds_lockstep"] > 0 and msm.stats["tail_lanes"] == 64
    assert msm.stats["rounds_tail"] > 0 and msm.stats["rounds_top"] > 0
    assert tstats["path"] == "tree" and tstats["k"] == 1 and tstats["stages"] == [1, 1]
    assert tstats["group"] == 12 and tstats["tail_lanes"] == [64, 0]
    assert_same_msm(pc, got, want, host_msm(pc, pts, ks), tree)

    k = random.Random("hot").randrange(1 << BITS)
    got, want, tree, tstats = both_sides(curves, pts, [k] * N, 4)
    assert msm.stats["rounds_lockstep"] == 0 and msm.stats["rounds_tail"] > 0
    assert tstats["finish_rounds"][0] == 0 and tstats["finish_tail_rounds"][0] > 0
    total = None
    for p in pts:
        total = pc.host_add(total, p)
    assert_same_msm(pc, got, want, pc.host_mul(total, k), tree)


def test_small_msm_vs_reference(curves):
    """n < 64: per-point scalar multiplication and a sequential sum, on
    either bucket path."""
    _, pc = curves
    pts = tiled_bases(pc, 6, "small", infinity=4)
    rng = random.Random("small-k")
    ks = [rng.randrange(1 << 32) for _ in range(6)]
    ks[1] = 0
    got, want, tree, _ = both_sides(curves, pts, ks, 2, c=None, scalar_bits=None)
    assert_same_msm(pc, got, want, host_msm(pc, pts, ks), tree)


def test_signed_digits_vs_reference():
    rng = random.Random("digits")
    for bits, c in ((256, 7), (255, 16), (64, 5), (64, 2), (33, 13)):
        ks = [rng.randrange(1 << bits) for _ in range(20)]
        sc = batch_int_to_limbs(ks, -(-bits // 16))
        nw = bits // c + 2  # room for the last carry
        got = msm.signed_digits(convert.from_reference(sc, "cpu"), c, nw)
        assert np.array_equal(got.numpy(), np.asarray(ref_msm.signed_digits(jnp.asarray(sc), c, nw)))
        assert [sum(int(got[w, j]) << (c * w) for w in range(nw)) for j in range(20)] == ks
        nw = msm._num_windows(bits, c)
        for w0, w1 in ((0, nw), (1, nw - 1)):
            got = msm.signed_digits(convert.from_reference(sc, "cpu"), c, nw,
                                    last_unsigned=True, w_start=w0, w_end=w1)
            want = ref_msm.signed_digits(jnp.asarray(sc), c, nw, last_unsigned=True,
                                         w_start=w0, w_end=w1)
            assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))


def test_plan_windows_vs_reference():
    for n in (1, 31, 64, 100, 1000, 1 << 16, 1 << 18, 1 << 20, 1 << 24):
        assert msm.ln_without_floats(n) == ref_msm.ln_without_floats(n)
        assert msm.default_window_size(n) == ref_msm.default_window_size(n)
        for bits in (16, 64, 128, 255, 256):
            c0 = msm.default_window_size(n)
            for tree in (False, True):
                assert msm.plan_windows(bits, c0, n, tree=tree) == \
                    ref_msm.plan_windows(bits, c0, n, tree=tree)
    assert msm.plan_windows(255, 15, 1 << 20, tree=False) == (16, 16)
    with bucket_path(False):
        assert msm.plan_windows(255, 15, 1 << 20) == (16, 16)


@pytest.mark.parametrize("n", [64, 96, 1000, 1 << 16, 1 << 20, 1 << 24])
def test_tree_plan_vs_reference(n):
    """The tree's plan (levels, padded slots, window group, with and without
    a slot budget) and its extra stages equal the reference's, for every
    window size the planner may pick."""
    for c in range(2, 17):
        B = 1 << (c - 1)
        for W, budget in ((1, None), (16, None), (40, None), (16, 1 << 19)):
            assert msm._tree_plan(n, B, W, budget) == ref_msm._tree_plan(n, B, W, budget)
        k = msm._tree_plan(n, B, 1)[0]
        assert msm._extra_stages(n, B, k) == ref_msm._extra_stages(n, B, k)


def test_recode_vs_reference():
    """Order, run starts and counts of every window equal the reference's
    stable sort of its keys; starts and counts also equal a binary search
    of the sorted keys (empty buckets start where the next run does)."""
    n, c, bits = 300, 6, 64
    rng = random.Random("recode")
    ks = [rng.randrange(1 << bits) for _ in range(n)]
    ks[:3] = [0, 1, 1 << 63]
    sc = batch_int_to_limbs(ks, 4)
    inf = np.zeros(n, dtype=bool)
    inf[[7, 100, 299]] = True
    nw = msm._num_windows(bits, c)
    B = 1 << (c - 1)
    for g0, g1 in ((0, nw), (3, 5)):
        order, is_neg, skey, start, counts = msm.recode_group(
            convert.from_reference(sc, "cpu"), torch.from_numpy(inf), c, nw, g0, g1)
        digits = ref_msm.signed_digits(jnp.asarray(sc), c, nw, last_unsigned=True,
                                       w_start=g0, w_end=g1)
        mags = jnp.abs(digits).astype(jnp.uint32)
        key = jnp.where((mags == 0) | jnp.asarray(inf)[None, :], jnp.uint32(B), mags - 1)
        want_order = np.asarray(jnp.argsort(key, axis=1))
        assert np.array_equal(order.numpy(), want_order)
        assert np.array_equal(is_neg.numpy(), np.asarray(digits < 0))
        want_skey = np.take_along_axis(np.asarray(key), want_order, axis=1)
        assert np.array_equal(skey.numpy(), want_skey)
        for w in range(g1 - g0):
            lo = np.searchsorted(want_skey[w], np.arange(B), side="left")
            hi = np.searchsorted(want_skey[w], np.arange(B), side="right")
            assert start[w].tolist() == lo.tolist() and counts[w].tolist() == (hi - lo).tolist()
    order_s, start_all, counts_all = msm.recode(convert.from_reference(sc, "cpu"),
                                                torch.from_numpy(inf), c, nw)
    order, is_neg, _, start, counts = msm.recode_group(
        convert.from_reference(sc, "cpu"), torch.from_numpy(inf), c, nw, 0, nw)
    assert torch.equal(order_s, order + n * torch.gather(is_neg, 1, order))
    assert torch.equal(start_all, start) and torch.equal(counts_all, counts)


def test_msm_chunks_and_msm_mont(curves):
    """Chunks of 64 < n = 80 points (the last one takes the n < 64 path),
    and Montgomery-form Fr scalars, against the host."""
    _, pc = curves
    pts = tiled_bases(pc, 80, "chunks")
    rng = random.Random("chunks-k")
    ks = [rng.randrange(1 << BITS) for _ in range(80)]
    sc = convert.from_reference(batch_int_to_limbs(ks, 4), "cpu")
    with bucket_path(False):
        got = msm.msm_chunks(pc, pc.from_host(pts), sc, chunk=64, c=C)
    assert pc.to_host(got) == host_msm(pc, pts, ks)
    # the tree: a 64-point chunk (32-bit scalars, c = 6: six windows in
    # one group, two one-level stages) and an 8-point one
    ks32 = [k >> 32 for k in ks[:72]]
    sc32 = convert.from_reference(batch_int_to_limbs(ks32, 2), "cpu")
    with bucket_path(True):
        got = msm.msm_chunks(pc, pc.from_host(pts[:72]), sc32, chunk=64, c=6)
        assert msm.stats["path"] == "tree" and msm.stats["stages"] == [1, 1]
        assert msm.stats["group"] == 6 and msm.stats["n"] == 64
    assert pc.to_host(got) == host_msm(pc, pts[:72], ks32)

    # a 61-bit scalar field keeps the n < 64 path at 64 bits here
    spec = field_spec(2**61 - 1, name="mersenne61")
    ks = [rng.randrange(spec.modulus) for _ in range(3)]
    sc_mont = mont.to_mont(spec, convert.from_reference(batch_int_to_limbs(ks, 4), "cpu"))
    got = msm.msm_mont(pc, spec, pc.from_host(pts[:3]), sc_mont)
    assert pc.to_host(got) == host_msm(pc, pts[:3], ks)


def test_affine_tree_needs_a_prime_base(curves):
    """Over a base field that is not prime the tree would need the
    reference's composed level (``SWCurve.affine_add`` over a tower, not
    ported): ``msm`` raises and says so, and does not fall back to the
    lockstep path."""
    from algebra_tpu_torch.fields.field import Field

    _, pc = curves
    pts = tiled_bases(pc, 64, "tree")
    sc = convert.from_reference(batch_int_to_limbs([1] * 64, 4), "cpu")
    tower = copy.copy(pc)
    tower.base = Field()
    assert msm._rows_level_fn(tower) is None and msm._rows_level_fn(pc) is not None
    with bucket_path(True):
        with pytest.raises(NotImplementedError, match="composed level"):
            msm.msm(tower, pc.from_host(pts), sc, c=C)


def test_entry_g1_msm_device_rule():
    """entry.g1_msm takes the reference's formats, runs on the default
    device ("cuda") unless asked, and raises without a card."""
    from algebra_tpu_torch import entry

    pc = bls12_381.g1("cpu")
    pts = tiled_bases(pc, 3, "entry")
    aff = convert.points_to_reference(pc.from_host(pts))
    assert aff[0].dtype == np.uint32 and aff[2].dtype == np.bool_
    ks = [5, 7, 11]
    sc = batch_int_to_limbs(ks, 1)  # one limb: 16 doublings on the n < 64 path
    got = entry.g1_msm(aff, sc, device="cpu")
    assert got[0].device.type == "cpu" and pc.to_host(got) == host_msm(pc, pts, ks)
    back = convert.points_from_reference(convert.points_to_reference(got), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, got))
    if not torch.cuda.is_available():
        assert config.default_device == "cuda"
        with pytest.raises(RuntimeError):
            entry.g1_msm(aff, sc)


@pytest.mark.cuda
@pytest.mark.parametrize("tree", [False, True])
def test_msm_on_card_vs_cpu(tree):
    """On a CUDA device: the MSM through the kernels equals the CPU run, on
    either bucket path (the same additions in the same order, so bit-exact
    in Jacobian coordinates)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")
    pc, gc = bls12_381.g1("cpu"), bls12_381.g1("cuda")
    pts = tiled_bases(pc, 200, "card", infinity=3)
    rng = random.Random("card-k")
    sc = batch_int_to_limbs([rng.randrange(1 << BITS) for _ in range(200)], 4)
    with bucket_path(tree):
        want = msm.msm(pc, pc.from_host(pts), convert.from_reference(sc, "cpu"), c=C)
        got = msm.msm(gc, gc.from_host(pts), convert.from_reference(sc, "cuda"), c=C)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
