#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and ``nvcc``; without a device it exits non-zero and
prints no result.  It (1) builds the CUDA kernels from ``algebra_tpu_torch/
csrc``, (2) holds each kernel against its plain PyTorch version on the
card and against a host big-integer oracle, (3) runs the flagship step —
``entry.poly_product`` over BLS12-381 Fr through a 2^24-point domain — and
checks the result exactly, (4) repeats it at 2^16 and 2^10 (staged path,
coset, short inputs), (5) runs the division path — ``entry.poly_quotient``
at 2^24 must give back the factor a product was made from, through the
blocked batched inversion — and checks the inversion on its own, (6) runs
the short paths over the same kernels (Lagrange coefficients, long
division, square roots), (7) holds the group-law kernels (Jacobian double,
add, mixed add, and the mixed add as one lockstep round of the MSM; the
MSM's weighted reduction and Horner fold in two kernels) against their
plain versions on planted exceptional lanes, on edge operands of the
Montgomery product and on real G1 points, (8) runs the G1 MSM —
``entry.g1_msm`` at 2^16, 2^18 and 2^20 and ``msm.msm_chunks`` at 2^24 —
against host oracles, step by step and under ``torch.profiler`` at 2^20,
with the round kernel at the operands of the MSM's rounds and the
reduction and fold kernels at its buckets, and once on the card and on the
CPU, in Jacobian words, (9) the group law's other
paths (scalar multiplication, cofactor clearing, subgroup checks, the small
MSM), (10) holds the affine tree's kernels (row pack, unpack, y negation,
unit expansion; the halving level's denominator and completion) against
their plain versions, (11) runs the G1 MSM through the affine tree at
the sizes of (8) against the host oracle, both bucket paths in turns at
2^20, and the tree's kernels at the shapes of the 2^20 MSM, (12) holds the
affine addition's kernels on coordinate arrays (denominator, completion)
against their plain versions and real secp256k1 and G1 pairs against the
host, (13) runs BASELINE configs[2]: ``entry.batch_affine_add`` on 2^20
secp256k1 and 2^20 G1 pairs, ``entry.scalar_mul`` by GLV on 2^18
secp256k1 points against plain double-and-add, wNAF, ``entry.fixed_base_msm``
on 2^20 scalars and ``entry.scalar_mul`` on 2^16 Jubjub points, each
against the host, (14) times the bottom of the batched inversion (K3,
safegcd) against the Fermat ladder it replaced, at the bottoms those
paths give it, and (15) runs BASELINE configs[3], the BLS12-381 pairing:
its kernel K17 (weighted sums of Montgomery products, every tower
product) against its plain version at three word counts, then
``entry.pairing``, ``multi_pairing`` and ``prepare_g2`` at 4096 and 256
pairs, e(g1, g2) against a pinned value, bilinearity on every lane, lanes
at infinity, two lanes against the CPU, and (16) runs BN254 (``curve=
"bn254"``): the kernels of its path against their plain versions at its
8-word field, e(g1, g2) pinned, the pairing entry points at 4096 and 256
pairs with eight lanes against the CPU, and ``entry.g1_msm`` on 2^20
scalars against the host oracle, with the kernels' rows at its shapes.
Phases 7-8 run the lockstep bucket path and 11 the tree,
whatever ``config.msm_affine_tree`` says.  Every comparison is bit-exact (tolerance
0: outputs are canonical integers).  One JSON object per line; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import operator
import random
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM at its full 700 W power limit: device
# memory rate, and 32-bit integer multiply-adds at half the float32 rate
# outside the tensor cores (67 TFLOP/s = 33.5e12 fused multiply-adds/s,
# so 16.75e12 integer multiply-adds/s).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_MAD_PER_S = 16.75e12

LOG_MAIN = 24  # main path: 2^24-point domain, two 2^23-coefficient inputs
SEED = 20240523
# G1 MSM: entry.g1_msm at these sizes, msm_chunks with 2^MSM_CHUNK-point
# chunks at 2^MSM_CHUNKED, distinct bases at 2^MSM_DISTINCT
MSM_LOGS = (16, 18, 20)
MSM_CHUNK = 20
MSM_CHUNKED = 24
MSM_DISTINCT = 16
MSM_SHARED = 9  # the lockstep MSM on the card and on the CPU, Jacobian words compared


_T0 = time.time()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the script's seconds so far
    (``t_s``), so each phase's time is the difference from the line before."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.time() - _T0}
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean milliseconds of the device work of ``fn`` over ``reps`` calls:
    the calls are queued behind a spin kernel of ~50 ms, so the events time
    the launches back to back on the device and not the host's Python
    between them (which ``time_ms`` includes when a launch is shorter)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn):
    """(result, milliseconds on the host clock) of one synchronised call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def median_ms(fn, reps: int = 3):
    """(median milliseconds, all times) of ``reps`` synchronised calls of
    ``fn`` on the host clock (warm it first)."""
    times = [wall_ms(fn)[1] for _ in range(reps)]
    return float(np.median(times)), times


def profile_call(fn, families, top: int = 16) -> dict:
    """One synchronised call of ``fn`` under torch.profiler, after one warm
    call the profiler traces and drops (without it the first kernels of a
    short call go unrecorded): its wall time, the device time of its
    kernels (device events only: a CPU op's row repeats its kernels' time),
    the share of the wall time the device was busy, the ``top`` kernels by
    device time, the launches of every kernel, and the device time of each
    kernel family by whole name (``pack_kernel`` is in ``unpack_kernel``)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    steps = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=steps) as prof:
        wall_ms(fn)
        prof.step()
        _, wall = wall_ms(fn)
        prof.step()
    by_kernel, launches = {}, {}
    for e in prof.key_averages():  # the step's own row repeats its kernels' time
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0 \
                and not e.key.startswith("ProfilerStep"):
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + e.self_device_time_total / 1e3
            launches[e.key[:90]] = launches.get(e.key[:90], 0) + e.count
    busy_ms = sum(by_kernel.values())
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {
        "wall_ms": wall,
        "device_ms": busy_ms if by_kernel else "not measured",
        "device_busy_share": busy_ms / wall if by_kernel else "not measured",
        "device_ms_by_kernel": {k[:90]: v for k, v in ranked},
        "launches_by_kernel": launches,
        "kernel_device_ms": {
            name: sum(v for k, v in by_kernel.items() if re.search(rf"\b{name}_kernel<", k))
            for name in families},
    }


def random_limbs(spec, n: int, rng: np.random.Generator) -> np.ndarray:
    """[L, n] uint32 limbs of n values below the modulus: every limb
    uniform in [0, 2^16) but the top one, uniform below the modulus's top
    limb.  Any such pattern is a valid Montgomery-form element."""
    L = spec.n_limbs
    out = rng.integers(0, 1 << 16, size=(L, n), dtype=np.uint32)
    top = spec.modulus >> (16 * (L - 1))
    out[L - 1] = rng.integers(0, top, size=n, dtype=np.uint32)
    return out


def mismatches(got: torch.Tensor, want: torch.Tensor) -> tuple[int, int]:
    """(number of differing words, largest absolute difference)."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    return int((diff != 0).sum().item()), int(diff.max().item()) if diff.numel() else 0


def tuple_mismatches(got, want) -> tuple[int, int]:
    """``mismatches`` over a tensor or a tuple of them (flags as 0/1)."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    as_int = lambda t: t.to(torch.int32) if t.dtype == torch.bool else t  # noqa: E731
    bad = [mismatches(as_int(g), as_int(w)) for g, w in zip(got, want)]
    return sum(b for b, _ in bad), max(e for _, e in bad)


def limbs_to_ints(arr: np.ndarray) -> list:
    """[L, n] limb array -> list of n Python ints."""
    L, n = arr.shape
    buf = np.ascontiguousarray(arr.T.astype("<u2")).tobytes()
    nb = 2 * L
    return [int.from_bytes(buf[i * nb : (i + 1) * nb], "little") for i in range(n)]


def host_eval(vals: list, z: int, p: int, block: int = 1024) -> int:
    """sum vals[i] * z^i mod p with Python ints: Horner over blocks, each
    block an inner product with the first ``block`` powers of z."""
    zp = [1]
    for _ in range(block - 1):
        zp.append(zp[-1] * z % p)
    z_block = zp[-1] * z % p
    acc = 0
    for start in range((len(vals) - 1) // block * block, -1, -block):
        chunk = vals[start : start + block]
        acc = (acc * z_block + sum(map(operator.mul, chunk, zp))) % p
    return acc


def host_eval_mont(spec, t: torch.Tensor, z: int) -> int:
    """Canonical value at z of the polynomial whose Montgomery-form
    coefficients are t [L, n]: one R^-1 fix-up for the whole polynomial."""
    vals = limbs_to_ints(t.cpu().numpy())
    r_inv = pow(spec.R, -1, spec.modulus)
    return host_eval(vals, z, spec.modulus) * r_inv % spec.modulus


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions and a host oracle
# ---------------------------------------------------------------------------


def product_edges(spec) -> list:
    """Operands at the edges of a Montgomery product: 0, 1, p - 1, p - 2
    and R mod p (one in Montgomery form)."""
    p = spec.modulus
    return [0, 1, p - 1, p - 2, spec.R % p]


def check_mul_kernel(spec, rng, device):
    """K1 for one field: random and edge operands, a length that is not a
    multiple of the block, the one-element (stride-0) operand, a host
    big-integer oracle on 64 lanes."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.bigint import batch_int_to_limbs
    from algebra_tpu_torch.ops import mont_kernels as mk

    p, L = spec.modulus, spec.n_limbs
    edge = product_edges(spec)
    ea = [x for x in edge for _ in edge]
    eb = [y for _ in edge for y in edge]
    n_rand = (1 << 16) + 37 - len(ea)
    a_np = np.concatenate(
        [batch_int_to_limbs(ea, L), random_limbs(spec, n_rand, rng)], axis=1)
    b_np = np.concatenate(
        [batch_int_to_limbs(eb, L), random_limbs(spec, n_rand, rng)], axis=1)
    a = convert.from_reference(a_np, device)
    b = convert.from_reference(b_np, device)

    got = mk.mul(spec, a, b)
    torch.cuda.synchronize()
    bad, err = mismatches(got, mk.mul_plain(spec, a, b))

    one_elem = b[:, 5:6].contiguous()
    got_s = mk.mul(spec, a, one_elem)
    bad_s, err_s = mismatches(got_s, mk.mul_plain(spec, a, one_elem))

    lanes = 64
    r_inv = pow(spec.R, -1, p)
    av = limbs_to_ints(a_np[:, :lanes])
    bv = limbs_to_ints(b_np[:, :lanes])
    want = [x * y * r_inv % p for x, y in zip(av, bv)]
    oracle_bad = sum(
        g != w for g, w in zip(limbs_to_ints(got[:, :lanes].cpu().numpy()), want))

    n_time = 1 << 20
    at = convert.from_reference(random_limbs(spec, n_time, rng), device)
    bt = convert.from_reference(random_limbs(spec, n_time, rng), device)
    ms = time_ms(lambda: mk.mul(spec, at, bt), 20)
    return {
        "kernel": "mont_mul", "field": spec.name, "words": spec.n_words,
        "n": int(a.shape[1]), "mismatches": bad + bad_s,
        "max_abs_err": max(err, err_s), "oracle_lanes": lanes,
        "oracle_mismatches": oracle_bad, "timed_n": n_time, "kernel_ms": ms,
    }


def check_butterfly_kernel(spec, rng, device):
    """K5: flat halves with twiddle period half in {1, 32, 128, 256} at
    n_half = 256 and a longer case; in-array stages with B > 1 and B = 1,
    twiddles taken as strided views of a root table."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.ops import mont_kernels as mk

    def rand(*shape):
        n = int(np.prod(shape))
        return convert.from_reference(
            random_limbs(spec, n, rng).reshape((spec.n_limbs,) + shape), device)

    cases = []
    for n_half, half in [(256, 1), (256, 32), (256, 128), (256, 256),
                         (1 << 16, 1 << 10)]:
        lo, hi, w = rand(n_half), rand(n_half), rand(half)
        g_lo, g_hi = mk.butterfly_stage(spec, lo, hi, w)
        w_lo, w_hi = mk.butterfly_stage_plain(spec, lo, hi, w)
        bad = mismatches(g_lo, w_lo)[0] + mismatches(g_hi, w_hi)[0]
        cases.append({"form": "flat", "n_half": n_half, "half": half,
                      "mismatches": bad})
    for n1, B in [(64, 8), (256, 1), (32, 128)]:
        x, roots = rand(n1, B), rand(n1 // 2)
        s = 1
        while (1 << s) <= n1:
            m = 1 << s
            w = roots[:, :: n1 // m] if m < n1 else roots
            got = mk.butterfly_stage_major(spec, x, w)
            bad = mismatches(got, mk.butterfly_stage_major_plain(spec, x, w))[0]
            cases.append({"form": "major", "n1": n1, "B": B, "half": m // 2,
                          "mismatches": bad})
            s += 1
    torch.cuda.synchronize()
    return cases


def check_main_shapes(spec, rng, device, log_n):
    """Both kernels at the shapes the main path gives them, against their
    plain versions, with times and bounds."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.ops import mont_kernels as mk

    L = spec.n_limbs
    n = 1 << log_n
    n1 = 1 << (log_n // 2)
    n2 = n // n1
    a = convert.from_reference(random_limbs(spec, n, rng), device)
    b = convert.from_reference(random_limbs(spec, n, rng), device)

    # K1: full x full [L, n]
    got = mk.mul(spec, a, b)
    want, plain_ms = wall_ms(lambda: mk.mul_plain(spec, a, b))
    bad1, err1 = mismatches(got, want)
    del got, want
    _, plain_ms = wall_ms(lambda: mk.mul_plain(spec, a, b))
    ms1 = time_ms(lambda: mk.mul(spec, a, b), 10)
    bytes1 = 3 * L * 4 * n
    mads1 = mads_per_product(spec) * n
    k1 = {
        "mismatches": bad1, "max_abs_err": err1, "ms": ms1, "plain_ms": plain_ms,
        "shape": [L, n],
    }

    # K5: stages of x [L, n2, n1] (the longer of the two column transforms)
    x = a.reshape(L, n2, n1)
    roots = b[:, : n2 // 2].contiguous()
    bad5 = err5 = 0
    plain5 = None
    for half in (1, 64, n2 // 2):
        w = roots[:, :: (n2 // 2) // half]
        got = mk.butterfly_stage_major(spec, x, w)
        want, t = wall_ms(lambda: mk.butterfly_stage_major_plain(spec, x, w))
        bd, er = mismatches(got, want)
        bad5, err5 = bad5 + bd, max(err5, er)
        plain5 = t if half == 64 else plain5
        del got, want
    halves = [1 << s for s in range(n2.bit_length() - 1)]

    def all_stages():
        for half in halves:
            mk.butterfly_stage_major(spec, x, roots[:, :: (n2 // 2) // half])

    ms5 = time_ms(all_stages, 3) / len(halves)
    per_stage = {
        str(half): time_ms(
            lambda: mk.butterfly_stage_major(spec, x, roots[:, :: (n2 // 2) // half]), 5)
        for half in (1, 64, n2 // 2)
    }
    pairs = n // 2
    bytes5 = (4 * pairs + n2 // 2) * L * 4  # lo, hi in; lo, hi out; twiddles once
    mads5 = mads_per_product(spec) * pairs
    k5 = {
        "mismatches": bad5, "max_abs_err": err5, "ms": ms5, "plain_ms": plain5,
        "ms_by_half": per_stage,
        "shape": [L, n2, n1],
    }
    return with_bound(k1, bytes1, mads1), with_bound(k5, bytes5, mads5)


def mads_per_product(spec) -> int:
    """32-bit multiply-adds of one Montgomery product of W words."""
    W = spec.n_words
    return 2 * W * W + W


def mads_per_square(spec) -> int:
    """The same for the dedicated squaring."""
    W = spec.n_words
    return W * (W + 1) // 2 + W * W + W


def with_bound(k: dict, n_bytes: int, mads: int) -> dict:
    """Add the least time the card could take: the larger of the bytes that
    must move over the memory rate and the multiply-adds over their peak."""
    k["bound_bytes_ms"] = n_bytes / PEAK_BYTES_PER_S * 1e3
    k["bound_ops_ms"] = mads / PEAK_INT32_MAD_PER_S * 1e3
    k["bound_ms"] = max(k["bound_bytes_ms"], k["bound_ops_ms"])
    k["bound_by"] = ("bytes" if k["bound_bytes_ms"] >= k["bound_ops_ms"]
                     else "operations")
    return k


def inverse_oracle(spec, a_np: np.ndarray, lanes) -> list:
    """Host big-integer inverses, in Montgomery form, of the given lanes of
    a Montgomery-form limb array; zero for zero."""
    p = spec.modulus
    r_inv = pow(spec.R, -1, p)
    vals = limbs_to_ints(np.ascontiguousarray(a_np[:, lanes]))
    return [pow(x * r_inv % p, -1, p) * spec.R % p if x else 0 for x in vals]


def inverse_defects(spec, a: torch.Tensor, inv: torch.Tensor) -> int:
    """Number of lanes where ``inv`` is not the inverse of ``a``: the
    Montgomery product a * inv must be one where a is not zero, and inv
    must be zero where a is."""
    from algebra_tpu_torch.ops import mont, mont_kernels as mk

    zero = (a == 0).all(dim=0)
    one = mont.bconst(spec.one_mont_limbs, (1,), a.device)
    want = torch.where(zero, torch.zeros_like(one), one)
    prod = mk.mul(spec, a, inv)
    bad = ((prod != want).any(dim=0) & ~zero) | ((inv != 0).any(dim=0) & zero)
    return int(bad.sum().item())


def gcd_operands(spec, n: int, rng) -> np.ndarray:
    """[L, n] Montgomery-form values for the safegcd bottom: random, zeros
    planted at the first and last lane and at 128:200 where n reaches, and
    from lane 1 on the edge values 1, 2, p - 1, p - 2, (p - 1) / 2, R mod p,
    R^2 mod p and four values just below p, as far as n reaches."""
    from algebra_tpu_torch.bigint import batch_int_to_limbs

    p, R = spec.modulus, spec.R
    a = random_limbs(spec, n, rng)
    edge = [1, 2, p - 1, p - 2, (p - 1) // 2, R % p, R * R % p]
    edge += [p - 1 - int(v) for v in rng.integers(0, 1 << 40, size=4)]
    k = min(len(edge), n - 2)
    if k > 0:
        a[:, 1 : 1 + k] = batch_int_to_limbs(edge[:k], spec.n_limbs)
    a[:, [0, n - 1]] = 0
    a[:, 128:200] = 0
    return a


def check_gcd_kernel(spec, rng, device) -> list:
    """K3 (``inv_gcd``) for one field at n = 1 (a random value, and zero),
    127, 4097 and 2^14 on ``gcd_operands``: every lane against the
    ladder's plain version (one call over all the cases' lanes) and the
    host oracle."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.ops import mont_kernels as mk

    one = random_limbs(spec, 2, rng)
    one[:, 1] = 0
    inputs = [("random", one[:, :1]), ("zero", one[:, 1:])]
    inputs += [("planted", gcd_operands(spec, n, rng)) for n in (127, 4097, 1 << 14)]
    a_all = np.concatenate([a for _, a in inputs], axis=1)
    plain_all = mk.inv_fermat_plain(spec, convert.from_reference(a_all, device))
    want_all = inverse_oracle(spec, a_all, list(range(a_all.shape[1])))
    out, start = [], 0
    for kind, a_np in inputs:
        n = a_np.shape[1]
        got = mk.inv_gcd(spec, convert.from_reference(a_np, device))
        got_ints = limbs_to_ints(convert.to_reference(got))
        bad, err = mismatches(got, plain_all[:, start : start + n])
        out.append({"n": n, "lanes": kind, "batches": mk.gcd_batches(spec),
                    "mismatches": bad, "max_abs_err": err, "oracle_lanes": n,
                    "oracle_mismatches": sum(
                        g != w for g, w in zip(got_ints, want_all[start : start + n]))})
        start += n
    return out


def check_inverse_kernels(spec, rng, device):
    """K2-K4 for one field.  The dedicated squaring against the product
    a * a (through the ladder); each kernel against its plain version on
    ragged shapes with planted zeros, the safegcd bottom also at n = 1 and
    with edge values (``check_gcd_kernel``) and the ladder beside it; the
    whole inversion on every lane (a * inv == 1, zero to zero) and against
    a host big-integer oracle on 64 lanes, for ragged n, with the levels
    the port uses and with small ones that fold a short batch several
    times."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.bigint import batch_int_to_limbs
    from algebra_tpu_torch.ops import mont_kernels as mk

    p, L = spec.modulus, spec.n_limbs

    def planted(n, everywhere=False):
        a = random_limbs(spec, n, rng)
        if everywhere:
            a[:] = 0
        else:
            a[:, 0] = 0
            a[:, n - 1] = 0
            a[:, 128:200] = 0  # a whole block of lanes, where n reaches it
        return a

    edge = batch_int_to_limbs([0, 1, p - 1, spec.R % p], L)
    a = convert.from_reference(
        np.concatenate([edge, random_limbs(spec, (1 << 16) + 33, rng)], axis=1), device)
    sq_bad, sq_err = mismatches(mk.inv_fermat(spec, a, 2), mk.mul(spec, a, a))
    sq_n = int(a.shape[1])

    single = []
    for n, group in [(4097, 5), (260, 32)]:
        a = convert.from_reference(planted(n), device)
        pref, tails = mk.inv_prefix(spec, a, group)
        p_pref, p_tails = mk.inv_prefix_plain(spec, a, group)
        bad2 = mismatches(pref, p_pref)[0] + mismatches(tails, p_tails)[0]
        tinv = mk.inv_gcd(spec, tails)
        ladder = mk.inv_fermat(spec, tails)
        if n == 4097:
            p_tinv = mk.inv_fermat_plain(spec, tails)
            bad3 = mismatches(tinv, p_tinv)[0]
            bad3_ladder = mismatches(ladder, p_tinv)[0]
        else:
            bad3 = bad3_ladder = None
        out = mk.inv_backward(spec, a, pref, tinv, group)
        bad4 = mismatches(out, mk.inv_backward_plain(spec, a, pref, tinv, group))[0]
        single.append({"n": n, "group": group, "columns": int(tails.shape[1]),
                       "prefix_mismatches": bad2, "gcd_mismatches": bad3,
                       "gcd_vs_ladder_mismatches": mismatches(tinv, ladder)[0],
                       "ladder_mismatches": bad3_ladder, "backward_mismatches": bad4})

    whole = []
    shapes = [(n, False) for n in (1, 127, 260, 4097, (1 << 16) + 3)] + [(260, True)]
    for n, everywhere in shapes:
        a_np = planted(n, everywhere)
        a = convert.from_reference(a_np, device)
        lanes = sorted(set(range(min(n, 32))) | set(range(max(n - 32, 0), n)))
        want = inverse_oracle(spec, a_np, lanes)
        for group, bottom in [(mk.INV_GROUP, mk.INV_BOTTOM), (4, 64)]:
            got = mk.batch_inverse(spec, a, group, bottom)
            got_lanes = limbs_to_ints(convert.to_reference(got[:, lanes]))
            whole.append({
                "n": n, "zeros": "everywhere" if everywhere else "first,last,block",
                "levels": len(mk.level_plan(n, group, bottom)),
                "mismatches": inverse_defects(spec, a, got),
                "oracle_lanes": len(lanes),
                "oracle_mismatches": sum(g != w for g, w in zip(got_lanes, want)),
            })
    gcd = check_gcd_kernel(spec, rng, device)
    torch.cuda.synchronize()
    return {"field": spec.name, "words": spec.n_words,
            "mont_sq": {"n": sq_n, "mismatches": sq_bad, "max_abs_err": sq_err},
            "single_kernels": single, "gcd": gcd, "batch_inverse": whole}


def inverse_case_failures(case: dict) -> list:
    bad = [case["mont_sq"]] if case["mont_sq"]["mismatches"] else []
    bad += [c for c in case["single_kernels"]
            if c["prefix_mismatches"] or c["gcd_mismatches"] or c["ladder_mismatches"]
            or c["gcd_vs_ladder_mismatches"] or c["backward_mismatches"]]
    bad += [c for c in case["gcd"] if c["mismatches"] or c["oracle_mismatches"]]
    bad += [c for c in case["batch_inverse"] if c["mismatches"] or c["oracle_mismatches"]]
    return bad


def check_inverse_main_shapes(spec, rng, device, log_n):
    """K2, K3 and K4 at the shapes the division path gives them (the top
    level of a 2^log_n inversion, and its bottom), against their plain
    versions, with times and bounds; K3 (safegcd) also against the ladder
    it replaced, both timed in turns; and every level's kernel times."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.ops import mont_kernels as mk

    L = spec.n_limbs
    n = 1 << log_n
    a_np = random_limbs(spec, n, rng)
    a_np[:, rng.integers(0, n, size=1000)] = 0
    a_np[:, [0, n - 1]] = 0
    a = convert.from_reference(a_np, device)
    del a_np
    plan = mk.level_plan(n)

    # down: every level's input, prefixes and group size
    levels, cur = [], a
    for _, rows, _ in plan:
        pref, tails = mk.inv_prefix(spec, cur, rows)
        levels.append((cur, pref, rows))
        cur = tails
    bottom = cur
    tinv_bottom = mk.inv_gcd(spec, bottom)
    # up: every level's tail inverses
    tinvs, inv = [None] * len(levels), tinv_bottom
    for i in range(len(levels) - 1, -1, -1):
        tinvs[i] = inv
        inv = mk.inv_backward(spec, levels[i][0], levels[i][1], inv, levels[i][2])
    out = inv
    defects = inverse_defects(spec, a, out)

    _, pref, rows = levels[0]
    m = -(-n // rows)
    tails = levels[1][0] if len(levels) > 1 else bottom
    (p_pref, p_tails), plain2 = wall_ms(lambda: mk.inv_prefix_plain(spec, a, rows))
    bad2 = mismatches(pref, p_pref)
    bad2t = mismatches(tails, p_tails)
    del p_pref, p_tails
    p_out, plain4 = wall_ms(lambda: mk.inv_backward_plain(spec, a, pref, tinvs[0], rows))
    bad4 = mismatches(out, p_out)
    del p_out
    p_tinv, plain3 = wall_ms(lambda: mk.inv_fermat_plain(spec, bottom))
    bad3 = mismatches(tinv_bottom, p_tinv)
    bad3_ladder = mismatches(mk.inv_fermat(spec, bottom), p_tinv)[0]
    del p_tinv, out

    level_ms = []
    for (lvl, pr, g), ti in zip(levels, tinvs):
        level_ms.append({
            "n": int(lvl.shape[1]), "rows": g,
            "prefix_ms": time_ms(lambda: mk.inv_prefix(spec, lvl, g), 5),
            "backward_ms": time_ms(lambda: mk.inv_backward(spec, lvl, pr, ti, g), 5),
        })
    k3 = gcd_vs_ladder(spec, bottom)

    nb = bottom.shape[1]
    products = (rows - 1) * m  # one a column in every row but the first
    k2 = with_bound(
        {"mismatches": bad2[0] + bad2t[0], "max_abs_err": max(bad2[1], bad2t[1]),
         "ms": level_ms[0]["prefix_ms"], "plain_ms": plain2, "shape": [L, n],
         "rows": rows},
        (2 * n + m) * L * 4, products * mads_per_product(spec))
    k4 = with_bound(
        {"mismatches": bad4[0] + defects, "max_abs_err": bad4[1],
         "ms": level_ms[0]["backward_ms"], "plain_ms": plain4, "shape": [L, n],
         "rows": rows},
        (3 * n + m) * L * 4, 2 * products * mads_per_product(spec))
    k3.update({"mismatches": bad3[0] + k3["mismatches"], "max_abs_err": bad3[1],
               "ladder_mismatches": bad3_ladder, "plain_ms": plain3})
    return k2, k3, k4, {"levels": level_ms, "bottom_n": nb, "gcd_ms": k3["ms"],
                        "ladder_ms": k3["ladder_ms"]}


def gcd_work(spec, n: int) -> tuple:
    """(bytes, 32 x 32 -> 64 multiply-adds) of K3's safegcd on n elements:
    one element read and one written; a fixed count of batches, each one
    matrix update on N signed 30-bit limbs (4 N multiply-adds for f, g;
    6 N + 2 for d, e) after 30 divsteps, whose word operations the
    compiler merges and which are left out."""
    from algebra_tpu_torch.ops import mont_kernels as mk

    limbs = 32 * spec.n_words // 30 + 1
    return 2 * n * spec.n_limbs * 4, n * mk.gcd_batches(spec) * (10 * limbs + 2)


def ladder_mads(spec, n: int) -> int:
    """32-bit multiply-adds of the Fermat ladder a^(p-2) on n elements."""
    e = spec.modulus - 2
    return n * ((e.bit_length() - 1) * mads_per_square(spec)
                + (bin(e).count("1") - 1) * mads_per_product(spec))


def gcd_vs_ladder(spec, a: torch.Tensor, reps: int = 20) -> dict:
    """K3 through safegcd (``inv_gcd``) and the Fermat ladder it replaced
    (``inv_fermat``) on the same [L, n] batch: equal outputs, device times
    in turns (ladder, safegcd, safegcd, ladder), the safegcd's bound from
    its bytes and counted multiply-adds, the ladder's bound, and one lane's
    safegcd time: the latency floor of a chain of fixed length, which binds
    up to one block a multiprocessor (2^14 lanes)."""
    from algebra_tpu_torch.ops import mont_kernels as mk

    n = a.shape[1]
    bad = mismatches(mk.inv_gcd(spec, a), mk.inv_fermat(spec, a))
    gcd = lambda: mk.inv_gcd(spec, a)  # noqa: E731
    ladder = lambda: mk.inv_fermat(spec, a)  # noqa: E731
    turns = [device_ms(f, reps) for f in (ladder, gcd, gcd, ladder)]
    lane = a[:, :1].contiguous()
    one_lane_ms = device_ms(lambda: mk.inv_gcd(spec, lane), reps)
    n_bytes, mads = gcd_work(spec, n)
    k = with_bound(
        {"name": "inv_gcd_kernel", "field": spec.name, "words": spec.n_words,
         "shape": [spec.n_limbs, n], "mismatches": bad[0], "max_abs_err": bad[1],
         "ms": (turns[1] + turns[2]) / 2, "ladder_ms": (turns[0] + turns[3]) / 2,
         "turns_ms_ladder_gcd_gcd_ladder": turns, "batches": mk.gcd_batches(spec),
         "divsteps": 30 * mk.gcd_batches(spec), "latency_floor_ms": one_lane_ms,
         "multiply_adds": mads,
         "ladder_bound_ms": max(n_bytes / PEAK_BYTES_PER_S,
                                ladder_mads(spec, n) / PEAK_INT32_MAD_PER_S) * 1e3,
         "library_ms": None,
         "library_call": "none: no PyTorch call inverts a 255- to 753-bit field element"},
        n_bytes, mads)
    k["share_of_bound"] = k["bound_ms"] / k["ms"]
    k["share_of_latency_floor"] = one_lane_ms / k["ms"]
    return k


# ---------------------------------------------------------------------------
# phases 3 and 4: the polynomial product, checked exactly
# ---------------------------------------------------------------------------


def check_product(F, domain, a, b, z):
    """Through ``domain``: (a) ifft(fft(a)) == a zero-padded; (b) the
    product c has c(z) == a(z) * b(z) on the host.  Returns c."""
    spec = F.spec
    fa = domain.fft(a)
    back = domain.ifft(fa)
    pad = torch.nn.functional.pad(a, (0, domain.size - a.shape[1]))
    if not torch.equal(back, pad):
        raise AssertionError(f"ifft(fft(a)) != a on {domain}")
    del back, pad
    fb = domain.fft(b)
    c = domain.ifft(domain.mul_polynomials_in_evaluation_domain(fa, fb))
    del fa, fb
    lhs = host_eval_mont(spec, c, z)
    rhs = host_eval_mont(spec, a, z) * host_eval_mont(spec, b, z) % spec.modulus
    if lhs != rhs:
        raise AssertionError(f"c(z) != a(z) b(z) on {domain}")
    return c


def run_main_path(device, rng, gpu):
    from algebra_tpu_torch import convert, entry
    from algebra_tpu_torch.curves.instances import bls12_381
    from algebra_tpu_torch.ops import mont_kernels as mk
    from algebra_tpu_torch.poly.domain import Radix2EvaluationDomain

    spec = bls12_381.fr_spec
    F = bls12_381.Fr.to(device)
    n = 1 << LOG_MAIN
    a = convert.from_reference(random_limbs(spec, n // 2, rng), device)
    b = convert.from_reference(random_limbs(spec, n // 2, rng), device)

    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    c, total_ms = wall_ms(lambda: entry.poly_product(a, b, device=device))
    counts = dict(mk.launches)

    # (d) launches the path implies: two root tables of n/2 powers by
    # doubling, three transforms (each LOG_MAIN butterfly stages and one
    # twiddle multiply), the pointwise product, the 1/n scaling
    # and no inversion kernel
    want_counts = {**dict.fromkeys(counts, 0),
                   "mont_mul": 2 * (LOG_MAIN - 1) + 3 + 2, "butterfly": 3 * LOG_MAIN}
    if counts != want_counts:
        raise AssertionError(f"launch counts {counts}, expected {want_counts}")
    if tuple(c.shape) != (spec.n_limbs, n) or c.dtype != torch.int32:
        raise AssertionError(f"product has shape {tuple(c.shape)} {c.dtype}")
    # (c) two inputs of degree < n/2: the top coefficient is zero
    if int(c[:, n - 1].abs().sum().item()) != 0:
        raise AssertionError("coefficient n-1 of the product is not zero")
    # (b) c(z) == a(z) b(z) at a random point, on the host
    z = int.from_bytes(rng.bytes(40), "little") % spec.modulus
    t0 = time.perf_counter()
    lhs = host_eval_mont(spec, c, z)
    rhs = host_eval_mont(spec, a, z) * host_eval_mont(spec, b, z) % spec.modulus
    host_s = time.perf_counter() - t0
    if lhs != rhs:
        raise AssertionError("c(z) != a(z) b(z) at the main size")

    # the same steps one by one, timed, on a domain of our own
    domain = Radix2EvaluationDomain(F, n)
    _, roots_ms = wall_ms(domain._root_tables)
    a_pad = torch.nn.functional.pad(a, (0, n // 2))
    b_pad = torch.nn.functional.pad(b, (0, n // 2))
    fa, fft_a_ms = wall_ms(lambda: domain.fft(a_pad))
    fb, fft_b_ms = wall_ms(lambda: domain.fft(b_pad))
    prod, mul_ms = wall_ms(lambda: F.mul(fa, fb))
    mul_kernel_ms = time_ms(lambda: F.mul(fa, fb), 10)
    c2, ifft_ms = wall_ms(lambda: domain.ifft(prod))
    if not torch.equal(c2, c):
        raise AssertionError("step-by-step product differs from poly_product")
    del c2, prod, fb
    # (a) ifft(fft(a)) == a
    back = domain.ifft(fa)
    if not torch.equal(back, a_pad):
        raise AssertionError("ifft(fft(a)) != a at the main size")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return counts, {
        "phase": "main_path", "field": spec.name, "log_n": LOG_MAIN,
        "checks": ["ifft_fft_identity", "host_eval_at_random_point",
                   "top_coefficient_zero", "launch_counts"],
        "launches": counts, "poly_product_ms": total_ms,
        "root_tables_ms": roots_ms, "fft_a_ms": fft_a_ms, "fft_b_ms": fft_b_ms,
        "pointwise_mul_ms": mul_ms, "ifft_ms": ifft_ms,
        "ntt_ms": min(fft_a_ms, fft_b_ms),
        "fr_mults_per_s": n / (mul_kernel_ms * 1e-3),
        "peak_memory_bytes": peak, "host_check_s": host_s, "gpu": gpu,
    }


def run_small_paths(device, rng, gpu):
    from algebra_tpu_torch import convert, entry
    from algebra_tpu_torch.curves.instances import bls12_381
    from algebra_tpu_torch.poly.domain import Radix2EvaluationDomain

    spec = bls12_381.fr_spec
    F = bls12_381.Fr.to(device)

    def rand(n):
        return convert.from_reference(random_limbs(spec, n, rng), device)

    def z():
        return int.from_bytes(rng.bytes(40), "little") % spec.modulus

    done = []
    for log_n in (16, 10):
        n = 1 << log_n
        domain = Radix2EvaluationDomain(F, n)
        a, b = rand(n // 2), rand(n // 2)
        c = check_product(F, domain, a, b, z())
        if not torch.equal(c, entry.poly_product(a, b, device=device)):
            raise AssertionError(f"poly_product differs from the domain at 2^{log_n}")
        done.append(f"2^{log_n}")
        # a short input takes the degree-aware transform
        check_product(F, domain, rand(100), b, z())
        done.append(f"2^{log_n} short input")
    coset = Radix2EvaluationDomain(F, 1 << 10).get_coset(7)
    check_product(F, coset, rand(512), rand(512), z())
    done.append("2^10 coset offset 7")
    torch.cuda.synchronize()
    return {"phase": "small_path", "field": spec.name, "passed": done, "gpu": gpu}


# ---------------------------------------------------------------------------
# phases 5 and 6: the division path and the short paths over its kernels
# ---------------------------------------------------------------------------


def run_inverse_path(device, rng, gpu, log_n, level_times):
    """``poly_quotient(poly_product(q, d), d) == q`` through a 2^log_n
    coset, the inversion alone on a random batch with planted zeros, and
    the blocked inversion against the per-element ladder at 2^20."""
    from algebra_tpu_torch import convert, entry
    from algebra_tpu_torch.curves.instances import bls12_381
    from algebra_tpu_torch.ops import mont, mont_kernels as mk

    spec = bls12_381.fr_spec
    F = bls12_381.Fr.to(device)
    n = 1 << log_n
    q = convert.from_reference(random_limbs(spec, n // 2, rng), device)
    d = convert.from_reference(random_limbs(spec, n // 2, rng), device)
    num = entry.poly_product(q, d, device=device)

    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    quo, quotient_ms = wall_ms(lambda: entry.poly_quotient(num, d, device=device))
    counts = dict(mk.launches)
    peak = torch.cuda.max_memory_allocated()

    # launches the path implies: two root tables (log_n - 1 doublings each);
    # the coset's power table (log_n doublings), its scaling and the
    # four-step twiddle multiply for each of three transforms; the
    # pointwise multiply; the 1/n scaling; log_n butterfly stages a
    # transform; and the inversion's own level plan
    plan = mk.level_plan(n)
    want_counts = {**dict.fromkeys(counts, 0),
                   "mont_mul": 2 * (log_n - 1) + 3 * (log_n + 2) + 2,
                   "butterfly": 3 * log_n, "inv_prefix": len(plan),
                   "inv_gcd": 1, "inv_backward": len(plan)}
    if counts != want_counts:
        raise AssertionError(f"launch counts {counts}, expected {want_counts}")
    if not plan:
        raise AssertionError("the division path is too short to fold a level")
    if tuple(quo.shape) != (spec.n_limbs, n) or quo.dtype != torch.int32:
        raise AssertionError(f"quotient has shape {tuple(quo.shape)} {quo.dtype}")
    if not torch.equal(quo[:, : n // 2], q):
        raise AssertionError("poly_quotient(poly_product(q, d), d) != q")
    if bool(quo[:, n // 2 :].any()):
        raise AssertionError("the quotient's upper half is not zero")
    del quo, num, q, d

    # the inversion alone, through the field kind
    a_np = random_limbs(spec, n, rng)
    a_np[:, rng.integers(0, n, size=1000)] = 0
    a_np[:, [0, n - 1]] = 0
    a = convert.from_reference(a_np, device)
    del a_np
    inv = F.inverse(a)
    defects = inverse_defects(spec, a, inv)
    if defects:
        raise AssertionError(f"a * inverse(a) != 1 on {defects} lanes")
    del inv
    inverse_ms = time_ms(lambda: F.inverse(a), 5)

    # the blocked inversion against the route it replaces
    small = a[:, : 1 << 20].contiguous()
    mk.reset_launches()
    old = mont.inv(spec, small)
    ladder_launches = mk.launches["mont_mul"]
    if not torch.equal(mont.batch_inverse(spec, small), old):
        raise AssertionError("batch_inverse differs from the per-element ladder")
    ladder_ms = time_ms(lambda: mont.inv(spec, small), 2)
    blocked_ms = time_ms(lambda: mont.batch_inverse(spec, small), 5)

    # why the level constants are what they are: the inversion alone at 2^22
    # for rows per level x bottom width around the port's choice
    mid = a[:, : 1 << 22].contiguous()
    sweep = {f"{group}x{bottom}": time_ms(
        lambda: mk.batch_inverse(spec, mid, group, bottom), 5)
        for group in (16, 32, 64) for bottom in (4096, 16384, 65536)}
    torch.cuda.synchronize()
    return counts, {
        "phase": "inverse_path", "field": spec.name, "log_n": log_n,
        "checks": ["quotient_recovers_factor", "upper_half_zero", "launch_counts",
                   "a_times_inverse_is_one", "zero_to_zero",
                   "blocked_equals_ladder_at_2^20"],
        "launches": counts, "level_plan": plan, "poly_quotient_ms": quotient_ms,
        "inverse_ms": inverse_ms, "inversions_per_s": n / (inverse_ms * 1e-3),
        **level_times, "peak_memory_bytes": peak,
        "at_2^20": {"ladder_ms": ladder_ms, "ladder_launches": ladder_launches,
                    "blocked_ms": blocked_ms},
        "level_constants": [mk.INV_GROUP, mk.INV_BOTTOM],
        "ms_at_2^22_by_group_x_bottom": sweep,
        "gpu": gpu,
    }


def run_small_inverse_paths(device, rng, gpu):
    """The short paths over the same kernels: all Lagrange coefficients at
    2^16, long division, square roots and Legendre symbols."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.curves.instances import bls12_381
    from algebra_tpu_torch.ops import mont_kernels as mk
    from algebra_tpu_torch.poly.dense import DensePolynomial
    from algebra_tpu_torch.poly.domain import Radix2EvaluationDomain

    done = []
    spec = bls12_381.fr_spec
    F = bls12_381.Fr.to(device)

    def rand(n):
        return convert.from_reference(random_limbs(spec, n, rng), device)

    n = 1 << 16
    domain = Radix2EvaluationDomain(F, n).get_coset(5)
    tau = rand(1)[:, 0].contiguous()
    mk.reset_launches()
    li = domain.evaluate_all_lagrange_coefficients(tau)
    if not all(mk.launches[k] > 0 for k in ("inv_prefix", "inv_gcd", "inv_backward")):
        raise AssertionError(f"Lagrange coefficients skipped a kernel: {mk.launches}")
    if not torch.equal(F.sum(li, axis=0), F.one()):
        raise AssertionError("the Lagrange coefficients do not sum to one")
    poly = DensePolynomial(F, rand(n))
    by_lagrange = F.sum(F.mul(li, domain.fft(poly.coeffs)), axis=0)
    if not torch.equal(by_lagrange, poly.evaluate(tau)):
        raise AssertionError("sum L_i(tau) p(x_i) != p(tau)")
    inside = domain.evaluate_all_lagrange_coefficients(F.constant(domain.element(777)))
    one_hot = F.zero((n,))
    one_hot[:, 777] = F.one()
    if not torch.equal(inside, one_hot):
        raise AssertionError("tau inside the domain does not give the one-hot row")
    done.append("lagrange 2^16 coset")

    q, d, r = rand(40), rand(24), rand(23)
    num = DensePolynomial(F, q).naive_mul(DensePolynomial(F, d)).add(DensePolynomial(F, r))
    got_q, got_r = num.divide_with_q_and_r(DensePolynomial(F, d))
    if not (torch.equal(got_q.coeffs, q) and torch.equal(got_r.coeffs, r)):
        raise AssertionError("long division does not recover quotient and remainder")
    done.append("divide_with_q_and_r 63 / 24")

    for field, non_residue in ((F, 5), (bls12_381.Fq.to(device), 2)):
        fp = field.spec.modulus
        x = convert.from_reference(random_limbs(field.spec, 61, rng), device)
        squares = field.square(x)
        a = torch.cat([squares, field.zero((1,)),
                       field.mul(squares[:, :2], field.constant(non_residue))], dim=1)
        if pow(non_residue, (fp - 1) // 2, fp) != fp - 1:
            raise AssertionError(f"{non_residue} is a square in {field.name}")
        if field.legendre(a).tolist() != [1] * 61 + [0] + [-1] * 2:
            raise AssertionError(f"legendre is wrong in {field.name}")
        ok, root = field.sqrt(a)
        if ok.tolist() != [True] * 62 + [False] * 2:
            raise AssertionError(f"sqrt's mask is wrong in {field.name}")
        if not torch.equal(field.square(root)[:, :62], a[:, :62]):
            raise AssertionError(f"sqrt's roots do not square back in {field.name}")
        done.append(f"sqrt/legendre {field.name} ({field.spec.sqrt_mode})")
    torch.cuda.synchronize()
    return {"phase": "small_inverse_path", "passed": done, "gpu": gpu}


# ---------------------------------------------------------------------------
# phase 7: the group-law kernels against their plain versions
# ---------------------------------------------------------------------------


def sw_operands(spec, n: int, rng: np.random.Generator, device, planted: bool):
    """Random coordinates for K6-K8 on n lanes, as (P, Q, inf2): P, Q
    Jacobian triples [L, n], inf2 a bool [n] mask (1 in 8 set).  The group
    laws are polynomial identities, so the coordinates need no curve.  With
    ``planted``: P = inf on lane 0, Q = inf (z2 = 0 and inf2) on lane 1,
    P = Q on lane 2 and on a whole warp, lanes 64-95 (z1 = one and
    (x2, y2) = (x1, y1) for K8; Q = P for K7), P = -Q on lane 3, where H = 0
    and r != 0 so Z3 = 0.  Lanes past n are not planted."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.ops import mont

    coords = [convert.from_reference(random_limbs(spec, n, rng), device) for _ in range(6)]
    inf2 = torch.from_numpy(rng.integers(0, 8, size=n) == 0).to(device)
    x1, y1, z1, x2, y2, z2 = coords
    if planted:
        one = mont.bconst(spec.one_mont_limbs, (1,), device)
        lanes = torch.arange(n, device=device)
        same = (lanes == 2) | ((lanes >= 64) & (lanes < 96))
        opp = lanes == 3
        z1 = torch.where(same | opp, one, z1)
        z1 = torch.where(lanes == 0, 0, z1)
        z2 = torch.where(lanes == 1, 0, z2)
        inf2 = torch.where(lanes == 1, True, inf2 & ~(same | opp))
        x2 = torch.where(same | opp, x1, x2)
        y2 = torch.where(same, y1, torch.where(opp, mont.neg(spec, y1), y2))
        z2 = torch.where(same | opp, z1, z2)
    return (x1, y1, z1), (x2, y2, z2), inf2


def edge_sw_operands(spec, device):
    """(P, Q, inf2) on 5^5 = 3125 lanes whose x1, y1, z1, x2, y2 run over
    every combination of ``product_edges``; z2 is z1 moved one lane on,
    inf2 set on every seventh lane.  Every product and square of K6-K8
    then meets edge operands."""
    import itertools

    from algebra_tpu_torch import convert
    from algebra_tpu_torch.bigint import batch_int_to_limbs

    cols = list(zip(*itertools.product(product_edges(spec), repeat=5)))
    cols.append(cols[2][1:] + cols[2][:1])
    x1, y1, z1, x2, y2, z2 = (convert.from_reference(batch_int_to_limbs(list(c), spec.n_limbs),
                                                     device) for c in cols)
    inf2 = torch.arange(len(cols[0]), device=device) % 7 == 0
    return (x1, y1, z1), (x2, y2, z2), inf2


def check_sw_kernels(spec, rng, device):
    """K6, K7 and K8 for one field against their plain versions on ragged n
    with planted lanes, on every combination of product edge operands, and
    the operand forms the MSM gives them: K8 in place with point-major rows
    for Q, K7 with a broadcast Q."""
    from algebra_tpu_torch.ops import sw_kernels as swk

    def compare(P, Q, inf2) -> dict:
        aff = (Q[0], Q[1], inf2)
        bad6 = tuple_mismatches(swk.double(spec, P), swk.double_plain(spec, *P))
        bad7 = tuple_mismatches(swk.add(spec, P, Q), swk.add_plain(spec, *P, *Q))
        bad8 = tuple_mismatches(swk.madd(spec, P, aff), swk.madd_plain(spec, *P, *aff))
        return {"double": bad6[0], "add": bad7[0], "madd": bad8[0],
                "max_abs_err": max(bad6[1], bad7[1], bad8[1])}

    cases = []
    for n in (1, 127, 4097, 65539):
        P, Q, inf2 = sw_operands(spec, n, rng, device, planted=n > 96)
        cases.append({"n": n, "operands": "random", "planted": n > 96,
                      **compare(P, Q, inf2)})
    P, Q, inf2 = edge_sw_operands(spec, device)
    cases.append({"n": int(inf2.numel()), "operands": "edges", "planted": False,
                  **compare(P, Q, inf2)})
    # K8 in place, Q as strided views of point-major rows [n, 2L]
    L = spec.n_limbs
    P, Q, inf2 = sw_operands(spec, 4097, rng, device, planted=True)
    rows = torch.cat([Q[0].T, Q[1].T], dim=1).contiguous()
    aff = (rows[:, :L].T, rows[:, L:].T, inf2)
    want = swk.madd_plain(spec, *P, Q[0], Q[1], inf2)
    acc = tuple(c.clone() for c in P)
    swk.madd(spec, acc, aff, out=acc)
    bad_rows = tuple_mismatches(acc, want)
    # K7 with one Q for every lane (lane stride 0)
    Q1 = tuple(c[:, 5:6].contiguous() for c in Q)
    bad_bc = tuple_mismatches(swk.add(spec, P, Q1), swk.add_plain(spec, *P, *Q1))
    torch.cuda.synchronize()
    return {"field": spec.name, "words": spec.n_words, "ragged": cases,
            "madd_in_place_point_major_rows": bad_rows[0],
            "add_broadcast_q": bad_bc[0]}


ROUND_CASES = ("past", "zero_past", "zero_adds", "eq", "neg")


def round_operands(spec, m: int, rng: np.random.Generator, device, planted: bool,
                   n_pts: int = 4099, r: int = 3):
    """Operands of K8's round kernel on m lanes: (acc [L, m] x3, table
    [2 n_pts, 2L] of random rows (row n_pts + j holding -y_j), a flat order
    of three windows of n_pts random rows, first, count, r).  A lane's run
    starts anywhere in any window (as the drain's compacted lanes do) and
    holds 0-8 points.  With ``planted``, lane k and the whole warp
    32 (k + 1) .. 32 (k + 2) - 1 take case k of ``ROUND_CASES``: a run too
    short for round r (Z1 != 0); the same with (X, Y, 0), X, Y != one; a
    point to add with Z1 = 0; the row equal to the accumulator's affine
    point (Z1 = one); and its negative."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.ops import mont

    L = spec.n_limbs
    one = mont.bconst(spec.one_mont_limbs, (1,), device)
    x, y = (convert.from_reference(random_limbs(spec, n_pts, rng), device) for _ in range(2))
    table = torch.cat([torch.cat([x.T, y.T], dim=1),
                       torch.cat([x.T, mont.neg(spec, y).T], dim=1)]).contiguous()
    as_t = lambda a: torch.from_numpy(a.astype(np.int64)).to(device)  # noqa: E731
    order = as_t(rng.integers(0, 2 * n_pts, size=3 * n_pts))
    count = rng.integers(0, 9, size=m)
    first = rng.integers(0, 3, size=m) * n_pts + rng.integers(0, n_pts - 8, size=m)
    X, Y, Z = (convert.from_reference(random_limbs(spec, m, rng), device) for _ in range(3))
    if planted:
        case = np.full(m, -1)
        for k in range(len(ROUND_CASES)):
            case[k] = k
            case[32 * (k + 1): 32 * (k + 2)] = k
        short = (case == 0) | (case == 1)
        adds = case >= 2
        count[short] = rng.integers(0, r + 1, size=int(short.sum()))
        count[adds] = rng.integers(r + 1, 9, size=int(adds.sum()))
        first_t = as_t(first)
        rows = table[order[first_t + r]]
        lanes = lambda k: torch.from_numpy(case == k).to(device)  # noqa: E731
        Z = torch.where(lanes(1) | lanes(2), 0, Z)
        same = lanes(3) | lanes(4)
        X = torch.where(same, rows[:, :L].T, X)
        Y = torch.where(lanes(3), rows[:, L:].T, Y)
        Y = torch.where(lanes(4), mont.neg(spec, rows[:, L:].T), Y)
        Z = torch.where(same, one, Z)
    acc = tuple(c.contiguous() for c in (X, Y, Z))
    return acc, table, order, as_t(first), as_t(count), r


def check_round_kernel(spec, rng, device):
    """K8's round kernel for one field against its plain version on ragged
    m, with the planted lanes and whole warps of ``round_operands``, for
    one round (``madd_round``) and for rounds 0-5 in a row
    (``madd_rounds``)."""
    from algebra_tpu_torch.ops import sw_kernels as swk

    cases = []
    for m in (1, 127, 4097, 65539):
        acc, table, order, first, count, r = round_operands(spec, m, rng, device,
                                                            planted=m > 191)
        for rounds in ((r,), tuple(range(6))):
            want = tuple(c.clone() for c in acc)
            got = tuple(c.clone() for c in acc)
            for rr in rounds:
                swk.madd_round_plain(spec, want, table, order, first, count, rr)
            if len(rounds) == 1:
                swk.madd_round(spec, got, table, order, first, count, r)
            else:
                swk.madd_rounds(spec, got, table, order, first, count, 0, len(rounds))
            bad = tuple_mismatches(got, want)
            cases.append({"m": m, "rounds": list(rounds), "planted": m > 191,
                          "mismatches": bad[0], "max_abs_err": bad[1]})
    torch.cuda.synchronize()
    return {"field": spec.name, "words": spec.n_words, "cases": cases}


def reduce_buckets(spec, W: int, B: int, rng: np.random.Generator, device, planted: bool):
    """Random coordinates as [L, W, B] buckets for the MSM tail's kernels
    (the group law is a polynomial identity, so no curve is needed).  With
    ``planted``, in window 0: buckets at infinity as (X, Y, 0) and as
    (1, 1, 0); the same words in two neighbouring buckets (a doubling in
    the accT chain); an infinity right after the top bucket (two equal
    suffix sums: a doubling in the accW chain); and window W - 1 all
    infinity."""
    from algebra_tpu_torch.ops import mont, sw_kernels as swk

    P, _, _ = sw_operands(spec, W * B, rng, device, planted=False)
    x, y, z = (c.reshape(-1, W, B).clone() for c in P)
    if planted:
        one = mont.bconst(spec.one_mont_limbs, (1,), device)[:, 0]
        G = swk.reduce_block(B)
        z[:, 0, B - 2] = 0
        for c in (x, y, z):
            c[:, 0, B - G - 2] = c[:, 0, B - G - 1]
        for k in (B - 2 * G, B - 2 * G + 2):
            x[:, 0, k], y[:, 0, k], z[:, 0, k] = one, one, 0
        z[:, W - 1] = 0
    return x.contiguous(), y.contiguous(), z.contiguous()


def check_reduce_kernels(spec, rng, device, wide: bool = False):
    """The MSM tail's kernels for one field against their plain versions on
    the same inputs: ``bucket_reduce`` (the inner scan) on [L, W, B]
    buckets, ``reduce_fold`` (outer scan and fold) on the plain inner
    scan's T and innerW; planted buckets at B = 64 (``reduce_buckets``),
    random ones at B = 32 (G = 8, 4 blocks); the fold alone on window sums
    (one bucket a window); with ``wide``, 70 windows of B = 4, more than
    one round of the fold kernel's threads.  The plain versions run on the
    CPU (the same function: at these few lanes, thousands of small launches
    on the card take longer)."""
    from algebra_tpu_torch.ops import sw_kernels as swk

    on_card = lambda ts: tuple(t.to(device) for t in ts)  # noqa: E731
    cases = []
    shapes = [(3, 64, 7, True), (2, 32, 6, False)] + ([(70, 4, 2, False)] if wide else [])
    for W, B, c, planted in shapes:
        P = reduce_buckets(spec, W, B, rng, "cpu", planted)
        G = swk.reduce_block(B)
        want_T, want_IW = swk.bucket_reduce_plain(spec, P)
        T, IW = swk.bucket_reduce(spec, on_card(P))
        bad_inner = tuple_mismatches(tuple(t.cpu() for t in T + IW), want_T + want_IW)
        got = swk.reduce_fold(spec, on_card(want_T), on_card(want_IW), G, c)
        bad_fold = tuple_mismatches(tuple(g.cpu() for g in got),
                                    swk.reduce_fold_plain(spec, want_T, want_IW, G, c))
        cases.append({"windows": W, "buckets": B, "block": G, "c": c, "planted": planted,
                      "inner_mismatches": bad_inner[0], "fold_mismatches": bad_fold[0],
                      "max_abs_err": max(bad_inner[1], bad_fold[1])})
    sums = tuple(a[:, :, 0].contiguous() for a in reduce_buckets(spec, 5, 64, rng, "cpu", True))
    got = swk.reduce_fold(spec, on_card(sums), None, 1, 2)
    bad = tuple_mismatches(tuple(g.cpu() for g in got),
                           swk.reduce_fold_plain(spec, sums, None, 1, 2))
    cases.append({"windows": 5, "buckets": 1, "c": 2, "planted": True, "inner_mismatches": 0,
                  "fold_mismatches": bad[0], "max_abs_err": bad[1]})
    torch.cuda.synchronize()
    return {"field": spec.name, "words": spec.n_words, "cases": cases}


class CountingLaw:
    """The general K7 and K6 (``curve.add``, ``curve.double``), counting
    the 32-bit multiply-adds each call's data makes them do
    (``sw_mads``)."""

    def __init__(self, curve):
        self.curve, self.mads = curve, 0

    def zero(self, batch_shape=()):
        return self.curve.zero(batch_shape)

    def add(self, P, Q):
        self.mads += sw_mads(self.curve.base.spec, P, Q)
        return self.curve.add(P, Q)

    def double(self, P):
        self.mads += sw_mads(self.curve.base.spec, P)
        return self.curve.double(P)


def reduce_kernels_at(curve, buckets, c: int) -> dict:
    """The MSM tail's two kernels at a real MSM's buckets: each against its
    plain version on the same inputs and the pair against the general K7
    and K6 run step by step (which also count the multiply-adds this data
    makes them do, lane by lane on their branches); device time (launches
    queued behind a spin kernel); bounds from the data: the bytes each
    input read once and each output written once, the multiply-adds; and
    the latency chain, the dependent adds and doublings of one thread.
    The fold's plain version runs on the CPU (its batches are a window or
    one point: on the card it is ~100,000 small launches), the inner
    scan's on the card."""
    from algebra_tpu_torch.ops import sw_kernels as swk

    spec = curve.base.spec
    L, W, B = buckets[0].shape
    G = swk.reduce_block(B)
    nb, log2G = B // G, G.bit_length() - 1
    (want_T, want_IW), plain_inner_ms = wall_ms(lambda: swk.bucket_reduce_plain(spec, buckets))
    cpu_T, cpu_IW = (tuple(t.cpu() for t in ts) for ts in (want_T, want_IW))
    want, plain_fold_ms = wall_ms(lambda: swk.reduce_fold_plain(spec, cpu_T, cpu_IW, G, c))
    T, IW = swk.bucket_reduce(spec, buckets)
    bad_inner = tuple_mismatches(T + IW, want_T + want_IW)
    total = swk.reduce_fold(spec, want_T, want_IW, G, c)
    bad_fold = tuple_mismatches(tuple(t.cpu() for t in total), want)
    law = CountingLaw(curve)
    gen_T, gen_IW = swk.inner_scan(law, buckets, G)
    inner_mads, law.mads = law.mads, 0
    gen = swk.outer_fold(law, gen_T, gen_IW, G, c)
    bad_general = tuple_mismatches(T + IW + total, gen_T + gen_IW + gen)[0]
    del want_T, want_IW, cpu_T, cpu_IW, gen_T, gen_IW
    coord = 4 * L  # bytes of one coordinate at one limb a word
    inner = with_bound(
        {"mismatches": bad_inner[0], "max_abs_err": bad_inner[1],
         "mismatches_vs_general_k7_k6": bad_general,
         "ms": device_ms(lambda: swk.bucket_reduce(spec, buckets), 5),
         "host_ms_per_call": time_ms(lambda: swk.bucket_reduce(spec, buckets), 5),
         "plain_ms": plain_inner_ms, "shape": [L, W, B], "block": G,
         "chain": {"dependent_adds": G + 1, "adds": 2 * G * W * nb}},
        W * B * 3 * coord + 2 * W * nb * 3 * coord, inner_mads)
    fold = with_bound(
        {"mismatches": bad_fold[0], "max_abs_err": bad_fold[1],
         "mismatches_vs_general_k7_k6": bad_general,
         "ms": device_ms(lambda: swk.reduce_fold(spec, T, IW, G, c), 5),
         "host_ms_per_call": time_ms(lambda: swk.reduce_fold(spec, T, IW, G, c), 5),
         "plain_ms": plain_fold_ms, "plain_device": "cpu", "shape": [L, W, nb], "c": c,
         "chain": {"dependent_adds": nb + 1 + W, "dependent_doublings": log2G + c * W}},
        2 * W * nb * 3 * coord + 3 * coord, law.mads)
    for k in (inner, fold):
        steps = sum(v for key, v in k["chain"].items() if key.startswith("dependent"))
        k["chain"]["us_per_dependent_step"] = k["ms"] * 1e3 / steps
    torch.cuda.synchronize()
    return {"bucket_reduce_inner": inner, "reduce_fold": fold}


def sw_case_failures(case: dict) -> list:
    bad = [c for c in case["ragged"] if c["double"] or c["add"] or c["madd"]]
    if case["madd_in_place_point_major_rows"] or case["add_broadcast_q"]:
        bad.append(case)
    return bad


def check_sw_on_curve(device, rng_host):
    """K6-K8 on 64 lanes of real G1 points: after to_affine the results are
    on the curve and equal the host group law."""
    from algebra_tpu_torch.curves.instances import bls12_381

    curve = bls12_381.g1(device)
    ps, qs = curve.random_host(rng_host, 64), curve.random_host(rng_host, 64)
    ps[7], qs[9] = None, None  # P = inf, Q = inf
    q11, q12 = curve.host_double(qs[11]), curve.host_double(qs[12])
    ps[11] = q11  # P = Q (Q below is 2 qs, Jacobian with z != 1)
    ps[12] = (q12[0], curve.base.spec.modulus - q12[1])  # P = -Q
    Pa, Qa = curve.from_host(ps), curve.from_host(qs)
    P, Q = curve.from_affine(Pa), curve.double(curve.from_affine(Qa))
    want_dbl = [curve.host_double(p) for p in ps]
    want_add = [curve.host_add(p, curve.host_double(q)) for p, q in zip(ps, qs)]
    want_madd = [curve.host_add(curve.host_double(q), p) for p, q in zip(ps, qs)]
    bad = 0
    for got, want in ((curve.double(P), want_dbl), (curve.add(P, Q), want_add),
                      (curve.add_mixed(Q, Pa), want_madd)):
        aff = curve.to_affine(got)
        if not bool(curve.is_on_curve(aff).all()):
            raise AssertionError("a group-law kernel left the curve")
        bad += sum(g != w for g, w in zip(curve.to_host(got), want))
    return {"lanes": 64, "host_oracle_mismatches": bad}


def sass_counts(words: int) -> dict:
    """Instructions in the compiled group-law kernels (cuobjdump -sass):
    for each kernel, all instructions and the IMAD-class ones (the 32-bit
    multiply-adds, wide and high forms included), also by form, since the
    compiler uses IMAD.MOV as a move.  Static counts: every branch of the
    kernel once, the loops unrolled as compiled; at 24 words the products
    are out-of-line functions, which are not counted."""
    import os
    import re

    from algebra_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build.library_path("sw_kernels", words)],
                          check=True, capture_output=True, text=True, timeout=300).stdout
    insn = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = next((k for k in ("jac_madd_round", "jac_double", "jac_add", "jac_madd")
                         if k in line), None)
            if name:
                counts[name] = {"instructions": 0, "imad": 0}
            continue
        m = insn.search(line) if name else None
        if m:
            op = m.group(1)
            counts[name]["instructions"] += 1
            if op.startswith("IMAD"):
                counts[name]["imad"] += 1
                forms = counts[name].setdefault("imad_by_form", {})
                forms[op] = forms.get(op, 0) + 1
    for c in counts.values():
        c["instructions_per_imad"] = c["instructions"] / max(c["imad"], 1)
    return counts


def ptxas_of(source: str, words: int, kernel: str, defines: tuple = ()) -> dict:
    """Registers and spill bytes that ptxas reported for ``kernel`` (a
    substring of the mangled name) in one library's build log (of the
    variant built with ``defines``, if any)."""
    from algebra_tpu_torch.kernels import build

    out, inside = {}, False
    for ln in build.build_log(source, words, defines).splitlines():
        if "entry function" in ln:
            inside = kernel in ln and (kernel != "jac_madd" or "jac_madd_round" not in ln)
        elif inside and "spill" in ln and "spill" not in out:
            out["spill"] = ln.strip()
        elif inside and "registers" in ln:
            out["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def sw_mads(spec, P, Q=None, inf2=None) -> int:
    """32-bit multiply-adds that these operands make the group-law kernel
    do, lane by lane on its branches: nothing for an infinity lane; the
    products up to H and r, then the doubling for a P = Q lane or the rest
    of the sum (K7 when Q is Jacobian, K8 when ``inf2`` is given; K6
    when Q is None)."""
    from algebra_tpu_torch.ops import mont_kernels as mk

    sq, mul = mads_per_square(spec), mads_per_product(spec)
    dbl = 5 * sq + 2 * mul
    if Q is None:
        return dbl * P[0][0].numel()
    zero = lambda t: (t == 0).all(dim=0)  # noqa: E731
    P, Q = [c.contiguous() for c in P], [c.contiguous() for c in Q]
    p_inf = zero(P[2])
    if inf2 is None:  # K7
        q_inf = zero(Q[2])
        prefix, rest = 2 * sq + 6 * mul, 3 * sq + 5 * mul
        z1z1, z2z2 = mk.mul(spec, P[2], P[2]), mk.mul(spec, Q[2], Q[2])
        h = mk.sub_plain(spec, mk.mul(spec, Q[0], z1z1), mk.mul(spec, P[0], z2z2))
        s = mk.sub_plain(spec, mk.mul(spec, Q[1], mk.mul(spec, P[2], z1z1)),
                         mk.mul(spec, P[1], mk.mul(spec, Q[2], z2z2)))
    else:  # K8
        q_inf = inf2
        prefix, rest = sq + 3 * mul, 3 * sq + 4 * mul
        z1z1 = mk.mul(spec, P[2], P[2])
        h = mk.sub_plain(spec, mk.mul(spec, Q[0], z1z1), P[0])
        s = mk.sub_plain(spec, mk.mul(spec, Q[1], mk.mul(spec, P[2], z1z1)), P[1])
    live = ~(p_inf | q_inf)
    same = live & zero(h) & zero(s)
    n_live, n_same = int(live.sum().item()), int(same.sum().item())
    return n_live * prefix + n_same * dbl + (n_live - n_same) * rest


def check_sw_main_shapes(device, rng, log_n: int, log_wide: int = 20):
    """The general K8, K7 and K6 on random coordinates with every lane
    valid, against their plain versions, with times and data-counted
    bounds.  K7 and K6 at the shapes the 2^log_n MSM launches them most
    often (K7: the inner step of the weighted reduction; K6: the Horner
    fold's batch (), and [L, 2^20] where the device sets the time).  K8 at
    the shape the lockstep round gave it before it had a kernel of its own
    ([L, W B], Q point-major gathered rows): no path calls it so now, but
    its earlier times were taken there (its path's shape is in
    ``check_tree_main_shapes``)."""
    from algebra_tpu_torch.curves.instances import bls12_381
    from algebra_tpu_torch.ops import msm, sw_kernels as swk

    spec = bls12_381.fq_spec
    L = spec.n_limbs
    n = 1 << log_n
    c, W = msm.plan_windows(255, msm.default_window_size(n), n, tree=False)
    B = 1 << (c - 1)
    G = swk.reduce_block(B)
    out = {}

    # K8 at [L, W B], Q from rows [W B, 2L] as the round gathers them
    P, Q, _ = sw_operands(spec, W * B, rng, device, planted=False)
    inf2 = torch.zeros(W * B, dtype=torch.bool, device=device)
    rows = torch.cat([Q[0].T, Q[1].T], dim=1).contiguous()
    aff = (rows[:, :L].T, rows[:, L:].T, inf2)
    want, plain_ms = wall_ms(lambda: swk.madd_plain(spec, *P, *aff))
    bad = tuple_mismatches(swk.madd(spec, P, aff), want)
    del want
    out["jac_madd"] = with_bound(
        {"mismatches": bad[0], "max_abs_err": bad[1], "plain_ms": plain_ms,
         "ms": device_ms(lambda: swk.madd(spec, P, aff), 10), "shape": [L, W * B]},
        (W * B) * (8 * L * 4 + 1), sw_mads(spec, P, aff, inf2))
    del P, Q, rows, aff

    # K7 at [L, W B / G], Q a strided slice as the reduction reads it
    m = W * B // G
    P, _, _ = sw_operands(spec, m, rng, device, planted=False)
    Qw = tuple(t.reshape(L, m, 2)[..., 1] for t in sw_operands(spec, 2 * m, rng, device,
                                                                planted=False)[0])
    want, plain_ms = wall_ms(lambda: swk.add_plain(spec, *P, *Qw))
    bad = tuple_mismatches(swk.add(spec, P, Qw), want)
    out["jac_add"] = with_bound(
        {"mismatches": bad[0], "max_abs_err": bad[1], "plain_ms": plain_ms,
         "ms": device_ms(lambda: swk.add(spec, P, Qw), 20),
         "host_ms_per_call": time_ms(lambda: swk.add(spec, P, Qw), 20), "shape": [L, m]},
        m * 9 * L * 4, sw_mads(spec, P, Qw))

    # K6 at batch () and at [L, 2^20]
    P1 = tuple(t[:, 0] for t in sw_operands(spec, 1, rng, device, planted=False)[0])
    want, plain1 = wall_ms(lambda: swk.double_plain(spec, *P1))
    bad1 = tuple_mismatches(swk.double(spec, P1), want)
    Pn, _, _ = sw_operands(spec, 1 << log_wide, rng, device, planted=False)
    want, plain_n = wall_ms(lambda: swk.double_plain(spec, *Pn))
    badn = tuple_mismatches(swk.double(spec, Pn), want)
    del want
    wide = with_bound({"ms": device_ms(lambda: swk.double(spec, Pn), 10),
                       "plain_ms": plain_n, "shape": [L, 1 << log_wide]},
                      (1 << log_wide) * 6 * L * 4, sw_mads(spec, Pn))
    out["jac_double"] = with_bound(
        {"mismatches": bad1[0] + badn[0], "max_abs_err": max(bad1[1], badn[1]),
         "plain_ms": plain1, "ms": device_ms(lambda: swk.double(spec, P1), 50),
         "host_ms_per_call": time_ms(lambda: swk.double(spec, P1), 50),
         "shape": [L], f"at_2^{log_wide}": wide},
        6 * L * 4, sw_mads(spec, P1))
    torch.cuda.synchronize()
    return out, {"c": c, "windows": W, "buckets": B, "block": G}


def round_kernel_at(curve, table, order_s, start, counts) -> dict:
    """K8's round kernel at the operands of a real lockstep MSM: every
    (window, bucket) lane, the recoded order, the signed table.  Round 0
    writes each bucket's first point into the empty accumulators (no
    products); round 1 is the first that adds, and is what is measured:
    against its plain version, in device time (launches queued behind a
    spin kernel, the accumulators updated in place), with its bound from
    the data: P read and written, the row, the order entry, first and
    count for a lane that adds; count, Z1 (and P written where Z1 = 0) for
    one that does not; the multiply-adds of the lanes that add."""
    from algebra_tpu_torch.ops import msm, sw_kernels as swk

    spec = curve.base.spec
    L, cb = spec.n_limbs, 4 * spec.n_limbs  # bytes a coordinate
    W, B = start.shape
    n = order_s.shape[1]
    order, first, count = msm.lane_runs(order_s, start, counts)
    acc = tuple(a.reshape(L, -1).contiguous() for a in curve.zero((W, B)))
    swk.madd_round(spec, acc, table, order, first, count, 0)
    r = 1
    want, plain_ms = wall_ms(lambda: swk.madd_round_plain(
        spec, tuple(a.clone() for a in acc), table, order, first, count, r))
    got = swk.madd_round(spec, tuple(a.clone() for a in acc), table, order, first, count, r)
    bad = tuple_mismatches(got, want)
    del want, got
    adds = count > r
    z_zero = (acc[2] == 0).all(dim=0) & ~adds
    n_adds, n_zero = int(adds.sum().item()), int(z_zero.sum().item())
    m = int(count.numel())
    n_bytes = n_adds * (8 * cb + 24) + (m - n_adds) * (8 + cb) + n_zero * 3 * cb
    x2, y2, inf2 = swk.round_operand(spec, table, order, first, count, r)
    mads = sw_mads(spec, acc, (x2, y2), inf2)
    del x2, y2, inf2
    timed = tuple(a.clone() for a in acc)
    ms = device_ms(lambda: swk.madd_round(spec, timed, table, order, first, count, r), 10)
    return with_bound({"mismatches": bad[0], "max_abs_err": bad[1], "ms": ms,
                       "plain_ms": plain_ms, "shape": [L, m], "round": r,
                       "lanes_adding": n_adds, "n_points": n, "table_rows": int(table.shape[0])},
                      n_bytes, mads)


# ---------------------------------------------------------------------------
# phase 8: the G1 MSM, checked against host oracles
# ---------------------------------------------------------------------------


def g1_bases_256(curve, rng_host):
    """256 random subgroup points made on the host: (host list, affine
    tensors [256])."""
    pts = curve.random_host(rng_host, 256)
    return pts, curve.from_host(pts)


def random_scalars(n: int, rng: np.random.Generator, modulus: int | None = None) -> np.ndarray:
    """uint32 [16, n] canonical limbs of full-width scalars below a 256-bit
    modulus (BLS12-381's r when None): every limb uniform but the top one,
    uniform below the modulus's top limb."""
    from algebra_tpu_torch.curves.instances import bls12_381

    modulus = bls12_381.R if modulus is None else modulus
    out = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    out[15] = rng.integers(0, modulus >> 240, size=n, dtype=np.uint32)
    return out


def tiled_oracle(curve, pts: list, scalars: np.ndarray):
    """sum_i s_i P_(i mod 256) on the host: the scalars summed per base
    (numpy limb sums, then Python ints mod r), 256 host multiplications."""
    n = scalars.shape[1]
    sums = scalars.reshape(16, n // 256, 256).sum(axis=1, dtype=np.uint64)
    r = curve.scalar_modulus
    acc = None
    for j, pt in enumerate(pts):
        k = sum(int(sums[i, j]) << (16 * i) for i in range(16)) % r
        acc = curve.host_add(acc, curve.host_mul(pt, k))
    return acc


def run_msm_path(device, rng, rng_host, gpu):
    """``entry.g1_msm`` at 2^16, 2^18 and 2^20 and ``msm.msm_chunks`` at
    2^24 on 256 tiled random bases, each against the host oracle; and
    2^16 distinct bases k_i G against (sum s_i k_i) G (the caller picks the
    bucket path)."""
    from algebra_tpu_torch import convert, entry
    from algebra_tpu_torch.curves.instances import bls12_381
    from algebra_tpu_torch.ops import mont_kernels as mk, msm

    curve = bls12_381.g1(device)
    pts, aff256 = g1_bases_256(curve, rng_host)
    host_scalars = random_scalars(1 << MSM_CHUNKED, rng)
    sizes, main_counts = [], None
    for log_n in MSM_LOGS + (MSM_CHUNKED,):
        n = 1 << log_n
        bases = tuple(a.repeat(1, n // 256) if a.ndim == 2 else a.repeat(n // 256)
                      for a in aff256)
        sc_np = host_scalars[:, :n]
        sc = convert.from_reference(sc_np, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mk.reset_launches()
        if log_n in MSM_LOGS:
            res, ms = wall_ms(lambda: entry.g1_msm(bases, sc, device=device))
            route = "entry.g1_msm"
        else:
            res, ms = wall_ms(lambda: msm.msm_chunks(curve, bases, sc,
                                                     chunk=1 << MSM_CHUNK))
            route = f"msm.msm_chunks(chunk=2^{MSM_CHUNK})"
        plan = dict(msm.stats)
        aff, affine_ms = wall_ms(lambda: curve.to_affine(res))
        counts = dict(mk.launches)  # the MSM and its result's normalisation
        peak = torch.cuda.max_memory_allocated()
        got = curve.to_host(res)
        want = tiled_oracle(curve, pts, sc_np)
        if got != want:
            raise AssertionError(f"G1 MSM at 2^{log_n} differs from the host oracle")
        if log_n == MSM_LOGS[-1]:
            main_counts = counts
        sizes.append({"log_n": log_n, "route": route, "ms": ms, "to_affine_ms": affine_ms,
                      "plan": plan, "launches": counts, "peak_memory_bytes": peak,
                      "host_oracle": "equal"})
        del bases, res, sc, aff
    # the 2^20 MSM again, phase by phase
    phases, round_k, reduce_k = msm_phase_times(
        curve, aff256, host_scalars[:, : 1 << MSM_LOGS[-1]], device)
    distinct, round_k[f"distinct_2^{MSM_DISTINCT}"] = run_distinct_bases(
        curve, rng, rng_host, device)
    shared = msm_vs_cpu(curve, aff256, host_scalars[:, : 1 << MSM_SHARED])
    idle = [k for k in ("mont_mul", "jac_madd_round", "bucket_reduce_inner", "reduce_fold",
                        "inv_gcd") if main_counts[k] <= 0]
    if idle:
        raise AssertionError(f"the main MSM launched no {idle}: {main_counts}")
    torch.cuda.synchronize()
    return main_counts, {"phase": "msm_path", "curve": "bls12_381.G1",
                         "sizes": sizes, f"phases_2^{MSM_LOGS[-1]}": phases,
                         f"distinct_bases_2^{MSM_DISTINCT}": distinct,
                         f"vs_cpu_2^{MSM_SHARED}": shared, "gpu": gpu}, round_k, reduce_k


def msm_vs_cpu(curve, aff256, sc_np, cpu=None) -> dict:
    """The lockstep MSM of the same bases and scalars on the card and on the
    CPU (the kernels' plain versions; ``cpu`` the curve there, BLS12-381 G1
    when None): the same adds in the same order, so the same words in
    Jacobian coordinates."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.curves.instances import bls12_381
    from algebra_tpu_torch.ops import msm

    n = sc_np.shape[1]
    bases = tuple(a.repeat(1, n // 256) if a.ndim == 2 else a.repeat(n // 256)
                  for a in aff256)
    got = msm.msm(curve, bases, convert.from_reference(sc_np, curve.device))
    plan = dict(msm.stats)
    cpu = bls12_381.g1("cpu") if cpu is None else cpu
    t0 = time.time()
    want = msm.msm(cpu, tuple(a.cpu() for a in bases), convert.from_reference(sc_np, "cpu"))
    cpu_s = time.time() - t0
    bad = tuple_mismatches(tuple(g.cpu() for g in got), want)
    if bad[0]:
        raise AssertionError(f"the MSM on the card differs from the CPU's in {bad[0]} "
                             f"Jacobian words")
    return {"n": n, "plan": plan, "jacobian_mismatches": bad[0], "cpu_seconds": cpu_s}


def msm_phase_times(curve, aff256, sc_np, device):
    """The 2^20 MSM's steps one by one, each synchronised (host clock):
    recode (digits, sort, runs), the signed row table, the bucket rounds
    (K8's round kernel, one launch a round), the weighted reduction's inner
    scan (``bucket_reduce_inner``, one launch), its outer scan and the
    Horner fold (``reduce_fold``, one launch), to_affine (K1, one K3);
    the bucket phase once under torch.profiler, with its launches
    by kernel (which must hold one round kernel a round and no other kernel
    as often); the reduction and fold once more, counted by the wrappers
    and under torch.profiler (which must show the two launches, at most
    three device kernels in all and no general K7 or K6); then the whole
    MSM once more under torch.profiler: device time by kernel and the share
    of the call's wall time the device was busy.  Returns (the steps, K8's
    round kernel at this MSM's operands, the tail's kernels at its
    buckets)."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.ops import msm

    n = sc_np.shape[1]
    x, y, inf = (a.repeat(1, n // 256) if a.ndim == 2 else a.repeat(n // 256)
                 for a in aff256)
    sc = convert.from_reference(sc_np, device)
    c, W = msm.plan_windows(curve.scalar_modulus.bit_length(), msm.default_window_size(n), n,
                            tree=False)
    out = {}
    (order_s, start, counts), out["recode_ms"] = wall_ms(lambda: msm.recode(sc, inf, c, W))
    table, out["table_ms"] = wall_ms(lambda: msm.signed_table(curve, x, y))
    buckets, out["rounds_ms"] = wall_ms(
        lambda: msm.bucket_sums(curve, table, order_s, start, counts))
    rounds = (msm.stats["rounds_lockstep"] + msm.stats["rounds_tail"]
              + msm.stats["rounds_top"])
    sums, out["reduction_ms"] = wall_ms(lambda: msm._weighted_reduce(curve, buckets))
    total, out["fold_ms"] = wall_ms(lambda: msm._horner_fold(curve, sums, c))
    out["reduction_fold_ms"] = out["reduction_ms"] + out["fold_ms"]
    _, out["to_affine_ms"] = wall_ms(lambda: curve.to_affine(total))
    _, out["to_affine_launches"] = launches_of(lambda: curve.to_affine(total))
    del sums

    def tail():
        return msm._horner_fold(curve, msm._weighted_reduce(curve, buckets), c)

    _, counts_tail = launches_of(tail)
    tail_prof = profile_call(tail, ("bucket_reduce_inner", "reduce_fold", "jac_add",
                                    "jac_double"), top=8)
    by_count = tail_prof["launches_by_kernel"]
    general = {k: v for k, v in by_count.items()
               if re.search(r"\bjac_(add|double)_kernel<", k)}
    if counts_tail != {"bucket_reduce_inner": 1, "reduce_fold": 1} or general \
            or sum(by_count.values()) > 3:
        raise AssertionError(f"the reduction and fold are not one launch each: wrappers "
                             f"{counts_tail}, kernels {by_count}")
    out["reduction_fold_launches"] = counts_tail
    out["reduction_fold_profiled"] = tail_prof
    reduce_k = reduce_kernels_at(curve, buckets, c)
    del buckets

    # the round kernel's launches by its wrapper's count, which is exact;
    # torch.profiler can drop a few kernels of a traced call (it recorded
    # 80 of 86 round kernels in one run), so its counts may fall short of
    # the calls made, never exceed them
    _, counts_bucket = launches_of(
        lambda: msm.bucket_sums(curve, table, order_s, start, counts))
    bucket_prof = profile_call(lambda: msm.bucket_sums(curve, table, order_s, start, counts),
                               ("jac_madd_round",), top=12)
    by_count = bucket_prof["launches_by_kernel"]
    n_round = sum(v for k, v in by_count.items() if "jac_madd_round_kernel" in k)
    other = {k: v for k, v in by_count.items() if "jac_madd_round_kernel" not in k}
    other_wrappers = {k: v for k, v in counts_bucket.items() if k != "jac_madd_round"}
    if counts_bucket.get("jac_madd_round") != rounds or n_round > rounds \
            or max([*other.values(), *other_wrappers.values()], default=0) >= rounds // 2:
        raise AssertionError(f"the bucket phase is not one launch a round: {rounds} rounds, "
                             f"wrappers {counts_bucket}, kernels {by_count}")
    out["bucket_phase_profiled"] = {**bucket_prof, "rounds": rounds,
                                    "launches_by_wrapper": counts_bucket}
    round_k = round_kernel_at(curve, table, order_s, start, counts)
    del order_s, start, counts, table

    out["profiled"] = profile_call(
        lambda: curve.to_affine(msm.msm(curve, (x, y, inf), sc)),
        ("jac_madd_round", "bucket_reduce_inner", "reduce_fold", "jac_add", "jac_double",
         "mont_mul", "inv_gcd"), top=12)
    return out, round_k, reduce_k


def run_distinct_bases(curve, rng, rng_host, device):
    """2^MSM_DISTINCT distinct bases P_i = k_i G, k_i = k0 + i d, made by
    host additions; the MSM against (sum s_i k_i mod r) G.  Returns (its
    line, K8's round kernel at its operands)."""
    from algebra_tpu_torch import convert, entry
    from algebra_tpu_torch.ops import msm

    n = 1 << MSM_DISTINCT
    r = curve.scalar_modulus
    k0, d = rng_host.randrange(1, r), rng_host.randrange(1, r)
    g = curve.generator_host
    step = curve.host_mul(g, d)
    pts = [curve.host_mul(g, k0)]
    for _ in range(n - 1):
        pts.append(curve.host_add(pts[-1], step))
    bases = curve.from_host(pts)
    sc_np = random_scalars(n, rng)
    res, ms = wall_ms(lambda: entry.g1_msm(bases, sc_np, device=device))
    s_ints = limbs_to_ints(sc_np)
    k = sum(s * ((k0 + i * d) % r) for i, s in enumerate(s_ints)) % r
    if curve.to_host(res) != curve.host_mul(g, k):
        raise AssertionError("G1 MSM on distinct bases differs from (sum s_i k_i) G")
    # K8's round kernel at this MSM's operands: 2^17 distinct table rows
    sc = convert.from_reference(sc_np, device)
    c, W = msm.plan_windows(255, msm.default_window_size(n), n, tree=False)
    order_s, start, counts = msm.recode(sc, bases[2], c, W)
    round_k = round_kernel_at(curve, msm.signed_table(curve, bases[0], bases[1]), order_s,
                              start, counts)
    return {"n": n, "ms": ms, "host_oracle": "equal"}, round_k


def run_small_group_paths(device, rng, rng_host, gpu):
    """The group law's other paths on 64 lanes against the host: scalar
    multiplication, mul_int, to/from affine, is_on_curve, equal; cofactor
    clearing and the subgroup check on curve points outside the subgroup;
    the MSM's n < 64 path."""
    from algebra_tpu_torch import convert, entry
    from algebra_tpu_torch.curves.instances import bls12_381

    curve = bls12_381.g1(device)
    F = curve.base
    done = []
    pts = curve.random_host(rng_host, 64)
    pts[3] = None
    aff = curve.from_host(pts)
    P = curve.from_affine(aff)
    sc_np = random_scalars(64, rng)
    ks = limbs_to_ints(sc_np)
    got = curve.to_host(curve.scalar_mul(P, convert.from_reference(sc_np, device)))
    if got != [curve.host_mul(p, k) if p else None for p, k in zip(pts, ks)]:
        raise AssertionError("scalar_mul differs from the host")
    done.append("scalar_mul 64 lanes")
    k = rng_host.randrange(1, 1 << 70)
    if curve.to_host(curve.mul_int(P, k)) != [curve.host_mul_raw(p, k) for p in pts]:
        raise AssertionError("mul_int differs from the host")
    done.append("mul_int")
    back, fin = curve.to_affine(P), ~aff[2]
    if not (torch.equal(back[0][:, fin], aff[0][:, fin])
            and torch.equal(back[1][:, fin], aff[1][:, fin]) and torch.equal(back[2], aff[2])):
        raise AssertionError("to_affine(from_affine(P)) != P")
    Q = curve.double(P)
    if not bool(curve.is_on_curve(curve.to_affine(Q)).all()):
        raise AssertionError("is_on_curve rejects 2P")
    if not bool(curve.equal(curve.add(P, P), Q).all()) or bool(curve.equal(P, Q)[5]):
        raise AssertionError("equal is wrong")
    done.append("to_affine/from_affine, is_on_curve, equal")

    # curve points outside the subgroup: random x until x^3 + 4 is a square
    x = convert.from_reference(random_limbs(F.spec, 256, rng), device)
    ok, y = F.sqrt(F.add(F.mul(F.square(x), x), F.constant(4)))
    off = (x[:, ok][:, :32], y[:, ok][:, :32],
           torch.zeros(32, dtype=torch.bool, device=device))
    if not bool(curve.is_on_curve(off).all()):
        raise AssertionError("sqrt gave points off the curve")
    Poff = curve.from_affine(off)
    inside = curve.is_in_correct_subgroup(Poff)
    host_inside = [curve.host_is_in_correct_subgroup(p) for p in curve.to_host(Poff)[:4]]
    cleared = curve.clear_cofactor(Poff)
    if bool(inside.any()) or any(host_inside) \
            or not bool(curve.is_in_correct_subgroup(cleared).all()):
        raise AssertionError("subgroup check or cofactor clearing is wrong")
    if not bool(curve.is_in_correct_subgroup(P).all()):
        raise AssertionError("subgroup points fail the subgroup check")
    done.append("clear_cofactor / is_in_correct_subgroup on 32 points outside G1")

    n = 40
    res = entry.g1_msm(curve.from_host(pts[:n]), sc_np[:, :n], device=device)
    want = None
    for p, kk in zip(pts[:n], ks[:n]):
        want = curve.host_add(want, curve.host_mul(p, kk))
    if curve.to_host(res) != want:
        raise AssertionError("the n < 64 MSM differs from the host")
    done.append("g1_msm n = 40 (scalar_mul path)")
    torch.cuda.synchronize()
    return {"phase": "small_group_paths", "passed": done, "gpu": gpu}


# ---------------------------------------------------------------------------
# phase 10: the affine tree's kernels (K11-K16) against their plain versions
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def bucket_path(tree: bool):
    """Run the MSM with ``config.msm_affine_tree`` = tree."""
    from algebra_tpu_torch import config

    saved = config.msm_affine_tree
    config.msm_affine_tree = tree
    try:
        yield
    finally:
        config.msm_affine_tree = saved


def check_row_kernels(spec, rng, device):
    """K13-K16 for one word count against their plain versions, for ragged
    n: pack, unpack (and the round trip), negate_y with y = 0 lanes, and
    expand_units for U = 1, 2, 8, 16 with the last unit ending at the last
    row of src and one starting on it (its rows past the end clipped)."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.ops import rows

    cases = []
    for n in (1, 31, 4097, 65539):
        x = convert.from_reference(random_limbs(spec, n, rng), device)
        y = convert.from_reference(random_limbs(spec, n, rng), device)
        y[:, :: 7] = 0
        inf = torch.from_numpy(rng.integers(0, 8, size=n) == 0).to(device)
        packed = rows.pack(spec, x, y, inf)
        k13 = tuple_mismatches(packed, rows.pack_plain(spec, x, y, inf))
        k14 = tuple_mismatches(rows.unpack(spec, packed), rows.unpack_plain(spec, packed))
        trip = tuple_mismatches(rows.unpack(spec, packed), (x, y, inf))
        neg = torch.from_numpy(rng.integers(0, 2, size=n) == 1).to(device)
        k15 = tuple_mismatches(rows.negate_y(spec, packed, neg),
                               rows.negate_y_plain(spec, packed, neg))
        k16 = 0
        for U in (1, 2, 8, 16):
            us = torch.from_numpy(rng.integers(0, n, size=1000)).to(device)
            us[-2], us[-1] = max(n - U, 0), n - 1
            k16 += tuple_mismatches(rows.expand_units(packed, us, U),
                                    rows.expand_units_plain(packed, us, U))[0]
        cases.append({"n": n, "pack": k13[0], "unpack": k14[0], "round_trip": trip[0],
                      "negate_y": k15[0], "expand_units": k16,
                      "max_abs_err": max(k13[1], k14[1], k15[1], trip[1])})
    torch.cuda.synchronize()
    return {"field": spec.name, "words": spec.n_words, "row_words": rows.row_width(spec),
            "ragged": cases}


def planted_pair_coords(spec, m: int, rng: np.random.Generator, device):
    """m pairs of random affine coordinates (x1, y1, i1, x2, y2, i2), [L, m]
    and bool [m], planted: pair 0 P = inf, 1 Q = inf, 2 both, 3 P = Q
    (tangent), 4 P = -Q, 5 equal y with x apart, 6 same x with
    y1 = y2 = 0 (opposite, not a tangent); a whole warp each of tangents
    (64-95), opposite points (96-127), equal y (128-159), P = inf
    (160-191).  The laws are polynomial identities, so the coordinates need
    no curve."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.ops import mont

    x1, y1, x2, y2 = (convert.from_reference(random_limbs(spec, m, rng), device)
                      for _ in range(4))
    i1 = torch.from_numpy(rng.integers(0, 8, size=m) == 0).to(device)
    i2 = torch.from_numpy(rng.integers(0, 8, size=m) == 0).to(device)
    lane = torch.arange(m, device=device)
    warp = lambda lo: (lane >= lo) & (lane < lo + 32)  # noqa: E731
    tangent = (lane == 3) | warp(64)
    opposite = (lane == 4) | warp(96)
    equal_y = (lane == 5) | warp(128)
    zero_y = lane == 6
    same = tangent | opposite | equal_y | zero_y
    i1 = torch.where(same, False, (i1 | (lane == 0) | (lane == 2) | warp(160)))
    i2 = torch.where(same, False, (i2 | (lane == 1) | (lane == 2)) & ~warp(160))
    x2 = torch.where(tangent | opposite | zero_y, x1, x2)
    y1 = torch.where(zero_y, 0, y1)
    y2 = torch.where(tangent | equal_y, y1,
                     torch.where(opposite, mont.neg(spec, y1), torch.where(zero_y, 0, y2)))
    return x1, y1, i1, x2, y2, i2


def level_operands(spec, m: int, rng: np.random.Generator, device):
    """Rows V [2m, RW] of the m planted pairs of ``planted_pair_coords``,
    and a valid mask [2m], 1 in 5 invalid, with a whole warp of invalid
    pairs (192-223)."""
    from algebra_tpu_torch.ops import rows

    x1, y1, i1, x2, y2, i2 = planted_pair_coords(spec, m, rng, device)

    def pair(a, b):  # a's and b's lanes interleaved
        return torch.stack([a, b], dim=-1).reshape(a.shape[:-1] + (2 * m,))

    V = rows.pack(spec, pair(x1, x2), pair(y1, y2), pair(i1, i2))
    valid = torch.from_numpy(rng.integers(0, 5, size=2 * m) != 0).to(device)
    valid[2 * 192 : 2 * 224] = False
    return V, valid


def check_level_kernels(spec, rng, device, a_mont=None, sizes=(4099, 300)):
    """K11 and K12 for one word count against their plain versions on
    planted pairs, with and without the valid mask, ragged numbers of
    pairs."""
    from algebra_tpu_torch.ops import mont_kernels as mk, sw_kernels as swk

    cases = []
    for m in sizes:
        V, valid = level_operands(spec, m, rng, device)
        for v in (valid, None):
            den = swk.affr_denom(spec, V, v)
            k11 = tuple_mismatches(den, swk.affr_denom_plain(spec, V, v))
            inv = mk.batch_inverse(spec, den)
            k12 = tuple_mismatches(swk.affr_post(spec, a_mont, V, v, inv),
                                   swk.affr_post_plain(spec, a_mont, V, v, inv))
            cases.append({"pairs": m, "valid": v is not None, "affr_denom": k11[0],
                          "affr_post": k12[0], "max_abs_err": max(k11[1], k12[1])})
    # V, valid and inv as views the wrappers copy: every other pair of a
    # wider level, and inv transposed from [m, L]
    m = sizes[0]
    W2, valid2 = level_operands(spec, 2 * m, rng, device)
    V = W2.reshape(m, 4, -1)[:, :2].reshape(2 * m, -1)
    v = valid2.reshape(m, 4)[:, :2].reshape(-1)
    Vc, vc = V.contiguous(), v.contiguous()
    den = swk.affr_denom(spec, V, v)
    k11 = tuple_mismatches(den, swk.affr_denom_plain(spec, Vc, vc))
    inv = mk.batch_inverse(spec, den).t().contiguous().t()
    k12 = tuple_mismatches(swk.affr_post(spec, a_mont, V, v, inv),
                           swk.affr_post_plain(spec, a_mont, Vc, vc, inv.contiguous()))
    cases.append({"pairs": m, "valid": True, "views": True, "affr_denom": k11[0],
                  "affr_post": k12[0], "max_abs_err": max(k11[1], k12[1])})
    torch.cuda.synchronize()
    return {"field": spec.name, "words": spec.n_words, "a": a_mont is not None,
            "cases": cases}


def check_level_on_curve(device, rng_host):
    """One level on 64 pairs of real G1 points (P + Q, P + P, P + (-P),
    P + inf, inf + inf), through the kernels and the blocked inversion,
    against the host group law."""
    from algebra_tpu_torch.curves.instances import bls12_381
    from algebra_tpu_torch.ops import mont, rows, sw_kernels as swk

    curve = bls12_381.g1(device)
    spec = curve.base.spec
    ps, qs = curve.random_host(rng_host, 64), curve.random_host(rng_host, 64)
    qs[5], ps[6] = ps[5], None
    qs[7] = (ps[7][0], spec.modulus - ps[7][1])
    ps[8] = qs[8] = None
    pts = [p for pq in zip(ps, qs) for p in pq]
    V = rows.pack(spec, *curve.from_host(pts))
    out = swk.affine_add_rows(spec, None, V, None, lambda d: mont.batch_inverse(spec, d))
    got = curve.to_host(curve.from_affine(rows.unpack(spec, out)))
    want = [curve.host_add(p, q) for p, q in zip(ps, qs)]
    return {"pairs": 64, "host_oracle_mismatches": sum(g != w for g, w in zip(got, want))}


def row_case_failures(cases) -> list:
    bad = []
    for case in cases:
        for c in case.get("ragged", case.get("cases", [])):
            counts = [v for k, v in c.items()
                      if k not in ("n", "pairs", "valid", "views", "max_abs_err")]
            if any(counts):
                bad.append(c)
    return bad


# ---------------------------------------------------------------------------
# phase 11: the G1 MSM through the affine tree
# ---------------------------------------------------------------------------


def capture_first_calls(run):
    """Run ``run()`` with the tree's row, level and mixed-add wrappers
    recording the operands of their first call (copies), for timing them at
    the shapes the path gives them; for ``madd`` the first call that adds,
    with an accumulator not all infinity (the finish's round 0 only copies
    each bucket's first row).  Returns (run's result, {name: operands})."""
    from algebra_tpu_torch.ops import rows, sw_kernels as swk

    def copy(a):
        if isinstance(a, tuple):
            return tuple(copy(t) for t in a)
        return a.clone() if isinstance(a, torch.Tensor) else a

    seen, saved = {}, []
    for mod, name in ((rows, "pack"), (rows, "negate_y"), (rows, "expand_units"),
                      (rows, "unpack"), (swk, "affr_denom"), (swk, "affr_post"),
                      (swk, "madd")):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def record(*args, _fn=fn, _name=name, **kw):
            if _name not in seen and (_name != "madd" or bool(args[1][2].any())):
                seen[_name] = copy(args)
            return _fn(*args, **kw)
        setattr(mod, name, record)
    try:
        out = run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return out, seen


def check_tree_main_shapes(seen: dict) -> dict:
    """K11-K16 on the operands the 2^20 tree MSM gave their first call, and
    the general K8 on those of the first finishing round that adds (Q the
    slot rows K14 unpacked, limb-major; its infinity mask ORed with
    counts <= r), against their plain versions, with device times, the
    plain versions' times, one PyTorch call's time where one computes the
    same function, and data-counted bounds."""
    from algebra_tpu_torch.ops import rows, sw_kernels as swk

    out = {}
    spec, P, aff = seen["madd"]
    L, inf2 = spec.n_limbs, aff[2]
    m = inf2.numel()
    want, plain_ms = wall_ms(lambda: swk.madd_plain(spec, *P, *aff))
    bad = tuple_mismatches(swk.madd(spec, P, aff), want)
    del want
    out["jac_madd"] = with_bound(
        {"mismatches": bad[0], "max_abs_err": bad[1], "plain_ms": plain_ms,
         "ms": device_ms(lambda: swk.madd(spec, P, aff), 10), "library_ms": None,
         "library_call": "none: no PyTorch call does field arithmetic on curve points",
         "shape": [L, *inf2.shape], "lanes_adding": int((~inf2).sum().item())},
        m * (8 * L * 4 + 1), sw_mads(spec, P, aff[:2], inf2))
    del P, aff
    spec, x, y, inf = seen["pack"]
    L, RW, n = spec.n_limbs, rows.row_width(spec), x.shape[1]
    pad = x.new_zeros((RW - 2 * L - 1, n))
    want, plain_ms = wall_ms(lambda: rows.pack_plain(spec, x, y, inf))
    bad = tuple_mismatches(rows.pack(spec, x, y, inf), want)
    lib = lambda: torch.cat([x, y, inf[None].int(), pad]).T.contiguous()  # noqa: E731
    bad_lib = tuple_mismatches(lib(), want)[0]
    out["pack"] = with_bound(
        {"mismatches": bad[0], "max_abs_err": bad[1], "plain_ms": plain_ms,
         "ms": device_ms(lambda: rows.pack(spec, x, y, inf), 20),
         "library_ms": device_ms(lib, 20), "library_call": "torch.cat + .T.contiguous()",
         "library_mismatches": bad_lib, "shape": [n, RW]},
        n * (2 * L * 4 + 1) + n * RW * 4, 0)

    spec, R = seen["unpack"]
    m = R.shape[0]
    want, plain_ms = wall_ms(lambda: rows.unpack_plain(spec, R))
    bad = tuple_mismatches(rows.unpack(spec, R), want)
    lib = lambda: (R[:, :L].T.contiguous(), R[:, L : 2 * L].T.contiguous(),  # noqa: E731
                   R[:, 2 * L] != 0)
    out["unpack"] = with_bound(
        {"mismatches": bad[0], "max_abs_err": bad[1], "plain_ms": plain_ms,
         "ms": device_ms(lambda: rows.unpack(spec, R), 50),
         "library_ms": device_ms(lib, 50), "library_call": "the .T slices, .contiguous()",
         "shape": [m, RW]},
        m * (2 * L + 1) * 4 + m * (2 * L * 4 + 1), 0)
    del R

    spec, R, neg = seen["negate_y"]
    m = R.shape[0]
    want, plain_ms = wall_ms(lambda: rows.negate_y_plain(spec, R, neg))
    bad = tuple_mismatches(rows.negate_y(spec, R, neg), want)
    del want
    out["negate_y"] = with_bound(
        {"mismatches": bad[0], "max_abs_err": bad[1], "plain_ms": plain_ms,
         "ms": device_ms(lambda: rows.negate_y(spec, R, neg), 10), "library_ms": None,
         "library_call": "none: no PyTorch call negates a 381-bit field element",
         "shape": [m, RW]},
        2 * m * RW * 4 + m, 0)
    del R, neg

    src, us, U = seen["expand_units"]
    S, mu = src.shape[0], us.shape[0]
    idx = (us[:, None] + torch.arange(U, device=us.device)).reshape(-1).clamp(0, S - 1)
    want, plain_ms = wall_ms(lambda: rows.expand_units_plain(src, us, U))
    bad = tuple_mismatches(rows.expand_units(src, us, U), want)
    lib = lambda: torch.index_select(src, 0, idx)  # noqa: E731
    bad_lib = tuple_mismatches(lib(), want)[0]
    del want
    out["expand_units"] = with_bound(
        {"mismatches": bad[0], "max_abs_err": bad[1], "plain_ms": plain_ms,
         "ms": device_ms(lambda: rows.expand_units(src, us, U), 10),
         "library_ms": device_ms(lib, 10),
         "library_call": "torch.index_select with the expanded row index",
         "library_mismatches": bad_lib, "shape": [mu * U, RW], "U": U, "src_rows": S},
        2 * mu * U * RW * 4 + mu * 8, 0)
    del src, us, idx

    spec, V, valid = seen["affr_denom"]
    m = V.shape[0] // 2
    want, plain_ms = wall_ms(lambda: swk.affr_denom_plain(spec, V, valid))
    bad = tuple_mismatches(swk.affr_denom(spec, V, valid), want)
    del want
    out["affr_denom"] = with_bound(
        {"mismatches": bad[0], "max_abs_err": bad[1], "plain_ms": plain_ms,
         "ms": device_ms(lambda: swk.affr_denom(spec, V, valid), 10), "library_ms": None,
         "library_call": "none: no PyTorch call does field arithmetic on curve points",
         "shape": [2 * m, RW]},
        2 * m * ((2 * L + 1) * 4 + 1) + m * L * 4, 0)

    spec, a_mont, V, valid, inv = seen["affr_post"]
    want, plain_ms = wall_ms(lambda: swk.affr_post_plain(spec, a_mont, V, valid, inv))
    bad = tuple_mismatches(swk.affr_post(spec, a_mont, V, valid, inv), want)
    del want
    x1, y1, i1, x2, y2, i2 = swk._row_pairs(spec, V, valid)
    _, dbl, _, _ = swk._aff_cases(spec, x1, y1, i1, x2, y2, i2)
    live = ~(i1 | i2)
    n_live, n_dbl = int(live.sum().item()), int((live & dbl).sum().item())
    del x1, y1, x2, y2
    sq, mul = mads_per_square(spec), mads_per_product(spec)
    out["affr_post"] = with_bound(
        {"mismatches": bad[0], "max_abs_err": bad[1], "plain_ms": plain_ms,
         "ms": device_ms(lambda: swk.affr_post(spec, a_mont, V, valid, inv), 10),
         "library_ms": None, "library_call": "none: as affr_denom",
         "shape": [2 * m, RW], "lanes_computed": n_live, "tangent_lanes": n_dbl},
        2 * m * ((2 * L + 1) * 4 + 1) + m * L * 4 + m * RW * 4,
        n_live * (2 * mul + sq) + n_dbl * sq)
    torch.cuda.synchronize()
    return out


def tree_phase_times(curve, aff256, sc_np, device) -> dict:
    """The 2^20 tree MSM step by step, each synchronised (host clock): the
    bucket phase (packing, per group: recode, stage A, the stages and the
    finish), the weighted reduction, the Horner fold, to_affine; then the
    whole MSM once under torch.profiler: device time by kernel, by the
    tree's kernel families, and the busy share of the call."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.ops import msm

    n = sc_np.shape[1]
    x, y, inf = (a.repeat(1, n // 256) if a.ndim == 2 else a.repeat(n // 256)
                 for a in aff256)
    sc = convert.from_reference(sc_np, device)
    out = {}
    with bucket_path(True):
        c, W = msm.plan_windows(255, msm.default_window_size(n), n)
        level_fn = msm._rows_level_fn(curve)
        buckets, out["tree_buckets_ms"] = wall_ms(
            lambda: msm.tree_bucket_sums(curve, (x, y, inf), sc, c, W, level_fn))
        sums, out["reduction_ms"] = wall_ms(lambda: msm._weighted_reduce(curve, buckets))
        total, out["fold_ms"] = wall_ms(lambda: msm._horner_fold(curve, sums, c))
        _, out["to_affine_ms"] = wall_ms(lambda: curve.to_affine(total))
        del buckets, sums

        families = ("expand_units", "negate_y", "pack", "unpack", "affr_denom", "affr_post",
                    "inv_prefix", "inv_gcd", "inv_backward", "jac_madd",
                    "bucket_reduce_inner", "reduce_fold", "jac_add", "jac_double", "mont_mul")
        out["profiled"] = profile_call(
            lambda: curve.to_affine(msm.msm(curve, (x, y, inf), sc)), families)
    return out


def run_tree_path(device, rng, rng_host, gpu):
    """``entry.g1_msm`` through the affine tree at 2^16, 2^18 and 2^20 and
    ``msm.msm_chunks`` at 2^24, on 256 tiled random bases, each against the
    host oracle, with the tree's plan, launches and peak memory; the 2^20
    MSM on both bucket paths in turns (lockstep, tree, tree, lockstep);
    the tree's steps and profile at 2^20; and its kernels at the shapes of
    their first call in the 2^20 MSM."""
    from algebra_tpu_torch import convert, entry
    from algebra_tpu_torch.curves.instances import bls12_381
    from algebra_tpu_torch.ops import mont_kernels as mk, msm

    curve = bls12_381.g1(device)
    pts, aff256 = g1_bases_256(curve, rng_host)
    host_scalars = random_scalars(1 << MSM_CHUNKED, rng)
    sizes, main_counts = [], None
    with bucket_path(True):
        for log_n in MSM_LOGS + (MSM_CHUNKED,):
            n = 1 << log_n
            bases = tuple(a.repeat(1, n // 256) if a.ndim == 2 else a.repeat(n // 256)
                          for a in aff256)
            sc_np = host_scalars[:, :n]
            sc = convert.from_reference(sc_np, device)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mk.reset_launches()
            if log_n in MSM_LOGS:
                res, ms = wall_ms(lambda: entry.g1_msm(bases, sc, device=device))
                route = "entry.g1_msm"
            else:
                res, ms = wall_ms(lambda: msm.msm_chunks(curve, bases, sc,
                                                         chunk=1 << MSM_CHUNK))
                route = f"msm.msm_chunks(chunk=2^{MSM_CHUNK})"
            counts = dict(mk.launches)
            plan = dict(msm.stats)
            peak = torch.cuda.max_memory_allocated()
            if curve.to_host(res) != tiled_oracle(curve, pts, sc_np):
                raise AssertionError(f"tree MSM at 2^{log_n} differs from the host oracle")
            if log_n == MSM_LOGS[-1]:
                main_counts = counts
            sizes.append({"log_n": log_n, "route": route, "ms": ms, "plan": plan,
                          "launches": counts, "peak_memory_bytes": peak,
                          "host_oracle": "equal"})
            del bases, res, sc
    n = 1 << MSM_LOGS[-1]
    bases = tuple(a.repeat(1, n // 256) if a.ndim == 2 else a.repeat(n // 256)
                  for a in aff256)
    sc = convert.from_reference(host_scalars[:, :n], device)
    turns = []
    for tree in (False, True, True, False):
        with bucket_path(tree):
            res, ms = wall_ms(lambda: entry.g1_msm(bases, sc, device=device))
        turns.append({"path": "tree" if tree else "lockstep", "ms": ms})
        if curve.to_host(res) != tiled_oracle(curve, pts, host_scalars[:, :n]):
            raise AssertionError("2^20 MSM differs from the host oracle in the turns")
    phases = tree_phase_times(curve, aff256, host_scalars[:, :n], device)
    with bucket_path(True):
        _, seen = capture_first_calls(lambda: entry.g1_msm(bases, sc, device=device))
    del bases, sc
    kernels = check_tree_main_shapes(seen)
    del seen
    need = ("pack", "unpack", "negate_y", "expand_units", "affr_denom", "affr_post",
            "inv_prefix", "inv_gcd", "inv_backward", "jac_madd", "bucket_reduce_inner",
            "reduce_fold")
    idle = [k for k in need if main_counts[k] <= 0]
    if idle:
        raise AssertionError(f"the tree MSM launched no {idle}: {main_counts}")
    torch.cuda.synchronize()
    line = {"phase": "tree_path", "curve": "bls12_381.G1", "sizes": sizes,
            f"turns_2^{MSM_LOGS[-1]}": turns, f"phases_2^{MSM_LOGS[-1]}": phases,
            "kernel_shapes": kernels, "gpu": gpu}
    return main_counts, line, kernels


# ---------------------------------------------------------------------------
# phase 12: the affine addition's kernels (K9, K10) against their plain
# versions
# ---------------------------------------------------------------------------


def aff_operands(spec, n: int, rng: np.random.Generator, device):
    """P = (x1, y1, i1), Q = (x2, y2, i2) [L, n] from
    ``planted_pair_coords`` and y-negation masks neg1, neg2 [n], 1 in 3
    set at random, planted: neg2 over the opposite points' warp (96-127),
    which makes them tangents, neg1 over 192-255 and neg2 over 224-255."""
    x1, y1, i1, x2, y2, i2 = planted_pair_coords(spec, n, rng, device)
    lane = torch.arange(n, device=device)
    neg1 = torch.from_numpy(rng.integers(0, 3, size=n) == 0).to(device)
    neg2 = torch.from_numpy(rng.integers(0, 3, size=n) == 0).to(device)
    neg1 = neg1 | ((lane >= 192) & (lane < 256))
    neg2 = neg2 | ((lane >= 96) & (lane < 128)) | ((lane >= 224) & (lane < 256))
    return (x1, y1, i1), (x2, y2, i2), neg1, neg2


def check_aff_kernels(spec, rng, device, a_mont=None):
    """K9 and K10 for one field against their plain versions on ragged n
    with planted lanes and warps, with and without the masks; and once with
    P a strided view, Q one point for every lane (lane stride 0) and a
    strided mask."""
    from algebra_tpu_torch.ops import mont_kernels as mk, sw_kernels as swk

    def compare(P, Q, negs, Pp, Qp, negs_p):
        den = swk.aff_denom(spec, P, Q, *negs)
        k9 = tuple_mismatches(den, swk.aff_denom_plain(spec, *Pp, *Qp, *negs_p))
        inv = mk.batch_inverse(spec, den.reshape(spec.n_limbs, -1)).reshape(den.shape)
        k10 = tuple_mismatches(swk.aff_post(spec, a_mont, P, Q, inv, *negs),
                               swk.aff_post_plain(spec, a_mont, *Pp, *Qp, inv, *negs_p))
        return {"aff_denom": k9[0], "aff_post": k10[0], "max_abs_err": max(k9[1], k10[1])}

    cases = []
    for n in (1, 31, 4097, 65539):
        P, Q, neg1, neg2 = aff_operands(spec, n, rng, device)
        for negs in ((neg1, neg2), (None, None)):
            cases.append({"n": n, "masks": negs[0] is not None,
                          **compare(P, Q, negs, P, Q, negs)})
    n = 4097
    P, Q, neg1, _ = aff_operands(spec, 2 * n, rng, device)
    Ps = tuple(c[..., ::2] for c in P)
    Q1 = tuple(c[..., 5] for c in Q)
    Q1e = (Q1[0][:, None].expand(-1, n), Q1[1][:, None].expand(-1, n), Q1[2].expand(n))
    strided = compare(Ps, Q1, (neg1[::2], None), tuple(c.contiguous() for c in Ps), Q1e,
                      (neg1[::2].contiguous(), None))
    # a [64, 64] batch from P [L, 1, 64], Q [L, 64, 1] and masks [64, 1],
    # [1, 64]: no operand's batch axes collapse to one stride, so the wrapper
    # copies all eight, and each copy must live until the launch
    P, Q, neg1, neg2 = aff_operands(spec, 64, rng, device)
    Pb = (P[0][:, None, :], P[1][:, None, :], P[2][None, :])
    Qb = (Q[0][:, :, None], Q[1][:, :, None], Q[2][:, None])
    negs_b = (neg1[:, None], neg2[None, :])
    full = lambda c: c.expand(c.shape[:-2] + (64, 64)).contiguous()  # noqa: E731
    grid = compare(Pb, Qb, negs_b, tuple(map(full, Pb)), tuple(map(full, Qb)),
                   tuple(map(full, negs_b)))
    torch.cuda.synchronize()
    return {"field": spec.name, "words": spec.n_words, "a": a_mont is not None,
            "cases": cases, "strided_broadcast": strided, "broadcast_2d": grid}


def aff_case_failures(case: dict) -> list:
    return [c for c in case["cases"] + [case["strided_broadcast"], case["broadcast_2d"]]
            if c["aff_denom"] or c["aff_post"]]


def cube_root_of_one(curve) -> int:
    """A nontrivial cube root of one in the base field (p = 1 mod 3): with
    it (beta x, y) is on an a = 0 curve beside (x, y), with the same y."""
    p = curve.base.spec.modulus
    return curve.glv["beta"] if curve.glv else pow(2, (p - 1) // 3, p)


def check_aff_on_curve(curve, rng_host) -> dict:
    """``SWCurve.affine_add`` on 64 pairs of real points (P + Q, P + P,
    P + (-P), P + inf, inf + Q, inf + inf, equal y), with and without
    masks, through K9, the blocked inversion and K10, against the host
    group law."""
    p = curve.base.spec.modulus
    ps, qs = curve.random_host(rng_host, 64), curve.random_host(rng_host, 64)
    qs[5], ps[6], qs[7], ps[9] = ps[5], None, None, None
    qs[8] = (ps[8][0], p - ps[8][1])
    qs[9] = None
    beta = cube_root_of_one(curve)
    qs[10] = (ps[10][0] * beta % p, ps[10][1])  # equal y, x apart
    neg1 = [i % 3 == 0 for i in range(64)]
    neg2 = [i % 5 == 0 or i == 8 for i in range(64)]  # lane 8: P + (-(-P)) = 2P
    dev = curve.device
    flip = lambda pt, m: pt if pt is None or not m else (pt[0], (p - pt[1]) % p)  # noqa: E731
    bad = 0
    for masks in (False, True):
        n1 = torch.tensor(neg1, device=dev) if masks else None
        n2 = torch.tensor(neg2, device=dev) if masks else None
        x, y, inf = curve.affine_add(curve.from_host(ps), curve.from_host(qs),
                                     curve.base.batch_inverse, n1, n2)
        got = [None if i else (a, b) for a, b, i in
               zip(curve.base.to_int(x), curve.base.to_int(y), inf.tolist())]
        want = [curve.host_add(flip(a, masks and m1), flip(b, masks and m2))
                for a, b, m1, m2 in zip(ps, qs, neg1, neg2)]
        bad += sum(g != w for g, w in zip(got, want))
    return {"curve": curve.name, "pairs": 64, "host_oracle_mismatches": bad}


# ---------------------------------------------------------------------------
# phase 13: batch point ops and scalar multiplication (BASELINE configs[2])
# ---------------------------------------------------------------------------

AFF_LOG = 20  # entry.batch_affine_add: 2^20 pairs of each curve
GLV_LOG = 18  # entry.scalar_mul (GLV) and WnafContext.mul on secp256k1
FIXED_LOG, FIXED_C = 20, 8  # entry.fixed_base_msm
TE_LOG = 16  # entry.scalar_mul on Jubjub
HOST_SAMPLE = 1024
AFF_SAMPLE = 1 << 14
AFF_KERNELS = ("aff_denom", "aff_post", "inv_prefix", "inv_gcd", "inv_backward")
PATH_FAMILIES = AFF_KERNELS + ("jac_double", "jac_add", "mont_mul")


def launches_of(fn):
    """(result, launches by kernel) of one call of ``fn``: the counts are
    set to 0 just before it and read just after."""
    from algebra_tpu_torch.ops import mont_kernels as mk

    mk.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in mk.launches.items() if v}


def measure(fn, need: tuple) -> tuple:
    """(result, {ms, ms_runs, launches, peak_memory_bytes, profiled}) of a
    path's call: launches by kernel of a first (warm) call, which must
    launch each kernel of ``need``, the median of 3 synchronised calls
    after it and their peak device memory, one more call under
    torch.profiler."""
    out, counts = launches_of(fn)
    idle = [k for k in need if not counts.get(k)]
    if idle:
        raise AssertionError(f"a call of the scalar-mul path launched no {idle}: {counts}")
    torch.cuda.reset_peak_memory_stats()
    ms, runs = median_ms(fn)
    peak = torch.cuda.max_memory_allocated()
    return out, {"ms": ms, "ms_runs": runs, "launches": counts, "peak_memory_bytes": peak,
                 "profiled": profile_call(fn, PATH_FAMILIES, top=8)}


def host_pool(curve, rng_host, n: int = 256) -> list:
    """n distinct subgroup points k0 G + i d G made on the host by
    additions (one host multiplication costs ~20-40 ms, an addition
    ~0.1 ms)."""
    r = curve.scalar_modulus
    g = curve.generator_host
    step = curve.host_mul(g, rng_host.randrange(1, r))
    pts = [curve.host_mul(g, rng_host.randrange(1, r))]
    for _ in range(n - 1):
        pts.append(curve.host_add(pts[-1], step))
    return pts


def host_muls(curve, pts: list, ks: list) -> list:
    """k P for each pair on the host, in projective coordinates with one
    inversion at the end (Jacobian madd-2007-bl / dbl-2009-l for a = 0
    short-Weierstrass, extended madd/dbl-2008-hwcd for twisted Edwards):
    an oracle of its own, ~10x faster than the curve's affine
    ``host_mul``, which it is held against on its first 4 lanes."""
    p = curve.base.spec.modulus
    te = hasattr(curve, "d_host")

    def sw_mul(pt, k):
        if pt is None or k % curve.scalar_modulus == 0:
            return None
        x2, y2 = pt
        X, Y, Z = 1, 1, 0
        for bit in bin(k)[2:]:
            if Z:
                A, B = X * X % p, Y * Y % p
                C = B * B % p
                D = 2 * ((X + B) ** 2 - A - C) % p
                E = 3 * A % p
                Z = 2 * Y * Z % p
                X = (E * E - 2 * D) % p
                Y = (E * (D - X) - 8 * C) % p
            if bit == "1":
                if Z == 0:
                    X, Y, Z = x2, y2, 1
                    continue
                Z1Z1 = Z * Z % p
                H = (x2 * Z1Z1 - X) % p
                rr = 2 * (y2 * Z * Z1Z1 - Y) % p
                if H == 0:  # the sum is 2 P or infinity: the affine law
                    zi = pow(Z, -1, p)
                    acc = curve.host_add((X * zi * zi % p, Y * zi * zi * zi % p), pt)
                    if acc is None:
                        X, Y, Z = 1, 1, 0
                    else:
                        X, Y, Z = acc[0], acc[1], 1
                    continue
                HH = H * H % p
                I = 4 * HH % p
                J, V = H * I % p, X * I % p
                X3 = (rr * rr - J - 2 * V) % p
                Y = (rr * (V - X3) - 2 * Y * J) % p
                Z = ((Z + H) ** 2 - Z1Z1 - HH) % p
                X = X3
        if Z == 0:
            return None
        zi = pow(Z, -1, p)
        return (X * zi * zi % p, Y * zi * zi * zi % p)

    def te_mul(pt, k):
        a, d = curve.a_host % p, curve.d_host % p
        x2, y2 = pt
        t2 = x2 * y2 % p
        X, Y, T, Z = 0, 1, 0, 1
        for bit in bin(k % curve.scalar_modulus)[2:]:
            A, B = X * X % p, Y * Y % p
            C = 2 * Z * Z % p
            D = a * A % p
            E = ((X + Y) ** 2 - A - B) % p
            G = (D + B) % p
            F, H = (G - C) % p, (D - B) % p
            X, Y, T, Z = E * F % p, G * H % p, E * H % p, F * G % p
            if bit == "1":
                A, B = X * x2 % p, Y * y2 % p
                C = d * T % p * t2 % p
                E = ((X + Y) * (x2 + y2) - A - B) % p
                F, G, H = (Z - C) % p, (Z + C) % p, (B - a * A) % p
                X, Y, T, Z = E * F % p, G * H % p, E * H % p, F * G % p
        zi = pow(Z, -1, p)
        return (X * zi % p, Y * zi % p)

    out = [(te_mul if te else sw_mul)(pt, int(k)) for pt, k in zip(pts, ks)]
    if out[:4] != [curve.host_mul(pt, k) for pt, k in zip(pts[:4], ks[:4])]:
        raise AssertionError("the projective host oracle disagrees with host_mul")
    return out


def tile(aff, n: int):
    """A [256] affine batch tiled to n lanes."""
    return tuple(a.repeat(1, n // 256) if a.ndim == 2 else a.repeat(n // 256) for a in aff)


def host_points(curve, x, y, inf, lanes) -> list:
    """The affine lanes ``lanes`` of (x, y, inf) as host points."""
    idx = torch.as_tensor(lanes, device=x.device)
    xs = curve.base.to_int(x[:, idx])
    ys = curve.base.to_int(y[:, idx])
    return [None if i else (a, b) for a, b, i in zip(xs, ys, inf[idx].tolist())]


def batch_affine_add_at_scale(curve, key: str, pts: list, rng, device):
    """``entry.batch_affine_add`` on 2^AFF_LOG pairs drawn from 256 host
    points, their negatives and their images (beta x, y) (equal y), with
    ~1 % of lanes planted: tangents 0.3 %, opposite points 0.3 %, equal y
    0.1 %, P = inf, Q = inf and both 0.1 % each; then with random masks.
    Every lane against the plain versions on the card (the same inversion
    of the plain denominators), the planted lanes and AFF_SAMPLE others
    against the host."""
    from algebra_tpu_torch import entry
    from algebra_tpu_torch.ops import sw_kernels as swk

    spec = curve.base.spec
    p, n = spec.modulus, 1 << AFF_LOG
    beta = cube_root_of_one(curve)
    table = pts + [(x, (p - y) % p) for x, y in pts] + [(x * beta % p, y) for x, y in pts]
    tx, ty, _ = curve.from_host(table)
    a = rng.integers(0, 256, size=n)
    b = rng.integers(0, 256, size=n)
    kind = rng.integers(0, 1000, size=n)
    b = np.where(kind < 3, a, np.where(kind < 6, a + 256, np.where(kind == 6, a + 512, b)))
    i1_np, i2_np = (kind == 7) | (kind == 9), (kind == 8) | (kind == 9)
    ai, bi = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
    P = (tx[:, ai].contiguous(), ty[:, ai].contiguous(), torch.from_numpy(i1_np).to(device))
    Q = (tx[:, bi].contiguous(), ty[:, bi].contiguous(), torch.from_numpy(i2_np).to(device))
    neg1 = torch.from_numpy(rng.integers(0, 2, size=n) == 1).to(device)
    neg2 = torch.from_numpy(rng.integers(0, 2, size=n) == 1).to(device)
    lanes = np.union1d(np.flatnonzero(kind < 10), rng.choice(n, AFF_SAMPLE, replace=False))
    out = {"pairs": n, "planted": int((kind < 10).sum()), "host_lanes": len(lanes)}
    for masks in (False, True):
        negs = (neg1, neg2) if masks else (None, None)
        res, stats = measure(lambda: entry.batch_affine_add(P, Q, curve=key, neg1=negs[0],
                                                            neg2=negs[1], device=device),
                             AFF_KERNELS)
        den = swk.aff_denom_plain(spec, *P, *Q, *negs)
        want, plain_ms = wall_ms(lambda: swk.aff_post_plain(
            spec, None, *P, *Q, curve.base.batch_inverse(den), *negs))
        bad = tuple_mismatches(res, want)
        del den, want
        n1 = neg1.cpu().numpy() if masks else np.zeros(n, bool)
        n2 = neg2.cpu().numpy() if masks else np.zeros(n, bool)
        flip = lambda pt, m: pt if not m else (pt[0], (p - pt[1]) % p)  # noqa: E731
        want_host = [curve.host_add(None if i1_np[j] else flip(table[a[j]], n1[j]),
                                    None if i2_np[j] else flip(table[b[j]], n2[j]))
                     for j in lanes]
        got_host = host_points(curve, *res, lanes)
        host_bad = sum(g != w for g, w in zip(got_host, want_host))
        out["masks" if masks else "no_masks"] = {
            **stats, "plain_ms": plain_ms, "plain_mismatches": bad[0],
            "host_oracle_mismatches": host_bad, "inf_out": int(res[2].sum().item())}
        if bad[0] or host_bad:
            raise AssertionError(f"batch_affine_add on {key} ({'masks' if masks else 'no masks'})"
                                 f" differs: {bad[0]} words from the plain version, "
                                 f"{host_bad} lanes from the host")
    return out, (P, Q)


def aff_kernel_shapes(spec, P, Q) -> dict:
    """K9 and K10 at the operands of a 2^AFF_LOG batch_affine_add (no
    masks): device times, the plain versions' times, data-counted bounds."""
    from algebra_tpu_torch.ops import mont_kernels as mk, sw_kernels as swk

    L, n = spec.n_limbs, P[0].shape[1]
    want, plain_ms = wall_ms(lambda: swk.aff_denom_plain(spec, *P, *Q))
    den = swk.aff_denom(spec, P, Q)
    bad = tuple_mismatches(den, want)
    out = {"aff_denom": with_bound(
        {"mismatches": bad[0], "max_abs_err": bad[1], "plain_ms": plain_ms,
         "ms": device_ms(lambda: swk.aff_denom(spec, P, Q), 20), "library_ms": None,
         "library_call": "none: no PyTorch call adds curve points", "shape": [L, n]},
        n * (4 * L * 4 + 2) + n * L * 4, 0)}
    inv = mk.batch_inverse(spec, den)
    want, plain_ms = wall_ms(lambda: swk.aff_post_plain(spec, None, *P, *Q, inv))
    bad = tuple_mismatches(swk.aff_post(spec, None, P, Q, inv), want)
    del want
    _, dbl, _, _ = swk._aff_cases(spec, P[0], P[1], P[2], Q[0], Q[1], Q[2])
    live = ~(P[2] | Q[2])
    n_live, n_dbl = int(live.sum().item()), int((live & dbl).sum().item())
    sq, mul = mads_per_square(spec), mads_per_product(spec)
    out["aff_post"] = with_bound(
        {"mismatches": bad[0], "max_abs_err": bad[1], "plain_ms": plain_ms,
         "ms": device_ms(lambda: swk.aff_post(spec, None, P, Q, inv), 20),
         "library_ms": None, "library_call": "none: no PyTorch call adds curve points",
         "shape": [L, n], "lanes_computed": n_live, "tangent_lanes": n_dbl},
        n * (5 * L * 4 + 2) + n * (2 * L * 4 + 1), n_live * (2 * mul + sq) + n_dbl * sq)
    torch.cuda.synchronize()
    return out


def glv_at_scale(curve, pts: list, rng, device) -> dict:
    """``entry.scalar_mul`` on 2^GLV_LOG secp256k1 points (256 host points
    tiled) with full-width scalars: the GLV route, every lane in affine
    against ``SWCurve.scalar_mul(use_glv=False)`` on the card, HOST_SAMPLE
    lanes against the host; both routes timed."""
    from algebra_tpu_torch import convert, entry

    n = 1 << GLV_LOG
    bases = tile(curve.from_host(pts), n)
    sc_np = random_scalars(n, rng, curve.scalar_modulus)
    sc = convert.from_reference(sc_np, device)
    res, glv_stats = measure(lambda: entry.scalar_mul(bases, sc, device=device),
                             ("jac_double", "jac_add", "mont_mul"))
    P = curve.from_affine(bases)
    res_plain, plain_stats = measure(lambda: curve.scalar_mul(P, sc, use_glv=False),
                                     ("jac_double", "jac_add"))
    bad = tuple_mismatches(curve.to_affine(res), curve.to_affine(res_plain))[0]
    general = general_k6_k7_at(capture_glv_calls(
        lambda: entry.scalar_mul(bases, sc, device=device)))
    lanes = rng.choice(n, HOST_SAMPLE, replace=False)
    want = host_muls(curve, [pts[j % 256] for j in lanes], limbs_to_ints(sc_np[:, lanes]))
    got = host_points(curve, *curve.to_affine(res), lanes)
    host_bad = sum(g != w for g, w in zip(got, want))
    if bad or host_bad:
        raise AssertionError(f"GLV scalar_mul differs: {bad} words from the plain route, "
                             f"{host_bad} lanes from the host")
    bad_general = {k: v for k, v in general.items() if v["mismatches"]}
    if bad_general:
        raise AssertionError(f"K6/K7 disagree at GLV's operands: {bad_general}")
    return {"n": n, "glv": glv_stats, "double_and_add": plain_stats,
            "mismatches_vs_double_and_add": bad, "host_lanes": HOST_SAMPLE,
            "host_oracle_mismatches": host_bad, "kernel_shapes": general}


def capture_glv_calls(run) -> dict:
    """Run ``run()`` with ``sw_kernels.add`` and ``double`` recording the
    operands (copies) of their first call whose P is not all infinity:
    where GLV gives the general K7 and K6 their work."""
    from algebra_tpu_torch.ops import sw_kernels as swk

    seen, saved = {}, {name: getattr(swk, name) for name in ("add", "double")}

    def wrap(name, fn):
        def record(spec, P, *rest, **kw):
            if name not in seen and bool((P[2] != 0).any()):
                seen[name] = (spec, tuple(t.clone() for t in P),
                              *(tuple(t.clone() for t in r) for r in rest))
            return fn(spec, P, *rest, **kw)
        return record

    for name, fn in saved.items():
        setattr(swk, name, wrap(name, fn))
    try:
        run()
    finally:
        for name, fn in saved.items():
            setattr(swk, name, fn)
    return seen


def general_k6_k7_at(seen: dict) -> dict:
    """The general K7 and K6 at the operands ``capture_glv_calls`` saw:
    against their plain versions, in device time, with their bounds from
    the data."""
    from algebra_tpu_torch.ops import sw_kernels as swk

    out = {}
    spec, P, Q = seen["add"]
    L, n = spec.n_limbs, P[0][0].numel()
    want, plain_ms = wall_ms(lambda: swk.add_plain(spec, *P, *Q))
    bad = tuple_mismatches(swk.add(spec, P, Q), want)
    out["jac_add"] = with_bound(
        {"mismatches": bad[0], "max_abs_err": bad[1], "plain_ms": plain_ms,
         "ms": device_ms(lambda: swk.add(spec, P, Q), 10), "shape": list(P[0].shape),
         "field": spec.name}, n * 9 * L * 4, sw_mads(spec, P, Q))
    spec, P = seen["double"]
    want, plain_ms = wall_ms(lambda: swk.double_plain(spec, *P))
    bad = tuple_mismatches(swk.double(spec, P), want)
    out["jac_double"] = with_bound(
        {"mismatches": bad[0], "max_abs_err": bad[1], "plain_ms": plain_ms,
         "ms": device_ms(lambda: swk.double(spec, P), 10), "shape": list(P[0].shape),
         "field": spec.name}, n * 6 * L * 4, sw_mads(spec, P))
    torch.cuda.synchronize()
    return out


def wnaf_at_scale(curve, pts: list, rng_host, device) -> dict:
    """``WnafContext(curve, 4).mul`` on 2^GLV_LOG tiled points with one host
    scalar: every lane against the host (256 host multiplications)."""
    from algebra_tpu_torch.ops import wnaf

    n = 1 << GLV_LOG
    bases = tile(curve.from_host(pts), n)
    k = rng_host.randrange(1, curve.scalar_modulus)
    ctx = wnaf.WnafContext(curve, 4)
    P = curve.from_affine(bases)
    res, stats = measure(lambda: ctx.mul(P, k), ("jac_double", "jac_add"))
    want = tile(curve.from_host(host_muls(curve, pts, [k] * len(pts))), n)
    got = curve.to_affine(res)
    bad = tuple_mismatches(got, want)[0]
    if bad:
        raise AssertionError(f"wNAF mul differs from the host in {bad} words")
    return {"n": n, "w": 4, "digits": len(wnaf.wnaf_digits(k, 4)), **stats,
            "host_oracle_mismatches": bad, "host_lanes": n}


def fixed_base_at_scale(curve, rng, device) -> dict:
    """``entry.fixed_base_msm`` for the generator, c = FIXED_C, on
    2^FIXED_LOG full-width scalars (the table build timed apart),
    HOST_SAMPLE lanes against the host."""
    from algebra_tpu_torch import convert, entry
    from algebra_tpu_torch.ops import fixed_base

    n = 1 << FIXED_LOG
    sc_np = random_scalars(n, rng, curve.scalar_modulus)
    sc = convert.from_reference(sc_np, device)
    res, stats = measure(lambda: entry.fixed_base_msm(sc, FIXED_C, device=device),
                         ("jac_double", "jac_add"))
    table = lambda: fixed_base.window_table(curve, curve.generator(), FIXED_C, 256)  # noqa: E731
    table()
    table_ms, table_runs = median_ms(table)
    lanes = rng.choice(n, HOST_SAMPLE, replace=False)
    want = host_muls(curve, [curve.generator_host] * len(lanes), limbs_to_ints(sc_np[:, lanes]))
    got = host_points(curve, *curve.to_affine(res), lanes)
    host_bad = sum(g != w for g, w in zip(got, want))
    if host_bad:
        raise AssertionError(f"fixed-base MSM differs from the host in {host_bad} lanes")
    return {"n": n, "c": FIXED_C, **stats, "table_ms": table_ms, "table_ms_runs": table_runs,
            "host_lanes": HOST_SAMPLE, "host_oracle_mismatches": host_bad}


def jubjub_at_scale(rng, rng_host, device) -> dict:
    """``entry.scalar_mul`` on 2^TE_LOG Jubjub points (256 host points
    tiled) with full-width scalars below the subgroup order, HOST_SAMPLE
    lanes against the host; clear_cofactor and the subgroup check on 64
    points outside the subgroup (P + (0, -1), of order 2r)."""
    from algebra_tpu_torch import convert, entry
    from algebra_tpu_torch.curves.instances import ed_on_bls12_381

    jub = ed_on_bls12_381.curve(device)
    q = jub.base.spec.modulus
    pts = host_pool(jub, rng_host)
    n = 1 << TE_LOG
    bases = tile(jub.from_host(pts), n)
    sc_np = random_scalars(n, rng, jub.scalar_modulus)
    sc = convert.from_reference(sc_np, device)
    res, stats = measure(lambda: entry.scalar_mul(bases, sc, curve="ed_on_bls12_381",
                                                  device=device), ("mont_mul",))
    lanes = rng.choice(n, HOST_SAMPLE, replace=False)
    x, y = jub.to_affine(res)
    idx = torch.as_tensor(lanes, device=device)
    got = list(zip(jub.base.to_int(x[:, idx]), jub.base.to_int(y[:, idx])))
    want = host_muls(jub, [pts[j % 256] for j in lanes], limbs_to_ints(sc_np[:, lanes]))
    host_bad = sum(g != w for g, w in zip(got, want))
    off = [jub.host_add(pt, (0, q - 1)) for pt in pts[:64]]
    P_off = jub.from_affine(jub.from_host(off))
    outside = jub.is_in_correct_subgroup(P_off)
    cleared = jub.clear_cofactor(P_off)
    subgroup_ok = (not bool(outside.any()) and bool(jub.is_in_correct_subgroup(cleared).all())
                   and not any(jub.host_is_in_correct_subgroup(pt) for pt in off[:4])
                   and jub.to_host(cleared)[:4] == [jub.host_mul_raw(pt, 8) for pt in off[:4]])
    if host_bad or not subgroup_ok:
        raise AssertionError(f"Jubjub scalar_mul differs from the host in {host_bad} lanes, "
                             f"or the subgroup check / cofactor clearing is wrong")
    return {"n": n, **stats, "host_lanes": HOST_SAMPLE, "host_oracle_mismatches": host_bad,
            "cofactor_and_subgroup_checks_on_64_points_outside": "passed"}


def run_inverse_bottoms(device, rng, tree_pairs: int, gpu) -> dict:
    """K3 through safegcd and through the Fermat ladder, in turns, at the
    bottoms the main paths give it (``gcd_vs_ladder``): the one Z of a G1
    MSM's ``to_affine`` (12 words), the division path's bottom (8), the
    bottoms of the 2^AFF_LOG ``batch_affine_add`` of secp256k1 (8) and G1
    (12), that of the 2^20 tree MSM's first halving level (12; its
    ``tree_pairs`` pairs), and a 2^14 batch at 24 words."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.curves.instances import bls12_381, mnt4_753, secp256k1
    from algebra_tpu_torch.ops import mont_kernels as mk

    def bottom(n):
        plan = mk.level_plan(n)
        return plan[-1][2] if plan else n

    cases = [
        ("msm_to_affine_one_lane", bls12_381.fq_spec, 1),
        (f"division_2^{LOG_MAIN}_bottom", bls12_381.fr_spec, bottom(1 << LOG_MAIN)),
        (f"batch_affine_add_2^{AFF_LOG}_secp256k1_bottom", secp256k1.fq_spec,
         bottom(1 << AFF_LOG)),
        (f"batch_affine_add_2^{AFF_LOG}_g1_bottom", bls12_381.fq_spec, bottom(1 << AFF_LOG)),
        (f"tree_2^{MSM_LOGS[-1]}_level_0_bottom", bls12_381.fq_spec, bottom(tree_pairs)),
        ("mnt4_753_fq_2^14", mnt4_753.fq_spec, 1 << 14),
    ]
    out = {}
    for key, spec, n in cases:
        a_np = gcd_operands(spec, n, rng) if n > 1 else random_limbs(spec, 1, rng)
        out[key] = gcd_vs_ladder(spec, convert.from_reference(a_np, device))
    return {"phase": "inverse_bottoms", "cases": out, "gpu": gpu}


def run_scalar_mul_path(device, rng, rng_host, gpu):
    """BASELINE configs[2] through the entry points a user calls:
    ``entry.batch_affine_add`` on secp256k1 and BLS12-381 G1,
    ``entry.scalar_mul`` (GLV) and ``WnafContext.mul`` on secp256k1,
    ``entry.fixed_base_msm`` on secp256k1's generator and
    ``entry.scalar_mul`` on Jubjub, each checked exactly; the launch counts
    are set to 0 just before each path's first call and read just after it
    (``measure``), and each path must launch its kernels there.  Then K9
    and K10 at the shapes of the 2^20 batch_affine_add calls; the counts of
    the secp256k1 call without masks stand for them on the kernels line."""
    from algebra_tpu_torch.curves.instances import bls12_381, secp256k1

    secp, g1 = secp256k1.g1(device), bls12_381.g1(device)
    pools = {"secp256k1": (secp, host_pool(secp, rng_host)),
             "bls12_381_g1": (g1, host_pool(g1, rng_host))}
    line = {"phase": "scalar_mul_path"}
    shapes = {}
    for key, (curve, pts) in pools.items():
        line[f"batch_affine_add_{key}"], shapes[key] = batch_affine_add_at_scale(
            curve, key, pts, rng, device)
    line["glv_scalar_mul_secp256k1"] = glv_at_scale(secp, pools["secp256k1"][1], rng, device)
    line["wnaf_secp256k1"] = wnaf_at_scale(secp, pools["secp256k1"][1], rng_host, device)
    line["fixed_base_msm_secp256k1"] = fixed_base_at_scale(secp, rng, device)
    line["scalar_mul_jubjub"] = jubjub_at_scale(rng, rng_host, device)
    counts = line["batch_affine_add_secp256k1"]["no_masks"]["launches"]
    kernels = aff_kernel_shapes(secp.base.spec, *shapes["secp256k1"])
    g1_kernels = aff_kernel_shapes(g1.base.spec, *shapes["bls12_381_g1"])
    for name in kernels:
        kernels[name]["at_bls12_381_g1"] = g1_kernels[name]
    bad = {k: v for k, v in kernels.items() if v["mismatches"] or v["at_bls12_381_g1"]["mismatches"]}
    if bad:
        raise AssertionError(f"K9/K10 disagree at the path's shapes: {bad}")
    line.update({"kernel_shapes": kernels, "gpu": gpu})
    return counts, line, kernels


# ---------------------------------------------------------------------------
# phase 15: the BLS12-381 pairing (BASELINE configs[3]) and its kernel K17
# ---------------------------------------------------------------------------

PAIRING_LOGS = (12, 8)  # entry.pairing at 4096 pairs, then 256
PAIRING_POOL = 64  # distinct G1 and G2 points made on the host, tiled
DOT_WIDE_LOG = 16  # K17's widest check, n = 2^16
PAIRING_FAMILIES = ("mont_dot", "mont_mul", "inv_prefix", "inv_gcd", "inv_backward")

# e(g1, g2) over BLS12-381: the canonical Fq coordinates of Fq12's
# ((c0.c0, c0.c1), (c1.c0, c1.c1), (c2.c0, c2.c1)), c0 then c1, as the JAX
# package computes them (algebra_tpu.curves.instances.bls12_381.pairing()
# .pairing on the two generators, run on the CPU).
GT_G1_G2 = (
    ((0x1250EBD871FC0A92A7B2D83168D0D727272D441BEFA15C503DD8E90CE98DB3E7B6D194F60839C508A84305AACA1789B6,
      0x089A1C5B46E5110B86750EC6A532348868A84045483C92B7AF5AF689452EAFABF1A8943E50439F1D59882A98EAA0170F),
     (0x1368BB445C7C2D209703F239689CE34C0378A68E72A6B3B216DA0E22A5031B54DDFF57309396B38C881C4C849EC23E87,
      0x193502B86EDB8857C273FA075A50512937E0794E1E65A7617C90D8BD66065B1FFFE51D7A579973B1315021EC3C19934F),
     (0x01B2F522473D171391125BA84DC4007CFBF2F8DA752F7C74185203FCCA589AC719C34DFFBBAAD8431DAD1C1FB597AAA5,
      0x018107154F25A764BD3C79937A45B84546DA634B8F6BE14A8061E55CCEBA478B23F7DACAA35C8CA78BEAE9624045B4B6)),
    ((0x19F26337D205FB469CD6BD15C3D5A04DC88784FBB3D0B2DBDEA54D43B2B73F2CBB12D58386A8703E0F948226E47EE89D,
      0x06FBA23EB7C5AF0D9F80940CA771B6FFD5857BAAF222EB95A7D2809D61BFE02E1BFD1B68FF02F0B8102AE1C2D5D5AB1A),
     (0x11B8B424CD48BF38FCEF68083B0B0EC5C81A93B330EE1A677D0D15FF7B984E8978EF48881E32FAC91B93B47333E2BA57,
      0x03350F55A7AEFCD3C31B4FCB6CE5771CC6A0E9786AB5973320C806AD360829107BA810C5A09FFDD9BE2291A0C25A99A2),
     (0x04C581234D086A9902249B64728FFD21A189E87935A954051C7CDBA7B3872629A4FAFC05066245CB9108F0242D0FE3EF,
      0x0F41E58663BF08CF068672CBD01A7EC73BACA4D72CA93544DEFF686BFD6DF543D48EAA24AFE47E1EFDE449383B676631)),
)


def pairing_instance(curve: str):
    """The port's instance module of a pairing-friendly curve by name."""
    from algebra_tpu_torch.curves.instances import bls12_381, bn254

    return {"bls12_381": bls12_381, "bn254": bn254}[curve]


def path_dot_weights(curve: str = "bls12_381") -> dict:
    """The weight matrices (W, square mask) K17 gets on the pairing path
    of ``curve``, by name: an Fp12 product, an Fp12 square, the line
    product (``mul_by_014`` on an M-twist, ``mul_by_034`` on a D-twist),
    the Miller loop's G2 doubling step's last wave and its add step's last
    wave.  Taken from ``mont_kernels.dot``'s calls in one run of each
    operation on the CPU at one lane."""
    from algebra_tpu_torch.ops import mont_kernels as mk

    inst = pairing_instance(curve)
    F12, F2 = inst.fq12("cpu"), inst.fq2("cpu")
    ctx = inst.pairing("cpu")
    rng = random.Random(SEED)
    p = inst.P

    def r2():
        return F2.from_int([(rng.randrange(p), rng.randrange(p))])

    a12 = (tuple(r2() for _ in range(3)), tuple(r2() for _ in range(3)))
    b12 = (tuple(r2() for _ in range(3)), tuple(r2() for _ in range(3)))
    r = (r2(), r2(), r2())
    line = "fp12_mul_by_014" if ctx.twist_type == "M" else "fp12_mul_by_034"
    line_fn = F12.mul_by_014 if ctx.twist_type == "M" else F12.mul_by_034
    runs = {"fp12_mul": lambda: F12.mul(a12, b12),
            "fp12_square": lambda: F12.square(a12),
            line: lambda: line_fn(a12, r[0], r[1], r[2]),
            "g2_double_step": lambda: ctx._double_step(r, (1,)),
            "g2_add_step": lambda: ctx._add_step(r, (r[1], r[2]))}
    out = {}
    orig = mk.dot
    for name, run in runs.items():
        calls = []

        def record(spec, A, B, W, square_mask=None):
            calls.append((np.asarray(W, np.int64), list(square_mask or [False] * A.shape[1])))
            return orig(spec, A, B, W, square_mask)

        mk.dot = record
        try:
            run()
        finally:
            mk.dot = orig
        out[name] = calls[-1]
    return out


def dot_operands(spec, K: int, n: int, square_mask, rng: np.random.Generator, device):
    """A, B int32 [L, K, n] on the card, random below p but for the first
    lanes, which cross 0, 1, p - 1 and one in Montgomery form; B = A on
    square pairs."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.bigint import batch_int_to_limbs

    L, p = spec.n_limbs, spec.modulus
    edge = batch_int_to_limbs([0, 1, p - 1, spec.R % p], L)
    A = random_limbs(spec, K * n, rng).reshape(L, K, n)
    B = random_limbs(spec, K * n, rng).reshape(L, K, n)
    m = min(n, 4)
    for k in range(K):
        A[:, k, :m] = edge[:, (np.arange(m) + k) % 4]
        B[:, k, :m] = edge[:, (np.arange(m) * 3 + k) % 4]
    sq = np.asarray(square_mask, bool)
    B[:, sq] = A[:, sq]
    return convert.from_reference(A, device), convert.from_reference(B, device)


def mass_limit_weights(spec, K: int, n_out: int, rng: np.random.Generator) -> np.ndarray:
    """Random signed weights, every row at the field's mass limit."""
    from algebra_tpu_torch.ops import mont

    limit = mont.dot_mass_limit(spec)
    W = rng.integers(-3, 4, size=(n_out, K))
    W[:, 0] = 0
    for o in range(n_out):
        rest = int(np.abs(W[o]).sum())
        W[o, 0] = (limit - rest) * (1 if o % 2 else -1)
    return W


def dot_host_oracle(spec, A, B, W, lanes: int) -> int:
    """Wrong words of K17 on its first ``lanes`` lanes against Python ints."""
    from algebra_tpu_torch.ops import mont_kernels as mk

    L, K, _ = A.shape
    p = spec.modulus
    r_inv = pow(spec.R, -1, p)
    a = [limbs_to_ints(A[:, k, :lanes].cpu().numpy()) for k in range(K)]
    b = [limbs_to_ints(B[:, k, :lanes].cpu().numpy()) for k in range(K)]
    got = mk.dot(spec, A[:, :, :lanes].contiguous(), B[:, :, :lanes].contiguous(), W)
    bad = 0
    for o in range(W.shape[0]):
        want = [sum(int(W[o, k]) * a[k][i] * b[k][i] for k in range(K)) * r_inv % p
                for i in range(lanes)]
        bad += sum(g != w for g, w in zip(limbs_to_ints(got[:, o].cpu().numpy()), want))
    return bad


def check_dot_kernels(rng, device) -> list:
    """K17 against ``dot_plain`` bit for bit at 8, 12 and 24 words: the
    pairing path's weight matrices and random signed weights at the mass
    limit, square masks, edge operands, n = 1 and 4097 (and 2^16 for the
    Fp12 product and the random weights at 12 words), and operands given
    as views the wrapper copies; 16 lanes of the Fp12 product against
    Python ints."""
    from algebra_tpu_torch.curves.instances import bls12_381, mnt4_753
    from algebra_tpu_torch.ops import mont_kernels as mk

    weights = path_dot_weights()
    cases = []
    for spec in (bls12_381.fr_spec, bls12_381.fq_spec, mnt4_753.fq_spec):
        mats = dict(weights)
        K = 20
        mats["random_at_mass_limit"] = (mass_limit_weights(spec, K, 6, rng),
                                        [k % 5 == 1 for k in range(K)])
        for name, (W, sq) in mats.items():
            sizes = [1, 4097]
            if spec is bls12_381.fq_spec and name in ("fp12_mul", "random_at_mass_limit"):
                sizes.append(1 << DOT_WIDE_LOG)
            for n in sizes:
                A, B = dot_operands(spec, W.shape[1], n, sq, rng, device)
                if n == 4097:  # views: a lane slice of a wider array
                    A = torch.cat([A, A], dim=2)[:, :, :n]
                    B = torch.cat([B, B], dim=2)[:, :, :n]
                got = mk.dot(spec, A, B, W, sq)
                torch.cuda.synchronize()
                bad, err = mismatches(got, mk.dot_plain(spec, A, B, W, sq))
                case = {"field": spec.name, "words": spec.n_words, "weights": name,
                        "n_out": int(W.shape[0]), "K": int(W.shape[1]), "n": n,
                        "square_pairs": int(np.sum(sq)), "mismatches": bad,
                        "max_abs_err": err}
                if name == "fp12_mul" and spec is bls12_381.fq_spec and n == 4097:
                    case["host_oracle_lanes"] = 16
                    case["host_oracle_mismatches"] = dot_host_oracle(spec, A, B, W, 16)
                cases.append(case)
                del A, B, got
    return cases


def dot_kernel_at(device, rng, curve: str = "bls12_381") -> dict:
    """K17 at an Fp12 product of ``curve`` over 4096 lanes: against its
    plain version, device ms, plain ms, and its bound: the bytes of A, B
    and the output, and one product for each of the K pairs a lane."""
    from algebra_tpu_torch.ops import mont_kernels as mk

    spec = pairing_instance(curve).fq_spec
    W, sq = path_dot_weights(curve)["fp12_mul"]
    n, L = 1 << PAIRING_LOGS[0], spec.n_limbs
    K, n_out = W.shape[1], W.shape[0]
    A, B = dot_operands(spec, K, n, sq, rng, device)
    want, plain_ms = wall_ms(lambda: mk.dot_plain(spec, A, B, W, sq))
    _, plain_ms = wall_ms(lambda: mk.dot_plain(spec, A, B, W, sq))
    bad, err = mismatches(mk.dot(spec, A, B, W, sq), want)
    n_sq = int(np.sum(sq))
    mads = n * ((K - n_sq) * mads_per_product(spec) + n_sq * mads_per_square(spec))
    n_bytes = n * (2 * K + n_out) * L * 4
    entries = int(np.count_nonzero(W))
    return with_bound({"mismatches": bad, "max_abs_err": err, "plain_ms": plain_ms,
                       "ms": device_ms(lambda: mk.dot(spec, A, B, W, sq), 20),
                       "shape": [L, K, n], "n_out": n_out, "weight_entries": entries,
                       "products_a_lane_computed": entries, "products_a_lane_needed": K,
                       "max_row_weight_mass": int(np.abs(W).sum(axis=1).max()),
                       "field": spec.name}, n_bytes, mads)


def pairing_inputs(n: int, pools):
    """Host points for n lanes: lane i < n/2 pairs a P_j with Q_j, lane
    n/2 + i pairs P_j with a Q_j (j = i mod the pool), so the halves must
    agree lane for lane; lanes 0 and n/2 have P at infinity, 1 and n/2 + 1
    Q at infinity."""
    ps, qs, aps, aqs = pools
    m = len(ps)
    half = n // 2
    P = [aps[i % m] for i in range(half)] + [ps[i % m] for i in range(half)]
    Q = [qs[i % m] for i in range(half)] + [aqs[i % m] for i in range(half)]
    for i in (0, half):
        P[i] = None
    for i in (1, half + 1):
        Q[i] = None
    return P, Q


def pairing_at_scale(log_n: int, pools, device, curve: str = "bls12_381",
                     cpu_lanes: int = 1) -> tuple:
    """``entry.pairing``, ``multi_pairing`` and ``prepare_g2`` over
    ``curve`` on n = 2^log_n pairs, every check of the path, ``cpu_lanes``
    lanes of each half (from lane 2 on) against the CPU: (launch counts of
    the first pairing call, the line)."""
    from algebra_tpu_torch import convert, entry
    from algebra_tpu_torch.fields.field import tree_map
    from algebra_tpu_torch.pairing.common import field_prod

    inst = pairing_instance(curve)
    n = 1 << log_n
    half = n // 2
    g1c, g2c = inst.g1("cpu"), inst.g2("cpu")
    P_host, Q_host = pairing_inputs(n, pools)
    p_aff = convert.points_from_reference(g1c.from_host(P_host), device)
    q_aff = convert.points_from_reference(g2c.from_host(Q_host), device)
    F12 = inst.fq12(device)
    ctx = inst.pairing(device)

    e, counts = launches_of(lambda: entry.pairing(p_aff, q_aff, curve=curve, device=device))
    idle = [k for k in ("mont_dot", "mont_mul", "inv_gcd") if not counts.get(k)]
    if idle:
        raise AssertionError(f"a pairing call launched no {idle}: {counts}")
    vals = F12.to_int(e)
    one = F12.to_int(F12.one((1,)))[0]
    planted = {0, 1, half, half + 1}
    checks = {
        "bilinear_lanes_disagreeing": sum(vals[i] != vals[half + i] for i in range(half)),
        "lanes_equal_to_one_outside_infinity": sum(
            vals[i] == one for i in range(n) if i not in planted),
        "infinity_lanes_not_one": sum(vals[i] != one for i in planted),
    }
    lanes = [i for lo in (2, half + 2) for i in range(lo, lo + cpu_lanes)]
    cpu = entry.pairing([P_host[i] for i in lanes], [Q_host[i] for i in lanes],
                        curve=curve, device="cpu")
    checks["lanes_differing_from_the_cpu"] = sum(
        g != vals[i] for g, i in zip(inst.fq12("cpu").to_int(cpu), lanes))
    neg_P = [None if pt is None else (pt[0], inst.P - pt[1]) for pt in P_host]
    p_neg = convert.points_from_reference(g1c.from_host(neg_P), device)
    cat = lambda u, v: tree_map(lambda x, y: torch.cat([x, y], dim=-1), u, v)  # noqa: E731
    cancel = entry.multi_pairing(cat(p_aff, p_neg), cat(q_aff, q_aff), curve=curve,
                                 device=device)
    checks["multi_pairing_with_negations_is_one"] = F12.to_int(cancel) == one
    multi = entry.multi_pairing(p_aff, q_aff, curve=curve, device=device)
    checks["multi_pairing_equals_product_of_lanes"] = (
        F12.to_int(multi) == F12.to_int(field_prod(F12, e)))
    prepared = entry.prepare_g2(q_aff, curve=curve, device=device)
    checks["prepared_lanes_differing"] = sum(
        g != w for g, w in zip(
            F12.to_int(entry.pairing(p_aff, prepared, curve=curve, device=device)), vals))

    f = ctx.miller_loop(p_aff, q_aff)
    times = {name: median_ms(fn)[0] for name, fn in (
        ("miller_loop_ms", lambda: ctx.miller_loop(p_aff, q_aff)),
        ("final_exponentiation_ms", lambda: ctx.final_exponentiation(f)),
        ("multi_pairing_ms",
         lambda: entry.multi_pairing(p_aff, q_aff, curve=curve, device=device)),
        ("prepare_g2_ms", lambda: entry.prepare_g2(q_aff, curve=curve, device=device)),
        ("pairing_prepared_ms",
         lambda: entry.pairing(p_aff, prepared, curve=curve, device=device)))}
    torch.cuda.reset_peak_memory_stats()
    times["pairing_ms"], times["pairing_ms_runs"] = median_ms(
        lambda: entry.pairing(p_aff, q_aff, curve=curve, device=device))
    times["pairing_ms_a_pair"] = times["pairing_ms"] / n
    peak = torch.cuda.max_memory_allocated()
    line = {"n": n, "checks": checks, "cpu_lanes": lanes, **times, "launches": counts,
            "launches_by_family": {k: counts.get(k, 0) for k in PAIRING_FAMILIES},
            "peak_memory_gb": peak / 1e9,
            "profiled": profile_call(
                lambda: entry.pairing(p_aff, q_aff, curve=curve, device=device),
                PAIRING_FAMILIES, top=8)}
    bad = [k for k, v in checks.items() if (not v if isinstance(v, bool) else v)]
    if bad:
        raise AssertionError(f"the {curve} pairing path failed {bad}: {checks}")
    return counts, line


def run_pairing_path(device, rng, rng_host, gpu) -> tuple:
    """BASELINE configs[3] through the entry points: e(g1, g2) against the
    pinned value on the card, then ``pairing_at_scale`` at 4096 and 256
    pairs; then K17 at the Fp12 product's shape.  Returns (the 4096-pair
    pairing's launch counts, the line, K17's row)."""
    from algebra_tpu_torch import entry
    from algebra_tpu_torch.curves.instances import bls12_381

    g1c, g2c = bls12_381.g1("cpu"), bls12_381.g2("cpu")
    gen = entry.pairing([g1c.generator_host], [g2c.generator_host], device=device)
    pinned = bls12_381.fq12(device).to_int(gen)[0] == GT_G1_G2
    if not pinned:
        raise AssertionError("e(g1, g2) differs from the pinned value")
    a = rng_host.randrange(1, bls12_381.R)
    ps, qs = host_pool(g1c, rng_host, PAIRING_POOL), host_pool(g2c, rng_host, PAIRING_POOL)
    pools = (ps, qs, [g1c.host_mul(pt, a) for pt in ps], [g2c.host_mul(pt, a) for pt in qs])
    line = {"phase": "pairing_path", "e_g1_g2_equals_pinned": pinned, "pool": PAIRING_POOL}
    counts = None
    for log_n in PAIRING_LOGS:
        c, line[f"pairs_2^{log_n}"] = pairing_at_scale(log_n, pools, device)
        counts = counts or c
    k17 = dot_kernel_at(device, rng)
    if k17["mismatches"]:
        raise AssertionError(f"K17 disagrees at the Fp12 product's shape: {k17}")
    line.update({"kernel_shape": k17, "gpu": gpu})
    return counts, line, k17


BN254_MSM_LOG = 20  # the BN254 G1 MSM: 2^20 scalars on 256 tiled bases
BN254_CPU_LANES = 4  # lanes of each half of a pairing batch also paired on the CPU
BN254_MSM_SHARED = 9  # the BN254 lockstep MSM on the card and on the CPU, words compared
BN254_INF_BASE = 7  # the base of the 256 at infinity
BN254_FAMILIES = ("mont_dot", "mont_mul", "inv_gcd", "jac_madd_round",
                  "bucket_reduce_inner", "reduce_fold")

# e(g1, g2) over BN254, in the order of GT_G1_G2, as the JAX package computes
# it (algebra_tpu.curves.instances.bn254.pairing().pairing on the two
# generators, run on the CPU).
BN254_GT_G1_G2 = (
    ((0x262B253FEDA94CFE0DA01BDE280A3ED6F87E5FEB898578B55E1F63739D870E95,
      0x02E02D2CC795A2000A1B1F823879ABBD397C4DEA0918ED66B49D34B48EFB8A4A),
     (0x13A9F2D6E29B128DA5B1AD44B31977935FD2957387ECB1FC4E135402FDBD1DE0,
      0x040BA9FA500F1A5C4B31984A74E68659C4B420BD699CE630B130B08A6EA1162B),
     (0x0AFC2F3FD870678FBE359D7F9873F052478F590B211CE30BF5E3EEAEF89EAFDB,
      0x1C54A530398C9064BDC662D929E645CADDA9A712CC5A8243F9CDDBD2D98DD1F0)),
    ((0x095C0FBF5D5A1AC023794A0D856F92591BA990ECFD4B7AEF5C0D58C5DC2429FE,
      0x14D3D6CA72D8A950A31DC10F7B4053C9E9AD9EBB590CB4A60F8215D4B99F2B4A),
     (0x1DC0E7BBC3D70E6689DC206B4B91C85759DC1A23043C585FDFAF545838CA7429,
      0x0B53320E5A6488CB98A855FFC837D2A75AB90D61AC16CC1B7AB2CD3ED5E22B97),
     (0x13A8AFD3085DAE4C6C91476EF36CD1D318CE07BAC42A9C0F9BD7FDDAF5EBD723,
      0x00F97B5221474526B601F3730A3AFA965CEEE1B343940C383E5314859E762C97)),
)


def bn254_scalars(n: int, rng: np.random.Generator) -> np.ndarray:
    """uint32 [16, n] scalars below BN254's r: random, with zeros at lanes
    0, 1 and every 4099th lane, r - 1 at lanes 2 and 3 and every 4111th
    lane (the top window's largest digit), and 2^240 - 1 at lane 4 (all
    ones below the top window: signed digits -1 that carry into it)."""
    from algebra_tpu_torch.bigint import batch_int_to_limbs
    from algebra_tpu_torch.curves.instances import bn254

    sc = random_scalars(n, rng, bn254.R)
    sc[:, [0, 1]] = 0
    sc[:, ::4099] = 0
    top = batch_int_to_limbs([bn254.R - 1, (1 << 240) - 1], 16)
    sc[:, [2, 3]] = top[:, :1]
    sc[:, 5::4111] = top[:, :1]
    sc[:, 4] = top[:, 1]
    return sc


def mul_kernel_at(spec, n: int, rng, device) -> dict:
    """K1 on [L, n] operands (the product edges planted in the first
    lanes): against its plain version, device ms, plain ms, its bound."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.bigint import batch_int_to_limbs
    from algebra_tpu_torch.ops import mont_kernels as mk

    L = spec.n_limbs
    edge = product_edges(spec)
    a_np, b_np = random_limbs(spec, n, rng), random_limbs(spec, n, rng)
    m = min(n, len(edge) ** 2)
    a_np[:, :m] = batch_int_to_limbs([x for x in edge for _ in edge][:m], L)
    b_np[:, :m] = batch_int_to_limbs([y for _ in edge for y in edge][:m], L)
    a, b = convert.from_reference(a_np, device), convert.from_reference(b_np, device)
    want, plain_ms = wall_ms(lambda: mk.mul_plain(spec, a, b))
    bad, err = mismatches(mk.mul(spec, a, b), want)
    return with_bound({"mismatches": bad, "max_abs_err": err, "plain_ms": plain_ms,
                       "ms": device_ms(lambda: mk.mul(spec, a, b), 20), "shape": [L, n],
                       "field": spec.name}, 3 * n * L * 4, n * mads_per_product(spec))


def gcd_kernel_at(spec, n: int, rng, device) -> dict:
    """K3 (safegcd) on [L, n] values with zeros and edge values planted
    (``gcd_operands``): ``gcd_vs_ladder``, and against its plain version,
    whose time is the plain ms."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.ops import mont_kernels as mk

    a = convert.from_reference(gcd_operands(spec, n, rng), device)
    k = gcd_vs_ladder(spec, a)
    want, k["plain_ms"] = wall_ms(lambda: mk.inv_fermat_plain(spec, a))
    bad, err = mismatches(mk.inv_gcd(spec, a), want)
    k.update({"mismatches": k["mismatches"] + bad, "max_abs_err": max(k["max_abs_err"], err),
              "defects": inverse_defects(spec, a, mk.inv_gcd(spec, a))})
    k["mismatches"] += k["defects"]
    return k


def bn254_kernel_cases(rng, device) -> dict:
    """The kernels of the BN254 path against their plain versions at
    BN254's Fq (254 of 256 bits: two spare bits, where BLS12-381's Fq has
    three and secp256k1's none): K1 with every pair of the product edges
    and a host oracle, K3 with edge values and zeros, K8's round kernel
    with planted lanes and warps, the MSM tail's kernels on planted
    buckets, K17 on the BN254 pairing's weight matrices (xi = 9 + u) and on
    random weights at the mass limit, with edge operands, n = 1, 4097 (as
    views) and 2^16 for the Fp12 product."""
    from algebra_tpu_torch.curves.instances import bn254
    from algebra_tpu_torch.ops import mont_kernels as mk

    spec = bn254.fq_spec
    mats = dict(path_dot_weights("bn254"))
    K = 20
    mats["random_at_mass_limit"] = (mass_limit_weights(spec, K, 6, rng),
                                    [k % 5 == 1 for k in range(K)])
    dots = []
    for name, (W, sq) in mats.items():
        for n in [1, 4097] + ([1 << DOT_WIDE_LOG] if name == "fp12_mul" else []):
            A, B = dot_operands(spec, W.shape[1], n, sq, rng, device)
            if n == 4097:  # views: a lane slice of a wider array
                A = torch.cat([A, A], dim=2)[:, :, :n]
                B = torch.cat([B, B], dim=2)[:, :, :n]
            bad, err = mismatches(mk.dot(spec, A, B, W, sq), mk.dot_plain(spec, A, B, W, sq))
            case = {"weights": name, "n_out": int(W.shape[0]), "K": int(W.shape[1]), "n": n,
                    "max_row_weight_mass": int(np.abs(W).sum(axis=1).max()),
                    "mismatches": bad, "max_abs_err": err}
            if name == "fp12_mul" and n == 4097:
                case["host_oracle_mismatches"] = dot_host_oracle(spec, A, B, W, 16)
            dots.append(case)
            del A, B
    torch.cuda.synchronize()
    return {"field": spec.name, "words": spec.n_words,
            "mont_mul": check_mul_kernel(spec, rng, device),
            "inv_gcd": check_gcd_kernel(spec, rng, device),
            "jac_madd_round": check_round_kernel(spec, rng, device),
            "msm_tail": check_reduce_kernels(spec, rng, device),
            "mont_dot": dots}


def bn254_case_failures(cases: dict) -> list:
    k1 = cases["mont_mul"]
    bad = [k1] if k1["mismatches"] or k1["oracle_mismatches"] else []
    bad += [c for c in cases["inv_gcd"] if c["mismatches"] or c["oracle_mismatches"]]
    bad += [c for c in cases["jac_madd_round"]["cases"] if c["mismatches"]]
    bad += [c for c in cases["msm_tail"]["cases"]
            if c["inner_mismatches"] or c["fold_mismatches"]]
    bad += [c for c in cases["mont_dot"] if c["mismatches"] or c.get("host_oracle_mismatches")]
    return bad


def bn254_msm(device, rng, rng_host) -> tuple:
    """``entry.g1_msm(curve="bn254")`` on 2^20 scalars (``bn254_scalars``)
    over 256 distinct host-made bases tiled, one of them at infinity:
    exact against the host oracle (the scalars summed per base), the
    plan, the top window's highest bucket, launches, the median of 3
    synchronised calls, the steps and device time by kernel
    (``msm_phase_times``), and 2^9 of it on the card and on the CPU in
    Jacobian words.  Returns (launches of the first call, the line, K8's
    round kernel at its operands, the tail's kernels at its buckets)."""
    from algebra_tpu_torch import convert, entry
    from algebra_tpu_torch.curves.instances import bn254
    from algebra_tpu_torch.ops import msm

    curve = bn254.g1(device)
    pts = host_pool(bn254.g1("cpu"), rng_host)
    pts[BN254_INF_BASE] = None
    aff256 = curve.from_host(pts)
    n = 1 << BN254_MSM_LOG
    sc_np = bn254_scalars(n, rng)
    bases = tile(aff256, n)
    sc = convert.from_reference(sc_np, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def call():  # the MSM and its result's normalisation (K1, one K3)
        res = entry.g1_msm(bases, sc, curve="bn254", device=device)
        return res, curve.to_affine(res)

    (res, _), counts = launches_of(call)
    peak = torch.cuda.max_memory_allocated()
    plan = dict(msm.stats)
    if curve.to_host(res) != tiled_oracle(curve, pts, sc_np):
        raise AssertionError("the BN254 G1 MSM at 2^20 differs from the host oracle")
    idle = [k for k in ("mont_mul", "jac_madd_round", "bucket_reduce_inner", "reduce_fold",
                        "inv_gcd") if not counts.get(k)]
    if idle:
        raise AssertionError(f"the BN254 MSM launched no {idle}: {counts}")
    c, W = plan["c"], plan["windows"]
    _, _, bucket_counts = msm.recode(sc, bases[2], c, W)
    reached = torch.nonzero(bucket_counts[W - 1]).flatten()
    top = {"bits_in_top_window": bn254.R.bit_length() - c * (W - 1),
           "highest_bucket_reached": int(reached.max().item()) if reached.numel() else -1,
           "buckets_reached": int(reached.numel())}
    if top["highest_bucket_reached"] < 0:
        raise AssertionError(f"no scalar reached the BN254 MSM's top window: {top}")
    ms, runs = median_ms(lambda: entry.g1_msm(bases, sc, curve="bn254", device=device))
    del bases, res, bucket_counts
    phases, round_k, reduce_k = msm_phase_times(curve, aff256, sc_np, device)
    shared = msm_vs_cpu(curve, aff256, sc_np[:, : 1 << BN254_MSM_SHARED], bn254.g1("cpu"))
    line = {"n": n, "plan": plan, "top_window": top, "ms": ms, "ms_runs": runs,
            "launches": counts, "peak_memory_gb": peak / 1e9, "host_oracle": "equal",
            "base_at_infinity": BN254_INF_BASE, f"phases_2^{BN254_MSM_LOG}": phases,
            f"vs_cpu_2^{BN254_MSM_SHARED}": shared}
    return counts, line, round_k, reduce_k


def run_bn254_path(device, rng, rng_host, gpu) -> tuple:
    """BN254 through the entry points: its kernels against their plain
    versions at its field (``bn254_kernel_cases``); e(g1, g2) against the
    pinned value on the card; ``pairing_at_scale`` at 4096 and 256 pairs
    with 8 lanes against the CPU; the 2^20 G1 MSM (``bn254_msm``); then
    the kernel rows: K1, K3 and K17 at the 4096-pair pairing's shapes with
    its launches, K8's round kernel and the MSM tail's kernels at the MSM's
    operands with its launches.  Returns (the line, the rows by kernel:
    (launches, row))."""
    from algebra_tpu_torch import entry
    from algebra_tpu_torch.curves.instances import bn254

    t0 = time.time()
    cases = bn254_kernel_cases(rng, device)
    failed = bn254_case_failures(cases)
    if failed:
        raise AssertionError(f"a kernel disagrees with its plain version at BN254: {failed}")
    g1c, g2c = bn254.g1("cpu"), bn254.g2("cpu")
    gen = entry.pairing([g1c.generator_host], [g2c.generator_host], curve="bn254",
                        device=device)
    pinned = bn254.fq12(device).to_int(gen)[0] == BN254_GT_G1_G2
    if not pinned:
        raise AssertionError("the BN254 e(g1, g2) differs from the pinned value")
    a = rng_host.randrange(1, bn254.R)
    ps, qs = host_pool(g1c, rng_host, PAIRING_POOL), host_pool(g2c, rng_host, PAIRING_POOL)
    pools = (ps, qs, [g1c.host_mul(pt, a) for pt in ps], [g2c.host_mul(pt, a) for pt in qs])
    line = {"phase": "bn254_path", "kernel_cases": cases, "e_g1_g2_equals_pinned": pinned,
            "pool": PAIRING_POOL}
    pair_counts = None
    for log_n in PAIRING_LOGS:
        c, line[f"pairs_2^{log_n}"] = pairing_at_scale(log_n, pools, device, curve="bn254",
                                                        cpu_lanes=BN254_CPU_LANES)
        pair_counts = pair_counts or c
    msm_counts, line[f"g1_msm_2^{BN254_MSM_LOG}"], round_k, reduce_k = bn254_msm(
        device, rng, rng_host)
    n_pairs = 1 << PAIRING_LOGS[0]
    rows = {"mont_mul": (pair_counts, mul_kernel_at(bn254.fq_spec, n_pairs, rng, device)),
            "inv_gcd": (pair_counts, gcd_kernel_at(bn254.fq_spec, n_pairs, rng, device)),
            "jac_madd_round": (msm_counts, round_k),
            "bucket_reduce_inner": (msm_counts, reduce_k["bucket_reduce_inner"]),
            "reduce_fold": (msm_counts, reduce_k["reduce_fold"]),
            "mont_dot": (pair_counts, dot_kernel_at(device, rng, "bn254"))}
    bad = {k: r for k, (_, r) in rows.items()
           if r["mismatches"] or r.get("mismatches_vs_general_k7_k6")}
    if bad:
        raise AssertionError(f"a kernel disagrees at the BN254 path's shapes: {bad}")
    line.update({"kernel_rows": {k: r for k, (_, r) in rows.items()}, "gpu": gpu,
                 "seconds": time.time() - t0})
    return line, rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from algebra_tpu_torch.bigint import batch_int_to_limbs
    from algebra_tpu_torch.curves.instances import bls12_381, mnt4_753, secp256k1
    from algebra_tpu_torch.fields.spec import field_spec
    from algebra_tpu_torch.kernels import build

    device = torch.device("cuda", 0)
    gpu = nvidia_smi_line()
    rng = np.random.default_rng(SEED)

    build_s = build.build_all()
    emit({"phase": "device", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": max(build_s.values(), default=0.0),
          "build_s_by_library": build_s,
          "ptxas": {f"{src}_w{w}": [ln.strip() for ln in build.build_log(src, w).splitlines()
                                    if "entry function" in ln or "registers" in ln
                                    or "spill" in ln]
                    for src in build.KERNEL_SOURCES for w in build.WORD_COUNTS}})

    rng_host = random.Random(SEED)
    fr = bls12_381.fr_spec
    # the three fields in use, and a modulus with no spare top bit, where the
    # final subtraction has to look at the carry word
    full_width = field_spec(2**256 - 189, name="full_width_256")
    secp = secp256k1.fq_spec  # a real modulus with no spare bit
    specs = (fr, bls12_381.fq_spec, mnt4_753.fq_spec, full_width, secp)
    cases = [check_mul_kernel(s, rng, device) for s in specs]
    k5_cases = check_butterfly_kernel(fr, rng, device)
    inv_cases = [check_inverse_kernels(s, rng, device) for s in specs]
    emit({"phase": "kernel_cases", "mont_mul": cases, "butterfly": k5_cases,
          "inverse": inv_cases, "gpu": gpu})
    failed = [c for c in cases if c["mismatches"] or c["oracle_mismatches"]]
    failed += [c for c in k5_cases if c["mismatches"]]
    failed += [c for case in inv_cases for c in inverse_case_failures(case)]
    if failed:
        raise AssertionError(f"kernel disagrees with its plain version: {failed}")

    k1, k5 = check_main_shapes(fr, rng, device, LOG_MAIN)
    if k1["mismatches"] or k5["mismatches"]:
        raise AssertionError(f"kernel disagrees at the main shape: {k1} {k5}")

    k2, k3, k4, level_times = check_inverse_main_shapes(fr, rng, device, LOG_MAIN)
    if k2["mismatches"] or k3["mismatches"] or k4["mismatches"]:
        raise AssertionError(f"kernel disagrees at the main shape: {k2} {k3} {k4}")

    t0 = time.time()
    sw_specs = (full_width, secp, bls12_381.fq_spec, mnt4_753.fq_spec)
    sw_cases = [check_sw_kernels(s, rng, device) for s in sw_specs]
    round_cases = [check_round_kernel(s, rng, device) for s in sw_specs]
    on_curve = check_sw_on_curve(device, rng_host)
    sass = {f"w{w}": sass_counts(w) for w in build.WORD_COUNTS}
    emit({"phase": "sw_kernel_cases", "cases": sw_cases, "round_cases": round_cases,
          "g1_points": on_curve, "sass": sass, "seconds": time.time() - t0, "gpu": gpu})
    failed = [c for case in sw_cases for c in sw_case_failures(case)]
    failed += [c for case in round_cases for c in case["cases"] if c["mismatches"]]
    if failed or on_curve["host_oracle_mismatches"]:
        raise AssertionError(f"group-law kernel disagrees: {failed} {on_curve}")
    t0 = time.time()
    reduce_cases = [check_reduce_kernels(s, rng, device, wide=s is bls12_381.fq_spec)
                    for s in sw_specs]
    emit({"phase": "reduce_kernel_cases", "cases": reduce_cases,
          "seconds": time.time() - t0, "gpu": gpu})
    failed = [c for case in reduce_cases for c in case["cases"]
              if c["inner_mismatches"] or c["fold_mismatches"]]
    if failed:
        raise AssertionError(f"an MSM-tail kernel disagrees: {failed}")
    t0 = time.time()
    row_cases = [check_row_kernels(s, rng, device)
                 for s in (full_width, bls12_381.fq_spec, mnt4_753.fq_spec)]
    mnt_a = tuple(int(v) for v in batch_int_to_limbs(
        [mnt4_753.COEFF_A * mnt4_753.fq_spec.R % mnt4_753.fq_spec.modulus],
        mnt4_753.fq_spec.n_limbs)[:, 0])
    level_cases = [check_level_kernels(full_width, rng, device),
                   check_level_kernels(bls12_381.fq_spec, rng, device),
                   check_level_kernels(mnt4_753.fq_spec, rng, device, a_mont=mnt_a)]
    level_on_curve = check_level_on_curve(device, rng_host)
    emit({"phase": "rows_kernel_cases", "rows": row_cases, "levels": level_cases,
          "g1_pairs": level_on_curve, "seconds": time.time() - t0, "gpu": gpu})
    failed = row_case_failures(row_cases + level_cases)
    if failed or level_on_curve["host_oracle_mismatches"]:
        raise AssertionError(f"tree kernel disagrees: {failed} {level_on_curve}")
    t0 = time.time()
    aff_cases = [check_aff_kernels(secp, rng, device),
                 check_aff_kernels(full_width, rng, device),
                 check_aff_kernels(bls12_381.fq_spec, rng, device),
                 check_aff_kernels(mnt4_753.fq_spec, rng, device, a_mont=mnt_a)]
    aff_on_curve = [check_aff_on_curve(secp256k1.g1(device), rng_host),
                    check_aff_on_curve(bls12_381.g1(device), rng_host)]
    emit({"phase": "affine_add_cases", "cases": aff_cases, "real_pairs": aff_on_curve,
          "seconds": time.time() - t0, "gpu": gpu})
    failed = [c for case in aff_cases for c in aff_case_failures(case)]
    failed += [c for c in aff_on_curve if c["host_oracle_mismatches"]]
    if failed:
        raise AssertionError(f"affine-add kernel disagrees: {failed}")
    sw_main, msm_shape = check_sw_main_shapes(device, rng, MSM_LOGS[-1])
    bad = {k: v for k, v in sw_main.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"group-law kernel disagrees at the main shape: {bad}")

    counts, main_line = run_main_path(device, rng, gpu)
    emit(main_line)
    emit(run_small_paths(device, rng, gpu))
    inv_counts, inverse_line = run_inverse_path(device, rng, gpu, LOG_MAIN, level_times)
    emit(inverse_line)
    emit(run_small_inverse_paths(device, rng, gpu))
    t0 = time.time()
    with bucket_path(False):
        msm_counts, msm_line, round_main, reduce_main = run_msm_path(device, rng, rng_host,
                                                                     gpu)
    for name, k in reduce_main.items():
        k.update(ptxas_of("msm_reduce_kernels", bls12_381.fq_spec.n_words, name))
    emit({**msm_line, "kernel_shapes": msm_shape, "round_kernel": round_main,
          "reduce_kernels": reduce_main,
          "seconds": time.time() - t0})
    bad = [k for k in (round_main, round_main[f"distinct_2^{MSM_DISTINCT}"],
                       *reduce_main.values())
           if k["mismatches"] or k.get("mismatches_vs_general_k7_k6")]
    if bad:
        raise AssertionError(f"K8's round kernel disagrees at the MSM's operands: {bad}")
    fq_words = bls12_381.fq_spec.n_words
    t0 = time.time()
    emit({**run_small_group_paths(device, rng, rng_host, gpu), "seconds": time.time() - t0})
    t0 = time.time()
    tree_counts, tree_line, tree_main = run_tree_path(device, rng, rng_host, gpu)
    emit({**tree_line, "seconds": time.time() - t0})
    bad = {k: v for k, v in tree_main.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"tree kernel disagrees at the main shape: {bad}")
    tree_main["jac_madd"]["at_lockstep_round_shape_before"] = sw_main["jac_madd"]
    for name, k in (("jac_madd_round", round_main), ("jac_madd", tree_main["jac_madd"])):
        k.update(ptxas_of("sw_kernels", fq_words, name))
        k["instructions_per_imad"] = sass[f"w{fq_words}"][name]["instructions_per_imad"]
    t0 = time.time()
    scalar_counts, scalar_line, aff_main = run_scalar_mul_path(device, rng, rng_host, gpu)
    emit({**scalar_line, "seconds": time.time() - t0})
    t0 = time.time()
    bottoms = run_inverse_bottoms(device, rng, tree_main["affr_denom"]["shape"][0] // 2, gpu)
    emit({**bottoms, "seconds": time.time() - t0})
    bad = {k: v for k, v in bottoms["cases"].items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"safegcd and the ladder disagree at a path's bottom: {bad}")
    t0 = time.time()
    dot_cases = check_dot_kernels(rng, device)
    emit({"phase": "dot_kernel_cases", "cases": dot_cases, "seconds": time.time() - t0,
          "gpu": gpu})
    failed = [c for c in dot_cases if c["mismatches"] or c.get("host_oracle_mismatches")]
    if failed:
        raise AssertionError(f"K17 disagrees with its plain version: {failed}")
    t0 = time.time()
    pairing_counts, pairing_line, k17 = run_pairing_path(device, rng, rng_host, gpu)
    emit({**pairing_line, "seconds": time.time() - t0})
    bn254_line, bn254_rows = run_bn254_path(device, rng, rng_host, gpu)
    emit(bn254_line)

    # launches: K1 and K5 as the product path counted them, K2-K4 as the
    # division path did (which also ran K1 and K5: see its own line), K8's
    # round kernel and the MSM tail's two kernels (K7's and K6's in the
    # reduction and fold) as the 2^20 G1 MSM did on the lockstep path,
    # K11-K16 and the general K8 as it did through the affine tree (which
    # also ran K2-K4 and the tail's kernels: see its own line), the general
    # K6 and K7 as the 2^18 GLV scalar_mul did (and times at its operands),
    # K9/K10 as one 2^20 secp256k1 entry.batch_affine_add without masks did
    # (K2-K4 too; the scalar-mul path's line has each call's counts), K17 as
    # one 4096-pair entry.pairing did (and K1, K3 there: see its own line)
    ntt_src = {"route": "cuda", "source": "algebra_tpu_torch/csrc/mont_kernels.cu",
               "library_ms": None, "gpu": gpu}
    inv_src = {**ntt_src, "source": "algebra_tpu_torch/csrc/inverse_kernels.cu"}
    sw_src = {**ntt_src, "source": "algebra_tpu_torch/csrc/sw_kernels.cu"}
    rows_src = {**ntt_src, "source": "algebra_tpu_torch/csrc/rows_kernels.cu"}
    reduce_src = {**ntt_src, "source": "algebra_tpu_torch/csrc/msm_reduce_kernels.cu"}
    dot_src = {**ntt_src, "source": "algebra_tpu_torch/csrc/dot_kernels.cu"}
    glv = scalar_line["glv_scalar_mul_secp256k1"]
    glv_counts, glv_main = glv["glv"]["launches"], glv["kernel_shapes"]
    for name in ("jac_add", "jac_double"):
        glv_main[name]["at_msm_reduction_shape_before"] = sw_main[name]
    rows = [
        ("mont_mul", "algebra_tpu/ops/mont_pallas.py:189", counts, k1, ntt_src),
        ("butterfly", "algebra_tpu/ops/mont_pallas.py:417", counts, k5, ntt_src),
        ("inv_prefix", "algebra_tpu/ops/mont_pallas.py:207", inv_counts, k2, inv_src),
        ("inv_gcd", "algebra_tpu/ops/mont_pallas.py:238", inv_counts, k3, inv_src),
        ("inv_backward", "algebra_tpu/ops/mont_pallas.py:221", inv_counts, k4, inv_src),
        ("jac_double", "algebra_tpu/ops/sw_pallas.py:111", glv_counts, glv_main["jac_double"],
         sw_src),
        ("reduce_fold", "algebra_tpu/ops/sw_pallas.py:111", msm_counts,
         reduce_main["reduce_fold"], reduce_src),
        ("jac_add", "algebra_tpu/ops/sw_pallas.py:120", glv_counts, glv_main["jac_add"],
         sw_src),
        ("bucket_reduce_inner", "algebra_tpu/ops/sw_pallas.py:120", msm_counts,
         reduce_main["bucket_reduce_inner"], reduce_src),
        ("jac_madd_round", "algebra_tpu/ops/sw_pallas.py:56", msm_counts, round_main,
         sw_src),
        ("jac_madd", "algebra_tpu/ops/sw_pallas.py:56", tree_counts, tree_main["jac_madd"],
         sw_src),
        ("aff_denom", "algebra_tpu/ops/sw_pallas.py:199", scalar_counts,
         aff_main["aff_denom"], sw_src),
        ("aff_post", "algebra_tpu/ops/sw_pallas.py:216", scalar_counts,
         aff_main["aff_post"], sw_src),
        ("affr_denom", "algebra_tpu/ops/sw_pallas.py:373", tree_counts,
         tree_main["affr_denom"], sw_src),
        ("affr_post", "algebra_tpu/ops/sw_pallas.py:391", tree_counts,
         tree_main["affr_post"], sw_src),
        ("pack", "algebra_tpu/ops/rows_pallas.py:36", tree_counts, tree_main["pack"],
         rows_src),
        ("unpack", "algebra_tpu/ops/rows_pallas.py:86", tree_counts, tree_main["unpack"],
         rows_src),
        ("negate_y", "algebra_tpu/ops/rows_pallas.py:131", tree_counts,
         tree_main["negate_y"], rows_src),
        ("expand_units", "algebra_tpu/ops/rows_pallas.py:166", tree_counts,
         tree_main["expand_units"], rows_src),
        # no Pallas kernel: the XLA fusion of the reference's dot_stacked
        ("mont_dot", "algebra_tpu/ops/mont.py:536", pairing_counts, k17, dot_src),
    ]
    kernel_rows = [
        {"name": name, "replaces": replaces, "launches": path_counts.get(name, 0),
         "kernel_ms": k["ms"], **src, **k}
        for name, replaces, path_counts, k, src in rows]
    # the same kernels at BN254's constants, W = 8: K1, K3 and K17 with the
    # launches of one 4096-pair BN254 entry.pairing, K8's round kernel and
    # the MSM tail's kernels with those of the 2^20 BN254 G1 MSM
    by_name = {name: (replaces, src) for name, replaces, _, _, src in rows}
    kernel_rows += [
        {"replaces": by_name[name][0], "launches": path_counts.get(name, 0),
         "kernel_ms": k["ms"], **by_name[name][1], **k, "name": f"{name}_bn254",
         "kernel": name, "curve": "bn254"}
        for name, (path_counts, k) in bn254_rows.items()]
    emit({"kernels": kernel_rows})
    idle = [name for name, _, path_counts, _, _ in rows if path_counts.get(name, 0) <= 0]
    idle += [f"{name}_bn254" for name, (path_counts, _) in bn254_rows.items()
             if path_counts.get(name, 0) <= 0]
    if idle:
        raise AssertionError(f"a path launched no kernel of: {idle}")
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
