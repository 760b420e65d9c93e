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
coset, short inputs).  Every comparison is bit-exact (tolerance 0: outputs
are canonical integers).  One JSON object per line; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import operator
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


def emit(obj) -> None:
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


def wall_ms(fn):
    """(result, milliseconds on the host clock) of one synchronised call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


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


def check_mul_kernel(spec, rng, device):
    """K1 for one field: random and edge operands, a length that is not a
    multiple of the block, the one-element (stride-0) operand, a host
    big-integer oracle on 64 lanes."""
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.bigint import batch_int_to_limbs
    from algebra_tpu_torch.ops import mont_kernels as mk

    p, L = spec.modulus, spec.n_limbs
    edge = [0, 1, p - 1, spec.R % p]
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

    L, W = spec.n_limbs, spec.n_words
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
    mads1 = (2 * W * W + W) * n
    k1 = {
        "mismatches": bad1, "max_abs_err": err1, "ms": ms1, "plain_ms": plain_ms,
        "bound_bytes_ms": bytes1 / PEAK_BYTES_PER_S * 1e3,
        "bound_ops_ms": mads1 / PEAK_INT32_MAD_PER_S * 1e3,
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
    mads5 = (2 * W * W + W) * pairs
    k5 = {
        "mismatches": bad5, "max_abs_err": err5, "ms": ms5, "plain_ms": plain5,
        "ms_by_half": per_stage,
        "bound_bytes_ms": bytes5 / PEAK_BYTES_PER_S * 1e3,
        "bound_ops_ms": mads5 / PEAK_INT32_MAD_PER_S * 1e3,
        "shape": [L, n2, n1],
    }
    for k in (k1, k5):
        k["bound_ms"] = max(k["bound_bytes_ms"], k["bound_ops_ms"])
        k["bound_by"] = ("bytes" if k["bound_bytes_ms"] >= k["bound_ops_ms"]
                         else "operations")
    return k1, k5


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
    want_counts = {"mont_mul": 2 * (LOG_MAIN - 1) + 3 + 2, "butterfly": 3 * LOG_MAIN}
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from algebra_tpu_torch.curves.instances import bls12_381, mnt4_753
    from algebra_tpu_torch.fields.spec import field_spec
    from algebra_tpu_torch.kernels import build

    device = torch.device("cuda", 0)
    gpu = nvidia_smi_line()
    rng = np.random.default_rng(SEED)

    build_s = build.build_all()
    emit({"phase": "device", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s,
          "ptxas": {str(w): [ln for ln in build.build_log(w).splitlines()
                             if "registers" in ln or "spill" in ln]
                    for w in build.WORD_COUNTS}})

    fr = bls12_381.fr_spec
    # the three fields in use, and a modulus with no spare top bit, where the
    # final subtraction has to look at the carry word
    full_width = field_spec(2**256 - 189, name="full_width_256")
    cases = [check_mul_kernel(s, rng, device)
             for s in (fr, bls12_381.fq_spec, mnt4_753.fq_spec, full_width)]
    k5_cases = check_butterfly_kernel(fr, rng, device)
    emit({"phase": "kernel_cases", "mont_mul": cases, "butterfly": k5_cases,
          "gpu": gpu})
    failed = [c for c in cases if c["mismatches"] or c["oracle_mismatches"]]
    failed += [c for c in k5_cases if c["mismatches"]]
    if failed:
        raise AssertionError(f"kernel disagrees with its plain version: {failed}")

    k1, k5 = check_main_shapes(fr, rng, device, LOG_MAIN)
    if k1["mismatches"] or k5["mismatches"]:
        raise AssertionError(f"kernel disagrees at the main shape: {k1} {k5}")

    counts, main_line = run_main_path(device, rng, gpu)
    emit(main_line)
    emit(run_small_paths(device, rng, gpu))

    common = {"route": "cuda", "source": "algebra_tpu_torch/csrc/mont_kernels.cu",
              "library_ms": None, "gpu": gpu}
    emit({"kernels": [
        {"name": "mont_mul", "replaces": "algebra_tpu/ops/mont_pallas.py:189",
         "launches": counts["mont_mul"], "kernel_ms": k1["ms"], **k1, **common},
        {"name": "butterfly", "replaces": "algebra_tpu/ops/mont_pallas.py:417",
         "launches": counts["butterfly"], "kernel_ms": k5["ms"], **k5, **common},
    ]})
    if not (counts["mont_mul"] > 0 and counts["butterfly"] > 0):
        raise AssertionError(f"the main path launched no kernel: {counts}")
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
