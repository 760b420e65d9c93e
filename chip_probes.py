"""Measurements on the H100 that ``chip_smoke.py`` does not make, each
printing one JSON line a result and the card's name and power limit.

    python3 chip_probes.py round-blocks
        K8's round kernel (``jac_madd_round_kernel`` at 12 words) with the
        register bound it is built with (``kRoundBlocks`` = 4 blocks of 128
        threads a multiprocessor) against a build with -DROUND_BLOCKS=3, in
        turns (4, 3, 3, 4), at round 1 of a 2^20 G1 MSM on 2^20 distinct
        bases (a signed table of 2^21 rows, 403 MB, far larger than L2) and
        on 256 tiled bases, and of a 2^16 MSM on 2^16 distinct bases (the
        size of ``chip_smoke.py``'s distinct-base MSM): device time,
        checked against the plain version, and the host time of the whole
        bucket phase (``msm.bucket_sums``).
    python3 chip_probes.py host-turns OTHER_CHECKOUT
        Host-bound paths timed on two checkouts in turns (OTHER, this one,
        this one, OTHER), one process each: ``WnafContext.mul`` on 2^18
        secp256k1 points, ``entry.scalar_mul`` on 2^16 Jubjub points, and
        the 2^20 lockstep G1 MSM step by step (with the weighted reduction
        and the Horner fold summed, since a checkout may split the work
        between them differently), each through the checkout's own
        ``chip_smoke.py`` functions and checked as they check it.
    python3 chip_probes.py inv-bottom
        The blocked batched inversion (``mont_kernels.batch_inverse``) with
        its bottom width (``INV_BOTTOM``, the most elements left for K3's
        safegcd) swept over 2^12-2^17, at n = 2^20 and 2^24, for
        BLS12-381 Fr (8 words) and Fq (12 words): device time of the whole
        inversion in two turns (widths up, then down), its level plan, and
        each output against the one at the width in use.
    python3 chip_probes.py inverse-turns OTHER_CHECKOUT
        The paths whose batched inversion K3 ends, on two checkouts in
        turns (OTHER, this one, this one, OTHER), one process each, each
        through its checkout's own ``chip_smoke.py`` functions and checked
        as they check it: ``entry.batch_affine_add`` on 2^20 secp256k1 and
        G1 pairs (median ms, device ms by kernel), ``entry.g1_msm`` at 2^20
        on the lockstep path and through the affine tree (median of 3),
        and the tree MSM's device time by kernel under torch.profiler.

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import torch

ROUND_LOG = 20
SMALL_LOG = 16  # chip_smoke.py's distinct-base MSM: 81,920 lanes, under two waves


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def round_blocks() -> int:
    import chip_smoke as cs
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.curves.instances import bls12_381
    from algebra_tpu_torch.kernels import build
    from algebra_tpu_torch.ops import fixed_base, msm

    device = torch.device("cuda", 0)
    gpu = cs.nvidia_smi_line()
    build.build_all()
    variant = ("ROUND_BLOCKS=3",)
    with build.variant("sw_kernels", 12, variant):
        pass  # build it before anything is timed
    regs = {"4": cs.ptxas_of("sw_kernels", 12, "jac_madd_round"),
            "3": cs.ptxas_of("sw_kernels", 12, "jac_madd_round", variant)}
    emit({"phase": "round_blocks_build", "ptxas_w12": regs, "gpu": gpu})

    curve = bls12_381.g1(device)
    rng, rng_host = np.random.default_rng(cs.SEED), random.Random(cs.SEED)
    n = 1 << ROUND_LOG
    # 2^20 distinct bases k_i G from random k_i (fixed-base windows of 8 bits)
    ks = convert.from_reference(cs.random_scalars(n, rng), device)
    table_g = fixed_base.window_table(curve, curve.generator(), 8, 256)
    distinct = curve.to_affine(fixed_base.msm(curve, table_g, ks, 8))
    del ks, table_g
    _, aff256 = cs.g1_bases_256(curve, rng_host)
    tiled = tuple(a.repeat(1, n // 256) if a.ndim == 2 else a.repeat(n // 256)
                  for a in aff256)
    sc = convert.from_reference(cs.random_scalars(n, rng), device)
    small = 1 << SMALL_LOG
    results = []
    for name, log_n, bases in (("distinct", ROUND_LOG, distinct),
                               ("tiled_256", ROUND_LOG, tiled),
                               ("distinct", SMALL_LOG,
                                tuple(a[..., :small].contiguous() for a in distinct))):
        m = 1 << log_n
        x, y, inf = bases
        c, W = msm.plan_windows(255, msm.default_window_size(m), m, tree=False)
        order_s, start, counts = msm.recode(sc[:, :m].contiguous(), inf, c, W)
        table = msm.signed_table(curve, x, y)
        for blocks in (4, 3, 3, 4):
            with build.variant("sw_kernels", 12, () if blocks == 4 else variant):
                k = cs.round_kernel_at(curve, table, order_s, start, counts)
                msm.bucket_sums(curve, table, order_s, start, counts)  # warm
                _, phase_ms = cs.wall_ms(
                    lambda: msm.bucket_sums(curve, table, order_s, start, counts))
            if k["mismatches"]:
                raise AssertionError(f"round kernel at {blocks} blocks disagrees: {k}")
            results.append({"bases": name, "log_n": log_n, "blocks": blocks,
                            "round_ms": k["ms"],
                            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                            "plain_ms": k["plain_ms"], "lanes": k["shape"][1],
                            "lanes_adding": k["lanes_adding"], "table_rows": k["table_rows"],
                            "mismatches": k["mismatches"], "bucket_phase_ms": phase_ms,
                            "rounds": msm.stats["rounds_lockstep"] + msm.stats["rounds_tail"]
                            + msm.stats["rounds_top"]})
            emit(results[-1])
        del order_s, start, counts, table
    print(gpu, flush=True)
    emit({"ok": True, "probe": "round-blocks", "results": results})
    return 0


BOTTOM_LOGS = range(12, 18)


def inv_bottom() -> int:
    import chip_smoke as cs
    from algebra_tpu_torch import convert
    from algebra_tpu_torch.curves.instances import bls12_381
    from algebra_tpu_torch.kernels import build
    from algebra_tpu_torch.ops import mont_kernels as mk

    device = torch.device("cuda", 0)
    gpu = cs.nvidia_smi_line()
    for words in (8, 12):
        build.library("inverse_kernels", words)  # built before anything is timed
    rng = np.random.default_rng(cs.SEED)
    results = []
    for spec in (bls12_381.fr_spec, bls12_381.fq_spec):
        for log_n in (20, 24):
            n = 1 << log_n
            a_np = cs.random_limbs(spec, n, rng)
            a_np[:, rng.integers(0, n, size=1000)] = 0
            a = convert.from_reference(a_np, device)
            del a_np
            want = mk.batch_inverse(spec, a)
            widths = [1 << b for b in BOTTOM_LOGS]
            times = {w: [] for w in widths}
            for order in (widths, widths[::-1]):
                for w in order:
                    if not torch.equal(mk.batch_inverse(spec, a, mk.INV_GROUP, w), want):
                        raise AssertionError(f"bottom {w} changes the inverses")
                    times[w].append(cs.device_ms(
                        lambda: mk.batch_inverse(spec, a, mk.INV_GROUP, w), 10))
            del want, a
            row = {"field": spec.name, "words": spec.n_words, "log_n": log_n,
                   "in_use": mk.INV_BOTTOM,
                   "ms_by_bottom": {str(w): t for w, t in times.items()},
                   "levels_by_bottom": {str(w): mk.level_plan(n, mk.INV_GROUP, w)
                                        for w in widths},
                   "fastest_by_turn": [min(widths, key=lambda w: times[w][i])
                                       for i in range(2)]}
            results.append(row)
            emit(row)
    print(gpu, flush=True)
    emit({"ok": True, "probe": "inv-bottom", "results": results})
    return 0


def _checkout(root: str):
    """Import ``chip_smoke`` and the port from the checkout at ``root``."""
    root = os.path.abspath(root)
    sys.path[0] = root
    os.chdir(root)
    import chip_smoke as cs
    import algebra_tpu_torch

    for mod in (cs, algebra_tpu_torch):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise AssertionError(f"{mod.__name__} came from {mod.__file__}, not {root}")
    return root, cs


def host_one(root: str) -> int:
    """One turn of ``host-turns`` on the checkout at ``root``."""
    root, cs = _checkout(root)
    from algebra_tpu_torch.curves.instances import bls12_381, secp256k1
    from algebra_tpu_torch.kernels import build

    device = torch.device("cuda", 0)
    build.build_all()
    rng, rng_host = np.random.default_rng(cs.SEED), random.Random(cs.SEED)
    secp = secp256k1.g1(device)
    pts = cs.host_pool(secp, rng_host)
    wnaf = cs.wnaf_at_scale(secp, pts, rng_host, device)
    jub = cs.jubjub_at_scale(rng, rng_host, device)
    g1 = bls12_381.g1(device)
    _, aff256 = cs.g1_bases_256(g1, rng_host)
    phases = cs.msm_phase_times(g1, aff256, cs.random_scalars(1 << 20, rng), device)
    phases = phases[0] if isinstance(phases, tuple) else phases
    keep = ("recode_ms", "table_ms", "rounds_ms", "reduction_ms", "fold_ms", "to_affine_ms")
    steps = {k: phases[k] for k in keep if k in phases}
    steps["reduction_fold_ms"] = steps["reduction_ms"] + steps["fold_ms"]
    emit({"root": root, "wnaf_ms": wnaf["ms"], "wnaf_ms_runs": wnaf["ms_runs"],
          "jubjub_ms": jub["ms"], "jubjub_ms_runs": jub["ms_runs"],
          "msm_2^20_steps": steps,
          "msm_2^20_reduction_fold_launches": phases.get("reduction_fold_launches"),
          "msm_2^20_to_affine_launches": phases.get("to_affine_launches"),
          "msm_2^20_profiled_busy_share": phases.get("profiled", {}).get("device_busy_share"),
          "msm_2^20_profiled_wall_ms": phases.get("profiled", {}).get("wall_ms"),
          "msm_2^20_profiled_device_ms": phases.get("profiled", {}).get("device_ms")})
    return 0


def inverse_one(root: str) -> int:
    """One turn of ``inverse-turns`` on the checkout at ``root``."""
    root, cs = _checkout(root)
    from algebra_tpu_torch import convert, entry
    from algebra_tpu_torch.curves.instances import bls12_381, secp256k1
    from algebra_tpu_torch.kernels import build

    device = torch.device("cuda", 0)
    build.build_all()
    rng, rng_host = np.random.default_rng(cs.SEED), random.Random(cs.SEED)
    out = {"root": root}
    for key, curve in (("secp256k1", secp256k1.g1(device)),
                       ("bls12_381_g1", bls12_381.g1(device))):
        add, _ = cs.batch_affine_add_at_scale(curve, key, cs.host_pool(curve, rng_host), rng,
                                              device)
        prof = add["no_masks"]["profiled"]
        out[f"batch_affine_add_{key}"] = {
            "ms": add["no_masks"]["ms"], "ms_masks": add["masks"]["ms"],
            "ms_runs": add["no_masks"]["ms_runs"], "launches": add["no_masks"]["launches"],
            "device_ms": prof["device_ms"], "kernel_device_ms": prof["kernel_device_ms"]}
    g1 = bls12_381.g1(device)
    _, aff256 = cs.g1_bases_256(g1, rng_host)
    n = 1 << 20
    bases = tuple(a.repeat(1, n // 256) if a.ndim == 2 else a.repeat(n // 256) for a in aff256)
    sc_np = cs.random_scalars(n, rng)
    sc = convert.from_reference(sc_np, device)
    for tree in (False, True):
        with cs.bucket_path(tree):
            entry.g1_msm(bases, sc, device=device)  # warm
            out["g1_msm_2^20_tree_ms" if tree else "g1_msm_2^20_lockstep_ms"] = cs.median_ms(
                lambda: entry.g1_msm(bases, sc, device=device))
    tree = cs.tree_phase_times(g1, aff256, sc_np, device)["profiled"]
    out["tree_2^20_profiled"] = {k: tree[k] for k in ("wall_ms", "device_ms",
                                                        "device_busy_share",
                                                        "kernel_device_ms")}
    emit(out)
    return 0


def turns(name: str, one: str, other: str) -> int:
    """The probe ``name``: its turn ``one`` on the checkout ``other`` and on
    this one in turns (other, this, this, other), a process each; one JSON
    line a turn."""
    import chip_smoke as cs

    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    gpu = cs.nvidia_smi_line()
    results = []
    for root in (other, here, here, other):
        t0 = time.time()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), one, root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the turn on {root} failed ({proc.returncode})")
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        turn.update(which="other" if root == other else "this", seconds=time.time() - t0)
        results.append(turn)
        emit(turn)
    print(gpu, flush=True)
    emit({"ok": True, "probe": name, "turns": results})
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_probes: no CUDA device", file=sys.stderr)
        return 1
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    if what == "round-blocks":
        return round_blocks()
    if what == "inv-bottom":
        return inv_bottom()
    if what == "inverse-turns" and len(sys.argv) == 3:
        return turns("inverse-turns", "inverse-one", sys.argv[2])
    if what == "inverse-one" and len(sys.argv) == 3:
        return inverse_one(sys.argv[2])
    if what == "host-turns" and len(sys.argv) == 3:
        return turns("host-turns", "host-one", sys.argv[2])
    if what == "host-one" and len(sys.argv) == 3:
        return host_one(sys.argv[2])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
