"""Builds and loads the CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into
shared libraries with a plain C interface, one per source file and 32-bit
word count (``-DMONT_W=8|12|24``), and loaded with ``ctypes``.  A library is
built the first time a CUDA tensor needs it; importing this module needs
neither ``nvcc`` nor CUDA.  File names carry a hash of all the sources, so
an edited source never meets a stale library.  A measurement may build a
variant of a library with extra ``-D`` defines (``variant``), such as
another register bound for a kernel; the main path never does.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

from .. import config

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
# one library each, for each word count
KERNEL_SOURCES = ("mont_kernels", "inverse_kernels", "sw_kernels", "rows_kernels",
                  "msm_reduce_kernels", "dot_kernels")
_HEADERS = ("mont.cuh", "launch.cuh", "sw.cuh", "rows.cuh", "msm_reduce.cuh", "inverse.cuh",
            "dot.cuh")
WORD_COUNTS = (8, 12, 24)

_libs: dict[tuple[str, int], ctypes.CDLL] = {}
_defines: dict[tuple[str, int], tuple[str, ...]] = {}  # variants in use


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in [f"{src}.cu" for src in KERNEL_SOURCES] + list(_HEADERS):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def library_path(source: str, words: int, defines: tuple[str, ...] = ()) -> str:
    tag = "".join(f"_{d.replace('=', '')}" for d in defines)
    return os.path.join(config.build_dir, f"lib{source}_w{words}{tag}_{_source_hash()}.so")


def _start_build(source: str, words: int,
                 defines: tuple[str, ...] = ()) -> tuple[subprocess.Popen, str, str]:
    """Start one nvcc; returns (process, temporary output, final path)."""
    if source not in KERNEL_SOURCES or words not in WORD_COUNTS:
        raise ValueError(f"no kernel instance of {source} for {words} words")
    os.makedirs(config.build_dir, exist_ok=True)
    final = library_path(source, words, defines)
    tmp = f"{final}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        f"-DMONT_W={words}", *(f"-D{d}" for d in defines), "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
        "-o", tmp, os.path.join(_CSRC, f"{source}.cu"),
    ]
    log = open(final + ".log", "wb")
    try:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    return proc, tmp, final


def _finish_build(proc: subprocess.Popen, tmp: str, final: str) -> None:
    rc = proc.wait()
    if rc != 0:
        with open(final + ".log", "r", errors="replace") as f:
            raise RuntimeError(f"nvcc failed (exit {rc}):\n{f.read()}")
    os.replace(tmp, final)


def build_all(word_counts=WORD_COUNTS) -> dict[str, float]:
    """Build every missing library, all compilers started together.
    Returns the seconds from the start until each library was built, by
    ``<source>_w<words>``."""
    t0 = time.time()
    jobs = {
        f"{src}_w{w}": _start_build(src, w) for src in KERNEL_SOURCES for w in word_counts
        if not os.path.exists(library_path(src, w))
    }
    done: dict[str, float] = {}
    while len(done) < len(jobs):  # wait for every compiler
        for name, (proc, _, _) in jobs.items():
            if name not in done and proc.poll() is not None:
                done[name] = time.time() - t0
        time.sleep(0.1)
    errors = []
    for job in jobs.values():  # then report the first failure
        try:
            _finish_build(*job)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    return done


def build_log(source: str, words: int, defines: tuple[str, ...] = ()) -> str:
    """What nvcc/ptxas printed for this library (registers, spills)."""
    with open(library_path(source, words, defines) + ".log", "r", errors="replace") as f:
        return f.read()


def _signatures() -> dict[str, dict[str, list]]:
    """Argument types of every launcher, by source.  Each library also has
    ``<prefix>_words()``, which returns the word count it was built for."""
    vp, sz, ci, u32 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_uint32
    words_p = ctypes.POINTER(ctypes.c_uint32)
    # K9/K10's operands: x1, y1, inf1, x2, y2, inf2, neg1, neg2 (a coordinate
    # as pointer, limb stride, lane stride; a mask as pointer, lane stride)
    aff_in = [vp, sz, sz] * 2 + [vp, sz] + [vp, sz, sz] * 2 + [vp, sz] * 3
    return {
        "mont_kernels": {
            "mont_words": [],
            "mont_mul_launch": [vp, sz, sz, vp, sz, sz, vp, sz, words_p, u32, vp],
            "butterfly_launch": [
                vp, vp, vp, vp, sz, sz, ci, ci, ci, vp, sz, sz, words_p, u32, vp,
            ],
        },
        "inverse_kernels": {
            "inverse_words": [],
            "inv_prefix_launch": [vp, vp, vp, sz, sz, ci, words_p, u32, words_p, vp],
            "inv_backward_launch": [
                vp, vp, vp, vp, sz, sz, ci, words_p, u32, words_p, vp,
            ],
            "inv_fermat_launch": [vp, vp, sz, words_p, ci, words_p, u32, vp],
            "inv_gcd_launch": [vp, vp, sz, words_p, u32, words_p, ci, vp],
        },
        "sw_kernels": {
            "sw_words": [],
            "jac_double_launch": [vp, sz, sz] * 3 + [vp, vp, vp, sz, words_p, u32, vp],
            "jac_add_launch": [vp, sz, sz] * 6 + [vp, vp, vp, sz, words_p, u32, vp],
            "jac_madd_launch": [vp, sz, sz] * 5 + [vp, sz, vp, vp, vp, sz, words_p, u32,
                                                   words_p, vp],
            "jac_madd_round_launch": [vp, vp, vp, sz, vp, vp, vp, vp, ctypes.c_longlong,
                                      words_p, u32, words_p, vp],
            "affr_denom_launch": [vp, vp, vp, sz, words_p, u32, words_p, vp],
            "affr_post_launch": [vp, vp, vp, vp, sz, words_p, u32, words_p, ci, vp],
            "aff_denom_launch": aff_in + [vp, sz, words_p, u32, words_p, vp],
            "aff_post_launch": aff_in + [vp, vp, vp, vp, sz, words_p, u32, words_p, ci, vp],
        },
        "msm_reduce_kernels": {
            "msm_words": [],
            "bucket_reduce_inner_launch": [vp] * 9 + [sz, ci, words_p, u32, words_p, vp],
            "reduce_fold_launch": [vp] * 10 + [ci] * 5 + [words_p, u32, words_p, vp],
        },
        "dot_kernels": {
            "dot_words": [],
            "dot_max_row": [],
            "mont_dot_launch": [vp, vp, vp, sz, ci, ci, vp, vp, words_p, u32, vp],
        },
        "rows_kernels": {
            "rows_words": [],
            "pack_launch": [vp, vp, vp, vp, sz, vp],
            "unpack_launch": [vp, vp, vp, vp, sz, vp],
            "negate_y_launch": [vp, vp, vp, sz, words_p, u32, vp],
            "expand_units_launch": [vp, vp, vp, sz, ci, sz, vp],
        },
    }


def library(source: str, words: int) -> ctypes.CDLL:
    """The loaded library of ``source`` for ``words`` 32-bit words per
    element (the variant that ``variant`` put in place, if any), built
    first if it is not there."""
    defines = _defines.get((source, words), ())
    lib = _libs.get((source, words, defines))
    if lib is not None:
        return lib
    path = library_path(source, words, defines)
    if not os.path.exists(path):
        _finish_build(*_start_build(source, words, defines))
    lib = ctypes.CDLL(path)
    for name, argtypes in _signatures()[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    built_for = getattr(lib, source.split("_")[0] + "_words")()
    if built_for != words:
        raise RuntimeError(f"{path} was built for {built_for} words, not {words}")
    _libs[(source, words, defines)] = lib
    return lib


@contextlib.contextmanager
def variant(source: str, words: int, defines: tuple[str, ...]):
    """Within the block, every launch from ``source`` at ``words`` goes to
    the library built with the extra ``-D`` ``defines`` (built on first
    use): for measuring a variant of a kernel beside the one in use."""
    saved = _defines.get((source, words), ())
    _defines[(source, words)] = tuple(defines)
    try:
        yield library(source, words)
    finally:
        _defines[(source, words)] = saved
