"""Builds and loads the CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into
shared libraries with a plain C interface, one per 32-bit word count
(``-DMONT_W=8|12|24``), and loaded with ``ctypes``.  A library is built the
first time a CUDA tensor needs it; importing this module needs neither
``nvcc`` nor CUDA.  File names carry a hash of the sources, so an edited
source never meets a stale library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

from .. import config

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SOURCES = ("mont_kernels.cu", "mont.cuh")
WORD_COUNTS = (8, 12, 24)

_libs: dict[int, ctypes.CDLL] = {}


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
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def library_path(words: int) -> str:
    return os.path.join(config.build_dir, f"libmont_w{words}_{_source_hash()}.so")


def _start_build(words: int) -> tuple[subprocess.Popen, str, str]:
    """Start one nvcc; returns (process, temporary output, final path)."""
    if words not in WORD_COUNTS:
        raise ValueError(f"no kernel instance for {words} words")
    os.makedirs(config.build_dir, exist_ok=True)
    final = library_path(words)
    tmp = f"{final}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        f"-DMONT_W={words}", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
        "-o", tmp, os.path.join(_CSRC, "mont_kernels.cu"),
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


def build_all(word_counts=WORD_COUNTS) -> float:
    """Build every missing library, all compilers started together.
    Returns the seconds spent."""
    t0 = time.time()
    jobs = [
        _start_build(w) for w in word_counts if not os.path.exists(library_path(w))
    ]
    errors = []
    for job in jobs:  # wait for every compiler, then report the first failure
        try:
            _finish_build(*job)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    return time.time() - t0


def build_log(words: int) -> str:
    """What nvcc/ptxas printed for this library (registers, spills)."""
    with open(library_path(words) + ".log", "r", errors="replace") as f:
        return f.read()


def library(words: int) -> ctypes.CDLL:
    """The loaded kernel library for ``words`` 32-bit words per element,
    built first if it is not there."""
    lib = _libs.get(words)
    if lib is not None:
        return lib
    path = library_path(words)
    if not os.path.exists(path):
        _finish_build(*_start_build(words))
    lib = ctypes.CDLL(path)

    vp, sz, ci = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
    words_p = ctypes.POINTER(ctypes.c_uint32)
    lib.mont_words.argtypes = []
    lib.mont_words.restype = ci
    lib.mont_mul_launch.argtypes = [
        vp, sz, sz, vp, sz, sz, vp, sz, words_p, ctypes.c_uint32, vp,
    ]
    lib.mont_mul_launch.restype = ci
    lib.butterfly_launch.argtypes = [
        vp, vp, vp, vp, sz, sz, ci, ci, ci, vp, sz, sz, words_p, ctypes.c_uint32, vp,
    ]
    lib.butterfly_launch.restype = ci
    if lib.mont_words() != words:
        raise RuntimeError(f"{path} was built for {lib.mont_words()} words, not {words}")
    _libs[words] = lib
    return lib
