"""Host-side big-integer <-> limb-array conversion helpers.

A multi-precision integer is an array of ``LIMB_BITS``-bit limbs, one
limb per 32-bit word, little-endian.  All host computation (constant
derivation, test oracles) uses arbitrary-precision Python ints; these
helpers convert between the two worlds.  Arrays here are numpy; only
``convert.py`` turns them into tensors.
"""

from __future__ import annotations

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def n_limbs_for_bits(bit_size: int) -> int:
    """Number of 16-bit limbs for a modulus of the given bit size: 4x the
    number of 64-bit words, so the Montgomery radix is
    R = 2^(64 * ceil(bits / 64)) whatever the limb width."""
    n64 = (bit_size + 63) // 64
    return 4 * n64


def int_to_limbs(x: int, n_limbs: int, dtype=np.uint32) -> np.ndarray:
    """Little-endian 16-bit limb decomposition of a nonnegative int."""
    if x < 0:
        raise ValueError("int_to_limbs requires a nonnegative integer")
    if x >> (LIMB_BITS * n_limbs):
        raise ValueError(f"{x} does not fit in {n_limbs} limbs")
    out = np.zeros((n_limbs,), dtype=dtype)
    for i in range(n_limbs):
        out[i] = (x >> (LIMB_BITS * i)) & LIMB_MASK
    return out


def limbs_to_int(limbs) -> int:
    """Recompose a little-endian limb vector (1-D) into a Python int."""
    arr = np.asarray(limbs)
    if arr.ndim != 1:
        raise ValueError("limbs_to_int takes a single 1-D limb vector")
    x = 0
    for i, limb in enumerate(arr.tolist()):
        x |= int(limb) << (LIMB_BITS * i)
    return x


def batch_int_to_limbs(xs, n_limbs: int, dtype=np.uint32) -> np.ndarray:
    """Convert an iterable of ints to a LIMB-MAJOR [n_limbs, len(xs)] array.

    Bulk path: each int serializes to little-endian bytes and the whole
    buffer reinterprets as 16-bit limbs."""
    xs = list(xs)
    nb = 2 * n_limbs
    buf = b"".join(int(x).to_bytes(nb, "little") for x in xs)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(xs), n_limbs)
    return np.ascontiguousarray(arr.T).astype(dtype)


def batch_limbs_to_int(arr):
    """Convert a limb-major [n_limbs, *batch] array to a nested list of
    Python ints (a bare int for batch rank 0)."""
    arr = np.asarray(arr)
    if arr.ndim == 1:
        return limbs_to_int(arr)
    shape = arr.shape[1:]
    rows = np.ascontiguousarray(
        arr.reshape(arr.shape[0], -1).T.astype("<u2")
    )  # [n, L] little-endian 16-bit
    nb = 2 * arr.shape[0]
    buf = rows.tobytes()
    flat = np.empty((rows.shape[0],), dtype=object)
    for i in range(rows.shape[0]):
        flat[i] = int.from_bytes(buf[i * nb : (i + 1) * nb], "little")
    return flat.reshape(shape).tolist()


def signed_naf(x: int) -> list:
    """Non-adjacent form digits of x >= 0 (little-endian, each in
    {-1, 0, 1}), for exponentiation by a host-constant exponent in a group
    whose inverse is cheap (the cyclotomic subgroup)."""
    digits = []
    while x != 0:
        if x & 1:
            d = 2 - (x % 4)  # 1 if x % 4 == 1 else -1
            x -= d
        else:
            d = 0
        digits.append(d)
        x >>= 1
    return digits
