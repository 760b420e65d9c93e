"""Fixed-base scalar multiplication: one base point, many scalars.

Counterpart of the JAX package's ``ops/fixed_base.py``: a table of
d * 2^(c w) * base for every window w and digit d < 2^c is built once, then
each window of every scalar picks its entry with one gather and the
windows fold with one batched addition each (kernel K7 for an a = 0 curve).
Every lane is independent, so the whole batch advances together.
"""

from __future__ import annotations

import torch

from ..curves.sw import scalar_bits_le


def window_table(curve, base, c: int, scalar_bits: int):
    """The table as a point tuple, each coordinate [L, num_windows, 2^c,
    *b] for a base of batch shape b: table[w, d] = d 2^(c w) base.

    The reference builds it as a scan over windows of a scan over entries;
    here the windows' multiples 2^(c w) base come first (c doublings each),
    then the entries of every window at once: 2^c - 1 additions over a
    [num_windows] batch, the same operations lane by lane."""
    num_windows = -(-scalar_bits // c)
    curs = [base]
    for _ in range(num_windows - 1):
        cur = curs[-1]
        for _ in range(c):
            cur = curve.double(cur)
        curs.append(cur)
    cur = tuple(torch.stack([pt[i] for pt in curs], dim=1) for i in range(len(base)))
    acc = curve.zero(curve.batch_shape(cur))
    entries = [acc]
    for _ in range((1 << c) - 1):
        acc = curve.add(acc, cur)
        entries.append(acc)
    return tuple(torch.stack([e[i] for e in entries], dim=2) for i in range(len(base)))


def msm(curve, table, scalars: torch.Tensor, c: int):
    """k_i * base for every lane: scalars int32 [Ls, n] canonical 16-bit
    limbs, ``table`` from ``window_table`` for one base (batch shape ())
    with at least 16 Ls bits of windows.  Returns the [n] batch of projective points."""
    L, n = scalars.shape
    scalar_bits = 16 * L
    num_windows = -(-scalar_bits // c)
    if table[0].shape[1] < num_windows:
        raise ValueError(f"the table has {table[0].shape[1]} windows; "
                         f"{scalar_bits}-bit scalars need {num_windows}")
    bits = scalar_bits_le(scalars).to(torch.int64)
    acc = curve.zero((n,))
    for w in range(num_windows):
        lo, hi = w * c, min(w * c + c, scalar_bits)
        weights = torch.tensor([1 << (i - lo) for i in range(lo, hi)],
                               dtype=torch.int64, device=scalars.device)
        digit = (bits[lo:hi] * weights[:, None]).sum(dim=0)
        acc = curve.add(acc, tuple(t[:, w, digit] for t in table))
    return acc
