"""Bilinear-form compiler for tower fields.

Turns a tower multiplication, or any linear combination of products, into
ONE ``mont.dot_stacked`` call over the prime field (one launch of kernel
K17): flatten the operands to their prime-field coordinates, look up the
tower's integer multiplication tensor T[o, i, j] (c_o = sum_ij T[o,i,j]
a_i b_j), and compute every output coordinate as a weighted sum of
coordinate products.

The port of the JAX package's ``fields/dot.py``, with the same weights,
the same merged pairs (``a is b``) and the same square masks, so that
``dot_multi`` takes its generic path at exactly the call sites where the
reference does.  What depends only on the structure of a call (the pairs,
the weight matrix, the mass check) is computed once per structure and
cached on the kind; a call then flattens, stacks and launches.

The tensor exists whenever every tower nonresidue acts on its base field's
prime coordinates as a SMALL-INTEGER matrix, true for the BLS12-381 tower
(u^2 = -1, xi = 1 + u, w^2 = v).
"""

from __future__ import annotations

import numpy as np
import torch

_SMALL = 1 << 12  # |entry| bound for "small-integer" classification


# --------------------------------------------------------------------------
# host arithmetic on kind structure (Python ints)
# --------------------------------------------------------------------------


def _is_prime(kind) -> bool:
    from .prime import PrimeField

    return isinstance(kind, PrimeField)


def _arity(kind):
    from .cubic import CubicExtField

    return 3 if isinstance(kind, CubicExtField) else 2


def _host_add(kind, a, b):
    if _is_prime(kind):
        return (a + b) % kind.spec.modulus
    return tuple(_host_add(kind.base, x, y) for x, y in zip(a, b))


def _host_mul(kind, a, b):
    """Schoolbook host multiply following the kind structure."""
    from .cubic import CubicExtField
    from .quadratic import QuadExtField

    if _is_prime(kind):
        return (a * b) % kind.spec.modulus
    B = kind.base
    nr = kind.nonresidue_host
    if isinstance(kind, QuadExtField):
        v0 = _host_mul(B, a[0], b[0])
        v1 = _host_mul(B, a[1], b[1])
        c0 = _host_add(B, v0, _host_mul(B, nr, v1))
        c1 = _host_add(B, _host_mul(B, a[0], b[1]), _host_mul(B, a[1], b[0]))
        return (c0, c1)
    if isinstance(kind, CubicExtField):
        def m(x, y):
            return _host_mul(B, x, y)

        def ad(*xs):
            out = xs[0]
            for x in xs[1:]:
                out = _host_add(B, out, x)
            return out

        c0 = ad(m(a[0], b[0]), _host_mul(B, nr, ad(m(a[1], b[2]), m(a[2], b[1]))))
        c1 = ad(m(a[0], b[1]), m(a[1], b[0]), _host_mul(B, nr, m(a[2], b[2])))
        c2 = ad(m(a[0], b[2]), m(a[1], b[1]), m(a[2], b[0]))
        return (c0, c1, c2)
    raise TypeError(f"no host multiply for {type(kind).__name__}")


def _host_flatten(kind, a):
    if _is_prime(kind):
        return [a]
    out = []
    for c in a:
        out.extend(_host_flatten(kind.base, c))
    return out


def _host_unflatten(kind, coords):
    if _is_prime(kind):
        return coords[0]
    d = len(coords) // _arity(kind)
    return tuple(_host_unflatten(kind.base, coords[k * d : (k + 1) * d])
                 for k in range(_arity(kind)))


def _host_unit(kind, i, dim):
    """i-th prime-basis unit vector as a host tower value."""
    coords = [0] * dim
    coords[i] = 1
    return _host_unflatten(kind, coords)


def _as_small_int(p: int, e: int):
    """Field element (canonical int) -> small signed int, or None."""
    if e <= _SMALL:
        return e
    if p - e <= _SMALL:
        return -(p - e)
    return None


# --------------------------------------------------------------------------
# multiplication tensor
# --------------------------------------------------------------------------


def mul_tensor(kind):
    """Integer multiplication tensor {(o, i, j): int} over prime
    coordinates, or None if the tower is not small-int structured.
    Computed by host-multiplying prime-basis unit vectors."""
    if getattr(kind, "_mul_tensor_cache", "unset") != "unset":
        return kind._mul_tensor_cache
    if _is_prime(kind):
        kind._mul_tensor_cache = {(0, 0, 0): 1}
        return kind._mul_tensor_cache
    dim = kind.extension_degree() // kind.prime_kind().extension_degree()
    p = kind.characteristic()
    tensor = {}
    ok = True
    try:
        units = [_host_unit(kind, i, dim) for i in range(dim)]
        for i in range(dim):
            for j in range(dim):
                prod = _host_flatten(kind, _host_mul(kind, units[i], units[j]))
                for o, e in enumerate(prod):
                    if e == 0:
                        continue
                    s = _as_small_int(p, e)
                    if s is None:
                        ok = False
                        break
                    tensor[(o, i, j)] = s
                if not ok:
                    break
            if not ok:
                break
    except TypeError:
        ok = False
    kind._mul_tensor_cache = tensor if ok else None
    return kind._mul_tensor_cache


# --------------------------------------------------------------------------
# device-side flatten / unflatten
# --------------------------------------------------------------------------


def flatten_coords(kind, a):
    """Tower element -> list of [L, *batch] prime coordinate tensors."""
    if _is_prime(kind):
        return [a]
    out = []
    for c in a:
        out.extend(flatten_coords(kind.base, c))
    return out


def unflatten_coords(kind, coords):
    if _is_prime(kind):
        return coords[0]
    d = len(coords) // _arity(kind)
    return tuple(unflatten_coords(kind.base, coords[k * d : (k + 1) * d])
                 for k in range(_arity(kind)))


# --------------------------------------------------------------------------
# the dot entry point
# --------------------------------------------------------------------------


def dot(kind, terms):
    """sum of s * (a * b) over terms, computed as ONE prime-field kernel.

    terms: list of (s:int, a, b, a_mask, b_mask) where a/b are elements
    of ``kind`` and the optional masks are per-prime-coordinate bool
    tuples marking structurally nonzero coordinates (None = all).
    Returns an element of ``kind``, or None if the kind has no
    small-integer multiplication tensor or the weight mass exceeds the
    kernel's bound (callers fall back to the generic path).
    """
    out = dot_multi(kind, [terms])
    return None if out is None else out[0]


def _plan(kind, T, dim, structure):
    """The pairs (g, t, i, j) in column order and the weight matrix of one
    call structure (per term: s, a_mask, b_mask, a is b), or None where a
    row's weight mass exceeds ``mont.dot_mass_limit``: the reference's
    column bookkeeping, done once."""
    from ..ops import mont

    pairs = {}  # (group_idx, term_idx, i, j) -> column index
    entries = []  # (row, col, w)
    for g_idx, terms in enumerate(structure):
        for t_idx, (s, a_mask, b_mask, symmetric) in enumerate(terms):
            if s == 0:
                continue
            for (o, i, j), w in T.items():
                if a_mask is not None and not a_mask[i]:
                    continue
                if b_mask is not None and not b_mask[j]:
                    continue
                if symmetric and j < i:
                    i, j = j, i  # (i,j)/(j,i) coincide when a == b
                col = pairs.setdefault((g_idx, t_idx, i, j), len(pairs))
                entries.append((g_idx * dim + o, col, s * w))
    if not pairs:
        return {"pairs": []}
    W = np.zeros((dim * len(structure), len(pairs)), np.int64)
    for row, col, w in entries:
        W[row, col] += w
    if int(np.abs(W).sum(axis=1).max()) > mont.dot_mass_limit(kind.prime_kind().spec):
        return None
    return {"pairs": sorted(pairs, key=pairs.get), "W": W}


def _mask_key(term, at: int):
    return tuple(term[at]) if len(term) > at and term[at] is not None else None


def dot_multi(kind, groups):
    """Several independent linear combinations of products, ALL in one
    prime-field kernel.  ``groups`` is a list of term lists (see ``dot``);
    returns a list of kind elements, or None on fallback.

    The workhorse for hand-fused formulas (pairing step functions, curve
    group laws): every output of a formula round is a weight-matrix row
    instead of a chain of mul/add launches.
    """
    from ..ops import mont

    T = mul_tensor(kind)
    if T is None:
        return None
    spec = kind.prime_kind().spec
    dim = kind.extension_degree() // kind.prime_kind().extension_degree()

    structure = tuple(
        tuple((term[0], _mask_key(term, 3), _mask_key(term, 4), term[1] is term[2])
              for term in terms)
        for terms in groups)
    cache = kind.__dict__.setdefault("_dot_plans", {})
    if structure not in cache:
        cache[structure] = _plan(kind, T, dim, structure)
    plan = cache[structure]
    if plan is None:
        return None
    if not plan["pairs"]:
        return [kind.zero(()) for _ in groups]

    flat = {}
    for g_idx, terms in enumerate(groups):
        for t_idx, term in enumerate(terms):
            if term[0] != 0:
                flat[(g_idx, t_idx)] = (flatten_coords(kind, term[1]),
                                        flatten_coords(kind, term[2]))

    # broadcast all coordinates to a common batch shape
    batch = torch.broadcast_shapes(*[c.shape[1:] for fa, fb in flat.values()
                                     for c in (*fa, *fb)])
    L = spec.n_limbs

    def bc(c):
        return mont.expand(c, len(batch)).expand((L,) + tuple(batch))

    cols_a, cols_b, sq_mask = [], [], []
    for g_idx, t_idx, i, j in plan["pairs"]:
        fa, fb = flat[(g_idx, t_idx)]
        cols_a.append(bc(fa[i]))
        cols_b.append(bc(fb[j]))
        sq_mask.append(fa[i] is fb[j])  # self-products square in the kernel
    A = torch.stack(cols_a, dim=1)
    B = torch.stack(cols_b, dim=1)
    out = mont.dot_stacked(spec, A, B, plan["W"], square_mask=sq_mask)
    return [unflatten_coords(kind, [out[:, g * dim + o] for o in range(dim)])
            for g in range(len(groups))]
