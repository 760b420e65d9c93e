"""GLV endomorphism scalar multiplication.

Counterpart of the JAX package's ``ops/glv.py``.  k decomposes as
k = k1 + k2 lambda (mod r) with |k1|, |k2| ~ sqrt(r) through the curve's
LLL-reduced basis; phi(x, y) = (beta x, y) multiplies by lambda, so a joint
double-and-add over (k1, k2) takes about half the steps of one over k.
The decomposition is exact integer arithmetic on ~256-bit values: on the
host for a host scalar, and for a batch of scalars on the device by
Babai rounding over 16-bit limbs (``decompose_traced``).

The limb helpers compute in int64, where the reference computes in uint32
(torch on the CPU cannot add, shift or compare uint32): every column sum
and carry is the same non-negative integer below 2^32, a borrow is the
same bit (an arithmetic shift of a negative difference gives -1, whose low
bit is the one the uint32 wrap gives), so the limbs are the reference's.
On the device a step of ``glv_mul`` is one doubling (kernel K6), three
point selects and one addition (kernel K7); phi is one product (K1).
"""

from __future__ import annotations

import torch

M16 = 0xFFFF


def decompose(glv: dict, r: int, k: int):
    """k -> (k1, k2) with k = k1 + k2 lam (mod r), short: Babai rounding
    against the basis rows (a1, b1), (a2, b2)."""
    (a1, b1), (a2, b2) = glv["basis"]
    det = a1 * b2 - a2 * b1
    c1 = (b2 * k + det // 2) // det
    c2 = (-b1 * k + det // 2) // det
    k1 = k - c1 * a1 - c2 * a2
    k2 = -c1 * b1 - c2 * b2
    if (k1 + k2 * glv["lam"] - k) % r:
        raise ArithmeticError("the GLV basis does not decompose k")
    return k1, k2


def endomorphism(curve, P):
    """phi(x, y, z) = (beta x, y, z): lambda P on the prime-order group."""
    beta = curve.base.constant(curve.glv["beta"], curve.base.batch_shape(P[0]))
    return (curve.base.mul(P[0], beta), P[1], P[2])


def glv_mul_host(curve, P, k: int):
    """P * k for a host scalar: the joint double-and-add over the host
    decomposition, a digit b1 + 2 b2 picking one of [0, P1, P2, P1 + P2]
    each step.  The digits are the same in every lane, so the reference's
    table gather is a host choice here."""
    r = curve.scalar_modulus
    k1, k2 = decompose(curve.glv, r, int(k) % r)
    P1 = P if k1 >= 0 else curve.neg(P)
    P2 = endomorphism(curve, P)
    if k2 < 0:
        P2 = curve.neg(P2)
    k1, k2 = abs(k1), abs(k2)
    nbits = max(k1.bit_length(), k2.bit_length(), 1)
    zero = curve.zero(curve.batch_shape(P))
    table = (zero, P1, P2, curve.add(P1, P2))
    acc = zero
    for i in range(nbits - 1, -1, -1):
        acc = curve.double(acc)
        acc = curve.add(acc, table[((k1 >> i) & 1) | (((k2 >> i) & 1) << 1)])
    return acc


def _const_limbs(v: int, L: int) -> list:
    """Non-negative host int -> L 16-bit limbs (Python ints)."""
    if v < 0:
        raise ValueError("a negative constant has no limbs")
    return [(v >> (16 * i)) & M16 for i in range(L)]


def _mul_const_round_shift(x: torch.Tensor, g: int, m_limbs: int,
                           out_limbs: int) -> torch.Tensor:
    """round(x g / 2^(16 m_limbs)) over 16-bit limbs: x int64 [Lx, n]
    canonical limbs, g a non-negative host int; int64 [out_limbs, n] with
    the carries propagated."""
    Lx, n = x.shape
    Lg = max(1, -(-g.bit_length() // 16))
    ncols = m_limbs + out_limbs + 1
    cols = [None] * ncols
    for j, gj in enumerate(_const_limbs(g, Lg)):
        if gj == 0:
            continue
        for i in range(Lx):
            k = i + j
            if k >= ncols:
                break
            prod = x[i] * gj
            lo, hi = prod & M16, prod >> 16
            cols[k] = lo if cols[k] is None else cols[k] + lo
            if k + 1 < ncols:
                cols[k + 1] = hi if cols[k + 1] is None else cols[k + 1] + hi
    zero = torch.zeros(n, dtype=torch.int64, device=x.device)
    cols = [zero if c is None else c for c in cols]
    cols[m_limbs - 1] = cols[m_limbs - 1] + 0x8000  # rounding: + 2^(16 m - 1)
    carry = zero
    out = []
    for k in range(ncols):
        v = cols[k] + carry
        if k >= m_limbs and len(out) < out_limbs:
            out.append(v & M16)
        carry = v >> 16
    while len(out) < out_limbs:
        out.append(zero)
    return torch.stack(out, dim=0)


def _mul_const_mod(x: torch.Tensor, c: int, W: int) -> torch.Tensor:
    """(x c) mod 2^(16 W) over 16-bit limbs (c a non-negative host int)."""
    Lx, n = x.shape
    Lc = max(1, -(-c.bit_length() // 16))
    zero = torch.zeros(n, dtype=torch.int64, device=x.device)
    cols = [zero] * W
    for j, cj in enumerate(_const_limbs(c, Lc)):
        if cj == 0 or j >= W:
            continue
        for i in range(min(Lx, W - j)):
            k = i + j
            prod = x[i] * cj
            cols[k] = cols[k] + (prod & M16)
            if k + 1 < W:
                cols[k + 1] = cols[k + 1] + (prod >> 16)
    carry = zero
    out = []
    for k in range(W):
        v = cols[k] + carry
        out.append(v & M16)
        carry = v >> 16
    return torch.stack(out, dim=0)


def _add_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod 2^(16 W), limb arrays of one shape."""
    carry = torch.zeros_like(a[0])
    out = []
    for k in range(a.shape[0]):
        v = a[k] + b[k] + carry
        out.append(v & M16)
        carry = v >> 16
    return torch.stack(out, dim=0)


def _sub_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod 2^(16 W)."""
    borrow = torch.zeros_like(a[0])
    out = []
    for k in range(a.shape[0]):
        v = a[k] - b[k] - borrow
        out.append(v & M16)
        borrow = (v >> 16) & 1
    return torch.stack(out, dim=0)


def _to_sign_magnitude(t: torch.Tensor):
    """Two's complement mod 2^(16 W) -> (neg [n] bool, magnitude [W, n])."""
    neg = (t[-1] >> 15) != 0
    inv = (~t) & M16
    carry = torch.ones_like(t[0])
    rows = []
    for k in range(t.shape[0]):
        v = inv[k] + carry
        rows.append(v & M16)
        carry = v >> 16
    return neg, torch.where(neg[None, :], torch.stack(rows, dim=0), t)


def _basis_width(glv: dict) -> tuple:
    """(W, nbits): the limbs of a magnitude (the basis entries and 3 bits
    of slack) and the bits the joint scan walks."""
    max_basis = max(abs(v) for row in glv["basis"] for v in row)
    W = -(-(max_basis.bit_length() + 3) // 16)
    return W, min(16 * W, max_basis.bit_length() + 3)


def decompose_traced(glv: dict, r: int, scalars: torch.Tensor):
    """Babai rounding of a batch of canonical scalars (int32 [Ls, n]
    16-bit limbs, values < r): (neg1 [n], mag1 [W, n], neg2, mag2) with
    k = (-1)^neg1 mag1 + (-1)^neg2 mag2 lambda (mod r), magnitudes int64
    limbs below 2^(16 W - 1).

    c_i = round(k beta_i / det) is taken as
    (k round(beta_i 2^m / det) + 2^(m-1)) >> m with m 16 bits above k's
    width: off by at most one, which lengthens k1, k2 by at most a bit
    (k1 + k2 lambda = k (mod r) holds for any c_i).  The signs of the basis
    entries are host decisions."""
    (a1, b1), (a2, b2) = glv["basis"]
    det = a1 * b2 - a2 * b1
    if det < 0:  # normalise so that the rounding constants have det > 0
        a1, b1, a2, b2, det = -a1, -b1, -a2, -b2, -det
    k = scalars.to(torch.int64)
    Ls = k.shape[0]
    m_limbs = Ls + 1
    m = 16 * m_limbs
    W, _ = _basis_width(glv)
    c_limbs = W + 1

    def round_mul(beta: int):
        """c = round(k beta / det) as (neg, magnitude limbs)."""
        g = (abs(beta) << m) // det
        return beta < 0, _mul_const_round_shift(k, g, m_limbs, c_limbs)

    n1, c1 = round_mul(b2)
    n2, c2 = round_mul(-b1)

    def acc_k(base, pairs):
        """base - sum(c const), exact mod 2^(16 W)."""
        t = base
        for neg_c, c, const in pairs:
            term = _mul_const_mod(c, abs(const), W)
            if (const < 0) != neg_c:  # the term's sign: sign(c) xor sign(const)
                t = _add_mod(t, term)
            else:
                t = _sub_mod(t, term)
        return t

    if Ls >= W:
        k_low = k[:W]
    else:
        k_low = torch.cat([k, k.new_zeros((W - Ls,) + tuple(k.shape[1:]))], dim=0)
    # k1 = k - c1 a1 - c2 a2;  k2 = -c1 b1 - c2 b2
    t1 = acc_k(k_low, [(n1, c1[:W], a1), (n2, c2[:W], a2)])
    t2 = acc_k(torch.zeros_like(k_low), [(n1, c1[:W], b1), (n2, c2[:W], b2)])
    neg1, mag1 = _to_sign_magnitude(t1)
    neg2, mag2 = _to_sign_magnitude(t2)
    return neg1, mag1, neg2, mag2


def glv_mul(curve, P, scalars: torch.Tensor):
    """P * k lane by lane for a batch of scalars: ``decompose_traced``, then
    the joint double-and-add over the bits of (k1, k2), MSB first, each
    step adding one of [0, P1, P2, P1 + P2] (P1 = +-P, P2 = +-phi(P)) picked
    by two selects: ~(bits/2 + 3) steps instead of ``bits``.

    P: Jacobian points with batch shape ``scalars.shape[1:]``; scalars:
    int32 [Ls, *batch] canonical 16-bit limbs."""
    batch = tuple(scalars.shape[1:])
    if len(batch) != 1:  # the limb helpers take one batch axis
        nb = scalars[0].numel()
        out = glv_mul(curve, tuple(c.reshape(c.shape[0], nb) for c in P),
                      scalars.reshape(scalars.shape[0], nb))
        return tuple(c.reshape(c.shape[:1] + batch) for c in out)
    neg1, mag1, neg2, mag2 = decompose_traced(curve.glv, curve.scalar_modulus, scalars)
    _, nbits = _basis_width(curve.glv)
    P1 = curve.select(neg1, curve.neg(P), P)
    P2 = endomorphism(curve, P)
    P2 = curve.select(neg2, curve.neg(P2), P2)
    both = curve.add(P1, P2)
    zero = curve.zero(curve.batch_shape(P))

    def bits_of(mag):  # [nbits, n] bool, MSB first
        return torch.stack([(mag[i // 16] >> (i % 16)) & 1 != 0
                            for i in range(nbits - 1, -1, -1)], dim=0)

    b1v, b2v = bits_of(mag1), bits_of(mag2)
    acc = zero
    for bb1, bb2 in zip(b1v, b2v):
        acc = curve.double(acc)
        lo = curve.select(bb1, P1, zero)
        hi = curve.select(bb1, both, P2)
        acc = curve.add(acc, curve.select(bb2, hi, lo))
    return acc
