"""Short-Weierstrass curves: batched Jacobian group law over any field kind.

Counterpart of the JAX package's ``curves/sw.py``.  A *curve kind* is an
object whose methods act on batched point values, the way field kinds act
on batched limb tensors.

Representations
  * projective batch: ``(x, y, z)``, base-field values in Jacobian
    coordinates (affine x = X/Z^2, y = Y/Z^3); the point at infinity is any
    representative with Z == 0.
  * affine batch: ``(x, y, inf)`` with ``inf`` a bool batch mask.

The group law is the reference's, lane for lane: the same EFD formulas
(dbl-2009-l / dbl-2007-bl, add-2007-bl, madd-2007-bl) and the same order
of exceptional-case selects, so every output is the reference's, bit for
bit.  Where the base is a prime field and a = 0 (BLS12-381 G1, secp256k1)
the three laws run as the CUDA kernels of ``ops/sw_kernels.py`` (a CPU
tensor takes their plain versions); for a != 0 they are composed from field
operations.  Over a tower base (BLS12-381 G2 over Fq2) they are the
reference's fused "waves": each round of a formula is one
``fields/dot.dot_multi`` call, one K17 launch.  The batched affine addition
(``affine_add``) runs as kernels K9/K10 for any a over a prime base, and
as the reference's composed body over a tower.  Loops the reference runs as
``lax.scan`` are Python loops over launches.
"""

from __future__ import annotations

import torch

from ..bigint import int_to_limbs
from ..fields import dot as dot_mod
from ..fields.cubic import CubicExtField
from ..fields.host_tower import HostCubicExt, HostPrime, HostQuadExt
from ..fields.prime import PrimeField
from ..fields.quadratic import QuadExtField
from ..ops import sw_kernels


def scalar_bits_le(scalars: torch.Tensor) -> torch.Tensor:
    """int32 [Ls, *batch] 16-bit-limb scalars -> bool [16*Ls, *batch] LE bits."""
    L = scalars.shape[0]
    shifts = torch.arange(16, dtype=scalars.dtype, device=scalars.device)
    shifts = shifts.reshape((1, 16) + (1,) * (scalars.ndim - 1))
    bits = (scalars[:, None] >> shifts) & 1
    return bits.reshape((16 * L,) + tuple(scalars.shape[1:])).to(torch.bool)


class SWCurve:
    """y^2 = x^3 + a*x + b over a field kind (prime or a tower); a and b are
    host values of the base (ints, or nested tuples over a tower)."""

    def __init__(self, base, a_host, b_host, generator_host, cofactor: int,
                 scalar_modulus: int, name: str = "SW", glv=None):
        self.base = base
        self.name = name
        self._prime_base = isinstance(base, PrimeField)
        self.a_host = int(a_host) if self._prime_base else a_host
        self.b_host = int(b_host) if self._prime_base else b_host
        self.generator_host = generator_host
        self.cofactor = int(cofactor)
        self.scalar_modulus = int(scalar_modulus)
        self.cofactor_inv = pow(self.cofactor, -1, self.scalar_modulus)
        hf = self._hf()
        self.a_is_zero = hf.equal(hf.add(self.a_host, hf.zero()), hf.zero())
        # GLV parameters (``ops/glv.py``): {"beta", "lam", "basis"}, or None
        self.glv = glv
        # optional fast subgroup checks installed by curve instances:
        #   host fn: (curve, host_pt) -> bool      (host_pt never None)
        #   device fn: (curve, projective batch) -> bool tensor
        self.subgroup_check_host = None
        self.subgroup_check_device = None

    @property
    def _kernels(self) -> bool:
        """The group-law kernels serve a = 0 curves over a prime field; the
        device of the tensors decides kernel or plain version."""
        return self._prime_base and self.a_is_zero

    @property
    def _waves(self) -> bool:
        """Over a tower with a small-integer multiplication tensor the group
        law runs as the reference's ``dot_multi`` waves."""
        return not self._prime_base and dot_mod.mul_tensor(self.base) is not None

    @property
    def device(self) -> torch.device:
        return self.base.device

    # ------------------------------------------------------------ constants
    def zero(self, batch_shape=()):
        """Point at infinity (1 : 1 : 0)."""
        one = self.base.one(batch_shape)
        return (one, one, self.base.zero(batch_shape))

    def generator(self, batch_shape=()):
        gx, gy = self.generator_host
        return (self.base.constant(gx, batch_shape), self.base.constant(gy, batch_shape),
                self.base.one(batch_shape))

    def generator_affine(self, batch_shape=()):
        gx, gy = self.generator_host
        return (self.base.constant(gx, batch_shape), self.base.constant(gy, batch_shape),
                torch.zeros(tuple(batch_shape), dtype=torch.bool, device=self.device))

    def _mul_by_a(self, x):
        if self.a_is_zero:
            return self.base.zero(self.base.batch_shape(x))
        return self.base.mul(x, self.base.constant(self.a_host, self.base.batch_shape(x)))

    # ----------------------------------------------------------- predicates
    def is_zero(self, P):
        return self.base.is_zero(P[2])

    def batch_shape(self, P):
        return self.base.batch_shape(P[0])

    def select(self, mask, P, Q):
        """Lane-wise select between two point batches (mask over batch dims)."""
        return tuple(self.base.select(mask, p, q) for p, q in zip(P, Q))

    def index_point(self, P, idx):
        """Slice/gather a point batch along the leading batch axis."""
        return tuple(self.base.index(p, idx) for p in P)

    def equal(self, P, Q):
        """Projective equality x1 z2^2 == x2 z1^2 && y1 z2^3 == y2 z1^3."""
        B = self.base
        z1z1, z2z2 = B.square(P[2]), B.square(Q[2])
        xe = B.equal(B.mul(P[0], z2z2), B.mul(Q[0], z1z1))
        ye = B.equal(B.mul(P[1], B.mul(z2z2, Q[2])), B.mul(Q[1], B.mul(z1z1, P[2])))
        both_inf = self.is_zero(P) & self.is_zero(Q)
        either_inf = self.is_zero(P) | self.is_zero(Q)
        return torch.where(either_inf, both_inf, xe & ye)

    # ------------------------------------------------------------ group law
    def neg(self, P):
        return (P[0], self.base.neg(P[1]), P[2])

    def double(self, P, out=None):
        """Jacobian doubling: dbl-2009-l for a = 0 (kernel K6), dbl-2007-bl
        otherwise.  Infinity and 2-torsion fall out (Z3 = 2*Y1*Z1 == 0).
        ``out``: arrays to write the result to (the kernel's in place)."""
        if self._kernels:
            return sw_kernels.double(self.base.spec, P, out=out)
        B = self.base
        X1, Y1, Z1 = P
        if self.a_is_zero and self._waves:
            # dbl-2009-l flattened into three waves:
            #   A = X^2, Bv = Y^2, D = 4*X*Bv,
            #   X3 = 9*A^2 - 8*X*Bv, Z3 = 2*Y*Z, Y3 = 3*A*(D - X3) - 8*Bv^2
            A, Bv, Z3 = dot_mod.dot_multi(B, [[(1, X1, X1)], [(1, Y1, Y1)], [(2, Y1, Z1)]])
            D, X3 = dot_mod.dot_multi(B, [[(4, X1, Bv)], [(9, A, A), (-8, X1, Bv)]])
            S = B.sub(D, X3)
            (Y3,) = dot_mod.dot_multi(B, [[(3, A, S), (-8, Bv, Bv)]])
            return sw_kernels.store((X3, Y3, Z3), out)
        XX = B.square(X1)
        YY = B.square(Y1)
        YYYY = B.square(YY)
        ZZ = B.square(Z1)
        S = B.double(B.sub(B.sub(B.square(B.add(X1, YY)), XX), YYYY))
        M = B.add(B.add(B.double(XX), XX), self._mul_by_a(B.square(ZZ)))
        X3 = B.sub(B.square(M), B.double(S))
        Y3 = B.sub(B.mul(M, B.sub(S, X3)), B.double(B.double(B.double(YYYY))))
        Z3 = B.sub(B.sub(B.square(B.add(Y1, Z1)), YY), ZZ)
        return sw_kernels.store((X3, Y3, Z3), out)

    def add(self, P, Q, out=None):
        """Full Jacobian addition (add-2007-bl) with the exceptional cases:
        P == Q -> double, then Q = inf -> P, then P = inf -> Q.  Kernel K7
        for a = 0."""
        if self._kernels:
            return sw_kernels.add(self.base.spec, P, Q, out=out)
        B = self.base
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        if self._waves:
            # add-2007-bl flattened into five waves.  With rho = S2 - S1
            # (r = 2 rho), I = 4 H^2, J = H I, V = U1 I:
            #   X3 = 4 rho^2 - 4 H^3 - 8 U1 H^2
            #   Y3 = 2 rho (V - X3) - 8 S1 H^3
            #   Z3 = 2 Z1 Z2 H
            ZZ1, ZZ2, ZZ12, YZ12, YZ21 = dot_mod.dot_multi(B, [
                [(1, Z1, Z1)], [(1, Z2, Z2)], [(1, Z1, Z2)], [(1, Y1, Z2)], [(1, Y2, Z1)]])
            U1, S1, H, rho = dot_mod.dot_multi(B, [
                [(1, X1, ZZ2)],
                [(1, YZ12, ZZ2)],
                [(1, X2, ZZ1), (-1, X1, ZZ2)],
                [(1, YZ21, ZZ1), (-1, YZ12, ZZ2)],
            ])
            HH, Z3 = dot_mod.dot_multi(B, [[(1, H, H)], [(2, ZZ12, H)]])
            X3, V, J4 = dot_mod.dot_multi(B, [
                [(4, rho, rho), (-4, H, HH), (-8, U1, HH)],
                [(4, U1, HH)],
                [(4, H, HH)],
            ])
            S5 = B.sub(V, X3)
            (Y3,) = dot_mod.dot_multi(B, [[(2, rho, S5), (-2, S1, J4)]])
            same = B.is_zero(H) & B.is_zero(rho)
            res = self.select(same, self.double(P), (X3, Y3, Z3))
            res = self.select(self.is_zero(Q), P, res)
            res = self.select(self.is_zero(P), Q, res)
            return sw_kernels.store(res, out)
        Z1Z1 = B.square(Z1)
        Z2Z2 = B.square(Z2)
        U1 = B.mul(X1, Z2Z2)
        U2 = B.mul(X2, Z1Z1)
        S1 = B.mul(Y1, B.mul(Z2, Z2Z2))
        S2 = B.mul(Y2, B.mul(Z1, Z1Z1))
        H = B.sub(U2, U1)
        r = B.double(B.sub(S2, S1))
        I = B.square(B.double(H))
        J = B.mul(H, I)
        V = B.mul(U1, I)
        X3 = B.sub(B.sub(B.square(r), J), B.double(V))
        Y3 = B.sub(B.mul(r, B.sub(V, X3)), B.double(B.mul(S1, J)))
        Z3 = B.mul(B.sub(B.sub(B.square(B.add(Z1, Z2)), Z1Z1), Z2Z2), H)
        same = B.is_zero(H) & B.is_zero(r)
        res = self.select(same, self.double(P), (X3, Y3, Z3))
        res = self.select(self.is_zero(Q), P, res)
        res = self.select(self.is_zero(P), Q, res)
        return sw_kernels.store(res, out)

    def add_mixed(self, P, aff, out=None):
        """Mixed addition P + affine Q (madd-2007-bl); ``aff`` is an affine
        batch (x, y, inf).  Kernel K8 for a = 0."""
        if self._kernels:
            return sw_kernels.madd(self.base.spec, P, aff, out=out)
        B = self.base
        X1, Y1, Z1 = P
        X2, Y2, inf2 = aff
        if self._waves:
            # madd-2007-bl flattened into five waves.  With rho = S2 - Y1
            # (r = 2 rho), I = 4 HH, J = H I, V = X1 I:
            #   X3 = 4 rho^2 - 4 H HH - 8 X1 HH
            #   Y3 = 2 rho (V - X3) - 8 Y1 H HH
            #   Z3 = 2 Z1 H
            ZZ, YZ = dot_mod.dot_multi(B, [[(1, Z1, Z1)], [(1, Y2, Z1)]])
            U2, S2 = dot_mod.dot_multi(B, [[(1, X2, ZZ)], [(1, YZ, ZZ)]])
            H = B.sub(U2, X1)
            rho = B.sub(S2, Y1)
            HH, Z3 = dot_mod.dot_multi(B, [[(1, H, H)], [(2, Z1, H)]])
            X3, V, J4 = dot_mod.dot_multi(B, [
                [(4, rho, rho), (-4, H, HH), (-8, X1, HH)],
                [(4, X1, HH)],
                [(4, H, HH)],
            ])
            S5 = B.sub(V, X3)
            (Y3,) = dot_mod.dot_multi(B, [[(2, rho, S5), (-2, Y1, J4)]])
            same = B.is_zero(H) & B.is_zero(rho)
            res = self.select(same, self.double(P), (X3, Y3, Z3))
            res = self.select(inf2, P, res)
            res = self.select(self.is_zero(P), self.from_affine(aff), res)
            return sw_kernels.store(res, out)
        Z1Z1 = B.square(Z1)
        U2 = B.mul(X2, Z1Z1)
        S2 = B.mul(Y2, B.mul(Z1, Z1Z1))
        H = B.sub(U2, X1)
        r = B.double(B.sub(S2, Y1))
        HH = B.square(H)
        I = B.double(B.double(HH))
        J = B.mul(H, I)
        V = B.mul(X1, I)
        X3 = B.sub(B.sub(B.square(r), J), B.double(V))
        Y3 = B.sub(B.mul(r, B.sub(V, X3)), B.double(B.mul(Y1, J)))
        Z3 = B.sub(B.sub(B.square(B.add(Z1, H)), Z1Z1), HH)
        same = B.is_zero(H) & B.is_zero(r)
        res = self.select(same, self.double(P), (X3, Y3, Z3))
        res = self.select(inf2, P, res)
        res = self.select(self.is_zero(P), self.from_affine(aff), res)
        return sw_kernels.store(res, out)

    def sub(self, P, Q):
        return self.add(P, self.neg(Q))

    def affine_add(self, P, Q, inv_fn, neg1=None, neg2=None):
        """Batched affine P + Q -> (x3, y3, inf3) by the chord/tangent law,
        every exceptional case selected as the reference does: P or Q at
        infinity -> the other; x1 = x2, y1 = y2 != 0 -> the tangent;
        x1 = x2 otherwise -> infinity.  ``inv_fn`` inverts the [L, *batch]
        batch of slope denominators (zero to zero), e.g.
        ``self.base.batch_inverse``: about three products a lane, so an
        affine sum costs ~7 products against ~19 for the Jacobian mixed add.
        ``neg1``/``neg2``: optional bool masks negating the y of the
        corresponding operand first.  Over a prime base: kernels K9, K10
        around ``inv_fn`` (``sw_kernels.affine_add``), whatever the batch
        shape; over a tower the reference's composed body."""
        if not self._prime_base:
            return self._affine_add_composed(P, Q, inv_fn, neg1, neg2)
        a_mont = None
        if not self.a_is_zero:
            spec = self.base.spec
            a_mont = tuple(int(v) for v in int_to_limbs(
                self.a_host * spec.R % spec.modulus, spec.n_limbs))
        return sw_kernels.affine_add(self.base.spec, a_mont, P, Q, inv_fn,
                                     neg1=neg1, neg2=neg2)

    def _affine_add_composed(self, P, Q, inv_fn, neg1, neg2):
        """``affine_add`` from field operations: the tangent or the chord
        and every exceptional case selected, in the reference's order."""
        B = self.base
        x1, y1, i1 = P
        x2, y2, i2 = Q
        if neg1 is not None:
            y1 = B.select(neg1, B.neg(y1), y1)
        if neg2 is not None:
            y2 = B.select(neg2, B.neg(y2), y2)
        d = B.sub(x2, x1)
        same_x = B.is_zero(d)
        dbl = same_x & B.equal(y1, y2) & ~B.is_zero(y1)
        opp = same_x & ~dbl
        x1sq = B.square(x1)
        three_x1sq = B.add(B.add(x1sq, x1sq), x1sq)
        if not self.a_is_zero:
            three_x1sq = B.add(three_x1sq, B.constant(self.a_host, B.batch_shape(x1)))
        num = B.select(dbl, three_x1sq, B.sub(y2, y1))
        denom = B.select(dbl, B.add(y1, y1), d)
        degenerate = i1 | i2 | opp
        shape = B.batch_shape(x1)
        denom = B.select(degenerate, B.one(shape), denom)
        lam = B.mul(num, inv_fn(denom))
        x3 = B.sub(B.sub(B.square(lam), x1), x2)
        y3 = B.sub(B.mul(lam, B.sub(x1, x3)), y1)
        x3 = B.select(i1, x2, B.select(i2, x1, x3))
        y3 = B.select(i1, y2, B.select(i2, y1, y3))
        inf3 = torch.where(i1, i2, torch.where(i2, i1, opp))
        return (x3, y3, inf3)

    # ------------------------------------------------------- representation
    def from_affine(self, aff):
        """(x, y, inf) -> Jacobian; infinity maps to (1, 1, 0)."""
        B = self.base
        x, y, inf = aff
        shape = B.batch_shape(x)
        one, zero = B.one(shape), B.zero(shape)
        return (B.select(inf, one, x), B.select(inf, one, y), B.select(inf, zero, one))

    def to_affine(self, P):
        """Batch-normalise to affine: one batched inversion of Z
        (``PrimeField.inverse``)."""
        B = self.base
        X, Y, Z = P
        inf = self.is_zero(P)
        zinv = B.inverse(Z)  # 0 -> 0
        zinv2 = B.square(zinv)
        x = B.mul(X, zinv2)
        y = B.mul(Y, B.mul(zinv2, zinv))
        shape = B.batch_shape(x)
        x = B.select(inf, B.zero(shape), x)
        y = B.select(inf, B.one(shape), y)
        return (x, y, inf)

    def affine_neg(self, aff):
        return (aff[0], self.base.neg(aff[1]), aff[2])

    def is_on_curve(self, aff):
        """y^2 == x^3 + a x + b; infinity lanes count as on the curve."""
        B = self.base
        x, y, inf = aff
        shape = B.batch_shape(x)
        rhs = B.add(B.add(B.mul(B.square(x), x), self._mul_by_a(x)),
                    B.constant(self.b_host, shape))
        return inf | B.equal(B.square(y), rhs)

    # ----------------------------------------------------------- scalar mul
    def scalar_mul(self, P, scalars: torch.Tensor, use_glv: bool | None = None):
        """P * scalar for per-lane scalars (int32 [Ls, *batch] canonical
        16-bit limbs): MSB-first double-and-add over all 16*Ls bits, the
        reference's ``lax.scan`` as a loop.  A curve with GLV parameters
        takes the endomorphism split (``ops/glv.glv_mul``: about half the
        steps) when the scalars cover the scalar field's width, unless
        ``use_glv`` says otherwise."""
        if use_glv is None:
            use_glv = (self.glv is not None
                       and 16 * scalars.shape[0] >= self.scalar_modulus.bit_length())
        if use_glv and self.glv is not None:
            from ..ops import glv

            return glv.glv_mul(self, P, scalars)
        bits = scalar_bits_le(scalars)
        acc = self.zero(self.batch_shape(P))
        for i in range(bits.shape[0] - 1, -1, -1):
            acc = self.double(acc)
            acc = self.select(bits[i], self.add(acc, P), acc)
        return acc

    def mul_bits_be(self, P, bits):
        """P * scalar from an explicit big-endian host bit sequence, with NO
        reduction (bits may exceed the scalar field)."""
        k = 0
        for b in bits:
            k = (k << 1) | int(bool(b))
        return self.mul_int(P, k)

    def mul_int(self, P, k: int):
        """P * k for a host-constant k, MSB-first double-and-add.  The bit
        is the same in every lane, so the reference's select over a
        broadcast bit is a host branch here (the same result)."""
        k = int(k)
        if k == 0:
            return self.zero(self.batch_shape(P))
        if k < 0:
            return self.neg(self.mul_int(P, -k))
        nbits = k.bit_length()
        if nbits <= 4:
            acc = None
            for bit in bin(k)[2:]:
                if acc is not None:
                    acc = self.double(acc)
                if bit == "1":
                    acc = P if acc is None else self.add(acc, P)
            return acc
        acc = self.zero(self.batch_shape(P))
        for bit in bin(k)[2:]:
            acc = self.double(acc)
            if bit == "1":
                acc = self.add(acc, P)
        return acc

    def clear_cofactor(self, P):
        """Multiply by the cofactor; instances may install a faster map."""
        return self.mul_int(P, self.cofactor)

    def is_in_correct_subgroup(self, P):
        """Subgroup membership: the instance's endomorphism check where one
        is installed, else [r]P == 0."""
        if self.subgroup_check_device is not None:
            return self.is_zero(P) | self.subgroup_check_device(self, P)
        return self.is_zero(self.mul_int(P, self.scalar_modulus))

    def host_is_in_correct_subgroup(self, pt) -> bool:
        """Subgroup membership of a host affine point (None = infinity)."""
        if pt is None:
            return True
        if self.cofactor == 1:
            return True
        if self.subgroup_check_host is not None:
            return bool(self.subgroup_check_host(self, pt))
        return self.host_mul_raw(pt, self.scalar_modulus) is None

    # ------------------------------------------------------------- host I/O
    def from_host(self, points):
        """Host affine points ((x, y) host values of the base, or None for
        infinity) -> affine batch [n] on the curve's device."""
        hf = self._hf()
        xs = [hf.zero() if pt is None else pt[0] for pt in points]
        ys = [hf.one() if pt is None else pt[1] for pt in points]
        infs = [pt is None for pt in points]
        return (self.base.from_int(xs), self.base.from_int(ys),
                torch.tensor(infs, dtype=torch.bool, device=self.device))

    def to_host(self, P):
        """Projective batch -> host affine points (None = infinity); a bare
        point for batch ()."""
        x, y, inf = self.to_affine(P)
        xs, ys = self.base.to_int(x), self.base.to_int(y)
        infs = inf.cpu()
        if infs.ndim == 0:
            return None if bool(infs) else (xs, ys)
        return [None if bool(i) else (xv, yv) for xv, yv, i in zip(xs, ys, infs.tolist())]

    def random_host(self, rng, n: int):
        """n random subgroup points as host affine pairs (generator * k)."""
        return [self.host_mul(self.generator_host, rng.randrange(1, self.scalar_modulus))
                for _ in range(n)]

    # host-side group law (Python ints, tuples over a tower) for oracles
    def _hf(self):
        return _host_field_of(self.base)

    def host_add(self, P, Q):
        if P is None:
            return Q
        if Q is None:
            return P
        hf = self._hf()
        x1, y1 = P
        x2, y2 = Q
        if hf.equal(x1, x2):
            if hf.equal(y1, y2) and not hf.equal(y1, hf.zero()):
                return self.host_double(P)
            return None
        lam = hf.mul(hf.sub(y2, y1), hf.inv(hf.sub(x2, x1)))
        x3 = hf.sub(hf.sub(hf.mul(lam, lam), x1), x2)
        y3 = hf.sub(hf.mul(lam, hf.sub(x1, x3)), y1)
        return (x3, y3)

    def host_double(self, P):
        if P is None:
            return None
        hf = self._hf()
        x1, y1 = P
        if hf.equal(y1, hf.zero()):
            return None
        a = hf.from_base_prime(self.a_host) if self._prime_base else self.a_host
        num = hf.add(hf.mul(hf.from_base_prime(3), hf.mul(x1, x1)), a)
        lam = hf.mul(num, hf.inv(hf.mul(hf.from_base_prime(2), y1)))
        x3 = hf.sub(hf.mul(lam, lam), hf.mul(hf.from_base_prime(2), x1))
        y3 = hf.sub(hf.mul(lam, hf.sub(x1, x3)), y1)
        return (x3, y3)

    def host_mul(self, P, k: int):
        return self.host_mul_raw(P, int(k) % self.scalar_modulus)

    def host_mul_raw(self, P, k: int):
        """Host scalar mul WITHOUT reduction mod r (for cofactor clearing,
        where the input is not yet in the r-torsion)."""
        acc = None
        for bit in bin(int(k))[2:] if k else "":
            acc = self.host_double(acc)
            if bit == "1":
                acc = self.host_add(acc, P)
        return acc

    def __repr__(self):
        return f"SWCurve({self.name}, device={self.device})"


def _host_field_of(base):
    """Host (Python big-int) mirror of a field kind."""
    if isinstance(base, PrimeField):
        return HostPrime(base.spec.modulus)
    if isinstance(base, QuadExtField):
        return HostQuadExt(_host_field_of(base.base), base.nonresidue_host)
    if isinstance(base, CubicExtField):
        return HostCubicExt(_host_field_of(base.base), base.nonresidue_host)
    raise TypeError(f"no host mirror for {base}")
