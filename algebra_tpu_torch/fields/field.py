"""Field "kind" objects.

A *field kind* is a lightweight object whose methods act on batched
*values*:

  * prime field element batch  = int32[L, *batch] limb tensor (Montgomery form)
  * quadratic extension batch  = (c0, c1) tuple of base values
  * cubic extension batch      = (c0, c1, c2)

So a tower value is a nested tuple of limb tensors (the reference's
pytrees), and the shape helpers here (``select``, ``stack``, ``index``,
``broadcast_to``, ``sum``, ...) act on every tensor of such a tuple.
"""

from __future__ import annotations

import torch


def tree_map(fn, *values):
    """``fn`` on the tensors of equal-structure nested tuples, structure
    kept."""
    if isinstance(values[0], tuple):
        return tuple(tree_map(fn, *parts) for parts in zip(*values))
    return fn(*values)


def tree_leaves(value) -> list:
    """The tensors of a nested tuple, in order."""
    if isinstance(value, tuple):
        return [leaf for part in value for leaf in tree_leaves(part)]
    return [value]


def tree_select(mask, a, b):
    """Select between two equal-structure values; a batch-shaped mask
    broadcasts right-aligned against every [L, *batch] tensor."""
    return tree_map(lambda x, y: torch.where(mask, x, y), a, b)


def tree_broadcast_to(value, batch_shape):
    batch_shape = tuple(batch_shape)

    def bc(x):
        missing = len(batch_shape) + 1 - x.ndim
        if missing > 0:
            x = x.reshape(x.shape[:1] + (1,) * missing + x.shape[1:])
        return x.expand(x.shape[:1] + batch_shape)

    return tree_map(bc, value)


class Field:
    """Abstract field kind.  Subclasses: PrimeField, QuadExtField,
    CubicExtField."""

    name: str

    # --- constants -------------------------------------------------------
    def zero(self, batch_shape=()):
        raise NotImplementedError

    def one(self, batch_shape=()):
        raise NotImplementedError

    def characteristic(self) -> int:
        raise NotImplementedError

    def extension_degree(self) -> int:
        raise NotImplementedError

    def order(self) -> int:
        return self.characteristic() ** self.extension_degree()

    def prime_kind(self):
        """The PrimeField kind at the bottom of the tower."""
        k = self
        while hasattr(k, "base"):
            k = k.base
        return k

    def dot(self, terms):
        """sum of s * (a * b) over terms = [(s:int, a, b[, a_mask, b_mask])],
        one K17 launch when the tower has an integer multiplication tensor
        (``fields/dot.py``), else the generic mul/add path."""
        from . import dot as dot_mod

        out = dot_mod.dot(self, terms)
        if out is not None:
            return out
        acc = None
        for term in terms:
            s, a, b = term[0], term[1], term[2]
            if s == 0:
                continue
            t0 = self.mul(a, b)
            if s < 0:
                t0 = self.neg(t0)
                s = -s
            t = t0
            for _ in range(s - 1):
                t = self.add(t, t0)
            acc = t if acc is None else self.add(acc, t)
        return acc

    # --- arithmetic --------------------------------------------------------
    def add(self, a, b):
        raise NotImplementedError

    def sub(self, a, b):
        raise NotImplementedError

    def neg(self, a):
        raise NotImplementedError

    def mul(self, a, b):
        raise NotImplementedError

    def square(self, a):
        return self.mul(a, a)

    def double(self, a):
        return self.add(a, a)

    def inverse(self, a):
        """Multiplicative inverse; maps 0 to 0 (caller checks is_zero)."""
        raise NotImplementedError

    def frobenius(self, a, power: int = 1):
        raise NotImplementedError

    # --- predicates ---------------------------------------------------------
    def is_zero(self, a):
        raise NotImplementedError

    def equal(self, a, b):
        raise NotImplementedError

    def is_one(self, a):
        return self.equal(a, self.one(self.batch_shape(a)))

    def select(self, mask, a, b):
        """Select between two values; mask over the batch dims (a
        batch-shaped mask broadcasts right-aligned against [L, *batch])."""
        return tree_select(mask, a, b)

    # --- structure ----------------------------------------------------------
    # Tensors are limb-major [L, *batch]; ``axis`` arguments below index the
    # BATCH axes (axis=0 = leading batch axis = tensor axis 1).
    def batch_shape(self, a) -> tuple:
        return tuple(tree_leaves(a)[0].shape[1:])

    def broadcast_to(self, a, batch_shape):
        return tree_broadcast_to(a, batch_shape)

    def stack(self, values, axis=0):
        ax = axis + 1 if axis >= 0 else axis
        return tree_map(lambda *xs: torch.stack(xs, dim=ax), *values)

    def concatenate(self, values, axis=0):
        ax = axis + 1 if axis >= 0 else axis
        return tree_map(lambda *xs: torch.cat(xs, dim=ax), *values)

    def index(self, a, idx):
        """Slice/gather along the batch axes (idx skips the limb axis)."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        full = (slice(None),) + idx
        return tree_map(lambda x: x[full], a)

    # --- host conversions -----------------------------------------------------
    def from_int(self, x, batch_shape=()):
        """Host int (or nested list matching batch_shape) -> device value."""
        raise NotImplementedError

    def to_int(self, a):
        """Device value -> host int / nested list (canonical representation)."""
        raise NotImplementedError

    def random(self, rng, batch_shape=()):
        """Uniform random value, sampled host-side from a random.Random."""
        raise NotImplementedError

    # --- exponentiation --------------------------------------------------------
    def pow_int(self, a, e: int):
        """a^e for a host-constant exponent, square and multiply MSB first.
        The bit is the same in every lane, so the reference's select over a
        broadcast bit is a host branch here (the same result)."""
        e = int(e)
        if e < 0:
            return self.pow_int(self.inverse(a), -e)
        res = self.one(self.batch_shape(a))
        for bit in bin(e)[2:] if e else "":
            res = self.square(res)
            if bit == "1":
                res = self.mul(res, a)
        return res

    def pow_with_table(self, powers_of_2, e: int):
        """a^e from a table [a, a^2, a^4, ...]; None when the table is too
        short for e's bit length."""
        e = int(e)
        if e < 0:
            raise ValueError("negative exponent")
        res = None
        bit = 0
        while e:
            if e & 1:
                if bit >= len(powers_of_2):
                    return None
                t = powers_of_2[bit]
                res = t if res is None else self.mul(res, t)
            e >>= 1
            bit += 1
        if res is None:
            shape = self.batch_shape(powers_of_2[0]) if powers_of_2 else ()
            return self.one(shape)
        return res

    def pow_table(self, a, n_bits: int):
        """The [a, a^2, a^4, ...] table for ``pow_with_table``."""
        table = [a]
        for _ in range(n_bits - 1):
            table.append(self.square(table[-1]))
        return table

    def sum(self, a, axis=0):
        """Field sum along a batch axis via a pairwise tree reduction."""
        ax = axis + 1 if axis >= 0 else axis
        n = tree_leaves(a)[0].shape[ax]
        val = a
        while n > 1:
            half = n // 2
            lo = tree_map(lambda x: x.narrow(ax, 0, half), val)
            hi = tree_map(lambda x: x.narrow(ax, half, half), val)
            combined = self.add(lo, hi)
            if n % 2:
                combined = tree_map(lambda c, x: torch.cat([c, x.narrow(ax, n - 1, 1)], dim=ax),
                                    combined, val)
                n = half + 1
            else:
                n = half
            val = combined
        return tree_map(lambda x: x.squeeze(ax), val)
