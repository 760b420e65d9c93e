"""Field "kind" objects.

A *field kind* is a lightweight object whose methods act on batched
*values*; a prime-field value is an int32[L, *batch] limb tensor in
Montgomery form.  This module holds the shape helpers the polynomial layer
calls; extension towers join later and will carry tuples of such tensors.
"""

from __future__ import annotations

import torch


class Field:
    """Abstract field kind.  Subclass: PrimeField."""

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
        return torch.where(mask, a, b)

    # --- structure ----------------------------------------------------------
    # Values are limb-major [L, *batch]; ``axis`` arguments below index the
    # BATCH axes (axis=0 = leading batch axis = tensor axis 1).
    def batch_shape(self, a) -> tuple:
        return tuple(a.shape[1:])

    def broadcast_to(self, a, batch_shape):
        batch_shape = tuple(batch_shape)
        missing = len(batch_shape) + 1 - a.ndim
        if missing > 0:
            a = a.reshape(a.shape[:1] + (1,) * missing + a.shape[1:])
        return a.expand(a.shape[:1] + batch_shape)

    def stack(self, values, axis=0):
        ax = axis + 1 if axis >= 0 else axis
        return torch.stack(list(values), dim=ax)

    def concatenate(self, values, axis=0):
        ax = axis + 1 if axis >= 0 else axis
        return torch.cat(list(values), dim=ax)

    def index(self, a, idx):
        """Slice/gather along the batch axes (idx skips the limb axis)."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        return a[(slice(None),) + idx]

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

    def sum(self, a, axis=0):
        """Field sum along a batch axis via a pairwise tree reduction."""
        ax = axis + 1 if axis >= 0 else axis
        n = a.shape[ax]
        val = a
        while n > 1:
            half = n // 2
            combined = self.add(val.narrow(ax, 0, half), val.narrow(ax, half, half))
            if n % 2:
                combined = torch.cat([combined, val.narrow(ax, n - 1, 1)], dim=ax)
                n = half + 1
            else:
                n = half
            val = combined
        return val.squeeze(ax)
