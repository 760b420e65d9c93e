"""GT as an additive group: the port of the JAX package's ``pairing/gt.py``.

A *group kind* over a pairing target field's cyclotomic subgroup: zero is
1_GT, addition is the field product, negation the cyclotomic inverse (a
conjugation), doubling the cyclotomic square, scalar multiplication
exponentiation.  All operations are batched over lanes like the curve
kinds, so a GT "MSM" is one batched exponentiation and a product fold.
"""

from __future__ import annotations

import torch

from ..curves.sw import scalar_bits_le
from ..fields.field import tree_map


class GTGroup:
    """Additive-notation group kind over a cyclotomic subgroup."""

    def __init__(self, field, scalar_modulus: int):
        self.field = field
        self.scalar_modulus = int(scalar_modulus)

    # ------------------------------------------------------------ basics
    def zero(self, batch_shape=()):
        return self.field.one(batch_shape)

    def batch_shape(self, g):
        return self.field.batch_shape(g)

    def add(self, g, h):
        return self.field.mul(g, h)

    def neg(self, g):
        return self.field.cyclotomic_inverse(g)

    def sub(self, g, h):
        return self.add(g, self.neg(h))

    def double(self, g):
        return self.field.cyclotomic_square(g)

    def equal(self, g, h):
        return self.field.equal(g, h)

    def is_zero(self, g):
        return self.field.equal(g, self.field.one(self.batch_shape(g)))

    def select(self, mask, g, h):
        return self.field.select(mask, g, h)

    def index(self, g, idx):
        return tree_map(lambda a: a[..., idx], g)

    # -------------------------------------------------------- scalar mul
    def mul_int(self, g, k: int):
        """g * k for a host-constant scalar (cyclotomic NAF exponent)."""
        return self.field.cyclotomic_exp(g, int(k) % self.scalar_modulus)

    def scalar_mul(self, g, scalars: torch.Tensor):
        """g * scalar for per-lane scalars (int32 [Ls, *batch] canonical
        16-bit limbs), square and multiply over all 16 Ls bits, the product
        selected by each lane's bit."""
        F = self.field
        bits = scalar_bits_le(scalars)  # [nbits, *batch], little-endian
        res = F.one(self.batch_shape(g))
        for i in range(bits.shape[0] - 1, -1, -1):
            res = F.cyclotomic_square(res)
            res = F.select(bits[i], F.mul(res, g), res)
        return res

    def msm(self, gs, scalars: torch.Tensor):
        """sum_i scalars[i] * gs[i] (= prod_i gs[i]^scalars[i]) along the
        last batch axis: one batched exponentiation over all lanes, then
        the products in lane order."""
        F = self.field
        powered = self.scalar_mul(gs, scalars)
        total = F.one(self.batch_shape(gs)[:-1])
        for i in range(self.batch_shape(gs)[-1]):
            total = F.mul(total, tree_map(lambda a: a[..., i], powered))
        return total
