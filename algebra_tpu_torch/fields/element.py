"""Operator-overloaded wrapper around (field kind, value) pairs.

Gives tests and user code an arkworks-like surface (``a * b + c.inverse()``)
over the batched values the kinds act on: the port of the JAX package's
``fields/element.py`` (there also a pytree, which torch has no need for).
"""

from __future__ import annotations

import torch

from .field import Field


class Felt:
    """A (possibly batched) field element."""

    __slots__ = ("field", "value")

    def __init__(self, field: Field, value):
        self.field = field
        self.value = value

    def _coerce(self, other):
        if isinstance(other, Felt):
            return other.value
        if isinstance(other, int):
            return self.field.from_int(other)
        return other

    def __add__(self, other):
        return Felt(self.field, self.field.add(self.value, self._coerce(other)))

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return Felt(self.field, self.field.sub(self.value, self._coerce(other)))

    def __rsub__(self, other):
        return Felt(self.field, self.field.sub(self._coerce(other), self.value))

    def __mul__(self, other):
        return Felt(self.field, self.field.mul(self.value, self._coerce(other)))

    def __rmul__(self, other):
        return self.__mul__(other)

    def __neg__(self):
        return Felt(self.field, self.field.neg(self.value))

    def __pow__(self, e: int):
        return Felt(self.field, self.field.pow_int(self.value, e))

    def __truediv__(self, other):
        other_v = self._coerce(other)
        return Felt(self.field, self.field.mul(self.value, self.field.inverse(other_v)))

    def __eq__(self, other):
        return bool(torch.all(self.field.equal(self.value, self._coerce(other))))

    __hash__ = None  # batched elements are not hashable

    def square(self):
        return Felt(self.field, self.field.square(self.value))

    def double(self):
        return Felt(self.field, self.field.double(self.value))

    def inverse(self):
        return Felt(self.field, self.field.inverse(self.value))

    def frobenius(self, power: int = 1):
        return Felt(self.field, self.field.frobenius(self.value, power))

    def is_zero(self):
        return bool(torch.all(self.field.is_zero(self.value)))

    def to_int(self):
        return self.field.to_int(self.value)

    def __repr__(self):
        return f"Felt({self.field.name}, {self.to_int()})"
