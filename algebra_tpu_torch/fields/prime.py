"""Prime field kind over a FieldSpec.

Element batches are int32[L, *batch] limb tensors in Montgomery form on
the kind's device; all arithmetic dispatches to ops/mont.py.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..bigint import batch_int_to_limbs, batch_limbs_to_int, int_to_limbs
from ..ops import mont
from .field import Field
from .spec import FieldSpec


class PrimeField(Field):
    """A prime field whose values live on one device.  ``to(device)`` gives
    the same field on another device."""

    def __init__(self, spec: FieldSpec, device=None):
        self.spec = spec
        self.name = spec.name
        self.device = torch.device(device if device is not None else config.default_device)

    def to(self, device) -> "PrimeField":
        return prime_field(self.spec, device)

    # --- constants ---------------------------------------------------------
    def zero(self, batch_shape=()):
        return torch.zeros(
            (self.spec.n_limbs,) + tuple(batch_shape), dtype=torch.int32,
            device=self.device,
        )

    def one(self, batch_shape=()):
        return mont.bconst(self.spec.one_mont_limbs, batch_shape, self.device)

    def constant(self, x: int, batch_shape=()):
        """Embed a host integer constant (canonical) as a Montgomery value."""
        v = int_to_limbs(self.spec.to_mont(x % self.spec.modulus), self.spec.n_limbs)
        return mont.bconst(v, batch_shape, self.device)

    def characteristic(self) -> int:
        return self.spec.modulus

    def extension_degree(self) -> int:
        return 1

    # --- arithmetic ---------------------------------------------------------
    def add(self, a, b):
        return mont.add(self.spec, a, b)

    def sub(self, a, b):
        return mont.sub(self.spec, a, b)

    def neg(self, a):
        return mont.neg(self.spec, a)

    def mul(self, a, b):
        return mont.mul(self.spec, a, b)

    def square(self, a):
        return mont.square(self.spec, a)

    def inverse(self, a):
        """Inverse; 0 -> 0, by a per-lane Fermat ladder."""
        return mont.inv(self.spec, a)

    def mul_by_u32(self, a, k: int):
        return mont.mul_by_u32(self.spec, a, k)

    # --- predicates ----------------------------------------------------------
    def is_zero(self, a):
        return mont.is_zero(self.spec, a)

    def equal(self, a, b):
        return mont.equal(self.spec, a, b)

    # --- host conversions -------------------------------------------------------
    def from_int(self, x, batch_shape=None):
        spec = self.spec
        if isinstance(x, (int, np.integer)):
            v = int_to_limbs(spec.to_mont(int(x) % spec.modulus), spec.n_limbs)
            return mont.bconst(v, batch_shape or (), self.device)
        # nested list
        flat = np.asarray(x, dtype=object)
        shape = flat.shape
        vals = [spec.to_mont(int(v) % spec.modulus) for v in flat.reshape(-1)]
        limbs = batch_int_to_limbs(vals, spec.n_limbs, dtype=np.int32)  # [L, n]
        return torch.from_numpy(limbs.reshape((spec.n_limbs,) + shape)).to(self.device)

    def to_int(self, a):
        canon = mont.from_mont(self.spec, a).cpu().numpy()
        return batch_limbs_to_int(canon)

    def random(self, rng, batch_shape=()):
        n = int(np.prod(batch_shape)) if batch_shape else 1
        vals = [rng.randrange(self.spec.modulus) for _ in range(n)]
        return self.from_int(np.asarray(vals, dtype=object).reshape(batch_shape or ()))

    # canonical (non-Montgomery) limb access, for serialization
    def to_canonical_limbs(self, a):
        return mont.from_mont(self.spec, a)

    def from_canonical_limbs(self, limbs):
        return mont.to_mont(self.spec, limbs)

    def __repr__(self):
        return f"PrimeField({self.spec.name}, device={self.device})"


_prime_cache: dict[tuple, PrimeField] = {}


def prime_field(spec: FieldSpec, device=None) -> PrimeField:
    """The one PrimeField kind per (spec, device)."""
    dev = torch.device(device if device is not None else config.default_device)
    key = (id(spec), dev)
    if key not in _prime_cache:
        _prime_cache[key] = PrimeField(spec, dev)
    return _prime_cache[key]
