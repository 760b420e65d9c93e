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
        """Inverse; 0 -> 0.  A batch goes through the blocked batched
        inversion (about three products an element), a single element on
        the card too (for one element it is K3's safegcd alone, one
        launch), and on the CPU through ``mont.inv``'s Fermat ladder.  All
        give the unique canonical inverse."""
        if a[0].numel() >= config.inverse_min_batch or a.device.type == "cuda":
            return mont.batch_inverse(self.spec, a)
        return mont.inv(self.spec, a)

    def batch_inverse(self, a, axis=0):
        return mont.batch_inverse(self.spec, a, axis=axis)

    def frobenius(self, a, power: int = 1):
        return a  # x^p = x in Fp

    def mul_by_u32(self, a, k: int):
        return mont.mul_by_u32(self.spec, a, k)

    # --- predicates ----------------------------------------------------------
    def is_zero(self, a):
        return mont.is_zero(self.spec, a)

    def equal(self, a, b):
        return mont.equal(self.spec, a, b)

    # --- square roots / legendre ---------------------------------------------
    def legendre(self, a):
        """int8 batch: 0 for zero, 1 for a square, -1 for a non-square."""
        s = mont.pow_fixed(self.spec, a, self.spec.modulus_minus_one_div_two)
        is_one = self.equal(s, self.one(self.batch_shape(a)))
        sign = torch.where(is_one, 1, -1)
        return torch.where(self.is_zero(a), 0, sign).to(torch.int8)

    def sqrt(self, a):
        """Batched square root: (ok mask, root).  ok is False where ``a`` is
        a non-square, and the root means nothing there.  The root is the one
        the field's precomputation gives (p = 3 mod 4: a^((p+1)/4); else
        Tonelli-Shanks), so sign conventions downstream agree with the
        reference."""
        spec = self.spec
        if spec.sqrt_mode == "case3mod4":
            root = mont.pow_fixed(spec, a, spec.sqrt_exp)
        else:
            root = self._tonelli_shanks(a)
        return self.equal(self.square(root), a), root

    def _tonelli_shanks(self, a):
        """Tonelli-Shanks with the same steps for every element (about
        s^2 / 2 squarings for two-adicity s), a double loop on the host."""
        spec = self.spec
        if spec.two_adic_root_of_unity is None:
            raise ValueError(f"{spec.name}: no generator known; cannot sqrt")
        shape = self.batch_shape(a)
        # w = a^((t-1)/2); x = a*w; b = x*w = a^t
        w = mont.pow_fixed(spec, a, (spec.trace - 1) // 2)
        x = self.mul(a, w)
        b = self.mul(x, w)
        z = self.constant(spec.two_adic_root_of_unity, shape)
        one = self.one(shape)
        for i in range(spec.two_adicity, 1, -1):
            t = b
            for _ in range(i - 2):
                t = self.square(t)
            flag = ~self.equal(t, one)
            x = self.select(flag, self.mul(x, z), x)
            z = self.square(z)
            b = self.select(flag, self.mul(b, z), b)
        return x

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

    def from_le_bytes_mod_order(self, data: bytes):
        """Bytes (little-endian) -> field element, reduced on the host."""
        return self.from_int(int.from_bytes(data, "little") % self.spec.modulus)

    def from_be_bytes_mod_order(self, data: bytes):
        return self.from_int(int.from_bytes(data, "big") % self.spec.modulus)

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
