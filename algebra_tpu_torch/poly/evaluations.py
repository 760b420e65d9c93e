"""Evaluation-form univariate polynomials over a domain: a field value
batch over the domain's elements (natural order), with pointwise
arithmetic (``div`` through the field's batched inversion) and
``interpolate`` via the domain's ifft.
"""

from __future__ import annotations

import numpy as np

from ..fields.field import Field


class Evaluations:
    def __init__(self, field: Field, domain, evals):
        self.field = field
        self.domain = domain
        self.evals = evals

    @classmethod
    def from_ints(cls, field: Field, domain, values):
        if len(values) != domain.size:
            raise ValueError("one value per domain element is required")
        return cls(field, domain, field.from_int(np.asarray(values, dtype=object)))

    def mul(self, other: "Evaluations") -> "Evaluations":
        return Evaluations(
            self.field, self.domain, self.field.mul(self.evals, other.evals)
        )

    def add(self, other: "Evaluations") -> "Evaluations":
        return Evaluations(
            self.field, self.domain, self.field.add(self.evals, other.evals)
        )

    def sub(self, other: "Evaluations") -> "Evaluations":
        return Evaluations(
            self.field, self.domain, self.field.sub(self.evals, other.evals)
        )

    def div(self, other: "Evaluations") -> "Evaluations":
        """Pointwise quotient: one batched inversion of ``other`` and one
        multiply.  Where ``other`` is zero the result is zero."""
        return Evaluations(
            self.field,
            self.domain,
            self.field.mul(self.evals, self.field.inverse(other.evals)),
        )

    def interpolate(self):
        """ifft back to coefficient form."""
        from .dense import DensePolynomial

        return DensePolynomial(self.field, self.domain.ifft(self.evals))

    def to_ints(self):
        return self.field.to_int(self.evals)
