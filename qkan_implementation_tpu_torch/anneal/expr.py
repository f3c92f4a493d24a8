"""Symbolic QUBO expression builder: the pyqubo/cpp_pyqubo equivalent.

A numpy copy of ``qkan_implementation_tpu.anneal.expr``; ``solve`` runs
the port's annealer on ``device`` (the card unless the caller asks for
the CPU).

The reference composes its Hamiltonians symbolically -- ``Array.create('q',
shape, 'BINARY')``, arithmetic on binary variables, ``Constraint(expr,
label)``, then ``H.compile().to_bqm()`` through the C++ cpp_pyqubo compiler
(``DegreeOptimizer.py:211-234``).  This module provides the same authoring
surface natively: multilinear expressions over binary variables (x^2 = x
idempotence applied at construction), labeled constraints with
satisfaction checking at decode time, and compilation straight to the
framework's dense ``QuboModel`` for the on-device annealer.

Only degree <= 2 polynomials compile (QUBO); higher-order products raise.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Tuple

import numpy as np

from qkan_implementation_tpu_torch.anneal.qubo import QuboModel

Term = FrozenSet[str]


def _merge_constraints(a, b):
    """Combine two constraint lists without duplicating shared entries.

    ``e * e`` (and ``e ** n``) combine an expression with itself; naive
    list concatenation would carry N copies of every constraint, so
    ``decode_sample`` would evaluate (and report) each one N times.
    Identity-dedupe preserves order and keeps genuinely distinct
    constraints with equal labels."""
    seen = {id(c) for c in a}
    return list(a) + [c for c in b if id(c) not in seen]


class QuboExpr:
    """A multilinear polynomial over binary variables."""

    __slots__ = ("terms", "constraints")

    def __init__(
        self,
        terms: Dict[Term, float] | None = None,
        constraints: List[Tuple[str, "QuboExpr"]] | None = None,
    ):
        self.terms = terms or {}
        self.constraints = constraints or []

    # -- construction helpers --------------------------------------------
    @staticmethod
    def constant(c: float) -> "QuboExpr":
        return QuboExpr({frozenset(): float(c)})

    @staticmethod
    def _coerce(other) -> "QuboExpr":
        if isinstance(other, QuboExpr):
            return other
        if isinstance(other, (int, float, np.integer, np.floating)):
            return QuboExpr.constant(float(other))
        return NotImplemented

    # -- arithmetic -------------------------------------------------------
    def __add__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        terms = dict(self.terms)
        for k, v in other.terms.items():
            terms[k] = terms.get(k, 0.0) + v
        return QuboExpr(
            terms, _merge_constraints(self.constraints, other.constraints)
        )

    __radd__ = __add__

    def __neg__(self):
        return QuboExpr(
            {k: -v for k, v in self.terms.items()}, list(self.constraints)
        )

    def __sub__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self + (-other)

    def __rsub__(self, other):
        return self._coerce(other) + (-self)

    def __mul__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        terms: Dict[Term, float] = {}
        for k1, v1 in self.terms.items():
            for k2, v2 in other.terms.items():
                key = k1 | k2  # binary idempotence: x*x = x
                terms[key] = terms.get(key, 0.0) + v1 * v2
        return QuboExpr(
            terms, _merge_constraints(self.constraints, other.constraints)
        )

    __rmul__ = __mul__

    def __pow__(self, exponent: int):
        if not isinstance(exponent, int) or exponent < 1:
            raise ValueError("Only positive integer powers are supported")
        out = self
        for _ in range(exponent - 1):
            out = out * self
        return out

    # -- evaluation / compilation ----------------------------------------
    def variables(self) -> List[str]:
        names = set()
        for term in self.terms:
            names.update(term)
        for _, c in self.constraints:
            names.update(c.variables())
        return sorted(names)

    def energy(self, assignment: Dict[str, int]) -> float:
        total = 0.0
        for term, coeff in self.terms.items():
            val = coeff
            for v in term:
                val *= assignment.get(v, 0)
            total += val
        return total

    def compile(self) -> "CompiledQubo":
        return CompiledQubo(self)


def Binary(name: str) -> QuboExpr:
    """A single binary variable."""
    return QuboExpr({frozenset([name]): 1.0})


def Constraint(expr: QuboExpr, label: str) -> QuboExpr:
    """Tag a (penalty) sub-expression so decode can check satisfaction.

    Mirrors cpp_pyqubo's ``Constraint`` (reference DegreeOptimizer.py:230):
    the constraint is considered satisfied when its energy is 0.
    """
    if not isinstance(expr, QuboExpr):
        expr = QuboExpr.constant(float(expr))
    return QuboExpr(dict(expr.terms), expr.constraints + [(label, expr)])


class Array:
    """pyqubo-style variable array factory."""

    @staticmethod
    def create(name: str, shape, vartype: str = "BINARY") -> np.ndarray:
        if vartype != "BINARY":
            raise ValueError("Only BINARY vartype is supported")
        if isinstance(shape, int):
            shape = (shape,)
        out = np.empty(shape, dtype=object)
        for idx in np.ndindex(*shape):
            label = name + "".join(f"[{i}]" for i in idx)
            out[idx] = Binary(label)
        return out


class CompiledQubo:
    """Compiled model: dense QuboModel + variable order + constraints."""

    def __init__(self, expr: QuboExpr):
        self.expr = expr
        self.variables = expr.variables()
        self.index = {v: i for i, v in enumerate(self.variables)}
        n = len(self.variables)
        h = np.zeros(n)
        J = np.zeros((n, n))
        offset = 0.0
        for term, coeff in expr.terms.items():
            if len(term) == 0:
                offset += coeff
            elif len(term) == 1:
                (v,) = term
                h[self.index[v]] += coeff
            elif len(term) == 2:
                u, v = sorted(term)
                i, j = self.index[u], self.index[v]
                J[i, j] += coeff
                J[j, i] += coeff
            else:
                raise ValueError(
                    f"Term {sorted(term)} has degree {len(term)} > 2; "
                    "not a QUBO"
                )
        self.model = QuboModel(h=h, J=J, offset=offset)

    def to_qubo_model(self) -> QuboModel:
        return self.model

    # pyqubo-compatible alias
    def to_bqm(self) -> QuboModel:
        return self.model

    def decode_sample(
        self, sample: np.ndarray, energy: float | None = None
    ) -> "DecodedSample":
        assignment = {
            v: int(sample[self.index[v]]) for v in self.variables
        }
        if energy is None:
            energy = float(
                self.model.energy(np.asarray(sample, dtype=np.float64))
            )
        broken = {
            label: float(c.energy(assignment))
            for label, c in self.expr.constraints
            if abs(c.energy(assignment)) > 1e-12
        }
        return DecodedSample(assignment, energy, broken)

    def decode_sampleset(
        self, samples: np.ndarray, energies: np.ndarray | None = None
    ) -> List["DecodedSample"]:
        rows = np.atleast_2d(samples)
        if energies is None:
            return [self.decode_sample(s) for s in rows]
        # precomputed annealer energies: attach instead of recomputing the
        # O(n^2) quadratic form per sample
        return [
            self.decode_sample(s, energy=float(e))
            for s, e in zip(rows, np.atleast_1d(energies))
        ]

    def solve(self, num_reads: int = 1000, num_sweeps: int = 1000, seed: int = 0,
              device="cuda"):
        """Anneal this model on ``device`` and return the best decoded
        sample."""
        from qkan_implementation_tpu_torch.anneal.sa import solve_qubo

        sample, _ = solve_qubo(
            self.model, num_reads=num_reads, num_sweeps=num_sweeps, seed=seed,
            device=device,
        )
        return self.decode_sample(sample)


class DecodedSample:
    """A decoded solution: assignment, energy, broken constraints."""

    def __init__(self, sample: Dict[str, int], energy: float, broken: Dict[str, float]):
        self.sample = sample
        self.energy = energy
        self.broken_constraints = broken

    def constraint_satisfied(self, label: str) -> bool:
        return label not in self.broken_constraints

    def __repr__(self):
        return (
            f"DecodedSample(energy={self.energy}, "
            f"broken={list(self.broken_constraints)})"
        )
