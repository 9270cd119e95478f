"""Workload zoo scaffolding — NP-hard problems onto the 31-level fabric.

Every workload is an ``encode() -> Problem`` / ``decode(sigma) -> native`` /
``verify(native) -> VerifyResult`` triple built on one shared contract:

* The native problem is written as an INTEGER QUBO
  ``f(x) = const + sum_i a_i x_i + sum_{i<j} c_ij x_i x_j`` over binary
  variables (objective + penalty terms), accumulated in a
  :class:`QuboModel`.
* The QUBO is scaled by 4 (``QUBO_SCALE``) before the spin transform so
  every Ising coupling and bias lands on the integer DAC grid exactly —
  ``x = (s+1)/2`` halves coefficients twice, and the factor 4 undoes both.
* The chip is bias-free, so linear terms are absorbed into one ANCILLA
  spin (index 0) whose row carries the bias fields
  (``core.hamiltonian.absorb_fields``). Solvers may return the ancilla
  flipped; decoding gauge-fixes by the global Z2 symmetry first.

The payoff is an exact affine identity, checked by the property harness in
``tests/test_torch_workloads.py`` for every workload and every solver:

    QUBO_SCALE * f(bits(sigma)) == Problem.energy(sigma) + meta["offset"]

for EVERY ±1 configuration ``sigma`` — not just feasible ones — because
``f`` includes the penalty terms. Feasible solutions have zero penalty, so
their native objective is ``(energy + offset) / QUBO_SCALE`` exactly.

Encodings whose couplings exceed the single-die ±15 DAC range (large
penalty×degree products, TSP bias rows) are still constructed — the digital
twin integrates arbitrary integer levels — but are flagged
``meta["fits_dac"] = False``; each workload's module gives its fit bound.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from ..api.problem import MAX_LEVEL, Problem

#: the exact integer factor between native QUBO units and Ising energy units.
QUBO_SCALE = 4

#: the engine's int8 fast path tops out at |level| 127; an encoding past
#: that is almost certainly a modelling bug (runaway penalty accumulation).
_HARD_LEVEL_CAP = 127


@dataclasses.dataclass(frozen=True)
class VerifyResult:
    """Outcome of checking a decoded native solution."""
    feasible: bool                 # all hard constraints satisfied
    objective: float               # native objective (sense per workload)
    detail: dict = dataclasses.field(default_factory=dict)


class Lit:
    """A literal over binary variable ``var``: ``x`` or ``1 - x``."""
    __slots__ = ("var", "neg")

    def __init__(self, var: int, neg: bool = False):
        self.var = int(var)
        self.neg = bool(neg)

    def value(self, bits) -> int:
        v = int(bits[self.var])
        return 1 - v if self.neg else v


class QuboModel:
    """Integer QUBO accumulator with an exact spin transform.

    All coefficients are integers; ``to_problem`` produces an integer-level
    :class:`Problem` with ``meta['offset']`` such that
    ``QUBO_SCALE * f(x) == Problem.energy(s) + offset`` for the spin vector
    ``s = (ancilla=+1, 2x-1)``.
    """

    def __init__(self, num_vars: int):
        self.num_vars = int(num_vars)
        self.const = 0
        self.lin = np.zeros(self.num_vars, dtype=np.int64)
        self.quad: dict[tuple[int, int], int] = {}

    # -- accumulation ------------------------------------------------------
    def add_const(self, c: int) -> None:
        self.const += int(c)

    def add_linear(self, i: int, c: int) -> None:
        self.lin[i] += int(c)

    def add_pair(self, i: int, j: int, c: int) -> None:
        if i == j:
            # x^2 == x for binary variables
            self.add_linear(i, c)
            return
        key = (i, j) if i < j else (j, i)
        self.quad[key] = self.quad.get(key, 0) + int(c)

    def add_lit(self, lit: Lit, c: int) -> None:
        """c * y where y is the literal value (x or 1-x)."""
        if lit.neg:
            self.add_const(c)
            self.add_linear(lit.var, -c)
        else:
            self.add_linear(lit.var, c)

    def add_lit_pair(self, la: Lit, lb: Lit, c: int) -> None:
        """c * y_a * y_b, expanded over negations."""
        sa, sb = (-1 if la.neg else 1), (-1 if lb.neg else 1)
        # y_a y_b = (ka + sa x_a)(kb + sb x_b), k = 1 for negated else 0
        ka, kb = (1 if la.neg else 0), (1 if lb.neg else 0)
        self.add_const(c * ka * kb)
        self.add_linear(la.var, c * sa * kb)
        self.add_linear(lb.var, c * ka * sb)
        self.add_pair(la.var, lb.var, c * sa * sb)

    # -- evaluation --------------------------------------------------------
    def value(self, bits) -> int:
        """Exact f(x) for a 0/1 assignment (penalties included)."""
        x = np.asarray(bits, dtype=np.int64)
        out = self.const + int(self.lin @ x)
        for (i, j), c in self.quad.items():
            out += c * int(x[i]) * int(x[j])
        return out

    # -- spin transform ----------------------------------------------------
    def to_problem(self, kind: str, meta: dict) -> Problem:
        """Scale by 4, map x=(s+1)/2, absorb biases into the ancilla spin.

        Derivation (all integer): with pair coefficient ``c_ij`` and linear
        ``a_i`` in f, the scaled QUBO 4f has J_ij = -c_ij, ancilla row
        h_i = -2 a_i - sum_j c_ij, and
        offset = 4*const + 2*sum_i a_i + sum_{i<j} c_ij.
        """
        n = self.num_vars
        J = np.zeros((n + 1, n + 1), dtype=np.int64)
        h = -2 * self.lin.copy()
        for (i, j), c in self.quad.items():
            J[i + 1, j + 1] = J[j + 1, i + 1] = -c
            h[i] -= c
            h[j] -= c
        J[0, 1:] = h
        J[1:, 0] = h
        offset = QUBO_SCALE * self.const + 2 * int(self.lin.sum()) \
            + sum(self.quad.values())
        absmax = int(np.abs(J).max(initial=0))
        if absmax > _HARD_LEVEL_CAP:
            raise ValueError(
                f"workload {kind!r} encoding needs coupling level {absmax} "
                f"> {_HARD_LEVEL_CAP}: shrink the instance (degree / clause "
                "count / distance range) or lower the penalty weight")
        meta = dict(meta)
        meta.update(offset=int(offset), qubo_scale=QUBO_SCALE,
                    num_vars=n, fits_dac=absmax <= MAX_LEVEL)
        return Problem(levels=J, scale=1.0, kind=kind, meta=meta,
                       max_level=max(MAX_LEVEL, absmax))


# ---------------------------------------------------------------------------
# spin <-> bit views
# ---------------------------------------------------------------------------

def spins_to_bits(sigma) -> np.ndarray:
    """Gauge-fix the ancilla (spin 0) to +1, return the logical 0/1 bits.

    The encoded Hamiltonian is bias-free, so sigma and -sigma are exactly
    degenerate; decoding always reads the gauge where the ancilla is +1.
    """
    s = np.asarray(sigma, dtype=np.int64)
    s = s * s[..., :1]
    return ((s[..., 1:] + 1) // 2).astype(np.int8)


def model_energy(problem: Problem, sigma) -> float:
    """(energy + offset) / QUBO_SCALE — what ``model_value`` must equal."""
    e = problem.energy(np.asarray(sigma, dtype=np.float64))
    return (e + problem.meta["offset"]) / problem.meta["qubo_scale"]


# ---------------------------------------------------------------------------
# workload protocol + registry
# ---------------------------------------------------------------------------

class Workload:
    """One NP-hard family. Subclasses set ``name``/``sense`` and implement
    the instance generator and the encode/decode/verify/model_value quad."""

    name: str = ""
    sense: str = "min"              # native objective direction

    def random_instance(self, size: int, seed: int = 0, **kw) -> dict:
        raise NotImplementedError

    def encode(self, instance: dict, **params) -> Problem:
        raise NotImplementedError

    def decode(self, problem: Problem, sigma):
        raise NotImplementedError

    def verify(self, problem: Problem, native) -> VerifyResult:
        raise NotImplementedError

    def model_value(self, problem: Problem, bits) -> int:
        """Exact native recomputation of f(x) — objective PLUS penalties —
        from the raw bit vector. The property harness pins
        ``model_value(bits(sigma)) == model_energy(problem, sigma)``."""
        raise NotImplementedError

    # -- shared conveniences ----------------------------------------------
    def roundtrip(self, problem: Problem, sigma) -> VerifyResult:
        """decode + verify in one call (the harness's inner loop)."""
        return self.verify(problem, self.decode(problem, sigma))

    def random_problem(self, size: int, seed: int = 0, **kw) -> Problem:
        return self.encode(self.random_instance(size, seed=seed, **kw))


WORKLOADS: dict[str, Workload] = {}


def register_workload(cls):
    """Class decorator: publish a Workload under ``cls.name``."""
    inst = cls()
    if not inst.name:
        raise ValueError(f"{cls.__name__} must set a workload name")
    WORKLOADS[inst.name] = inst
    return cls


def get_workload(name: str) -> Workload:
    try:
        return WORKLOADS[name]
    except KeyError:
        raise KeyError(f"unknown workload {name!r}; registered: "
                       f"{sorted(WORKLOADS)}") from None


def list_workloads() -> tuple[str, ...]:
    return tuple(sorted(WORKLOADS))


# -- shared random-graph helper --------------------------------------------

def random_graph(n: int, density: float, rng: np.random.Generator,
                 max_degree: Optional[int] = None,
                 keep: Optional[Callable[[int, int], bool]] = None
                 ) -> tuple[tuple[int, int], ...]:
    """Deterministic-order random edge list with an optional degree cap —
    the cap keeps penalty×degree bias fields on the DAC grid."""
    deg = np.zeros(n, dtype=np.int64)
    edges = []
    for u in range(n):
        for v in range(u + 1, n):
            if rng.random() >= density:
                continue
            if keep is not None and not keep(u, v):
                continue
            if max_degree is not None and \
                    (deg[u] >= max_degree or deg[v] >= max_degree):
                continue
            edges.append((u, v))
            deg[u] += 1
            deg[v] += 1
    return tuple(edges)
