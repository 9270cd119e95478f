"""3-SAT (planted-satisfiable MAX-3-SAT form).

Each clause (l1 ∨ l2 ∨ l3) contributes a quadratized unsatisfied-indicator
with one auxiliary variable w (Rosenberg substitution w := y1*y2, penalty
weight 2, folded in):

    pen = 1 - y1 - y2 - y3 + 3*y1*y2 + y1*y3 + y2*y3
          - w*y3 - 4*w*y1 - 4*w*y2 + 6*w

where y_i is the literal value (x or 1-x). For every literal assignment,
``min_w pen == (1-y1)(1-y2)(1-y3)`` and ``pen >= 0`` for both w — so
``min_x f = #unsatisfiable clauses`` and the aux bits are forced to
``y1*y2`` at any optimum. The generator PLANTS a satisfying assignment
(every clause is repaired to contain at least one true literal), so the
minimum is exactly 0 and every ground state decodes to a satisfying
assignment with all aux bits consistent.

Variable layout: x_0..x_{n-1} are the logical variables, then one aux per
clause. Clauses use DIMACS-style literals: ±(var+1).

DAC fit: aux rows stay small, but a variable shared by many clauses
accumulates pair levels of ±3 per co-occurrence — the generator's default
clause ratio keeps small instances on the grid; overflowing encodings are
flagged ``fits_dac=False`` (see base.py).
"""
from __future__ import annotations

import numpy as np

from .base import (Lit, QuboModel, VerifyResult, Workload, register_workload,
                   spins_to_bits)


def _clause_lits(clause) -> list[Lit]:
    return [Lit(abs(l) - 1, neg=l < 0) for l in clause]


def _lit_true(l: int, assignment) -> bool:
    v = bool(assignment[abs(l) - 1])
    return v if l > 0 else not v


@register_workload
class ThreeSat(Workload):
    name = "3sat"
    sense = "max"           # satisfied-clause count

    def random_instance(self, size: int, seed: int = 0,
                        clause_ratio: float = 2.0) -> dict:
        """``size`` variables, ``round(size*clause_ratio)`` planted clauses."""
        rng = np.random.default_rng(seed)
        planted = rng.integers(0, 2, size=size)
        clauses = []
        for _ in range(max(1, int(round(size * clause_ratio)))):
            vs = rng.choice(size, size=3, replace=False)
            lits = [int(v + 1) * (1 if rng.integers(0, 2) else -1)
                    for v in vs]
            if not any(_lit_true(l, planted) for l in lits):
                k = int(rng.integers(0, 3))      # repair: flip one literal
                lits[k] = -lits[k]
            clauses.append(lits)
        return {"n": size, "clauses": clauses}

    def encode(self, instance: dict) -> "Problem":
        n, clauses = instance["n"], instance["clauses"]
        q = QuboModel(n + len(clauses))
        for ci, clause in enumerate(clauses):
            y1, y2, y3 = _clause_lits(clause)
            w = Lit(n + ci)
            q.add_const(1)
            q.add_lit(y1, -1)
            q.add_lit(y2, -1)
            q.add_lit(y3, -1)
            q.add_lit_pair(y1, y2, 3)
            q.add_lit_pair(y1, y3, 1)
            q.add_lit_pair(y2, y3, 1)
            q.add_lit_pair(w, y3, -1)
            q.add_lit_pair(w, y1, -4)
            q.add_lit_pair(w, y2, -4)
            q.add_lit(w, 6)
        return q.to_problem(self.name, {"workload": self.name,
                                        "instance": instance})

    def decode(self, problem, sigma) -> list[bool]:
        inst = problem.meta["instance"]
        bits = spins_to_bits(sigma)
        return [bool(b) for b in bits[:inst["n"]]]

    def verify(self, problem, assignment) -> VerifyResult:
        inst = problem.meta["instance"]
        unsat = [c for c in inst["clauses"]
                 if not any(_lit_true(l, assignment) for l in c)]
        sat = len(inst["clauses"]) - len(unsat)
        return VerifyResult(feasible=not unsat, objective=float(sat),
                            detail={"unsat_clauses": unsat,
                                    "num_clauses": len(inst["clauses"])})

    def model_value(self, problem, bits) -> int:
        """Exact penalty sum with the ACTUAL aux bits (not re-optimized)."""
        inst = problem.meta["instance"]
        n = inst["n"]
        x = np.asarray(bits, dtype=np.int64)
        total = 0
        for ci, clause in enumerate(inst["clauses"]):
            y1, y2, y3 = (lit.value(x) for lit in _clause_lits(clause))
            w = int(x[n + ci])
            total += (1 - y1 - y2 - y3 + 3 * y1 * y2 + y1 * y3 + y2 * y3
                      - w * y3 - 4 * w * y1 - 4 * w * y2 + 6 * w)
        return total
