"""Minimum vertex cover.

    f(x) = sum_i x_i + P * sum_{(u,v) in E} (1-x_u)(1-x_v),     P = 2.

Covering an uncovered edge costs 1 and gains P, so P > 1 makes every ground
state a cover; P = 2 gives integer margin 1. Feasible solutions have
f = |C|, so the native objective is ``(energy+offset)/4``.

DAC fit: J_uv = -P per edge and bias h_i = P*deg_i - 2 — fits ±15 whenever
every degree is <= (15+2)/P (8 at P = 2; generator caps at 6 for symmetry
with MIS).
"""
from __future__ import annotations

import numpy as np

from .base import (Lit, QuboModel, VerifyResult, Workload, random_graph,
                   register_workload, spins_to_bits)

PENALTY = 2


@register_workload
class MinVertexCover(Workload):
    name = "vertex-cover"
    sense = "min"

    def random_instance(self, size: int, seed: int = 0, density: float = 0.3,
                        max_degree: int = 6) -> dict:
        rng = np.random.default_rng(seed)
        edges = random_graph(size, density, rng, max_degree=max_degree)
        return {"n": size, "edges": [list(e) for e in edges]}

    def encode(self, instance: dict, penalty: int = PENALTY) -> "Problem":
        n = instance["n"]
        q = QuboModel(n)
        for i in range(n):
            q.add_linear(i, 1)
        for u, v in instance["edges"]:
            q.add_lit_pair(Lit(u, neg=True), Lit(v, neg=True), penalty)
        return q.to_problem(self.name, {"workload": self.name,
                                        "instance": instance,
                                        "penalty": penalty})

    def decode(self, problem, sigma) -> list[int]:
        bits = spins_to_bits(sigma)
        return [i for i in range(problem.meta["num_vars"]) if bits[i]]

    def verify(self, problem, cover) -> VerifyResult:
        inst = problem.meta["instance"]
        inside = set(cover)
        uncovered = [(u, v) for u, v in inst["edges"]
                     if u not in inside and v not in inside]
        return VerifyResult(feasible=not uncovered,
                            objective=float(len(inside)),
                            detail={"uncovered_edges": uncovered})

    def model_value(self, problem, bits) -> int:
        inst, pen = problem.meta["instance"], problem.meta["penalty"]
        x = np.asarray(bits, dtype=np.int64)
        viol = sum(int((not x[u]) and (not x[v])) for u, v in inst["edges"])
        return int(x.sum()) + pen * viol
