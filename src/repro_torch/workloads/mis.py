"""Maximum independent set.

    f(x) = -sum_i x_i + P * sum_{(u,v) in E} x_u x_v,     P = 2.

Any P > 1 makes every ground state independent (removing one endpoint of a
violated edge gains P - 1 > 0); P = 2 gives integer margin 1. Feasible
solutions have f = -|S|, so the native objective is ``-(energy+offset)/4``.

DAC fit: J_uv = -P per edge and bias h_i = 2 - P*deg_i — instances fit the
±15 single-die range whenever every degree is <= (15-2)/P (6 at P = 2, the
generator's default cap).
"""
from __future__ import annotations

import numpy as np

from .base import (QuboModel, VerifyResult, Workload, random_graph,
                   register_workload, spins_to_bits)

PENALTY = 2


@register_workload
class MaxIndependentSet(Workload):
    name = "mis"
    sense = "max"

    def random_instance(self, size: int, seed: int = 0, density: float = 0.3,
                        max_degree: int = 6) -> dict:
        rng = np.random.default_rng(seed)
        edges = random_graph(size, density, rng, max_degree=max_degree)
        return {"n": size, "edges": [list(e) for e in edges]}

    def encode(self, instance: dict, penalty: int = PENALTY) -> "Problem":
        n = instance["n"]
        q = QuboModel(n)
        for i in range(n):
            q.add_linear(i, -1)
        for u, v in instance["edges"]:
            q.add_pair(u, v, penalty)
        return q.to_problem(self.name, {"workload": self.name,
                                        "instance": instance,
                                        "penalty": penalty})

    def decode(self, problem, sigma) -> list[int]:
        bits = spins_to_bits(sigma)
        return [i for i in range(problem.meta["num_vars"]) if bits[i]]

    def verify(self, problem, chosen) -> VerifyResult:
        inst = problem.meta["instance"]
        inside = set(chosen)
        bad = [(u, v) for u, v in inst["edges"]
               if u in inside and v in inside]
        return VerifyResult(feasible=not bad, objective=float(len(inside)),
                            detail={"violated_edges": bad})

    def model_value(self, problem, bits) -> int:
        inst, pen = problem.meta["instance"], problem.meta["penalty"]
        x = np.asarray(bits, dtype=np.int64)
        viol = sum(int(x[u] and x[v]) for u, v in inst["edges"])
        return -int(x.sum()) + pen * viol
