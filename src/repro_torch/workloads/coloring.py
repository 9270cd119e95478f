"""Graph k-coloring (decision form: f = 0 iff a proper coloring).

One-hot variables x_{v,c} (vertex v gets color c), var index v*k + c:

    f(x) = A * sum_v (1 - sum_c x_{v,c})^2
         + B * sum_{(u,v) in E} sum_c x_{u,c} x_{v,c},      A = 2, B = 1.

The generator plants a random k-coloring and only emits bichromatic edges,
so every instance is k-colorable and the encoding's minimum is exactly 0:
ANY positive A, B then make every ground state a proper coloring (a
violating assignment pays at least min(A, B) > 0 while f* = 0). The native
objective is the monochromatic-edge count — 0 when feasible — equal to
``(energy+offset)/4`` for every one-hot-valid configuration.

DAC fit: within-vertex J = -2A, same-color edge J = -B, bias
h_{v,c} = 2A - 2A(k-1) - B*deg_v — fits ±15 for deg_v <= 15 - 2A(k-2)
(k=3, A=2: degree <= 11; generator caps at 8).
"""
from __future__ import annotations

import numpy as np

from .base import (QuboModel, VerifyResult, Workload, random_graph,
                   register_workload, spins_to_bits)

PENALTY_ONE_HOT = 2     # A
PENALTY_EDGE = 1        # B


@register_workload
class GraphColoring(Workload):
    name = "coloring"
    sense = "min"

    def random_instance(self, size: int, seed: int = 0, k: int = 3,
                        density: float = 0.5, max_degree: int = 8) -> dict:
        rng = np.random.default_rng(seed)
        planted = rng.integers(0, k, size=size)
        edges = random_graph(size, density, rng, max_degree=max_degree,
                             keep=lambda u, v: planted[u] != planted[v])
        return {"n": size, "k": k, "edges": [list(e) for e in edges]}

    def encode(self, instance: dict, one_hot: int = PENALTY_ONE_HOT,
               edge: int = PENALTY_EDGE) -> "Problem":
        n, k = instance["n"], instance["k"]
        q = QuboModel(n * k)
        for v in range(n):
            # A*(1 - sum_c x)^2 == A*(1 - sum_c x + 2*sum_{c<c'} x x')
            q.add_const(one_hot)
            for c in range(k):
                q.add_linear(v * k + c, -one_hot)
                for c2 in range(c + 1, k):
                    q.add_pair(v * k + c, v * k + c2, 2 * one_hot)
        for u, v in instance["edges"]:
            for c in range(k):
                q.add_pair(u * k + c, v * k + c, edge)
        return q.to_problem(self.name, {"workload": self.name,
                                        "instance": instance,
                                        "one_hot": one_hot, "edge": edge})

    def decode(self, problem, sigma) -> list:
        """Per-vertex color, or None where the one-hot row isn't clean."""
        inst = problem.meta["instance"]
        n, k = inst["n"], inst["k"]
        bits = spins_to_bits(sigma)
        out = []
        for v in range(n):
            hot = [c for c in range(k) if bits[v * k + c]]
            out.append(hot[0] if len(hot) == 1 else None)
        return out

    def verify(self, problem, colors) -> VerifyResult:
        inst = problem.meta["instance"]
        unassigned = [v for v, c in enumerate(colors) if c is None]
        mono = [(u, v) for u, v in inst["edges"]
                if colors[u] is not None and colors[u] == colors[v]]
        return VerifyResult(feasible=not unassigned and not mono,
                            objective=float(len(mono)),
                            detail={"unassigned": unassigned,
                                    "monochromatic_edges": mono})

    def model_value(self, problem, bits) -> int:
        inst = problem.meta["instance"]
        a, b = problem.meta["one_hot"], problem.meta["edge"]
        n, k = inst["n"], inst["k"]
        x = np.asarray(bits, dtype=np.int64).reshape(n, k)
        one_hot = int(((1 - x.sum(axis=1)) ** 2).sum())
        mono = sum(int((x[u] * x[v]).sum()) for u, v in inst["edges"])
        return a * one_hot + b * mono
