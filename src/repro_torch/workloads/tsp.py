"""Traveling salesman (cyclic, integer distances) — the classic one-hot
time-step encoding (Lucas 2014 §7.2).

Variables x_{c,t} (city c visited at step t), var index c*n + t:

    f(x) = A * sum_t (1 - sum_c x_{c,t})^2        # one city per step
         + A * sum_c (1 - sum_t x_{c,t})^2        # each city visited once
         + sum_t sum_{c != c'} d_{c,c'} x_{c,t} x_{c',t+1 mod n}

with A = 2*max(d) > B*max(d) (B = 1), the standard sufficiency condition:
breaking a permutation constraint costs at least A while the best possible
tour-length gain is max(d), so every ground state is a valid tour. Feasible
solutions have f = tour length = ``(energy+offset)/4``.

DAC fit: the one-hot pair level is 2A <= 14 for max(d) <= 3 (the default
distance range), but the bias row scales with 4A(n-1) + 2*sum_c d — TSP
instances beyond ~3 cities exceed one die's ±15 bias range and are flagged
``fits_dac=False`` (solved exactly by the digital twin; on silicon they
need a multi-die field composition).
"""
from __future__ import annotations

import itertools

import numpy as np

from .base import (QuboModel, VerifyResult, Workload, register_workload,
                   spins_to_bits)


@register_workload
class TSP(Workload):
    name = "tsp"
    sense = "min"

    def random_instance(self, size: int, seed: int = 0,
                        max_distance: int = 3) -> dict:
        if size < 3:
            raise ValueError("TSP needs >= 3 cities (cyclic tour)")
        rng = np.random.default_rng(seed)
        d = rng.integers(1, max_distance + 1, size=(size, size))
        d = np.triu(d, 1)
        d = d + d.T
        return {"n": size, "dist": d.tolist()}

    def encode(self, instance: dict, penalty: int | None = None) -> "Problem":
        n = instance["n"]
        d = np.asarray(instance["dist"], dtype=np.int64)
        A = int(penalty) if penalty is not None else 2 * int(d.max())
        q = QuboModel(n * n)

        def var(c, t):
            return c * n + t

        for axis in range(2):       # 0: one city per step, 1: one step per city
            for a in range(n):
                members = ([var(c, a) for c in range(n)] if axis == 0
                           else [var(a, t) for t in range(n)])
                q.add_const(A)
                for i, m in enumerate(members):
                    q.add_linear(m, -A)
                    for m2 in members[i + 1:]:
                        q.add_pair(m, m2, 2 * A)
        for t in range(n):
            for c, c2 in itertools.permutations(range(n), 2):
                q.add_pair(var(c, t), var(c2, (t + 1) % n), int(d[c, c2]))
        return q.to_problem(self.name, {"workload": self.name,
                                        "instance": instance, "penalty": A})

    def decode(self, problem, sigma) -> list:
        """City visited at each step, or None where one-hot isn't clean."""
        n = problem.meta["instance"]["n"]
        x = spins_to_bits(sigma).reshape(n, n)
        tour = []
        for t in range(n):
            hot = np.flatnonzero(x[:, t])
            tour.append(int(hot[0]) if len(hot) == 1 else None)
        return tour

    def verify(self, problem, tour) -> VerifyResult:
        inst = problem.meta["instance"]
        n = inst["n"]
        d = np.asarray(inst["dist"], dtype=np.int64)
        valid = (None not in tour) and sorted(tour) == list(range(n))
        length = 0.0
        if valid:
            length = float(sum(d[tour[t], tour[(t + 1) % n]]
                               for t in range(n)))
        return VerifyResult(feasible=valid, objective=length,
                            detail={"tour": tour})

    def model_value(self, problem, bits) -> int:
        inst, A = problem.meta["instance"], problem.meta["penalty"]
        n = inst["n"]
        d = np.asarray(inst["dist"], dtype=np.int64)
        x = np.asarray(bits, dtype=np.int64).reshape(n, n)
        pen = int(((1 - x.sum(axis=0)) ** 2).sum()) \
            + int(((1 - x.sum(axis=1)) ** 2).sum())
        hops = 0
        for t in range(n):
            hops += int(x[:, t] @ d @ x[:, (t + 1) % n])
        return A * pen + hops
