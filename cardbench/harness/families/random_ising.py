"""The paper's random family (section IV), a copy of the program's
``repro_torch.problems.random_qubo.random_ising_problem`` and of the
streams ``paper_benchmark_suite`` draws them from.

Configuration keys: ``n``, ``density``, ``max_level``. A traffic mix may
give ``sizes`` and ``densities`` to draw a grid."""
from __future__ import annotations

import numpy as np


def random_ising(n: int, density: float, rng: np.random.Generator,
                 max_level: int) -> np.ndarray:
    """Symmetric, zero diagonal, each pair present with probability
    ``density``, nonzero integer levels uniform in [-max_level, max_level]
    without 0."""
    iu = np.triu_indices(n, k=1)
    n_edges = len(iu[0])
    present = rng.random(n_edges) < density
    mags = rng.integers(1, max_level + 1, size=n_edges)
    signs = rng.choice([-1, 1], size=n_edges)
    w = np.where(present, mags * signs, 0).astype(np.float32)
    J = np.zeros((n, n), dtype=np.float32)
    J[iu] = w
    return J + J.T


def make(config: dict, traffic: dict, seed: int) -> list[np.ndarray]:
    """``traffic["problems"]`` problems of every (size, density) pair of
    the grid, where the grid is the traffic's ``sizes`` and ``densities``
    or else the configuration's ``n`` and ``density``; pair (i, k) from
    the stream ``seed + 1000 i + 10 k`` (one pair: ``ProblemSuite.random(n,
    density, problems, seed)``)."""
    count = int(traffic["problems"])
    sizes = traffic.get("sizes", [config["n"]])
    dens = traffic.get("densities", [config["density"]])
    out = []
    for i, n in enumerate(sizes):
        for k, d in enumerate(dens):
            rng = np.random.default_rng(seed + 1000 * i + 10 * k)
            out += [random_ising(int(n), float(d), rng,
                                 int(config["max_level"]))
                    for _ in range(count)]
    return out
