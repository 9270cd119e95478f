"""Random problem instances matching the paper's measurement protocol (§IV):

    "problem sizes from 16 to 64 nodes and problem densities from 10% to 90%
     with each coupling coefficient chosen at random from -15 to +15.
     Each QUBO problem is solved 1000 times ... for each size-density pair,
     the mean across 20 random problems is plotted."
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class ProblemSet:
    """A batch of same-size instances: J (P, N, N) integer levels."""
    J: np.ndarray
    size: int
    density: float
    seed: int

    @property
    def num_problems(self) -> int:
        return self.J.shape[0]


def random_ising_problem(n: int, density: float, rng: np.random.Generator,
                         max_level: int = 15) -> np.ndarray:
    """One symmetric zero-diagonal J with ~density fraction of edges present
    and nonzero integer weights uniform in [-max_level, max_level] \\ {0}."""
    iu = np.triu_indices(n, k=1)
    n_edges = len(iu[0])
    present = rng.random(n_edges) < density
    # nonzero levels: uniform over {-15..-1, 1..15}
    mags = rng.integers(1, max_level + 1, size=n_edges)
    signs = rng.choice([-1, 1], size=n_edges)
    w = np.where(present, mags * signs, 0).astype(np.float32)
    J = np.zeros((n, n), dtype=np.float32)
    J[iu] = w
    J = J + J.T
    return J


def problem_set(n: int, density: float, num_problems: int, seed: int,
                max_level: int = 15) -> ProblemSet:
    rng = np.random.default_rng(seed)
    J = np.stack([random_ising_problem(n, density, rng, max_level)
                  for _ in range(num_problems)])
    return ProblemSet(J=J, size=n, density=density, seed=seed)


def paper_benchmark_suite(sizes: Sequence[int] = (16, 32, 48, 64),
                          densities: Sequence[float] = (0.1, 0.3, 0.5, 0.7, 0.9),
                          problems_per_cell: int = 20,
                          seed: int = 2026) -> dict[tuple[int, float], ProblemSet]:
    """The paper's 400-problem grid (4 sizes x 5 densities x 20 problems)."""
    suite = {}
    for i, n in enumerate(sizes):
        for k, d in enumerate(densities):
            suite[(n, d)] = problem_set(n, d, problems_per_cell,
                                        seed + 1000 * i + 10 * k)
    return suite
