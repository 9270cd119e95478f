"""``ProblemSuite`` — heterogeneous problem collections, batched for the chip.

The paper's evaluation grid (§IV: 16–64 spins x 10–90% density x 20
problems) used to be solved cell-by-cell — hundreds of separate device
dispatches. A ``ProblemSuite`` instead buckets its problems by *padded*
size: every problem is zero-padded up to a multiple of the 64-spin chip
block (exactly how a small instance is embedded on the real die — unused
nodes get zero couplings), and each bucket stacks into one ``(P, N, N)``
device batch. A whole mixed-size sweep then costs one engine dispatch per
bucket, not one per problem set.

Padding is exact: padded spins have zero couplings in both directions, so
they contribute nothing to any real spin's dynamics nor to the energy.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Sequence

import numpy as np

from .batching import (CHIP_BLOCK, BatchPlan, Bucket,  # noqa: F401
                       padded_size, plan_buckets)
from .problem import Problem


class ProblemSuite:
    """An ordered, heterogeneous collection of :class:`Problem`."""

    def __init__(self, problems: Iterable[Problem]):
        self.problems: tuple[Problem, ...] = tuple(problems)
        if not all(isinstance(p, Problem) for p in self.problems):
            raise TypeError("ProblemSuite takes Problem instances; wrap raw "
                            "arrays with Problem.from_couplings")

    # -- constructors ------------------------------------------------------
    @classmethod
    def random(cls, n: int, density: float, num_problems: int, seed: int,
               max_level: int = 15) -> "ProblemSuite":
        """The paper's random-QUBO family; reproduces the exact instances of
        the legacy ``problems.problem_set`` (same rng stream)."""
        from ..problems.random_qubo import problem_set
        ps = problem_set(n, density, num_problems, seed, max_level)
        return cls([Problem.from_couplings(
            J, kind="random_qubo",
            meta={"density": density, "seed": seed, "index": i},
            max_level=max_level) for i, J in enumerate(ps.J)])

    @classmethod
    def grid(cls, sizes: Sequence[int] = (16, 32, 48, 64),
             densities: Sequence[float] = (0.1, 0.3, 0.5, 0.7, 0.9),
             problems_per_cell: int = 20, seed: int = 2026) -> "ProblemSuite":
        """The paper's full size x density benchmark grid, flattened into one
        suite (cell coordinates in each problem's ``meta``)."""
        from ..problems.random_qubo import paper_benchmark_suite
        cells = paper_benchmark_suite(tuple(sizes), tuple(densities),
                                      problems_per_cell, seed)
        out = []
        for (n, d), ps in cells.items():
            for i, J in enumerate(ps.J):
                out.append(Problem.from_couplings(
                    J, kind="random_qubo",
                    meta={"density": d, "size": n, "seed": ps.seed,
                          "index": i}))
        return cls(out)

    # -- collection protocol ----------------------------------------------
    def __len__(self) -> int:
        return len(self.problems)

    def __iter__(self) -> Iterator[Problem]:
        return iter(self.problems)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return ProblemSuite(self.problems[i])
        return self.problems[i]

    def __add__(self, other: "ProblemSuite") -> "ProblemSuite":
        return ProblemSuite(self.problems + tuple(other))

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(p.n for p in self.problems)

    @property
    def hashes(self) -> tuple[str, ...]:
        return tuple(p.content_hash for p in self.problems)

    def select(self, pred) -> "ProblemSuite":
        return ProblemSuite([p for p in self.problems if pred(p)])

    # -- device batching ---------------------------------------------------
    def plan(self, block: int = CHIP_BLOCK) -> BatchPlan:
        """The shared pad-bucket plan (``api.batching.plan_buckets``) for
        this suite — membership only, no arrays stacked yet."""
        return plan_buckets(self.sizes, block)

    def buckets(self, block: int = CHIP_BLOCK) -> list[Bucket]:
        """Group problems by padded size; one stacked level-space batch per
        group (``api.batching``: plan + ``pad_stack``). The number of
        buckets is the number of device dispatches a batched solver needs
        for the whole suite."""
        return self.plan(block).materialize(
            [p.J_levels for p in self.problems])

    def num_dispatches(self, block: int = CHIP_BLOCK) -> int:
        return self.plan(block).num_buckets
