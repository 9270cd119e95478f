"""Problem generators (numpy). ``problem_set`` / ``paper_benchmark_suite``
are the reference's rng streams, so ``ProblemSuite.random`` / ``.grid``
build byte-identical instances in both packages."""
from .random_qubo import (ProblemSet, paper_benchmark_suite, problem_set,
                          random_ising_problem)

__all__ = ["random_ising_problem", "paper_benchmark_suite", "ProblemSet",
           "problem_set"]
