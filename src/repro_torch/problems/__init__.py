"""Problem generators (numpy), copied from the reference's ``problems``.

``problem_set`` / ``paper_benchmark_suite`` are the reference's rng streams,
so ``ProblemSuite.random`` / ``.grid`` build byte-identical instances in
both packages; the Max-Cut, Gset and partition generators likewise give the
same graphs (and ``Problem.content_hash``) for the same seed.
"""
from .random_qubo import (ProblemSet, paper_benchmark_suite, problem_set,
                          random_ising_problem)
from .maxcut import maxcut_problem, random_maxcut
from .partition import number_partitioning
from .gset import (cut_from_energy, dump_gset, gset_problem, load_gset,
                   parse_gset, random_gset)

__all__ = ["random_ising_problem", "paper_benchmark_suite", "ProblemSet",
           "random_maxcut", "maxcut_problem", "number_partitioning",
           "problem_set", "parse_gset", "dump_gset", "load_gset",
           "random_gset", "gset_problem", "cut_from_energy"]
