"""repro_torch.api — the typed Problem / Suite / Solver / Report surface.

    from repro_torch.api import ProblemSuite, solve_suite

    suite = ProblemSuite.random(n=64, density=0.5, num_problems=4, seed=42)
    report = solve_suite(suite, solver="engine", runs=256, seed=7,
                         torch_device="cuda")
    print(report.summary())          # SR / TTS / ETS vs the cached oracle
"""
from .problem import MAX_LEVEL, Problem
from .batching import (CHIP_BLOCK, BatchPlan, Bucket, pad_stack,
                       padded_size, plan_buckets)
from .suite import ProblemSuite
from .report import SolveReport
from .budget import (SearchEffort, budget_factor, deadline_to_budget,
                     search_effort)
from .oracle import (BRUTE_FORCE_MAX_N, best_known_energies,
                     cache_path as oracle_cache_path, reconcile_best_known)
from .registry import (Solver, SolverCaps, as_suite, get_solver,
                       list_solvers, register_solver, solve_suite)

__all__ = [
    "MAX_LEVEL", "Problem", "CHIP_BLOCK", "BatchPlan", "Bucket",
    "ProblemSuite", "pad_stack", "padded_size", "plan_buckets",
    "SolveReport", "SearchEffort", "budget_factor", "deadline_to_budget",
    "search_effort", "BRUTE_FORCE_MAX_N", "best_known_energies",
    "oracle_cache_path", "reconcile_best_known",
    "Solver", "SolverCaps", "as_suite", "get_solver", "list_solvers",
    "register_solver", "solve_suite",
]
