"""Solvers: host-side (numpy) exhaustive search and single-flip tabu, and
simulated bifurcation on the torch device (``sb_jax``, the reference's
module name)."""
from .brute_force import BRUTE_FORCE_MAX_N, brute_force_ground_state
from .sb_jax import simulated_bifurcation_jax, simulated_bifurcation_jax_runs
from .tabu import best_known, tabu_search

__all__ = ["BRUTE_FORCE_MAX_N", "brute_force_ground_state", "tabu_search",
           "best_known", "simulated_bifurcation_jax",
           "simulated_bifurcation_jax_runs"]
