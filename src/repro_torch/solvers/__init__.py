"""Host-side (numpy) solvers: exhaustive search and single-flip tabu."""
from .brute_force import BRUTE_FORCE_MAX_N, brute_force_ground_state
from .tabu import best_known, tabu_search

__all__ = ["BRUTE_FORCE_MAX_N", "brute_force_ground_state", "tabu_search",
           "best_known"]
