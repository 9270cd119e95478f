"""Solvers: host-side (numpy) exhaustive search, single-flip tabu and
simulated annealing, and on the torch device the classical search tier
(``sa_jax``, ``pt_jax``, ``tabu_jax``: batched torch loops) and simulated
bifurcation (``sb_jax``, on its own kernel). Module names keep the
reference's, so the registry and CLI names match one to one."""
from .brute_force import BRUTE_FORCE_MAX_N, brute_force_ground_state
from .tabu import tabu_search, best_known
from .tabu_jax import tabu_search_jax, tabu_search_jax_runs
from .sa import simulated_annealing
from .sa_jax import (metropolis_sweep, simulated_annealing_jax,
                     simulated_annealing_jax_runs)
from .pt_jax import beta_ladder, parallel_tempering_jax_runs
from .sb_jax import (simulated_bifurcation_jax,
                     simulated_bifurcation_jax_runs)

__all__ = ["BRUTE_FORCE_MAX_N", "brute_force_ground_state", "tabu_search",
           "best_known", "tabu_search_jax", "tabu_search_jax_runs",
           "simulated_annealing", "metropolis_sweep",
           "simulated_annealing_jax", "simulated_annealing_jax_runs",
           "beta_ladder", "parallel_tempering_jax_runs",
           "simulated_bifurcation_jax", "simulated_bifurcation_jax_runs"]
