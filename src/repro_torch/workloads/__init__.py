"""repro_torch.workloads — NP-hard problem zoo on the 31-level Ising fabric.

    from repro_torch.workloads import get_workload

    wl = get_workload("mis")
    problem = wl.random_problem(size=10, seed=1)   # -> repro_torch.api.Problem
    report = solve_suite(problem, solver="tabu", runs=16, torch_device="cpu")
    native = wl.decode(problem, report.best_sigma[0])
    result = wl.verify(problem, native)                # feasible + objective

Every workload encodes through ``Problem`` (integer DAC levels + ancilla
bias row), so ALL registered solvers — engine, chip-lns, sb-jax, sa-jax,
pt-jax, tabu-jax, sa-numpy, tabu, brute-force — get the zoo for free. See
base.py for the exact affine energy contract. A numpy copy of the JAX
package's ``workloads``: instance generators draw from numpy
``Generator``s, so encodings (levels, ``offset``, ``content_hash``) are
bitwise equal to the reference's.
"""
from .base import (QUBO_SCALE, VerifyResult, Workload, WORKLOADS,
                   get_workload, list_workloads, model_energy,
                   register_workload, spins_to_bits, QuboModel, Lit)
from .coloring import GraphColoring
from .mis import MaxIndependentSet
from .sat import ThreeSat
from .tsp import TSP
from .vertex_cover import MinVertexCover

__all__ = [
    "QUBO_SCALE", "VerifyResult", "Workload", "WORKLOADS", "get_workload",
    "list_workloads", "model_energy", "register_workload", "spins_to_bits",
    "QuboModel", "Lit", "GraphColoring", "MaxIndependentSet", "ThreeSat",
    "TSP", "MinVertexCover",
]
