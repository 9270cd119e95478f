"""Max-Cut instances and their Ising mapping (paper Eq. 2)."""
from __future__ import annotations

import numpy as np


def random_maxcut(n: int, density: float, seed: int = 0,
                  weighted: bool = True, max_w: int = 15) -> np.ndarray:
    """Random (weighted) graph adjacency W, symmetric, zero diagonal."""
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, k=1)
    present = rng.random(len(iu[0])) < density
    if weighted:
        w = rng.integers(1, max_w + 1, size=len(iu[0]))
    else:
        w = np.ones(len(iu[0]), dtype=np.int64)
    vals = np.where(present, w, 0).astype(np.float32)
    W = np.zeros((n, n), dtype=np.float32)
    W[iu] = vals
    return W + W.T


def maxcut_problem(n: int, density: float, seed: int = 0, weighted: bool = True):
    """Deprecated shim — prefer ``repro_torch.api.Problem.maxcut``.

    Returns (W, J): the graph and its bias-free Ising coupling J = -W,
    now normalized through ``Problem`` (integer DAC levels stored, float32
    materialized once — same values as before, single dtype convention).
    """
    from ..api import Problem
    p = Problem.maxcut(n, density, seed, weighted)
    return p.meta["W"], p.J
