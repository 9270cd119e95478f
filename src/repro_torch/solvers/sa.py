"""Simulated annealing baseline (software point of comparison for SR/TTS)."""
from __future__ import annotations

import numpy as np


def simulated_annealing(J, n_sweeps: int = 200, n_restarts: int = 16,
                        beta0: float = 0.05, beta1: float = 4.0, seed: int = 0,
                        return_all: bool = False):
    """Metropolis single-flip SA, vectorized over restarts.

    Geometric inverse-temperature schedule beta0 -> beta1 over n_sweeps.
    Returns (best_energy, best_sigma), or with ``return_all`` the
    per-restart (energies (R,), sigmas (R, N)).
    """
    J = np.asarray(J, dtype=np.float64)
    n = J.shape[-1]
    rng = np.random.default_rng(seed)
    s = rng.choice([-1.0, 1.0], size=(n_restarts, n))
    f = s @ J.T                                   # (R, n) local fields
    e = -0.5 * np.einsum("ri,ri->r", s, f)
    betas = beta0 * (beta1 / beta0) ** (np.arange(n_sweeps) / max(n_sweeps - 1, 1))
    best_e = e.copy()
    best_s = s.copy()
    order = np.arange(n)
    for beta in betas:
        rng.shuffle(order)
        for k in order:
            dH = 2.0 * s[:, k] * f[:, k]
            accept = rng.random(n_restarts) < np.exp(-beta * np.maximum(dH, 0))
            accept |= dH <= 0
            upd = np.where(accept, -2.0 * s[:, k], 0.0)   # change in s_k
            f += np.outer(upd, J[:, k])
            s[:, k] = np.where(accept, -s[:, k], s[:, k])
            e = e + np.where(accept, dH, 0.0)
        improved = e < best_e
        best_e = np.where(improved, e, best_e)
        best_s = np.where(improved[:, None], s, best_s)
    if return_all:
        return best_e, best_s.astype(np.int8)
    k = int(best_e.argmin())
    return float(best_e[k]), best_s[k].astype(np.int8)
