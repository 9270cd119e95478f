"""Single-flip tabu search — the paper's best-known-energy oracle ([7]: the
qbsolv-style tabu solver). Vectorized over restarts in numpy with O(N)
incremental field updates per flip.
"""
from __future__ import annotations

import numpy as np


def tabu_search(J, n_iters: int | None = None, n_restarts: int = 8,
                tenure: int | None = None, seed: int = 0,
                return_all: bool = False, return_iters: bool = False):
    """Minimize H = -0.5 s'Js. Returns (best_energy, best_sigma), or with
    ``return_all`` the per-restart (energies (R,), sigmas (R, N)) so callers
    can treat restarts as independent runs.

    Classic best-improvement tabu: flip the non-tabu spin with the lowest
    resulting energy (aspiration: tabu moves allowed if they beat the
    incumbent). dH for flipping k is 2 s_k f_k with f = J s; after flipping k,
    f_j += -2 s_k^old J_jk.

    A restart STOPS EARLY when every move is tabu and none aspirates (large
    tenure relative to N makes this common) — so the iteration budget a
    restart actually consumed can be well below ``n_iters``. With
    ``return_iters`` the per-restart count of applied flips (R,) int64 is
    appended to the return tuple, so budget accounting in reports reflects
    the work done, not the work requested.
    """
    J = np.asarray(J, dtype=np.float64)
    n = J.shape[-1]
    n_iters = n_iters if n_iters is not None else 40 * n
    tenure = tenure if tenure is not None else max(4, n // 4)
    rng = np.random.default_rng(seed)

    all_e = np.empty(n_restarts, dtype=np.float64)
    all_s = np.empty((n_restarts, n), dtype=np.int8)
    all_iters = np.empty(n_restarts, dtype=np.int64)
    for r in range(n_restarts):
        s = rng.choice([-1.0, 1.0], size=n)
        f = J @ s
        e = -0.5 * s @ f
        tabu_until = np.full(n, -1, dtype=np.int64)
        best_e, best_s = e, s.copy()
        used = 0
        for it in range(n_iters):
            dH = 2.0 * s * f                       # (n,)
            cand = e + dH
            allowed = (tabu_until < it) | (cand < best_e - 1e-12)
            cand = np.where(allowed, cand, np.inf)
            k = int(cand.argmin())
            if not np.isfinite(cand[k]):
                break                              # stalled: all tabu, none aspirate
            # apply flip k
            e = float(cand[k])
            f = f - 2.0 * s[k] * J[:, k]
            s[k] = -s[k]
            tabu_until[k] = it + tenure
            used = it + 1
            if e < best_e - 1e-12:
                best_e, best_s = e, s.copy()
        all_e[r] = best_e
        all_s[r] = best_s.astype(np.int8)
        all_iters[r] = used
    if return_all:
        return (all_e, all_s, all_iters) if return_iters else (all_e, all_s)
    k = int(all_e.argmin())
    if return_iters:
        return float(all_e[k]), all_s[k], all_iters
    return float(all_e[k]), all_s[k]


def best_known(J_batch, **kw) -> np.ndarray:
    """Best-known energies for a (P, N, N) batch of problems."""
    J_batch = np.asarray(J_batch)
    if J_batch.ndim == 2:
        J_batch = J_batch[None]
    seed = kw.pop("seed", 0)
    return np.array([tabu_search(J, seed=seed + 31 * p, **kw)[0]
                     for p, J in enumerate(J_batch)])
