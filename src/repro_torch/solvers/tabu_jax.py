"""Tabu search at machine batch scale (the reference's ``tabu_jax``): the
best-known oracle over (problems x restarts) on the torch device.

``solvers.tabu.tabu_search`` is the paper's qbsolv-style oracle as a host
numpy loop. This module keeps its algorithm (best-improvement single flip,
tabu tenure with aspiration, O(N) incremental local-field updates, the
stop when every move is tabu and none aspirates) and every semantic of the
reference's lockstep version:

  * problems and restarts are tensor dimensions; iterations run in
    lockstep across the batch, with tenure masking, aspiration at
    ``_EPS``, the first-index ``argmin`` over ``inf``-masked candidates,
    the stall ``break`` (latched in ``done`` when ``patience <= 0``) and
    per-problem iteration budgets all branch-free (``where``-masked);
  * after ``patience`` non-improving attempts a restart takes ``kick_len``
    random flips (an iterated-local-search kick; ``patience=0`` turns it
    off and gives the numpy oracle's semantics);
  * padded spins (zero rows and columns of a suite bucket) are masked out
    of the candidate set and pinned to +1, so a padded search visits
    exactly the moves of the unpadded one.

Draws (initial spins, and per iteration the kick index ``floor(u *
n_true)``) come from the counter-based ``rng``, n iterations' kicks at a
time (``KickDraws``), or are sliced from an injected stream
(``tabu_draws``, or the reference's through
``convert.tabu_draws_from_arrays``). Every quantity is an integer exact in
float32 or an index, so with the same draws the result is the reference's
to the bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import rng
from ..device import resolve_device
from .sa_jax import (KICK_STREAM, as_couplings, check_draws,
                     random_init_state, random_spins)

#: aspiration / improvement tolerance. Level-space energies are exact
#: integers (integer J, ±1 spins), inside float32's 2^24 integer range, so
#: anything below 0.5 tells them apart.
_EPS = 1e-4


def _per_problem(value, default, P: int) -> np.ndarray:
    """(P,) int64 of a per-problem option: ``default`` where ``value`` is
    None, else ``value`` broadcast."""
    if value is None:
        return np.asarray(default, np.int64)
    return np.broadcast_to(np.asarray(value, np.int64), (P,)).copy()


class KickDraws:
    """The kick indices of a run of iterations: ``draws(i0, i1)`` gives
    (P, R, i1 - i0) int64, iteration i's kick of restart r of problem p in
    [0, n_true[p]) from the key (seed, p, ``KICK_STREAM``) and the counter
    (i, r)."""

    def __init__(self, seed: int, P: int, R: int, n_true,
                 dev: torch.device):
        self.k = rng.keys(seed, range(P), KICK_STREAM, device=dev, ndim=3)
        self.r = rng.counters((1, R, 1), dev)
        self.n = torch.as_tensor(np.asarray(n_true, np.int64),
                                 device=dev).view(P, 1, 1)

    def __call__(self, i0: int, i1: int) -> torch.Tensor:
        its = torch.arange(i0, i1, dtype=torch.int64,
                           device=self.r.device).view(1, 1, -1)
        w, _ = rng.bits(self.k, its, self.r)
        return rng.index(w, self.n)


def tabu_draws(P: int, R: int, n: int, max_iters: int, n_true=None,
               seed: int = 0, torch_device: str | torch.device = "cuda"):
    """Every random draw of a tabu solve, the whole stream at once: ``(s0,
    kick)`` with initial spins s0 (P, R, n) float32 ±1 and the kick index
    of every iteration, kick (P, R, max_iters) int64 in [0, n_true[p]).
    The solve draws the same values n iterations at a time."""
    dev = resolve_device(torch_device)
    nt = _per_problem(n_true, np.full((P,), n), P)
    return (random_spins(seed, P, (R, n), dev),
            KickDraws(seed, P, R, nt, dev)(0, max_iters))


def tabu_search_jax_runs(J, n_true=None, n_iters=None, n_restarts: int = 8,
                         tenure=None, seed: int = 0, patience=None,
                         kick_len=None, draws=None,
                         torch_device: str | torch.device = "cuda"):
    """Per-restart tabu results for a (padded) problem batch, one batch.

    J: (P, n, n) or (n, n) level-space couplings (rows / columns >= each
    problem's true size zero: suite-bucket padding). ``n_true``: (P,) true
    spin counts (default: full n). Per-problem defaults follow the numpy
    oracle: ``n_iters = 40 * n_true``, ``tenure = max(4, n_true // 4)``,
    ``patience = 8 * tenure``, ``kick_len = tenure``. The loop runs
    ``max(n_iters)`` lockstep iterations; a problem with a smaller budget
    stops flipping at its own. ``draws``: ``(s0, kick)`` as ``tabu_draws``
    makes them, else drawn from ``seed``, the kicks of n iterations at a
    time.

    Returns ``(energies (P, R) float64, sigma (P, R, n) int8, iters_used
    (P, R) int64)`` as numpy arrays. ``iters_used`` counts APPLIED flips,
    short of the budget where a restart stalled.
    """
    dev = resolve_device(torch_device)
    J = as_couplings(J, dev)
    P, n = J.shape[0], J.shape[-1]
    R = int(n_restarts)
    nt = _per_problem(n_true, np.full((P,), n), P)
    iters = _per_problem(n_iters, 40 * nt, P)
    ten = _per_problem(tenure, np.maximum(4, nt // 4), P)
    pat = _per_problem(patience, 8 * ten, P)
    kl = _per_problem(kick_len, ten, P)
    max_iters = int(iters.max(initial=0))
    if draws is None:
        s0 = random_spins(seed, P, (R, n), dev)
        kick_draws = KickDraws(seed, P, R, nt, dev)
    else:
        s0, kick = check_draws(draws, {
            "s0": ((P, R, n), torch.float32),
            "kick": ((P, R, max_iters), torch.int64)}, dev)

        def kick_draws(i0, i1):
            return kick[:, :, i0:i1]

    def col(x):                                  # (P,) -> (P, 1, 1) on dev
        return torch.as_tensor(x, device=dev).view(P, 1, 1)

    n_iters_t, tenure_t, patience_t = col(iters), col(ten), col(pat)
    kick_on = patience_t > 0
    kick_reset = col(pat + kl - 1)               # since rolls over here
    valid = torch.arange(n, device=dev).view(1, 1, n) < col(nt)
    Jt = J.transpose(1, 2).contiguous()
    s, f, e = random_init_state(Jt, torch.where(valid, s0, 1.0))
    best_e, best_s = e.clone(), s.clone()
    tabu_until = torch.full((P, R, n), -1, dtype=torch.int64, device=dev)
    done = torch.zeros((P, R, 1), dtype=torch.bool, device=dev)
    used = torch.zeros((P, R, 1), dtype=torch.int64, device=dev)
    since = torch.zeros((P, R, 1), dtype=torch.int64, device=dev)
    # where() with a Python number fills a fresh tensor on every call
    inf, zero = (torch.tensor(x, device=dev) for x in (float("inf"), 0.0))
    zero_i = torch.zeros((), dtype=torch.int64, device=dev)

    for it in range(max_iters):
        if it % n == 0:                      # the next n iterations' kicks
            kicks = kick_draws(it, min(it + n, max_iters))
        cand = torch.mul(s, f).mul_(2.0).add_(e)         # e + dH
        allowed = (tabu_until < it) | (cand < best_e - _EPS)
        allowed &= valid
        k_best = torch.where(allowed, cand, inf).argmin(dim=-1, keepdim=True)
        stall = ~allowed.any(dim=-1, keepdim=True)     # all tabu, none aspire
        # the kick burst: after ``patience`` non-improving attempts,
        # ``kick_len`` random flips
        kicking = kick_on & (since >= patience_t)
        k = torch.where(kicking, kicks[:, :, it % n:it % n + 1], k_best)
        budget_left = ~done & (it < n_iters_t)
        active = budget_left & (kicking | ~stall)

        e = torch.where(active, cand.gather(2, k), e)
        upd = torch.where(active, -2.0 * s.gather(2, k), zero)
        f.addcmul_(upd, Jt.gather(1, k.expand(P, R, n)))  # -= 2 s_k J[:, k]
        s.scatter_add_(2, k, upd)
        tabu_until.scatter_(2, k, torch.where(active, tenure_t + it,
                                              tabu_until.gather(2, k)))
        improved = active & (e < best_e - _EPS)
        best_e = torch.where(improved, e, best_e)
        best_s = torch.where(improved, s, best_s)
        done |= stall & ~kick_on                         # numpy's break
        used += active
        # ``since`` counts non-improving ATTEMPTS: a stalled iteration that
        # is not kicking yet still moves it toward the kick
        since = torch.where(improved | (since >= kick_reset), zero_i,
                            since + budget_left)
    return (best_e[..., 0].double().cpu().numpy(),
            best_s.to(torch.int8).cpu().numpy(),
            used[..., 0].cpu().numpy())


def tabu_search_jax(J, n_iters=None, n_restarts: int = 8, tenure=None,
                    seed: int = 0, patience=None, kick_len=None,
                    torch_device: str | torch.device = "cuda"):
    """Best-of-restarts view. J (n, n) or (P, n, n); returns (best_energy,
    best_sigma): scalars / (n,) int8 for a single problem, (P,) / (P, n)
    for a batch."""
    single = np.ndim(J) == 2
    e, s, _ = tabu_search_jax_runs(J, n_iters=n_iters, n_restarts=n_restarts,
                                   tenure=tenure, seed=seed,
                                   patience=patience, kick_len=kick_len,
                                   torch_device=torch_device)
    best = np.argmin(e, axis=1)
    best_e = e[np.arange(e.shape[0]), best]
    best_s = s[np.arange(e.shape[0]), best]
    if single:
        return float(best_e[0]), best_s[0]
    return best_e, best_s
