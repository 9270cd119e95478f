"""Replica-exchange parallel tempering (PT) over the SA sweep (the
reference's ``pt_jax``).

Each restart holds K replicas ("rungs") of its problem at a fixed
geometric ladder of inverse temperatures and periodically exchanges
neighbouring rungs, so a configuration stuck in a local minimum at a low
temperature can escape by swapping up the ladder.

Built on ``solvers.sa_jax.metropolis_sweep``:

  * rungs are one more batch dimension: a bucket's state is (P, R, K, n),
    swept as (P, R*K, n) walkers, each at its rung's beta;
  * swap phases come every ``swap_every`` sweeps and alternate even / odd
    neighbour pairs (parity ``(t // swap_every) % 2``); a pair swaps with
    probability ``min(1, exp((beta_i - beta_{i+1}) (E_i - E_{i+1})))``,
    branch-free, as a gather permutation;
  * a restart reports the best energy any of its rungs has seen.

Draws come from ``pt_draws`` (one ``torch.Generator`` a problem) or are
injected (``convert.pt_draws_from_arrays``). As for SA, the two packages can
part only where an accept or swap decision ties with its ``exp``.
"""
from __future__ import annotations

import torch

from ..device import problem_generator, resolve_device
from .sa_jax import (as_couplings, check_draws, metropolis_sweep,
                     random_init_state, random_orders, random_spins)


def beta_ladder(n_rungs: int, beta0: float = 0.05, beta1: float = 4.0,
                torch_device: str | torch.device = "cuda") -> torch.Tensor:
    """(K,) float32 geometric inverse-temperature ladder, hot (beta0) ->
    cold (beta1), on ``torch_device``; made on the host, as
    ``sa_jax.sa_betas`` is, so it is the same on every device."""
    dev = resolve_device(torch_device)
    r = torch.arange(n_rungs, dtype=torch.float32) / max(n_rungs - 1, 1)
    return (beta0 * (beta1 / beta0) ** r).to(dev)


def pt_draws(P: int, R: int, K: int, n: int, T: int, seed: int = 0,
             torch_device: str | torch.device = "cuda"):
    """Every random draw of a PT solve: ``(s0, order, u, swap_u)`` with
    initial spins s0 (P, R, K, n) float32 ±1, spin orders (P, R, T, K, n)
    int32, sweep uniforms u (P, R, T, K, n) and swap uniforms swap_u
    (P, R, T, K), float32 in [0, 1). Problem p draws from its own
    generator, seeded from (seed, p)."""
    dev = resolve_device(torch_device)
    s0 = torch.empty((P, R, K, n), dtype=torch.float32, device=dev)
    order = torch.empty((P, R, T, K, n), dtype=torch.int32, device=dev)
    u = torch.empty((P, R, T, K, n), dtype=torch.float32, device=dev)
    swap_u = torch.empty((P, R, T, K), dtype=torch.float32, device=dev)
    for p in range(P):
        gen = problem_generator(seed, p, dev)
        s0[p] = random_spins((R, K, n), gen, dev)
        order[p] = random_orders((R, T, K, n), gen, dev)
        u[p].uniform_(generator=gen)
        swap_u[p].uniform_(generator=gen)
    return s0, order, u, swap_u


def _swap_perm(E, dbeta, is_left, u):
    """Branch-free replica-exchange permutation for one swap phase.

    E: (P, R, K) energies; dbeta: (K,) beta_i - beta_{i+1} (wrapped);
    is_left: (K,) the pairs' left rungs for this phase's parity; u:
    (P, R, K) uniforms. Pair (i, i+1) swaps with probability
    min(1, exp(dbeta_i (E_i - E_{i+1}))). Returns the (P, R, K) gather
    indices and the per-rung swap indicator.
    """
    delta = dbeta * (E - E.roll(-1, dims=-1))
    acc = is_left & (u < torch.exp(delta.clamp(max=0.0)))
    acc_right = acc.roll(1, dims=-1)          # i swaps down iff i-1 swapped up
    i = torch.arange(E.shape[-1], device=E.device)
    perm = i + acc.long() - acc_right.long()
    return perm, acc | acc_right


def parallel_tempering_jax_runs(J, n_runs: int = 16, n_sweeps: int = 100,
                                n_rungs: int = 4, beta0: float = 0.05,
                                beta1: float = 4.0, swap_every: int = 1,
                                seed: int = 0, draws=None,
                                torch_device: str | torch.device = "cuda"):
    """Per-run PT results for the SolveReport schema, one batch for all
    problems, restarts and rungs.

    J: (P, n, n) or (n, n) level-space couplings (zero-padded buckets are
    fine, as for SA). ``draws``: ``(s0, order, u, swap_u)`` as ``pt_draws``
    makes them, else drawn from ``seed``. Returns ``(energies (P, R)
    float64, sigma (P, R, n) int8, swaps (P, R) int64)`` as numpy arrays;
    swaps counts accepted replica exchanges per restart (0 everywhere means
    the ladder is too steep to exchange).
    """
    dev = resolve_device(torch_device)
    J = as_couplings(J, dev)
    P, n = J.shape[0], J.shape[-1]
    R, K, T = int(n_runs), int(n_rungs), int(n_sweeps)
    B = R * K
    if draws is None:
        draws = pt_draws(P, R, K, n, T, seed, dev)
    s0, order, u, swap_u = check_draws(draws, {
        "s0": ((P, R, K, n), torch.float32),
        "order": ((P, R, T, K, n), torch.int32),
        "u": ((P, R, T, K, n), torch.float32),
        "swap_u": ((P, R, T, K), torch.float32)}, dev)
    Jt = J.transpose(1, 2).contiguous()
    betas = beta_ladder(K, beta0, beta1, dev)
    neg_beta = (-betas).repeat(R).view(1, B, 1)          # walker r*K + k
    dbeta = betas - betas.roll(-1)
    rung = torch.arange(K, device=dev)
    is_left = [(rung % 2 == parity) & (rung + 1 < K) for parity in (0, 1)]

    s, f, e = random_init_state(Jt, s0.view(P, B, n))
    E = e.view(P, R, K)
    m = E.argmin(dim=-1, keepdim=True)                   # (P, R, 1)
    best_e = E.gather(2, m)
    best_s = s.view(P, R, K, n).gather(
        2, m[..., None].expand(P, R, 1, n))[:, :, 0]
    swaps = torch.zeros((P, R), dtype=torch.int64, device=dev)
    for t in range(T):
        metropolis_sweep(Jt, s, f, e, neg_beta,
                         order[:, :, t].reshape(P, B, n).long(),
                         u[:, :, t].reshape(P, B, n))
        if (t + 1) % swap_every == 0:
            perm, swapped = _swap_perm(e.view(P, R, K), dbeta,
                                       is_left[(t // swap_every) % 2],
                                       swap_u[:, :, t])
            idx = perm[..., None].expand(P, R, K, n)
            s = s.view(P, R, K, n).gather(2, idx).view(P, B, n)
            f = f.view(P, R, K, n).gather(2, idx).view(P, B, n)
            e = e.view(P, R, K).gather(2, perm).view(P, B, 1)
            swaps += swapped.sum(dim=-1) // 2
        E = e.view(P, R, K)
        m = E.argmin(dim=-1, keepdim=True)
        e_m = E.gather(2, m)
        better = e_m < best_e
        best_e = torch.where(better, e_m, best_e)
        s_m = s.view(P, R, K, n).gather(
            2, m[..., None].expand(P, R, 1, n))[:, :, 0]
        best_s = torch.where(better, s_m, best_s)
    return (best_e[..., 0].double().cpu().numpy(),
            best_s.to(torch.int8).cpu().numpy(), swaps.cpu().numpy())
