"""Simulated annealing at machine batch scale (the reference's ``sa_jax``).

The numpy SA baseline (``solvers.sa``) restructured for the torch device,
with the algorithm the reference keeps: Metropolis single flips, a
geometric beta schedule, a random spin order per sweep and O(N)
incremental local-field updates.

  * Problems and restarts are tensor dimensions. A bucket's state is
    (P, R, n) spins and local fields and (P, R, 1) energies.
  * The spin loop is a Python loop of batched torch ops. In step i every
    (problem, restart) flips its own ``order[p, r, t, i]``, and the coupling
    column it needs, ``J[p, :, k]``, is gathered from J^T.
  * The best state is kept once a sweep, as the reference keeps it.

Every random draw (the initial spins; per sweep the spin order and the
uniforms) comes from ``sa_draws``: one ``torch.Generator`` a problem,
seeded from (seed, p). ``simulated_annealing_jax_runs`` also takes the
draws as an argument, so the reference's ``jax.random`` draws can be
injected (``convert.sa_draws_from_arrays``). Fields and energies are sums
of integer levels times ±1, exact in float32. An accept decision compares
``u`` with an ``exp``, whose last bit may differ from XLA's, so the two
packages can part only where ``u`` ties with it.

A flip step makes 13 kernel launches over the whole (P, R) batch, so on
the card the loop is bound by launches, not by arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import problem_generator, resolve_device


def as_couplings(J, dev: torch.device) -> torch.Tensor:
    """(P, n, n) float32 couplings on ``dev`` from an (n, n) or (P, n, n)
    array or tensor."""
    J = torch.as_tensor(J, dtype=torch.float32, device=dev)
    return J[None] if J.dim() == 2 else J


def random_init_state(Jt: torch.Tensor, s0: torch.Tensor):
    """The state drawn spins ``s0`` (P, B, n) start from: the spins, their
    local fields f = J s and energies -s.f/2 (P, B, 1). ``Jt`` is J^T
    (P, n, n)."""
    s = s0.clone()
    f = torch.matmul(s, Jt)                     # f[p, b, i] = sum_j J_ij s_j
    e = -0.5 * torch.sum(s * f, dim=-1, keepdim=True)
    return s, f, e


def random_spins(shape, gen: torch.Generator, dev: torch.device):
    """Uniform ±1 float32 spins of ``shape`` from ``gen``."""
    return torch.randint(0, 2, shape, generator=gen, device=dev,
                         dtype=torch.int32).mul_(2).sub_(1).float()


def random_orders(shape, gen: torch.Generator, dev: torch.device):
    """Uniform random permutations of the last axis of ``shape``, int32:
    the argsort of uniforms."""
    keys = torch.rand(shape, generator=gen, device=dev)
    return keys.argsort(dim=-1).to(torch.int32)


def sa_betas(n_sweeps: int, beta0: float = 0.05, beta1: float = 4.0,
             torch_device: str | torch.device = "cuda") -> torch.Tensor:
    """(T,) float32 geometric schedule beta0 -> beta1 on ``torch_device``,
    computed in float32 as the reference computes it. The table is made on
    the host, so it is the same on every device (the card's ``pow`` and the
    host's part by a few ULP)."""
    dev = resolve_device(torch_device)
    r = torch.arange(n_sweeps, dtype=torch.float32) / max(n_sweeps - 1, 1)
    return (beta0 * (beta1 / beta0) ** r).to(dev)


def sa_draws(P: int, R: int, n: int, T: int, seed: int = 0,
             torch_device: str | torch.device = "cuda"):
    """Every random draw of an SA solve: ``(s0, order, u)`` with initial
    spins s0 (P, R, n) float32 ±1, spin orders (P, R, T, n) int32 (one
    permutation a sweep) and uniforms u (P, R, T, n) float32 in [0, 1).
    Problem p draws from its own generator, seeded from (seed, p)."""
    dev = resolve_device(torch_device)
    s0 = torch.empty((P, R, n), dtype=torch.float32, device=dev)
    order = torch.empty((P, R, T, n), dtype=torch.int32, device=dev)
    u = torch.empty((P, R, T, n), dtype=torch.float32, device=dev)
    for p in range(P):
        gen = problem_generator(seed, p, dev)
        s0[p] = random_spins((R, n), gen, dev)
        order[p] = random_orders((R, T, n), gen, dev)
        u[p].uniform_(generator=gen)
    return s0, order, u


def check_draws(draws, shapes: dict, dev: torch.device):
    """``draws`` (a tuple of tensors or arrays) on ``dev`` with the named
    shapes and dtypes; raises on a mismatch."""
    out = []
    for arr, (name, (shape, dtype)) in zip(draws, shapes.items(),
                                           strict=True):
        t = torch.as_tensor(arr, device=dev)
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"draw {name} must be {tuple(shape)} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        out.append(t)
    return tuple(out)


def metropolis_sweep(Jt, s, f, e, neg_beta, order, u):
    """One Metropolis sweep of every (problem, walker), in place: random spin
    order, O(N) incremental field updates. The shared single-rung step: SA
    runs it over a beta schedule, parallel tempering (``solvers.pt_jax``)
    over a fixed ladder.

    Jt: (P, n, n) J^T. s, f: (P, B, n) float32 spins and local fields; e:
    (P, B, 1) energies. ``neg_beta``: -beta, a 0-dim tensor or one that
    broadcasts against (P, B, 1). ``order``: (P, B, n) int64 spin order;
    ``u``: (P, B, n) uniforms in [0, 1). Returns (s, f, e).
    """
    P, B, n = s.shape
    neg_2beta = 2.0 * neg_beta
    zero = s.new_zeros(())          # a where() with a Python 0.0 would
    for i in range(n):              # fill a fresh one on every flip
        k = order[:, :, i:i + 1]                          # (P, B, 1)
        sk = s.gather(2, k)
        fk = f.gather(2, k)
        a = sk * fk                                       # dH = 2 s_k f_k
        # the reference accepts iff dH <= 0 or u < exp(-beta max(dH, 0)).
        # (-2 beta) max(a, 0) is -beta max(dH, 0) to the bit (scaling by 2
        # is exact), and dH <= 0 needs no test: exp(-0.0) == 1 > u
        accept = u[:, :, i:i + 1] < torch.exp(a.clamp_(min=0.0)
                                              .mul_(neg_2beta))
        upd = torch.where(accept, -2.0 * sk, zero)        # change in s_k
        f.addcmul_(upd, Jt.gather(1, k.expand(P, B, n)))  # += upd J[:, k]
        s.scatter_add_(2, k, upd)
        e.addcmul_(upd, fk, value=-1.0)                   # += dH if accepted
    return s, f, e


def simulated_annealing_jax_runs(J, n_runs: int = 16, n_sweeps: int = 200,
                                 beta0: float = 0.05, beta1: float = 4.0,
                                 seed: int = 0, draws=None,
                                 torch_device: str | torch.device = "cuda"):
    """Per-run SA results for the SolveReport schema, one batch for all
    problems and restarts.

    J: (P, n, n) or (n, n) level-space couplings (zero-padded buckets are
    fine: a padded spin's flip is a zero-dH move, accepted as the reference
    accepts it). ``draws``: ``(s0, order, u)`` as ``sa_draws`` makes them
    (e.g. the reference's, through ``convert.sa_draws_from_arrays``), else
    drawn from ``seed``. Returns ``(energies (P, R) float64, sigma (P, R, n)
    int8)`` as numpy arrays.
    """
    dev = resolve_device(torch_device)
    J = as_couplings(J, dev)
    P, n = J.shape[0], J.shape[-1]
    R, T = int(n_runs), int(n_sweeps)
    if draws is None:
        draws = sa_draws(P, R, n, T, seed, dev)
    s0, order, u = check_draws(draws, {
        "s0": ((P, R, n), torch.float32),
        "order": ((P, R, T, n), torch.int32),
        "u": ((P, R, T, n), torch.float32)}, dev)
    Jt = J.transpose(1, 2).contiguous()
    neg_betas = -sa_betas(T, beta0, beta1, dev)
    s, f, e = random_init_state(Jt, s0)
    best_e, best_s = e.clone(), s.clone()
    for t in range(T):
        metropolis_sweep(Jt, s, f, e, neg_betas[t], order[:, :, t].long(),
                         u[:, :, t])
        better = e < best_e
        best_e = torch.where(better, e, best_e)
        best_s = torch.where(better, s, best_s)
    return (best_e[..., 0].double().cpu().numpy(),
            best_s.to(torch.int8).cpu().numpy())


def simulated_annealing_jax(J, n_sweeps: int = 200, n_restarts: int = 16,
                            beta0: float = 0.05, beta1: float = 4.0,
                            seed: int = 0,
                            torch_device: str | torch.device = "cuda"):
    """Best-of-restarts view. J (n, n) or (P, n, n); returns (best_energy,
    best_sigma): scalars / (n,) int8 for a single problem, (P,) / (P, n)
    for a batch."""
    single = np.ndim(J) == 2
    e, s = simulated_annealing_jax_runs(J, n_runs=n_restarts,
                                        n_sweeps=n_sweeps, beta0=beta0,
                                        beta1=beta1, seed=seed,
                                        torch_device=torch_device)
    best = np.argmin(e, axis=1)
    best_e = e[np.arange(e.shape[0]), best]
    best_s = s[np.arange(e.shape[0]), best]
    if single:
        return float(best_e[0]), best_s[0]
    return best_e, best_s
