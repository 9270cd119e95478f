"""Simulated bifurcation (aSB / bSB / dSB) at machine batch scale.

The state-of-the-art classical competitor on dense Max-Cut, run as one
kernel launch per pad bucket: (problems × restarts) integrated by
``kernels.sb_kernel.fused_sb_kernel`` (the hand-written CUDA kernel on the
card; its plain version on the CPU). The name keeps the reference's
(``repro.solvers.sb_jax``), so the registry and CLI names match one to one.
This module owns everything per-problem:

  * the coupling normalization ``c0 = 0.5 / (sigma_J * sqrt(n))`` with
    ``sigma_J = sqrt(sum(J^2) / (n^2 - n))`` — the exemplar's scaling
    (SNIPPETS.md Snippet 2), computed in float64 numpy from each problem's
    TRUE size, bitwise equal to the reference;
  * restart initialization: x0, y0 ~ U(-0.1, 0.1) per (problem, restart)
    from a ``torch.Generator`` seeded per problem, masked to zero on padded
    spins (a zero-state, zero-coupling pad is exactly inert and reads +1);
  * ``sign_pm1`` readout and float64 energies against the ORIGINAL
    unscaled J, computed on the torch device. They are exact: integer
    levels times ±1 spins sum to integers below 2^53.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.binarize import sign_pm1
from ..device import problem_generator, resolve_device
from ..kernels.sb_kernel import check_variant, fused_sb_kernel

#: init amplitude for positions/momenta (standard SB practice: start just
#: off the unstable x=0 fixed point so restarts decorrelate).
INIT_AMP = 0.1


def sb_coupling_scale(J, n_true=None):
    """Per-problem c0 for (P, n, n) level-space couplings (numpy, float64).

    ``c0 = 0.5 / (sigma_J * sqrt(n_true))`` with ``sigma_J`` the RMS
    off-diagonal coupling over the TRUE n_true*(n_true-1) directed pairs —
    zero pad rows/columns don't perturb it. Degenerate problems (n <= 1 or
    all-zero J) get c0 = 1.0 so the dynamics stay finite.
    """
    J = np.asarray(J, np.float64)
    if J.ndim == 2:
        J = J[None]
    P, n = J.shape[0], J.shape[-1]
    nt = (np.full((P,), n, np.int64) if n_true is None
          else np.asarray(n_true, np.int64))
    ss = (J * J).sum(axis=(1, 2))
    pairs = np.maximum(nt * (nt - 1), 1)
    sigma = np.sqrt(ss / pairs)
    good = sigma > 0
    c0 = np.ones((P,), np.float64)
    c0[good] = 0.5 / (sigma[good] * np.sqrt(nt[good].astype(np.float64)))
    return c0


def sb_scaled_couplings(J, n_true=None) -> np.ndarray:
    """(P, n, n) float32 Jc = c0 * J, built on the host exactly as the
    reference builds it (float64 product, one rounding to float32)."""
    J = np.asarray(J, np.float32)
    if J.ndim == 2:
        J = J[None]
    c0 = sb_coupling_scale(J, n_true)
    return (J.astype(np.float64) * c0[:, None, None]).astype(np.float32)


def sb_inits(P, n_restarts, n, n_true=None, seed: int = 0,
             torch_device: str | torch.device = "cuda"):
    """x0, y0 ~ U(-INIT_AMP, INIT_AMP), (P, R, n) float32 on the torch
    device, padded spins zeroed.

    Problem p draws from its own ``torch.Generator`` seeded from (seed, p),
    so a problem's draws depend only on (seed, p, R, n) and the device's
    generator — not on the other problems of the batch. The reference draws
    from ``jax.random``: the two agree in distribution, not in value.
    """
    dev = resolve_device(torch_device)
    x0 = torch.empty((P, n_restarts, n), dtype=torch.float32, device=dev)
    y0 = torch.empty_like(x0)
    for p in range(P):
        gen = problem_generator(seed, p, dev)
        x0[p].uniform_(-INIT_AMP, INIT_AMP, generator=gen)
        y0[p].uniform_(-INIT_AMP, INIT_AMP, generator=gen)
    if n_true is not None:
        valid = (torch.arange(n, device=dev)[None, None, :]
                 < torch.as_tensor(n_true, device=dev)[:, None, None])
        x0 = torch.where(valid, x0, 0.0)
        y0 = torch.where(valid, y0, 0.0)
    return x0, y0


def simulated_bifurcation_jax_runs(J, n_true=None, variant: str = "bSB",
                                   n_steps: int = 400, n_restarts: int = 16,
                                   dt: float = 0.5, a0: float = 1.0,
                                   seed: int = 0, x0=None, y0=None,
                                   torch_device: str | torch.device = "cuda"):
    """Per-restart SB results for a (padded) problem batch, one launch.

    J: (P, n, n) or (n, n) level-space couplings (rows/cols >= each
    problem's true size must be zero — suite-bucket padding). ``n_true``:
    (P,) true spin counts (default: full n). ``x0`` / ``y0``: optional
    (P, R, n) initial states (e.g. the reference's draws, through
    ``convert.sb_inits_from_arrays``) in place of ``sb_inits``. Returns
    ``(energies (P, R) float64, sigma (P, R, n) int8)`` as numpy arrays;
    padded spins read +1.
    """
    check_variant(variant)
    dev = resolve_device(torch_device)
    J = np.asarray(J, np.float32)
    if J.ndim == 2:
        J = J[None]
    P, n = J.shape[0], J.shape[-1]
    R = int(n_restarts)

    Jc = torch.as_tensor(sb_scaled_couplings(J, n_true), device=dev)
    if (x0 is None) != (y0 is None):
        raise ValueError("pass both x0 and y0, or neither")
    if x0 is None:
        x0, y0 = sb_inits(P, R, n, n_true=n_true, seed=seed, torch_device=dev)
    else:
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev).contiguous()
        y0 = torch.as_tensor(y0, dtype=torch.float32, device=dev).contiguous()
        if tuple(x0.shape) != (P, R, n) or x0.shape != y0.shape:
            raise ValueError(f"x0 and y0 must be {(P, R, n)}, got "
                             f"{tuple(x0.shape)} and {tuple(y0.shape)}")
    x = fused_sb_kernel(Jc, x0, y0, variant=variant, n_steps=int(n_steps),
                        dt=float(dt), a0=float(a0))
    sig = sign_pm1(x, dtype=torch.int8)                    # (P, R, n)
    s64 = sig.to(torch.float64)
    J64 = torch.as_tensor(J, device=dev).to(torch.float64)
    e = -0.5 * torch.sum(s64 * torch.matmul(s64, J64.transpose(-1, -2)),
                         dim=-1)
    return e.cpu().numpy(), sig.cpu().numpy()


def simulated_bifurcation_jax(J, variant: str = "bSB", n_steps: int = 400,
                              n_restarts: int = 16, dt: float = 0.5,
                              a0: float = 1.0, seed: int = 0,
                              torch_device: str | torch.device = "cuda"):
    """Best-of-restarts view. J (n, n) or (P, n, n); returns
    (best_energy, best_sigma) — scalars / (n,) int8 for a single problem,
    (P,) / (P, n) for a batch."""
    single = np.ndim(J) == 2
    e, s = simulated_bifurcation_jax_runs(
        J, variant=variant, n_steps=n_steps, n_restarts=n_restarts,
        dt=dt, a0=a0, seed=seed, torch_device=torch_device)
    best = np.argmin(e, axis=1)
    best_e = e[np.arange(e.shape[0]), best]
    best_s = s[np.arange(e.shape[0]), best]
    if single:
        return float(best_e[0]), best_s[0]
    return best_e, best_s
