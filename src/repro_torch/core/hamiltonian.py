"""Ising / QUBO energy functions and problem mappings (paper Eq. 1-2).

Conventions
-----------
* ``J`` is a full (..., N, N) coupling matrix with zero diagonal; row i holds
  the input couplings of node i (the chip is directed).
* Spins ``sigma`` are +-1 with shape (..., N).
* Energy is the bias-free Ising Hamiltonian ``H = -0.5 * s^T J s``.

The energy functions take torch tensors; the QUBO / Max-Cut maps are the
reference's numpy code, copied.
"""
from __future__ import annotations

import numpy as np
import torch


def ising_energy(J: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Bias-free Ising energy, batched with broadcasting: J (..., N, N),
    sigma (..., N) with leading axes that broadcast against J's batch axes
    (e.g. J (P,N,N), sigma (P,R,N) -> (P,R))."""
    s = sigma.to(J.dtype)
    return -0.5 * torch.sum(s * local_field(J, s), dim=-1)


def local_field(J: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """f_i = sum_j J_ij s_j. Broadcasts: sigma (..., R, N) against J (..., N, N)."""
    return torch.matmul(sigma.to(J.dtype), J.transpose(-1, -2))


def flip_deltas(J: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Energy change for flipping each spin: dH_k = 2 s_k f_k (symmetric J)."""
    return 2.0 * sigma.to(J.dtype) * local_field(J, sigma)


# --------------------------------------------------------------------------
# QUBO <-> Ising maps (numpy)
# --------------------------------------------------------------------------

def qubo_to_ising(Q):
    """Map QUBO  min x^T Q x  (x in {0,1}^N, Q symmetric) to Ising (J, h, c)
    such that  x^T Q x == -0.5 s^T J s - h . s + const  with x = (s + 1)/2."""
    Q = np.asarray(Q, dtype=np.float64)
    Qs = 0.5 * (Q + Q.T)
    offdiag = Qs - np.diag(np.diag(Qs))
    J = -0.5 * offdiag
    h = -0.5 * Qs.sum(axis=1)  # row sums include the diagonal
    const = 0.25 * Qs.sum() + 0.25 * np.trace(Qs)
    return J, h, const


def maxcut_to_ising(W):
    """Max-Cut -> bias-free Ising per paper Eq. (2):  J = -W."""
    W = np.asarray(W, dtype=np.float64)
    return -(W - np.diag(np.diag(W)))


def absorb_fields(J, h):
    """Fold bias fields into one ancilla spin (the chip is bias-free):
    J' (N+1, N+1) with J'_{0,i} = J'_{i,0} = h_i; in the gauge s_0 = +1 the
    (N+1)-spin Hamiltonian equals H = -0.5 s'Js - h.s."""
    J = np.asarray(J, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    n = J.shape[-1]
    out = np.zeros((n + 1, n + 1), dtype=np.float64)
    out[1:, 1:] = J
    out[0, 1:] = h
    out[1:, 0] = h
    return out


def fix_gauge(sigma: torch.Tensor) -> torch.Tensor:
    """Flip configurations whose ancilla spin (index 0) is -1."""
    return sigma * sigma[..., :1]


def maxcut_value(W: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Cut weight for +-1 partition sigma."""
    s = sigma.to(W.dtype)
    total = torch.sum(torch.triu(W, diagonal=1))
    sWs = 0.5 * torch.einsum("...i,ij,...j->...", s, W, s)
    return 0.5 * (total - sWs)
