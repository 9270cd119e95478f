"""Plain reference of simulated bifurcation (Goto et al., aSB / bSB / dSB)
as the ``sb-jax`` solver defines it, in numpy and plain PyTorch.

Independent of the program: it imports neither ``repro_torch`` nor the
JAX package, and takes nothing the program made. It works out again:

  * the coupling scale c0 = 0.5 / (sigma_J sqrt(n)), sigma_J the RMS
    off-diagonal coupling over the n(n-1) directed pairs, in float64, and
    Jc = c0 J rounded once to float32;
  * the initial states x0, y0 ~ U(-0.1, 0.1): Threefry-2x32 (20 rounds)
    under the key (seed, problem, stream 1) at the counter (0, flat
    (restart, spin) index), the top 24 bits over 2^24, then ``* 0.2 -
    0.1`` in two float32 roundings;
  * the integration: ``n_steps`` symplectic steps, the pump ``a_t = a0
    (t+1) / n_steps`` in float32, inelastic walls for bSB / dSB;
  * the readout (x >= 0 reads +1) and the level-space energies, exact in
    float64.

The coupling sum dv_k = sum_j drive_j Jc[k, j] is taken in ascending j,
a rounded multiply and a rounded add a term: the order the solver
specifies, so a sound kernel agrees to the bit. A term whose coupling is
0 adds a signed zero, which leaves every sum as it is and never changes
a spin's sign, so only the nonzero couplings of each row are summed: on
a sparse graph the loop runs over the largest degree, not over n.

``tf32=True`` rounds the drive and the couplings to TF32 (10 mantissa
bits) before the products, with float32 accumulation: the control.
"""
from __future__ import annotations

import numpy as np
import torch

from .anneal import tf32_round

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
INIT_AMP = 0.1
_INIT_STREAM = 1


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al. 2011); words are Python
    ints or int64 tensors holding values in [0, 2^32)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _fold(k, d: int):
    d = int(d) % (1 << 64)
    return threefry2x32(k[0], k[1], d & M32, d >> 32)


def key(seed: int, *path: int):
    s = int(seed) % (1 << 64)
    k = (s & M32, s >> 32)
    for d in path:
        k = _fold(k, d)
    return k


def inits(seed: int, problem: int, runs: int, n: int, n_true: int,
          device) -> tuple[torch.Tensor, torch.Tensor]:
    """(runs, n) float32 x0, y0 of problem ``problem`` of a batch seeded
    ``seed`` and padded to ``n`` spins; spins at or past ``n_true`` are
    0. (The counter runs over the padded width.)"""
    k = key(seed, problem, _INIT_STREAM)
    idx = torch.arange(runs * n, dtype=torch.int64, device=device)
    w0, w1 = threefry2x32(k[0], k[1], 0, idx)
    out = []
    for w in (w0, w1):
        u = (w >> 8).to(torch.float32) * 2.0 ** -24
        x = (u * (2 * INIT_AMP) - INIT_AMP).view(runs, n)
        x[:, n_true:] = 0.0
        out.append(x)
    return out[0], out[1]


def coupling_scale(J: np.ndarray, n_true: int) -> float:
    """c0 of one (n, n) level matrix over its true size (float64)."""
    J = np.asarray(J, np.float64)
    pairs = max(n_true * (n_true - 1), 1)
    sigma = np.sqrt((J * J).sum() / pairs)
    return 0.5 / (sigma * np.sqrt(float(n_true))) if sigma > 0 else 1.0


def scaled(J: np.ndarray, n_true: int) -> np.ndarray:
    return (np.asarray(J, np.float64) * coupling_scale(J, n_true)) \
        .astype(np.float32)


def _f32(x: float) -> float:
    return float(np.float32(x))


def pump(n_steps: int, a0: float) -> list[float]:
    """a0 - a_t for t = 0..n_steps-1: a_t = f32(a0) * (f32(t+1) *
    f32(1/n_steps)), each op rounded to float32 (as Python floats)."""
    a = np.float32(a0)
    inv = np.float32(1.0 / n_steps)
    t1 = np.arange(1, n_steps + 1, dtype=np.float32)
    return (a - a * (t1 * inv)).tolist()


class SparseRows:
    """Each row k's nonzero couplings Jc[k, j] in ascending j, padded to
    the largest degree with a zero coupling."""

    def __init__(self, Jc: np.ndarray, device, tf32: bool = False):
        nz = Jc != 0
        deg = nz.sum(axis=1)
        D = max(int(deg.max()), 1)
        n = Jc.shape[0]
        idx = np.zeros((n, D), np.int64)
        coef = np.zeros((n, D), np.float32)
        for k in range(n):
            js = np.flatnonzero(nz[k])
            idx[k, :len(js)] = js
            coef[k, :len(js)] = Jc[k, js]
        self.idx = torch.as_tensor(idx.T.copy(), device=device)    # (D, n)
        c = torch.as_tensor(coef.T.copy(), device=device)
        self.coef = tf32_round(c) if tf32 else c
        self.tf32 = tf32

    def matvec(self, drive: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            drive = tf32_round(drive)
        acc = torch.zeros_like(drive)
        for idx, coef in zip(self.idx, self.coef):
            acc = acc + drive.index_select(-1, idx) * coef
        return acc


def integrate(Jc: np.ndarray, x0: torch.Tensor, y0: torch.Tensor, *,
              variant: str, n_steps: int, dt: float, a0: float,
              tf32: bool = False) -> torch.Tensor:
    """Final positions (rows, n) float32 of the rows x0, y0 of one problem
    with scaled couplings Jc (n, n) float32, all at the problem's true
    size (padded spins are zero and uncoupled, so they change nothing)."""
    rows = SparseRows(Jc, x0.device, tf32)
    c_xy, dt32 = _f32(a0 * dt), _f32(dt)
    x, y = x0, y0
    for amat in pump(n_steps, a0):
        x = x + c_xy * y
        drive = torch.where(x >= 0, 1.0, -1.0) if variant == "dSB" else x
        dv = rows.matvec(drive)
        if variant == "aSB":
            y = y + dt32 * (dv - (x * x + amat) * x)
        else:
            y = y + dt32 * (dv - amat * x)
            hit = torch.abs(x) > 1.0
            x = torch.clamp(x, -1.0, 1.0)
            y = torch.where(hit, 0.0, y)
    return x


def energies(J: np.ndarray, sigma: torch.Tensor) -> torch.Tensor:
    """Level-space H = -0.5 s'Js of spins (rows, n), float64 (exact)."""
    s = sigma.to(torch.float64)
    Jd = torch.as_tensor(np.asarray(J, np.float64), device=s.device)
    return -0.5 * (s * (s @ Jd.T)).sum(-1)
