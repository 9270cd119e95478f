"""Plain reference of the engine's anneal: the 64-spin chip's perturbed
dynamics (paper Eq. 3-6, section III), in numpy and plain PyTorch.

Independent of the program: it imports neither ``repro_torch`` nor the
JAX package, and takes nothing the program made. It works out again:

  * the LFSR initial voltages of every run (paper section II.C: a 64-bit
    Fibonacci LFSR, taps x^64 + x^63 + x^61 + x^60 + 1, one shift a run,
    each die's register seeded by splitmix64), vectorised over problems;
  * the closed-form column schedule (refresh, gate leakage, DAC rails
    gated off ``off_slots`` of every ``period_slots`` slots, none in the
    last ``settle_sweeps``), in the op order of the paper's model;
  * the anneal: T Euler steps of {1-bit ADC, column scale, the coupling
    product in float32 with TF32 off, integrate, clip to the rails};
  * the level-space energies of the final spins, exact in float64.

``tf32=True`` rounds both operands of the coupling product to TF32 (10
mantissa bits, as the tensor cores read a float32 operand), with float32
accumulation: the control that has to come out as not correct.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK64 = (1 << 64) - 1
_TAPS = (63, 62, 60, 59)
_ZERO_SEED = 0xACE1_BEEF_DEAD_F00D


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) or 1


def lfsr_states(seeds, num_states: int) -> np.ndarray:
    """(len(seeds), num_states) uint64: each register's first states, one
    shift apart (a zero seed takes the canonical nonzero one)."""
    s = np.array([int(x) & _MASK64 or _ZERO_SEED for x in seeds],
                 dtype=np.uint64)
    out = np.empty((len(s), num_states), dtype=np.uint64)
    one = np.uint64(1)
    for k in range(num_states):
        out[:, k] = s
        fb = np.zeros_like(s)
        for t in _TAPS:
            fb ^= (s >> np.uint64(t)) & one
        s = (s << one) | fb
    return out


def lfsr_voltages(n: int, runs: int, seeds, vdd: float,
                  swing: float) -> np.ndarray:
    """(len(seeds), runs, n) float32 initial voltages: vdd/2 +- swing*vdd/2
    by the low bits of each run's state; above 64 spins a register a
    64-spin tile, tile t seeded ``splitmix64(seed + t)``."""
    tiles = []
    for t in range(-(-n // 64)):
        width = min(64, n - 64 * t)
        st = lfsr_states([splitmix64(int(s) + t) for s in seeds], runs)
        shifts = np.arange(width, dtype=np.uint64)
        tiles.append(((st[..., None] >> shifts) & np.uint64(1))
                     .astype(np.int8))
    spins = (2 * np.concatenate(tiles, axis=-1) - 1).astype(np.float32)
    return (0.5 + 0.5 * swing * spins) * vdd


def schedule(chip: dict, pert: dict, n: int, device) -> torch.Tensor:
    """(T, n) float32 column scales s_j(t) in [0, 1] of the variant
    ``pert``: column j was last written at slot m_j(t) = slot - ((slot -
    j) mod C) (before the first pass, in the pre-anneal load at slot j -
    C); with ``leak`` the coefficient decays as exp(-age / (C tau)) since
    then (else ideal refresh holds it), and it reads 0 where that write
    fell while the rails were gated off."""
    C, sub = int(chip["cols_per_tile"]), int(chip["substeps"])
    T = int(round(chip["anneal_sweeps"] * C * sub))
    step = torch.arange(T, device=device, dtype=torch.int64)[:, None]
    j = torch.arange(n, device=device, dtype=torch.int64)[None, :] % C
    slot = torch.div(step, sub, rounding_mode="floor")
    last = slot - (slot - j) % C
    pre = last < 0
    last = torch.where(pre, j - C, last)
    age = step.to(torch.float32) / sub - last.to(torch.float32)
    if pert["leak"]:
        tau = torch.tensor(C * chip["tau_leak_sweeps"], dtype=torch.float32,
                           device=device)
        decay = torch.exp(-age / tau)
    else:
        decay = torch.ones_like(age)
    if not pert["off_slots"]:
        return decay
    settle = (chip["anneal_sweeps"] - pert["settle_sweeps"]) * C
    off = ((last % pert["period_slots"]) < pert["off_slots"]) & ~pre \
        & (last < settle)
    return torch.where(off, torch.zeros((), device=device), decay)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest, ties away
    from zero (the conversion the tensor cores apply)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def anneal(J: torch.Tensor, v0: torch.Tensor, chip: dict, pert: dict,
           tf32: bool = False) -> torch.Tensor:
    """Final +-1 spins (P, R, n) float32 of J (P, n, n) float32 levels from
    v0 (P, R, n) volts."""
    n = J.shape[-1]
    vdd = float(chip["vdd"])
    thr = 0.5 * vdd
    C, sub = int(chip["cols_per_tile"]), int(chip["substeps"])
    drive_dt = float(chip["drive"]) / (C * sub)
    scales = schedule(chip, pert, n, J.device) * drive_dt
    Jt = J.transpose(-1, -2).contiguous()
    if tf32:
        Jt = tf32_round(Jt)
    one = torch.ones((), device=J.device)
    v = v0
    for s in scales:
        sq = torch.where(v >= thr, one, -one) * s
        if tf32:
            sq = tf32_round(sq)
        v = torch.clamp(v + torch.matmul(sq, Jt), 0.0, vdd)
    return torch.where(v >= thr, one, -one)


def energies(J: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Level-space H = -0.5 s'Js of spins (P, R, n) under J (P, n, n),
    float64 (exact: integer terms far below 2^53)."""
    s = sigma.to(torch.float64)
    Jd = J.to(torch.float64)
    return -0.5 * (s * torch.matmul(s, Jd.transpose(-1, -2))).sum(-1)
