"""Success-rate / TTS / ETS metrology, exactly as the paper defines it.

* success: a run's Hamiltonian reaches >= 99% of the best-known energy
  (tabu oracle) — for negative energies, E <= E_best + 0.01*|E_best|.
* TTS (Eq. 7):   TTS = tau * ln(0.01) / ln(1 - p_suc)
* ETS (Table II): ETS = Power * TTS
* Normalized ETS: ETS / (log2(levels) * N_spins * interactions / 2)
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PaperHW:
    power_w: float = 31.6e-3      # Table II, all on-chip components @1.2V
    anneal_s: float = 3e-6        # tau
    coeff_levels: int = 31
    n_spins: int = 64
    interactions: int = 63        # directed all-to-all


def paper_hw_constants() -> PaperHW:
    return PaperHW()


def success_rate(energies, best_known, frac: float = 0.99,
                 scale=None) -> np.ndarray:
    """energies: (..., R) run energies; best_known: (...,). Returns (...,).

    The tolerance is ``(1-frac)*|best| + 1e-7*scale``: the relative term is
    the paper's 99%-of-best rule, the absolute term absorbs float rounding.
    The absolute term is SCALE-aware, not a fixed 1e-9: when the optimum
    sits exactly at 0 (satisfied planted 3-SAT after offset, balanced
    partitions) the relative term vanishes, and a fixed fudge would decide
    success from float noise — smaller than the noise of a large problem's
    float32 energy accumulation, yet the only margin left. ``scale``
    defaults to the magnitude of the energies being judged (per problem);
    1e-7*scale stays orders of magnitude below the 0.5 level-space grid
    that separates honest sub-optimal states, so no real gap is ever
    forgiven.
    """
    e = np.asarray(energies, dtype=np.float64)
    b = np.asarray(best_known, dtype=np.float64)[..., None]
    if scale is None:
        scale = np.max(np.abs(e), axis=-1, keepdims=True) if e.size else 0.0
    else:
        scale = np.abs(np.asarray(scale, dtype=np.float64))[..., None]
    scale = np.maximum(scale, np.abs(b))
    thresh = b + (1.0 - frac) * np.abs(b) + 1e-7 * scale
    return (e <= thresh + 1e-9).mean(axis=-1)


def time_to_solution(p_suc, tau: float, target: float = 0.99) -> np.ndarray:
    """Eq. (7). p_suc = 0 -> inf; p_suc >= target -> tau (at least one run)."""
    p = np.asarray(p_suc, dtype=np.float64)
    with np.errstate(divide="ignore"):
        tts = tau * np.log(1.0 - target) / np.log1p(-np.minimum(p, 1 - 1e-15))
    tts = np.where(p <= 0.0, np.inf, tts)
    return np.maximum(tts, tau)


def energy_to_solution(power_w: float, tts_s) -> np.ndarray:
    return power_w * np.asarray(tts_s, dtype=np.float64)


def normalized_ets(ets_j, levels: int = 31, n_spins: int = 64,
                   interactions: int = 63) -> np.ndarray:
    """Table II note D: ETS / (log2(levels) * n_spins * interactions / 2).
    Units: J per edge-bit; the paper quotes 2.28 nJ."""
    edges_bits = np.log2(levels) * n_spins * interactions / 2.0
    return np.asarray(ets_j, dtype=np.float64) / edges_bits


def tts_distribution(p_sucs, tau: float):
    """Mean/median/finite-fraction summary of a TTS set (Fig. 5 bottom)."""
    tts = time_to_solution(np.asarray(p_sucs), tau)
    finite = tts[np.isfinite(tts)]
    return {
        "tts": tts,
        "mean": float(finite.mean()) if finite.size else float("inf"),
        "median": float(np.median(finite)) if finite.size else float("inf"),
        "solved_fraction": float(np.isfinite(tts).mean()),
    }
