"""64-bit LFSR spin initializer (paper §II.C).

The chip seeds spins from a 64-bit linear feedback shift register; an external
CLK_INIT pulse shifts the LFSR by ONE bit per solve, so consecutive runs see
strongly-correlated-but-distinct initial configurations. We reproduce that
exactly (Fibonacci form, maximal-length taps x^64 + x^63 + x^61 + x^60 + 1)
and generalize to N != 64 by reading the low N bits (N <= 64) or by
concatenating independently-seeded LFSRs per 64-spin tile (N > 64).

Host-side (numpy) — initial states are inputs to the solver, not traced.
"""
from __future__ import annotations

import numpy as np

_TAPS_64 = (63, 62, 60, 59)  # bit indices (0-based) of x^64+x^63+x^61+x^60+1


def lfsr64_states(seed: int, num_states: int) -> np.ndarray:
    """Return ``num_states`` consecutive 64-bit LFSR states (uint64).

    state[k+1] = (state[k] << 1) | feedback, feedback = XOR of tap bits.
    A zero seed is mapped to the canonical nonzero seed 0xACE1...
    """
    state = np.uint64(seed) or np.uint64(0xACE1_BEEF_DEAD_F00D)
    out = np.empty(num_states, dtype=np.uint64)
    s = int(state)
    mask = (1 << 64) - 1
    for k in range(num_states):
        out[k] = s
        fb = 0
        for t in _TAPS_64:
            fb ^= (s >> t) & 1
        s = ((s << 1) | fb) & mask
    return out


def bits_from_states(states: np.ndarray, n_bits: int) -> np.ndarray:
    """Unpack the low ``n_bits`` of each uint64 state -> (len(states), n_bits) {0,1}."""
    n = min(n_bits, 64)
    shifts = np.arange(n, dtype=np.uint64)
    bits = (states[:, None] >> shifts[None, :]) & np.uint64(1)
    return bits.astype(np.int8)


def lfsr_spin_inits(n_spins: int, num_runs: int, seed: int = 0x5EED) -> np.ndarray:
    """(num_runs, n_spins) array of +-1 initial spins, chip-faithful.

    For n_spins > 64, each 64-spin tile gets its own LFSR seeded by
    splitmix64(seed + tile), mirroring a multi-die array with per-die LFSRs.
    """
    tiles = []
    remaining = n_spins
    tile_idx = 0
    while remaining > 0:
        width = min(64, remaining)
        tile_seed = _splitmix64(seed + tile_idx)
        states = lfsr64_states(tile_seed, num_runs)
        tiles.append(bits_from_states(states, width))
        remaining -= width
        tile_idx += 1
    bits = np.concatenate(tiles, axis=1)
    return (2 * bits - 1).astype(np.int8)


def lfsr_voltage_inits(n_spins: int, num_runs: int, seed: int = 0x5EED,
                       vdd: float = 1.0, swing: float = 0.25) -> np.ndarray:
    """Initial capacitor voltages: vdd/2 +- swing*vdd/2 according to LFSR bits."""
    spins = lfsr_spin_inits(n_spins, num_runs, seed).astype(np.float32)
    return (0.5 + 0.5 * swing * spins) * vdd


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & ((1 << 64) - 1)
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) or 1
