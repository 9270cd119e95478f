"""Exhaustive ground-state search for small N (validation oracle)."""
from __future__ import annotations

import numpy as np

#: THE exact-tier boundary, shared by the brute-force solver's capability
#: flag (``subset_max_n``) and the oracle cache's brute-force tier — they
#: used to disagree (24 vs 20), so N = 21..24 problems got a heuristic
#: best-known even though exhaustive search was declared feasible.
BRUTE_FORCE_MAX_N = 24


def brute_force_ground_state(J, max_n: int = BRUTE_FORCE_MAX_N,
                             chunk: int = 1 << 16):
    """Exact minimum of H = -0.5 s'Js over s in {-1,+1}^N (N <= max_n).

    Exploits Z2 symmetry (s and -s degenerate): fixes s_0 = +1, halving the
    space. Returns (best_energy, best_sigma).
    """
    J = np.asarray(J, dtype=np.float64)
    n = J.shape[-1]
    if n > max_n:
        raise ValueError(f"brute force limited to N<={max_n}, got {n}")
    total = 1 << (n - 1)
    best_e = np.inf
    best_s = None
    bitpos = np.arange(n - 1, dtype=np.int64)
    for start in range(0, total, chunk):
        codes = np.arange(start, min(start + chunk, total), dtype=np.int64)
        bits = ((codes[:, None] >> bitpos[None, :]) & 1).astype(np.float64)
        s = np.empty((len(codes), n))
        s[:, 0] = 1.0
        s[:, 1:] = 2 * bits - 1
        e = -0.5 * np.einsum("bi,ij,bj->b", s, J, s)
        k = int(e.argmin())
        if e[k] < best_e:
            best_e = float(e[k])
            best_s = s[k].copy()
    return best_e, best_s.astype(np.int8)
