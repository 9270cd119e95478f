"""``Problem`` — the one typed spec every solver and benchmark consumes.

The seed repo passed problems around as bare numpy tuples with drifting
conventions: ``maxcut_problem`` returned a float32 ``J`` while
``problem_set`` returned integer DAC levels, and ``number_partitioning``
returned continuously-scaled couplings that the machine then *re*-quantized
(``DeviceModel.quantize`` rescales to the full ±15 range, silently
distorting any instance whose strongest coupling is below 15). ``Problem``
normalizes all of that:

* couplings are stored ONCE as integer DAC levels (``levels``, int16,
  symmetric, zero diagonal) plus a single float ``scale`` such that the
  physical coupling matrix is ``J = levels * scale``;
* construction asserts the levels fit the chip's 31-level range
  (|level| <= 15 by default) — nothing downstream re-quantizes;
* ``J`` is materialized to float32 exactly once (cached);
* ``content_hash`` is a stable digest of (n, levels, scale, h) used to key
  the disk-backed best-known oracle cache across processes.

Problems are frozen numpy specs; ``content_hash`` is byte-identical to the
JAX package's, so both packages key their oracle caches the same way.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np

#: the chip's 4-bit + sign DAC: integer levels in [-15, 15] (31 levels).
MAX_LEVEL = 15


def _canonical_levels(levels, max_level: int) -> np.ndarray:
    lev = np.asarray(levels)
    if lev.ndim != 2 or lev.shape[0] != lev.shape[1]:
        raise ValueError(f"levels must be (N, N), got {lev.shape}")
    if not np.all(lev == np.round(lev)):
        raise ValueError(
            "couplings are not integer DAC levels; use "
            "Problem.from_couplings(..., quantize=True) for continuous J")
    if np.abs(lev).max(initial=0) > max_level:
        raise ValueError(
            f"coupling levels exceed the device's {2 * max_level + 1}-level "
            f"range: |level| max {np.abs(lev).max()} > {max_level}")
    if np.any(np.diag(lev) != 0):
        raise ValueError("levels must have a zero diagonal (bias-free chip)")
    if not np.array_equal(lev, lev.T):
        raise ValueError(
            "levels must be symmetric — the single-flip solvers' "
            "incremental field updates assume J == J.T; fold a directed "
            "coupling matrix to (J + J.T) / 2 first")
    out = lev.astype(np.int16)
    out.setflags(write=False)
    return out


@dataclasses.dataclass(frozen=True)
class Problem:
    """Frozen spec of one Ising instance: ``H = -0.5 s' (levels*scale) s``.

    ``meta`` carries problem-family extras (Max-Cut adjacency ``W``,
    partition ``values``, generator seed/density, …) and is excluded from
    the content hash.
    """
    levels: np.ndarray                      # (N, N) int16 DAC levels
    scale: float = 1.0                      # J = levels * scale
    h: Optional[np.ndarray] = None          # bias fields (chip is bias-free)
    kind: str = "custom"
    meta: dict = dataclasses.field(default_factory=dict)
    max_level: int = MAX_LEVEL

    def __post_init__(self):
        object.__setattr__(self, "levels",
                           _canonical_levels(self.levels, self.max_level))
        object.__setattr__(self, "scale", float(self.scale))
        if self.h is not None:
            h = np.asarray(self.h, dtype=np.float64)
            h.setflags(write=False)
            object.__setattr__(self, "h", h)

    # -- basic views -------------------------------------------------------
    @property
    def n(self) -> int:
        return self.levels.shape[0]

    @property
    def J(self) -> np.ndarray:
        """Physical float32 couplings, materialized once and cached."""
        cached = self.__dict__.get("_J")
        if cached is None:
            cached = (self.levels.astype(np.float32) *
                      np.float32(self.scale))
            cached.setflags(write=False)
            self.__dict__["_J"] = cached
        return cached

    @property
    def J_levels(self) -> np.ndarray:
        """Level-space float32 couplings — what the solvers integrate.

        Energies computed on ``J_levels`` are in level units; multiply by
        ``scale`` for physical units (energy is linear in J).
        """
        cached = self.__dict__.get("_J_levels")
        if cached is None:
            cached = self.levels.astype(np.float32)
            cached.setflags(write=False)
            self.__dict__["_J_levels"] = cached
        return cached

    @property
    def content_hash(self) -> str:
        """sha1 over (n, levels, scale, h) — keys the oracle cache."""
        cached = self.__dict__.get("_hash")
        if cached is None:
            hsh = hashlib.sha1()
            hsh.update(f"n={self.n};scale={self.scale!r};".encode())
            hsh.update(np.ascontiguousarray(self.levels).tobytes())
            if self.h is not None:
                hsh.update(b";h=")
                hsh.update(np.ascontiguousarray(self.h).tobytes())
            cached = hsh.hexdigest()
            self.__dict__["_hash"] = cached
        return cached

    def energy(self, sigma) -> np.ndarray:
        """Physical Ising energy of ±1 configuration(s) (..., N)."""
        s = np.asarray(sigma, dtype=np.float64)
        J = self.J.astype(np.float64)
        return -0.5 * np.einsum("...i,ij,...j->...", s, J, s)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_couplings(cls, J, kind: str = "custom", meta: dict | None = None,
                       quantize: bool = False,
                       max_level: int = MAX_LEVEL) -> "Problem":
        """Wrap a coupling matrix.

        Integer-valued J within ±max_level is stored exactly (scale = 1).
        Continuous J requires ``quantize=True``: proportional rounding onto
        the 31-level grid with ``scale = max|J| / max_level`` so that
        ``levels * scale ~= J`` (the DAC's own resolution limit).
        """
        J = np.asarray(J, dtype=np.float64)
        Jz = J - np.diag(np.diag(J))
        integral = np.all(Jz == np.round(Jz)) and \
            np.abs(Jz).max(initial=0) <= max_level
        if integral:
            return cls(levels=np.round(Jz), scale=1.0, kind=kind,
                       meta=meta or {}, max_level=max_level)
        if not quantize:
            raise ValueError(
                "J is not integer DAC levels in range; pass quantize=True "
                "to round onto the 31-level grid")
        scale = np.abs(Jz).max() / max_level
        levels = np.round(Jz / scale)
        return cls(levels=levels, scale=float(scale), kind=kind,
                   meta=meta or {}, max_level=max_level)

    @classmethod
    def random_qubo(cls, n: int, density: float, seed: int = 0,
                    max_level: int = MAX_LEVEL) -> "Problem":
        """The paper's §IV instance family: symmetric J with ~density edge
        fraction and nonzero integer weights uniform in ±max_level."""
        from ..problems.random_qubo import random_ising_problem
        rng = np.random.default_rng(seed)
        J = random_ising_problem(n, density, rng, max_level)
        return cls.from_couplings(
            J, kind="random_qubo",
            meta={"density": density, "seed": seed}, max_level=max_level)

    @classmethod
    def maxcut(cls, n: int, density: float, seed: int = 0,
               weighted: bool = True, max_w: int = MAX_LEVEL) -> "Problem":
        """Random (weighted) Max-Cut; J = -W per paper Eq. (2). The graph
        adjacency is kept in ``meta['W']`` for cut-value readout."""
        from ..core.hamiltonian import maxcut_to_ising
        from ..problems.maxcut import random_maxcut
        W = random_maxcut(n, density, seed, weighted, max_w)
        return cls.from_couplings(
            maxcut_to_ising(W), kind="maxcut",
            meta={"W": W, "density": density, "seed": seed})

    @classmethod
    def partition(cls, values, max_level: int = MAX_LEVEL) -> "Problem":
        """Number partitioning: J_ij = -2 a_i a_j (zero diagonal).

        Integer inputs whose couplings fit ±max_level are stored exactly —
        a perfectly-partitionable instance then reaches the analytic
        optimum H = -sum a_i^2 exactly. Larger/continuous inputs are
        proportionally quantized (scale recorded).
        """
        a = np.asarray(values, dtype=np.float64)
        J = -2.0 * np.outer(a, a)
        np.fill_diagonal(J, 0.0)
        integral = np.all(J == np.round(J)) and \
            np.abs(J).max(initial=0) <= max_level
        return cls.from_couplings(
            J, kind="partition", meta={"values": a},
            quantize=not integral, max_level=max_level)

    def partition_residue(self, sigma) -> np.ndarray:
        """|sum a_i s_i| for partition problems (0 == perfect partition)."""
        a = np.asarray(self.meta["values"], dtype=np.float64)
        return np.abs((a * np.asarray(sigma, dtype=np.float64)).sum(axis=-1))
