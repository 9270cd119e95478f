"""Process-variation models for the virtual-chip fleet (the reference's
``physics.variation``).

The paper characterizes ONE physical die. This module manufactures as many
as we like: a :class:`VariationModel` describes a process corner as spreads
around the nominal :class:`~repro_torch.core.device_model.DeviceModel`, and
``sample()`` draws a :class:`ChipVariation`, per-chip parameter tensors
with the chip axis leading, so a whole fleet of imperfect chips anneals in
ONE batched call (``physics.dynamics.fleet_anneal``).

Four non-idealities:

* ``j_mismatch_sigma``: per-CELL multiplicative coupling mismatch
  ``J_eff = J * (1 + sigma * z)``, drawn per directed cell (not
  symmetrized; each J_ij cell is its own current-steering DAC).
* ``tau_leak_spread``: lognormal spread of the gate-leak time constant,
  ``tau_chip = tau_nominal * exp(spread * z)``.
* ``refresh_jitter_slots``: uniform integer refresh-pointer phase offset
  in ``[-jitter, +jitter]`` column slots.
* ``sigma_gain_spread``: lognormal spread of the node nonlinearity gain.

Determinism: chip c's draws come from the counter-based ``rng`` with the
key (seed, c, stream), one stream per parameter. The same seed reproduces
the same draws in any process, growing the fleet never reshuffles
existing chips, and no stream is reused across the chip axis. The draws
are made on the host (float32, with the host's ``log``, ``cos`` and
``exp``), so they are bitwise the same whichever device the fleet then
anneals on. They agree with the reference's ``jax.random`` draws in
distribution, not in value; ``convert.chip_variation_from_arrays`` carries
the reference's draws across.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from .. import rng

#: rng streams of the four per-chip parameters
_STREAM_J, _STREAM_TAU, _STREAM_SLOT, _STREAM_GAIN = 1, 2, 3, 4


@dataclasses.dataclass(frozen=True)
class ChipVariation:
    """Per-chip parameter draws, chip axis leading.

    ``j_gain`` multiplies the coupling matrix (per directed cell),
    ``tau_scale`` multiplies ``DeviceModel.tau_leak_sweeps``,
    ``slot_offset`` shifts the refresh-pointer phase (column slots), and
    ``gain_scale`` multiplies the sigma-nonlinearity gain.
    """

    j_gain: torch.Tensor        # (C, N, N) float32
    tau_scale: torch.Tensor     # (C,)      float32
    slot_offset: torch.Tensor   # (C,)      int32
    gain_scale: torch.Tensor    # (C,)      float32

    @property
    def n_chips(self) -> int:
        return int(self.tau_scale.shape[0])

    @property
    def n_spins(self) -> int:
        return int(self.j_gain.shape[-1])

    def to(self, device) -> "ChipVariation":
        """The same draws on ``device``."""
        return ChipVariation(*(t.to(device) for t in self._leaves()))

    def _leaves(self):
        return (self.j_gain, self.tau_scale, self.slot_offset,
                self.gain_scale)

    @classmethod
    def concat(cls, parts: list["ChipVariation"]) -> "ChipVariation":
        """Stack fleets along the chip axis: how the robustness surface
        rides every process corner in ONE dispatch."""
        if not parts:
            raise ValueError("concat needs at least one ChipVariation")
        return cls(*(torch.cat(leaves, dim=0)
                     for leaves in zip(*(p._leaves() for p in parts))))


@dataclasses.dataclass(frozen=True)
class VariationModel:
    """One process corner: spreads around the nominal device (all zero ->
    every sampled chip IS the nominal device, exactly)."""

    j_mismatch_sigma: float = 0.0
    tau_leak_spread: float = 0.0
    refresh_jitter_slots: int = 0
    sigma_gain_spread: float = 0.0

    def __post_init__(self):
        if self.j_mismatch_sigma < 0 or self.tau_leak_spread < 0 or \
                self.sigma_gain_spread < 0 or self.refresh_jitter_slots < 0:
            raise ValueError(f"variation spreads must be nonnegative: {self}")

    @property
    def is_zero(self) -> bool:
        """True when sampling can only produce the nominal chip."""
        return (self.j_mismatch_sigma == 0 and self.tau_leak_spread == 0 and
                self.refresh_jitter_slots == 0 and
                self.sigma_gain_spread == 0)

    def sample(self, seed: int, n_chips: int, n_spins: int,
               chip0: int = 0) -> ChipVariation:
        """Draw ``n_chips`` chips with indices ``chip0..chip0+n_chips-1``,
        as CPU tensors.

        Chip ``c``'s draw depends only on ``(seed, c)``: prefix-stable
        (sampling 4 chips then 8 reproduces the first 4 bit-identically)
        and stream-independent across the chip axis.
        """
        if n_chips < 1:
            raise ValueError(f"n_chips must be >= 1, got {n_chips}")
        chips = range(chip0, chip0 + n_chips)

        def normal(stream: int, shape: tuple) -> torch.Tensor:
            k = rng.keys(seed, chips, stream, ndim=1 + len(shape))
            return rng.normal(*rng.bits(k, 0, rng.counters((1,) + shape,
                                                           "cpu")))

        zj = normal(_STREAM_J, (n_spins, n_spins))
        zt = normal(_STREAM_TAU, ())
        zg = normal(_STREAM_GAIN, ())
        jit = self.refresh_jitter_slots
        k = rng.keys(seed, chips, _STREAM_SLOT)
        w, _ = rng.bits(k, 0, rng.counters((1,), "cpu"))
        off = (rng.index(w, 2 * jit + 1) - jit).to(torch.int32)
        return ChipVariation(
            j_gain=1.0 + self.j_mismatch_sigma * zj,
            tau_scale=torch.exp(self.tau_leak_spread * zt),
            slot_offset=off,
            gain_scale=torch.exp(self.sigma_gain_spread * zg))


#: the nominal corner: zero spread everywhere.
NOMINAL_VARIATION = VariationModel()


def fingerprint(chips: ChipVariation) -> str:
    """Stable hex digest of a fleet's draws: what the cross-process
    determinism test compares."""
    h = hashlib.sha256()
    for leaf in chips._leaves():
        h.update(np.ascontiguousarray(leaf.cpu().numpy()).tobytes())
    return h.hexdigest()
