"""Digital twin of the chip's analog non-idealities (paper §II.D, §III).

Everything the 65nm circuit does to the mathematical Ising model is captured
here: 4-bit+sign DAC quantization (31 levels), CU gate leakage, the inverter
ADC threshold, drive strength (a/C of Eq. 4), and optional Gaussian "inherent
perturbation" noise used for the measured-baseline comparison of Fig. 4.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Hardware constants of the simulated chip (dimensionless units).

    Time unit = one full column-refresh sweep (64 column slots; 0.8 us at the
    chip's 80 MHz column clock). The paper's 3 us anneal is 3.75 sweeps.
    """

    n_spins: int = 64
    vdd: float = 1.0
    coeff_bits: int = 4                 # magnitude bits -> 31 levels with sign
    cols_per_tile: int = 64             # refresh pointer width (one die = 64)
    substeps: int = 8                   # Euler substeps per column slot
    anneal_sweeps: float = 3.75         # 3 us / 0.8 us
    drive: Optional[float] = None       # a/C in V/(unit level * sweep); None -> 1.0
    tau_leak_sweeps: float = 10.0       # gate-leak time constant, in sweeps
    noise_sigma: float = 0.0            # per-step dv noise (inherent perturbation)
    init_swing: float = 0.5             # |v0 - vdd/2| = init_swing * vdd/2
    compute_dtype: str = "float32"      # matvec operand dtype: 'float32' or
                                        # 'bfloat16' (J levels are exact in
                                        # bf16); accumulation stays f32.

    @property
    def max_level(self) -> int:
        return (1 << self.coeff_bits) - 1  # 15

    @property
    def n_levels(self) -> int:
        return 2 * self.max_level + 1  # 31

    @property
    def threshold(self) -> float:
        return 0.5 * self.vdd

    @property
    def slots_per_sweep(self) -> int:
        return self.cols_per_tile

    @property
    def has_leakage(self) -> bool:
        """True when CU gate leakage decays programmed coefficients (a
        positive, finite time constant). ``tau_leak_sweeps = inf`` models
        ideal refresh (the gradient-descent baseline). The schedule, the
        integer fast-path gate and the autotune cache key all branch on
        this one predicate."""
        return self.tau_leak_sweeps > 0 and math.isfinite(self.tau_leak_sweeps)

    @property
    def n_steps(self) -> int:
        """Total Euler steps in one anneal."""
        return int(round(self.anneal_sweeps * self.slots_per_sweep * self.substeps))

    @property
    def dt(self) -> float:
        """Euler step in sweep units."""
        return 1.0 / (self.slots_per_sweep * self.substeps)

    @property
    def drive_eff(self) -> float:
        """a/C (Eq. 4) in volts per (unit coupling level x sweep); default
        vdd, so the weakest level slews rail to threshold in ~0.5 sweep."""
        if self.drive is not None:
            return self.drive
        return float(self.vdd)

    # -- DAC / ADC -----------------------------------------------------------
    def quantize(self, J: torch.Tensor) -> torch.Tensor:
        """4-bit + sign current-steering DAC: integer levels in [-15, 15]."""
        J = torch.as_tensor(J)
        scale = torch.amax(torch.abs(J), dim=(-1, -2), keepdim=True)
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        lev = torch.round(J / scale * self.max_level)
        return torch.clamp(lev, -self.max_level, self.max_level)

    def adc(self, v: torch.Tensor) -> torch.Tensor:
        """1-bit inverter ADC, Eq. (5): +-1 at vdd/2 (>= maps to +1)."""
        from .binarize import sign_pm1
        return sign_pm1(v, self.threshold)


DEFAULT_DEVICE = DeviceModel()


def chip_power_watts() -> float:
    """Measured total on-chip power (Table II): 31.6 mW @ 1.2 V."""
    return 31.6e-3


def anneal_time_seconds(dev: DeviceModel = DEFAULT_DEVICE) -> float:
    """Physical per-run anneal time tau: sweeps * 64 slots * 12.5 ns."""
    return dev.anneal_sweeps * dev.slots_per_sweep * 12.5e-9
