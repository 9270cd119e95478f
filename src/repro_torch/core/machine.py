"""IsingMachine — the public solve() API of the digital twin.

Usage:
    m = IsingMachine(torch_device="cuda")       # paper chip: 64 spins
    out = m.solve(J, num_runs=1000, seed=7)     # J: (N,N) or (P,N,N)
    out.best_energy, out.success_rate(best_known)

``backend`` takes the engine's path names: 'scan' (torch loop), 'fused'
(the CUDA kernel; its plain version on the CPU) or 'auto' (fused on CUDA,
scan on the CPU, cache-aware). solve() dispatches through
``core.engine.AnnealEngine``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .device_model import DeviceModel
from .engine import AnnealEngine
from .lfsr import lfsr_voltage_inits
from .perturbation import DEFAULT_PERTURBATION, NOMINAL, PerturbationConfig

BACKENDS = ("scan", "fused", "auto")


@dataclasses.dataclass
class SolveOutput:
    sigma: np.ndarray           # (P, R, N)
    energy: np.ndarray          # (P, R)
    v_final: np.ndarray         # (P, R, N)
    energy_traj: Optional[np.ndarray] = None

    @property
    def best_energy(self) -> np.ndarray:          # (P,)
        return self.energy.min(axis=-1)

    @property
    def best_sigma(self) -> np.ndarray:           # (P, N)
        idx = self.energy.argmin(axis=-1)
        return np.take_along_axis(self.sigma, idx[:, None, None], axis=1)[:, 0]

    def success_rate(self, best_known, frac: float = 0.99) -> np.ndarray:
        """Fraction of runs reaching >= frac of best-known energy (paper's
        99%-of-best rule; energies are negative, so success is
        E <= best + (1-frac)*|best|)."""
        best_known = np.asarray(best_known, dtype=np.float64).reshape(-1, 1)
        thresh = best_known + (1.0 - frac) * np.abs(best_known)
        return (self.energy <= thresh + 1e-9).mean(axis=-1)


def _numpy(x: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if x is None else x.detach().cpu().numpy()


class IsingMachine:
    def __init__(self,
                 device: DeviceModel | None = None,
                 perturbation: PerturbationConfig | None = None,
                 backend: str = "auto",
                 autotune: bool = False,
                 torch_device: str | torch.device = "cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; the port's "
                             f"backends are the engine paths {BACKENDS}")
        self.device = device or DeviceModel()
        self.perturbation = (perturbation if perturbation is not None
                             else DEFAULT_PERTURBATION)
        self.backend = backend
        self.engine = AnnealEngine(device=self.device,
                                   perturbation=self.perturbation,
                                   path=backend, autotune=autotune,
                                   torch_device=torch_device)

    @property
    def torch_device(self) -> torch.device:
        return self.engine.torch_device

    # ------------------------------------------------------------------
    def solve(self, J, num_runs: int = 100, seed: int = 0,
              record_every: int = 0,
              noise_seed: Optional[int] = None,
              quantize: bool = True) -> SolveOutput:
        """Anneal ``num_runs`` LFSR-seeded runs per problem.

        J: (N, N) or (P, N, N) couplings (symmetric, zero diag).
        quantize: apply the 31-level DAC model (identity for integer J in
            [-15, 15], the paper's problem distribution).
        noise_seed: enables the noise path (dev.noise_sigma > 0): the
            seed of its counter-based per-step normals.
        """
        J = torch.as_tensor(J, dtype=torch.float32, device=self.torch_device)
        if J.dim() == 2:
            J = J[None]
        P, N, _ = J.shape
        dev = self.device
        if N != dev.n_spins:
            dev = dataclasses.replace(dev, n_spins=N)

        Jq = dev.quantize(J) if quantize else J
        v0 = np.stack([
            lfsr_voltage_inits(N, num_runs, seed=seed + 7919 * p,
                               vdd=dev.vdd, swing=dev.init_swing)
            for p in range(P)
        ])  # (P, R, N)
        res = self.engine.run(Jq, torch.as_tensor(v0, device=self.torch_device),
                              noise_seed=noise_seed, record_every=record_every)
        return SolveOutput(sigma=_numpy(res.sigma), energy=_numpy(res.energy),
                           v_final=_numpy(res.v_final),
                           energy_traj=_numpy(res.energy_traj))

    # ------------------------------------------------------------------
    def gradient_descent_baseline(self) -> "IsingMachine":
        """The paper's no-perturbation baseline: same chip, rails always on,
        leakage disabled (ideal refresh), no noise."""
        dev = dataclasses.replace(self.device, tau_leak_sweeps=float("inf"),
                                  noise_sigma=0.0)
        return IsingMachine(device=dev, perturbation=NOMINAL,
                            backend=self.backend,
                            autotune=self.engine.autotune_enabled,
                            torch_device=self.torch_device)

    def inherent_noise_baseline(self, sigma: float = 2.0) -> "IsingMachine":
        """Measured-chip baseline of Fig. 4: no deterministic perturbation,
        only circuit noise."""
        dev = dataclasses.replace(self.device, noise_sigma=sigma)
        return IsingMachine(device=dev, perturbation=NOMINAL,
                            backend=self.backend,
                            autotune=self.engine.autotune_enabled,
                            torch_device=self.torch_device)
