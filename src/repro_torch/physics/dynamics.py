"""Continuous-time analog device dynamics: the physics tier's integrator
(the reference's ``physics.dynamics``).

The discrete engine abstracts the chip to threshold logic: a 1-bit ADC
reads each capacitor and the node update is a hard-sign Euler step. Analog
Ising machines (BRIM arXiv:2007.06665, the memristor-MTJ intrinsic
annealer arXiv:2506.14676) are better described as coupled nodal ODEs with
a saturating nonlinearity, a bistable latch, RC relaxation and thermal
noise. This module integrates exactly that, in the chip's voltage
coordinates:

    C dv_i/dt = a * sum_j s_j(t) * Jg_ij * sig_g(v_j)     (coupling drive)
              + latch * u_i (1 - u_i^2) * vdd/2           (bistable latch)
              - (v_i - vdd/2) / tau_rc                    (RC relaxation)
              + xi_i(t),   u = (v - vdd/2) / (vdd/2)      (thermal noise)

with ``s(t)`` the same closed-form column-refresh / leakage / perturbation
schedule the discrete paths use (``core.perturbation.scales_from_cols``;
per-chip leakage spread and refresh jitter ride its overrides) and
``sig_g`` a tanh of gain ``g`` (``g = inf`` is the hard 1-bit ADC).

Integration is fixed-step Euler–Maruyama or stochastic Heun, a torch loop
of ``dev.n_steps`` steps over (chips, problems, restarts, spins): a whole
variation-aware virtual-chip fleet is ONE batched call per pad bucket.
The coupling product is a batched ``torch.matmul``; every other op is
elementwise.

Discrete-limit contract: with ``DISCRETE_LIMIT`` params (hard ADC, no
latch, no RC, no noise) and a trivial fleet (``chips=None``), the
integrator runs the port's scan path (``core.annealer.anneal``) op for op
— the same ``schedule_table`` times drive·dt, the same int8 ADC and
compute-dtype cast, the same ``torch.matmul`` on the same (P, R, N) @
(P, N, N) shapes, the same clip — so its voltages and spins are bitwise
the scan path's on every device.

Noise: step t's normals for chip c come from the counter-based ``rng``
with the key (key, c) and the counter (t, flat (P, R, N) index), so chip
c's noise depends only on (key, t, c): independent across the chip axis
and stable as the fleet grows.

Energies are reported against the NOMINAL couplings: the imperfect chip is
still being asked to solve the ideal problem, which is the robustness
question the paper's single die cannot answer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .. import rng
from ..core.annealer import _compute_dtype
from ..core.binarize import sign_pm1
from ..core.device_model import DeviceModel
from ..core.hamiltonian import ising_energy
from ..core.perturbation import (PerturbationConfig, column_scales,
                                 scales_from_cols, schedule_table)
from ..device import resolve_device
from .variation import ChipVariation

_INTEGRATORS = ("em", "heun")

#: rng stream of the thermal noise
NOISE_STREAM = 5


@dataclasses.dataclass(frozen=True)
class PhysicsParams:
    """Knobs of the analog node model.

    gain: sigma-nonlinearity gain; ``inf`` collapses tanh to the chip's
        hard 1-bit inverter ADC (the discrete limit).
    latch: bistable cross-coupled-latch restoring strength per sweep, a
        double-well drift ``u(1-u^2)`` stable at the rails, unstable at
        threshold. 0 disables.
    tau_rc_sweeps: RC relaxation of the node capacitor toward vdd/2
        (finite output impedance). ``inf`` disables.
    noise_sigma: thermal-noise amplitude in volts per sqrt(sweep),
        integrated Euler–Maruyama style (``sqrt(dt)`` scaling).
    integrator: 'em' (Euler–Maruyama) or 'heun' (stochastic Heun: the
        deterministic drift gets a predictor/corrector pass, the noise
        increment is shared).
    """

    gain: float = 8.0
    latch: float = 0.5
    tau_rc_sweeps: float = float("inf")
    noise_sigma: float = 0.0
    integrator: str = "em"

    def __post_init__(self):
        if self.integrator not in _INTEGRATORS:
            raise ValueError(f"unknown integrator {self.integrator!r}; "
                             f"choose from {_INTEGRATORS}")
        if not self.gain > 0:
            raise ValueError(f"gain must be positive, got {self.gain}")
        if self.latch < 0 or self.noise_sigma < 0:
            raise ValueError(f"latch/noise_sigma must be nonnegative: {self}")

    @property
    def hard_adc(self) -> bool:
        return math.isinf(self.gain)

    @property
    def has_rc(self) -> bool:
        return self.tau_rc_sweeps > 0 and math.isfinite(self.tau_rc_sweeps)


#: hardware-realistic defaults: saturating nodes + a mild latch.
DEFAULT_PHYSICS = PhysicsParams()

#: the regime where the ODE tier must agree with the discrete engine
#: bit for bit (hard ADC, no latch, no RC, no noise, plain Euler).
DISCRETE_LIMIT = PhysicsParams(gain=float("inf"), latch=0.0,
                               tau_rc_sweeps=float("inf"), noise_sigma=0.0,
                               integrator="em")


@dataclasses.dataclass(frozen=True)
class FleetResult:
    """One fleet anneal: chip axis leading, then (problems, runs, spins)."""
    v_final: torch.Tensor    # (C, P, R, N) final capacitor voltages
    sigma: torch.Tensor      # (C, P, R, N) readout spins (±1 float32)
    energy: torch.Tensor     # (C, P, R) Ising energy vs the NOMINAL J


# module-level dispatch ledger: one count per fleet_anneal call, which is
# one batched integration of a pad bucket
_dispatches = 0


def dispatch_count() -> int:
    return _dispatches


def reset_dispatch_count() -> None:
    global _dispatches
    _dispatches = 0


class _Schedule:
    """Per-column coupling scales times drive·dt at step t: (1, N) nominal,
    (C, N) per chip.

    The nominal branch indexes the scan path's own ``schedule_table``
    (the same call on the same shapes, so bitwise the same values); a
    Heun corrector's extra step past the end comes from ``column_scales``.
    The varied branch evaluates ``scales_from_cols`` with the chips'
    leakage and refresh-jitter overrides, one step at a time."""

    def __init__(self, dev: DeviceModel, pert: PerturbationConfig, n: int,
                 chips: Optional[ChipVariation], device: torch.device):
        self.dev, self.pert, self.chips = dev, pert, chips
        self.drive_dt = dev.drive_eff * dev.dt
        if chips is None:
            self.table = schedule_table(dev, pert, n_cols=n,
                                        device=device) * self.drive_dt
            self.n, self.device = n, device
        else:
            self.cols = torch.arange(n, device=device)[None, :]
            self.tau = (dev.tau_leak_sweeps * chips.tau_scale[:, None]
                        if dev.has_leakage else None)
            self.offset = chips.slot_offset[:, None]

    def __call__(self, t: int) -> torch.Tensor:
        if self.chips is not None:
            return scales_from_cols(t, self.cols, self.dev, self.pert,
                                    tau_leak_sweeps=self.tau,
                                    slot_offset=self.offset) * self.drive_dt
        if t < self.table.shape[0]:
            return self.table[t][None]
        return (column_scales(t, self.dev, self.pert, n_cols=self.n,
                              device=self.device) * self.drive_dt)[None]


def _drift(v, t, Jt, sched: _Schedule, dev: DeviceModel,
           params: PhysicsParams, cdt: torch.dtype, gain_scale):
    """Deterministic dv of one Euler step (dt folded in), (C, P, R, N);
    the nominal branch (``Jt`` (P, N, N)) runs the scan path's exact op
    sequence on v[0]."""
    s = sched(t)                                          # (C or 1, N)
    if params.hard_adc:
        q = sign_pm1(v, dev.threshold, torch.int8).to(torch.float32)
    else:
        u = (v - dev.threshold) / dev.threshold
        g = params.gain if gain_scale is None else params.gain * gain_scale
        q = torch.tanh(g * u)
    if Jt.dim() == 3:                                     # one nominal chip
        sq = (q[0] * s[0]).to(cdt).to(torch.float32)
        dv = torch.matmul(sq, Jt)[None]
    else:
        sq = (q * s[:, None, None, :]).to(cdt).to(torch.float32)
        dv = torch.matmul(sq, Jt)
    if params.latch > 0:
        u = (v - dev.threshold) / dev.threshold
        dv = dv + (params.latch * dev.dt * dev.threshold) * u * (1.0 - u * u)
    if params.has_rc:
        dv = dv + (dev.dt / params.tau_rc_sweeps) * (dev.threshold - v)
    return dv


def fleet_anneal(J, v0, dev: DeviceModel, pert: PerturbationConfig,
                 params: PhysicsParams = DEFAULT_PHYSICS,
                 chips: Optional[ChipVariation] = None,
                 key: Optional[int] = None,
                 torch_device: str | torch.device = "cuda") -> FleetResult:
    """Integrate the analog fleet on ``torch_device``: ONE batched call.

    J: (P, N, N) nominal level-space couplings; v0: (P, R, N) initial
    voltages (arrays or tensors); chips: per-chip variation draws (``None``
    = one nominal chip: the chip axis of the result has length 1). key:
    the integer seed of the thermal noise, required iff
    ``params.noise_sigma > 0``.
    """
    global _dispatches
    device = resolve_device(torch_device)
    J = torch.as_tensor(J, dtype=torch.float32, device=device)
    if J.dim() == 2:
        J = J[None]
    v0 = torch.as_tensor(v0, dtype=torch.float32, device=device)
    if v0.dim() == 2:
        v0 = v0[None].expand((J.shape[0],) + tuple(v0.shape))
    if params.noise_sigma > 0 and key is None:
        raise ValueError("params.noise_sigma > 0 needs a PRNG key (the "
                         "noise's integer seed): unseeded thermal noise "
                         "would make the fleet irreproducible")
    if chips is not None and chips.n_spins != J.shape[-1]:
        raise ValueError(f"chips sampled for N={chips.n_spins} but the "
                         f"bucket is N={J.shape[-1]}: sample the fleet "
                         f"at the PADDED size")
    n = J.shape[-1]
    if n != dev.n_spins:
        dev = dataclasses.replace(dev, n_spins=n)
    cdt = _compute_dtype(dev)
    # loop-invariant casts and transposes outside the loop, as the scan
    # path makes them (a bf16 operand is carried upcast to f32)
    Jc = J.to(cdt)
    gain_scale = None
    if chips is None:
        C = 1
        Jt = Jc.to(torch.float32).transpose(-1, -2).contiguous()
    else:
        chips = chips.to(device)
        C = chips.n_chips
        J_eff = Jc[None] * chips.j_gain[:, None].to(cdt)   # (C, P, N, N)
        Jt = J_eff.to(torch.float32).transpose(-1, -2).contiguous()
        if not params.hard_adc:
            gain_scale = chips.gain_scale[:, None, None, None]
    sched = _Schedule(dev, pert, n, chips, device)
    v = v0.to(torch.float32)[None].expand((C,) + tuple(v0.shape))
    if params.noise_sigma > 0:
        noise_keys = rng.keys(key, range(C), NOISE_STREAM, device=device,
                              ndim=4)
        noise_idx = rng.counters((1,) + tuple(v0.shape), device)
        noise_scale = params.noise_sigma * math.sqrt(dev.dt)

    for t in range(dev.n_steps):
        dv = _drift(v, t, Jt, sched, dev, params, cdt, gain_scale)
        if params.integrator == "heun":
            v_pred = torch.clamp(v + dv, 0.0, dev.vdd)
            dv2 = _drift(v_pred, t + 1, Jt, sched, dev, params, cdt,
                         gain_scale)
            dv = 0.5 * (dv + dv2)
        if params.noise_sigma > 0:
            z = rng.normal(*rng.bits(noise_keys, t, noise_idx))
            dv = dv + noise_scale * z
        v = torch.clamp(v + dv, 0.0, dev.vdd)
    sigma = dev.adc(v)                     # sign of the soft spin at readout
    energy = ising_energy(J[None], sigma)  # vs NOMINAL J: the ideal problem
    _dispatches += 1
    return FleetResult(v_final=v, sigma=sigma, energy=energy)
