"""Continuous programming + landscape perturbation schedule (paper §III).

The chip refreshes coupling columns round-robin (one column per 12.5 ns slot).
In nominal mode the DAC rails are always on, so the selected column is simply
re-programmed (mitigating gate leakage). In perturbation mode the DAC rails
are gated off for ``off_slots`` out of every ``period_slots`` column slots;
a column selected while the rails are off is written to ZERO and stays zero
until its next selection with rails on.

The schedule is deterministic and closed-form in the step index:

    column j's most recent selection slot  m_j(t) = slot - ((slot - j) mod C)
    zeroed_j(t)  = rails_off(m_j)                      (anneal-phase selections)
    scale_j(t)   = 0 if zeroed else exp(-age_j / (C * tau_leak))

Pre-anneal programming (the initial full load) is modeled as selection slots
m_j = j - C with rails on. ``mod`` is the floor modulo throughout (torch's
``%`` on integer tensors, ``jnp.mod`` in the reference); the CUDA kernel
writes it out explicitly because C's ``%`` truncates.
"""
from __future__ import annotations

import dataclasses

import torch

from .device_model import DeviceModel


@dataclasses.dataclass(frozen=True)
class PerturbationConfig:
    """Landscape-perturbation knobs (all deterministic).

    period_slots: DAC gating period in column slots (not a multiple of 64,
        so the disable window rotates across columns pass-to-pass).
    off_slots: rails-off window length per period (0 disables perturbation).
    settle_sweeps: perturbation is disabled for the LAST ``settle_sweeps``
        of the anneal so the restored Hamiltonian drives final convergence.
    """

    period_slots: int = 48
    off_slots: int = 8
    settle_sweeps: float = 1.0

    @property
    def enabled(self) -> bool:
        return self.off_slots > 0


NOMINAL = PerturbationConfig(off_slots=0)
DEFAULT_PERTURBATION = PerturbationConfig()


def scales_from_cols(step, col_ids: torch.Tensor, dev: DeviceModel,
                     pert: PerturbationConfig,
                     dtype: torch.dtype = torch.float32, *,
                     tau_leak_sweeps=None, slot_offset=None) -> torch.Tensor:
    """Closed-form column scales; ``step`` (int or integer tensor) broadcasts
    against the integer tensor ``col_ids`` and the per-chip overrides:

    tau_leak_sweeps: a tensor in place of ``dev.tau_leak_sweeps`` (the
        physics tier's per-chip leakage spread); nonpositive entries mean
        no decay.
    slot_offset: an integer tensor, the refresh pointer's phase offset in
        column slots (per-chip refresh jitter).

    With both ``None`` the op sequence is the one below without them, so
    the scan path and the kernel's plain version are unchanged.

    The float32 op sequence is the reference's, op for op: ``age = step /
    substeps - last_sel``, ``decay = exp(-age / (C * tau))``, then
    ``where(rails_off, 0, decay)``. The divisor ``C * tau`` is a tensor on
    the same device: torch turns division by a Python scalar on CUDA into a
    reciprocal multiply, which is not IEEE division.
    """
    C = dev.cols_per_tile
    device = col_ids.device
    step = torch.as_tensor(step, dtype=torch.int64, device=device)
    col_ids = col_ids.to(torch.int64)
    slot = torch.div(step, dev.substeps, rounding_mode="floor")
    if slot_offset is not None:
        offset = torch.as_tensor(slot_offset, device=device).to(torch.int64)
        slot = slot + offset

    j = col_ids % C                                 # column phase within tile
    d = (slot - j) % C                              # slots since last selection
    last_sel = slot - d                             # may be < 0 before 1st pass
    pre = last_sel < 0                              # pre-anneal load pass:
    last_sel = torch.where(pre, j - C, last_sel)    # column j at slot j - C

    age = step.to(dtype) / dev.substeps - last_sel.to(dtype)
    if slot_offset is not None:
        # last_sel lives in the offset slot clock: give the step clock the
        # same offset, so the age stays in [0, C]
        age = age + offset.to(dtype)
    if tau_leak_sweeps is not None:
        tau = torch.as_tensor(tau_leak_sweeps, device=device).to(dtype)
        one = torch.ones((), dtype=dtype, device=device)
        safe = torch.where(tau > 0, tau, one)
        decay = torch.where(tau > 0, torch.exp(-age / (C * safe)), one)
    elif dev.has_leakage:
        denom = torch.tensor(C * dev.tau_leak_sweeps, dtype=dtype,
                             device=device)
        decay = torch.exp(-age / denom)
    else:
        decay = torch.ones_like(age)
    if not pert.enabled:
        return decay
    settle_start = (dev.anneal_sweeps - pert.settle_sweeps) * C
    rails_off = (last_sel % pert.period_slots) < pert.off_slots
    rails_off = rails_off & ~pre & (last_sel < settle_start)
    return torch.where(rails_off, torch.zeros((), dtype=dtype, device=device),
                       decay)


def unit_scales(dev: DeviceModel, pert: PerturbationConfig) -> bool:
    """True when the schedule is identically 1 for every step/column — no
    DAC gating and no (finite) leakage. In that regime the anneal is pure
    gradient descent and the int8 fast path is exact."""
    return (not pert.enabled) and not dev.has_leakage


def column_scales(step, dev: DeviceModel, pert: PerturbationConfig,
                  n_cols: int | None = None, dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """Effective per-column coupling scale s_j at Euler step ``step`` ->
    (n_cols,) in [0, 1]. J_eff(t) = J * diag(s(t)) on the source-spin axis,
    applied as an elementwise scale on the quantized spin vector."""
    n = n_cols if n_cols is not None else dev.n_spins
    col_ids = torch.arange(n, device=device)
    return scales_from_cols(step, col_ids, dev, pert, dtype=dtype)


def schedule_table(dev: DeviceModel, pert: PerturbationConfig,
                   n_cols: int | None = None, dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """s(t) for all steps -> (n_steps, n_cols). The scan path and the
    table-driven oracle ``kernels.ref.fused_anneal_ref`` consume it; the
    CUDA kernel derives the same values in-kernel from the step index."""
    n = n_cols if n_cols is not None else dev.n_spins
    steps = torch.arange(dev.n_steps, device=device)[:, None]
    cols = torch.arange(n, device=device)[None, :]
    return scales_from_cols(steps, cols, dev, pert, dtype=dtype)
