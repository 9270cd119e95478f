"""Batched continuous-time anneal (paper Eq. 3-6) — the scan path as a torch
loop.

The dynamics integrated here are the chip's node equation

    dv_i/dt = (a/C) * sum_j  s_j(t) * J_ij * Q(v_j),     v clipped to [0, VDD]

with s(t) the deterministic column-scale schedule from ``perturbation.py``.
The op grouping is the reference's, so the unit schedule is bit-identical:
drive·dt folded into the scales outside the matvec, an int8 ADC, the
scaled spins cast to the compute dtype, an f32-accumulated contraction
against J^T, and a clip to the rails.

Shapes: J (P, N, N) integer coupling levels; v0 (P, R, N) voltages
(P problems, R runs per problem). This path serves noise and trajectory
recording, which the fused kernel does not materialize.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import rng
from .binarize import sign_pm1
from .device_model import DeviceModel
from .hamiltonian import ising_energy
from .perturbation import PerturbationConfig, schedule_table

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: rng stream of the noise path's per-step normals
NOISE_STREAM = 1


@dataclasses.dataclass(frozen=True)
class AnnealResult:
    v_final: torch.Tensor                     # (P, R, N) final voltages
    sigma: torch.Tensor                       # (P, R, N) final spins (+-1)
    energy: torch.Tensor                      # (P, R) final Ising energy
    energy_traj: Optional[torch.Tensor] = None  # (P, R, T_rec) if recorded
    j_dtype: Optional[str] = None             # variant AnnealEngine.run chose


def _compute_dtype(dev: DeviceModel) -> torch.dtype:
    try:
        return _COMPUTE_DTYPES[dev.compute_dtype]
    except KeyError:
        raise ValueError(f"compute_dtype must be one of "
                         f"{tuple(_COMPUTE_DTYPES)}, got "
                         f"{dev.compute_dtype!r}") from None


def _replicate_spin_axis(q8):
    """The ADC's int8 spins whole along the spin axis where they are
    DTensors that split it (the reference's constraint of the same name):
    the cross-shard exchange then moves the 1-byte spins, not the f32
    scaled ones, 4x the bytes. Numerically exact; the other axes keep
    their layout, and a plain tensor is returned as it is."""
    placements = getattr(q8, "placements", None)
    if placements is None:
        return q8
    from torch.distributed.tensor import Replicate
    d = q8.dim() - 1
    want = [Replicate() if p.is_shard(d) else p for p in placements]
    if want == list(placements):
        return q8
    return q8.redistribute(q8.device_mesh, want)


def anneal(J: torch.Tensor, v0: torch.Tensor, dev: DeviceModel,
           pert: PerturbationConfig,
           noise_seed: Optional[int] = None,
           record_every: int = 0,
           noise: Optional[torch.Tensor] = None) -> AnnealResult:
    """Run the full anneal on ``J``'s device. ``J`` must already be
    quantized to DAC levels; refresh/perturbation act through the column
    scales.

    noise_seed: enables the Gaussian "inherent perturbation" noise path
        (dev.noise_sigma > 0); step t's normals of v's shape come from the
        counter-based ``rng``, key (noise_seed, ``NOISE_STREAM``) and
        counter (t, flat index), made on J's device.
    noise: (T, P, R, N) standard normals to use instead of drawing them —
        lets a test feed the reference's exact per-step draws.
    record_every: if > 0, record the Hamiltonian every k steps (Fig. 4 left).
    """
    J = torch.as_tensor(J).to(torch.float32)
    v = torch.as_tensor(v0, device=J.device).to(torch.float32)
    T = dev.n_steps
    N = J.shape[-1]
    cdt = _compute_dtype(dev)
    # Loop-invariant cast and transpose outside the loop. A bf16 operand is
    # carried upcast to f32: products of bf16 values are exact in f32, so an
    # f32 product of the upcast operands is the reference's bf16 x bf16 dot
    # with f32 accumulation (torch's bf16 matmul would round its output).
    Jt = J.to(cdt).to(torch.float32).transpose(-1, -2).contiguous()
    scales = schedule_table(dev, pert, n_cols=N, device=J.device) \
        * (dev.drive_eff * dev.dt)
    use_noise = dev.noise_sigma > 0 and (noise_seed is not None or
                                         noise is not None)
    if use_noise and noise is None:
        noise_key = rng.key(noise_seed, NOISE_STREAM)
        noise_idx = rng.counters(tuple(v.shape), v.device)
    if noise is not None and tuple(noise.shape) != (T,) + tuple(v.shape):
        raise ValueError(f"noise must be (T, P, R, N) = {(T,) + tuple(v.shape)}"
                         f", got {tuple(noise.shape)}")
    noise_scale = dev.noise_sigma * dev.dt
    recs = []
    for t in range(T):
        q8 = _replicate_spin_axis(sign_pm1(v, dev.threshold, torch.int8))
        sq = (q8.to(torch.float32) * scales[t]).to(cdt).to(torch.float32)
        dv = torch.matmul(sq, Jt)
        if use_noise:
            z = noise[t].to(J.device) if noise is not None else rng.normal(
                *rng.bits(noise_key, t, noise_idx))
            dv = dv + noise_scale * z
        v = torch.clamp(v + dv, 0.0, dev.vdd)
        if record_every and t % record_every == 0:
            recs.append(ising_energy(J, dev.adc(v)))
    sigma = dev.adc(v)
    energy = ising_energy(J, sigma)
    traj = torch.stack(recs, dim=-1) if record_every else None
    return AnnealResult(v_final=v, sigma=sigma, energy=energy,
                        energy_traj=traj)


def anneal_energy_trace(J, v0, dev, pert, record_every=4, noise_seed=None):
    """Convenience: (P, R, T_rec) Hamiltonian trajectory for Fig. 4-style
    plots."""
    res = anneal(J, v0, dev, pert, noise_seed=noise_seed,
                 record_every=record_every)
    return res.energy_traj
