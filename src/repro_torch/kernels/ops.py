"""Public wrapper around the anneal kernel.

``fused_anneal`` is the thin shim kept for direct callers; new code goes
through ``repro_torch.core.engine.AnnealEngine``, which owns path and
block-size selection and the autotune cache.
"""
from __future__ import annotations

import torch

from ..core.binarize import sign_pm1
from ..core.device_model import DeviceModel
from ..core.engine import integer_levels
from ..core.hamiltonian import ising_energy
from ..core.perturbation import PerturbationConfig
from .ising_anneal import fused_anneal_kernel


def fused_anneal(J, v0, dev: DeviceModel, pert: PerturbationConfig,
                 block_r: int | None = None, j_dtype: str = "float32"):
    """Full anneal via the fused kernel (schedule derived in-kernel).

    J (P,N,N) and v0 (P,R,N), tensors on one device. Returns (v_final,
    sigma, energy) matching ``core.annealer.anneal``'s noise-free outputs.
    """
    J = torch.as_tensor(J).to(torch.float32).contiguous()
    v0 = torch.as_tensor(v0, device=J.device).to(torch.float32).contiguous()
    if j_dtype == "int8" and not integer_levels(J):
        # guard the silent int8 truncation / wraparound of the J cast
        raise ValueError("j_dtype='int8' requires integer coupling levels "
                         "in [-127, 127] (run DeviceModel.quantize first)")
    kw = {} if block_r is None else {"block_r": block_r}
    v = fused_anneal_kernel(J, v0, dev=dev, pert=pert, j_dtype=j_dtype, **kw)
    sigma = sign_pm1(v, dev.threshold)
    return v, sigma, ising_energy(J, sigma)
