"""The one ±1 binarization convention: ``x >= threshold -> +1``.

The chip's inverter resolves a node sitting exactly on the decision
boundary to +1 (``v >= vdd/2`` reads high). The comparison is written
``x >= threshold``, not ``(x - threshold) >= 0``: the subtraction rounds,
and a value one ULP below the threshold could land on the wrong side of
zero after it. Every path (scan anneal, fused kernel and its plain
version) binarizes through this function or the same comparison in CUDA.
"""
from __future__ import annotations

import torch


def sign_pm1(x: torch.Tensor, threshold: float = 0.0,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """±1 spins from a continuous state; the boundary maps to +1.
    ``dtype`` picks the spin storage type: float32 for matvec operands,
    int8 for the ADC wire format."""
    x = torch.as_tensor(x)
    one = torch.ones((), dtype=dtype, device=x.device)
    return torch.where(x >= threshold, one, -one)
