"""Table-driven oracle for the fused anneal kernel.

Semantically identical to ``core.annealer.anneal`` (noise-free path) but
consumes a precomputed ``schedule_table``, so the kernel's in-kernel
closed-form schedule can be checked against the table. Same op grouping as
the kernel and the scan path: drive_dt folded into the scales before the
matvec.
"""
from __future__ import annotations

import torch

from ..core.binarize import sign_pm1


def fused_anneal_ref(J: torch.Tensor, v0: torch.Tensor, scales: torch.Tensor,
                     drive_dt: float, vdd: float = 1.0) -> torch.Tensor:
    """Integrate the chip dynamics for scales.shape[0] Euler steps.

    J: (P, N, N) quantized couplings; v0: (P, R, N) initial voltages;
    scales: (T, N) per-step per-column coupling scales; drive_dt: a/C * dt.
    Returns v_final (P, R, N).
    """
    J = torch.as_tensor(J).to(torch.float32)
    v = torch.as_tensor(v0, device=J.device).to(torch.float32)
    scales = torch.as_tensor(scales, device=J.device).to(torch.float32) \
        * drive_dt
    Jt = J.transpose(-1, -2).contiguous()
    thr = 0.5 * vdd
    for s in scales:
        sq = sign_pm1(v, thr) * s                      # (P, R, N) * (N,)
        v = torch.clamp(v + torch.matmul(sq, Jt), 0.0, vdd)
    return v
